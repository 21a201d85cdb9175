#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (`tngp_torch`) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--profile]

Phases (any failure exits non-zero and prints no result line):
  1. build every CUDA kernel from `tngp_torch/csrc/`;
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes the paths give it: the eval render (encoder forward
     M = 393,216 samples of the flagship spec, the bin sort exactly, also
     with every sample in one tile and with NaN coordinates, the
     scatter-add's unique form for the encoder's payload sort, exact, its sorted form for
     the compositor's per-ray reduction and the eval round update, within
     (n-1) 2^-24 sum|v| of the exact sum and bitwise the same on a second
     call, and its general atomic form on the per-ray inputs), the training
     step (encoder backward and the cotangent sort, unique form, at the top
     budget tier, M = 131,072), and samples with x01 in [-0.06, 1.06], as
     D-NeRF's x + dx gives them (forward, table gradient and the
     input-gradient kernel), a small width (M = 4096, mostly padding) and
     every sample in one tile (forward, table gradient with the plain
     version's zeros, and input gradient; the input gradient bitwise the
     same on a second call wherever it is held), and the set-scatter exactly on the occupancy
     update's resample-shaped input (rand_idx ++ occ_idx on a ~10% occupied
     128^3 grid), an all-skip input, a ragged M and M = 0;
  2b. the device-parity entry, `tngp_torch.diagnostics.device_parity.main()`
     (the int-mul probe exact, the encoder kernels against independent plain
     versions, each scatter-add form against the exact sum);
  2c. the grid-update stage bench, `tngp_torch.diagnostics.bench_grid_update
     .main()` at full width (H = 128, 2N = 1,048,576 queries, the flagship
     network): its stage times, the set-scatter kernel exactly equal to its
     plain version (a failed check fails the run), and every kernel of its
     path launched;
  3. eval path, random weights from --seed: one warm-up and one timed
     800x800 frame of the flagship-width instant-NGP network through
     `Trainer.render_image` on bench.py's blob-scene occupancy grid; show
     that every eval kernel launched, and hold one 4096-ray chunk against
     the plain path on the card;
  4. training path: the same network trained on 12 views of 128x128 of the
     blob scene (rendered here, on the card) with bench.py's loop: 4096
     rays/step, lr 1e-2, grid update and budget-tier read every 16 steps;
     200 untimed and 100 timed steps; show that its four kernels launched in
     the timed steps, that the loss fell and everything stayed finite, and
     (over 32 further steps) that no step made a host sync; hold one step's
     gradients through the kernels against the same step through the plain
     versions;
  5. eval path again with the trained EMA weights: one timed 800x800 frame;
  6. D-NeRF training at full width with scripts/bench_dnerf_step.py's
     config (`dnerf_phase`): the pinned NGP step, then D-NeRF on 12 views of
     128x128 of the dynamic blob scene, 64 untimed and 100 timed steps each;
     rays/s, ms/step, their ratio, the time-grid update's wall (CUDA events
     on the stream, no host sync in the timed steps), the loss
     halving, no host sync in a step, the input-gradient kernel once per
     backward, one step through the kernels against the plain versions on
     a freshly built net (whose deform net must get a nonzero gradient) and
     again after training (where a deform net that died in training is
     reported, not failed), and the EMA PSNR over the 12 views at their own
     times;
  7. time each kernel (one row per scatter-add form and caller), its plain
     version and the nearest single PyTorch call at the paths' shapes: ms
     (CUDA events around 20 back-to-back calls), host_us (200 calls without
     a sync) and, last, device_ms (profiler device events, or CUDA graph
     replays where the profiler records none, as after --profile's
     profiles), beside the least time the card could take
     (`tngp_torch.diagnostics.kernel_times`); the bin sort's row is the
     whole `bin_dest` call, its device operations counted; the encoder rows
     also time the small width, one tile and (forward) a training step's
     inputs under `shapes` (`kernel_times.encoder_calls` on
     `encoder_inputs`, the inputs `kernel_times.py` times);
  8. print the card's name and power limit, the kernel table as one JSON
     line, and `{"ok": true, "device": ...}` last.

`--profile` adds a profiled partial grid update (resample, H = 128), a
profiled eval frame and ten profiled training steps with device time by
kernel and the idle share.

It needs a CUDA card and the rest of the repository next to it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time
import warnings

import numpy as np
import torch

RES = 800  # frame side, the reference's test resolution
WARM_STEPS, TIMED_STEPS = 200, 100  # training: untimed, then timed
SYNC_STEPS = 32  # further steps under the host-sync log
DNERF_WARM, DNERF_TIMED = 64, 100  # D-NeRF and pinned NGP: untimed, then timed
DNERF_SYNC_STEPS = 16
DNERF_FRAMES, DNERF_RES, DNERF_TIME_SIZE = 12, 128, 16  # bench_dnerf_step.py's scene and grid
GRID_SIZE = 128  # occupancy grid side, bench.py's render config
N_RAYS = 4096  # rays per training step and per eval chunk
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
INT32_OPS_PER_S = 16.7e12  # H100 SXM int32: 64 per clock per SM x 132 SMs x 1.98 GHz


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(bytes_moved: float, ops: float, ops_rate: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max().item())


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-30))


@contextlib.contextmanager
def host_sync_log():
    """Collects one entry per synchronizing CUDA call made inside the scope
    (torch's sync debug mode, which warns on `.item()`, `.cpu()`, blocking
    copies and the like)."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.cuda.set_sync_debug_mode("default")


def n_syncs(caught) -> int:
    return sum("synchronizing CUDA operation" in str(w.message) for w in caught)


def profile_device(fn, label: str, wall_off: float) -> None:
    """Run `fn` under torch.profiler; print device time by kernel, the
    idle share of `wall_off`, the same work's wall time with the profiler
    off (the profiler's host cost inflates the profiled wall), and the
    cumsums' device time by input shape."""
    from torch.profiler import ProfilerActivity, profile

    from tngp_torch.diagnostics.step_times import ops_by_shape

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    # device-side events only (kernels, memsets, copies): the aten ops above
    # them report the same time again
    cuda_t = torch.autograd.DeviceType.CUDA
    # and not the optimizer's annotation span, which covers its kernels' time
    dev_us = [(e.key, e.device_time_total, e.count) for e in prof.key_averages()
              if e.device_type == cuda_t and e.device_time_total > 0
              and not e.key.startswith("Optimizer.")]
    dev_us.sort(key=lambda kv: -kv[1])
    busy = sum(t for _, t, _ in dev_us) / 1e6
    n_ev = sum(c for _, _, c in dev_us)
    log(f"[profile] {label}: wall {wall:.3f} s with the profiler on ({wall_off:.3f} s off), "
        f"device busy {busy:.4f} s over {n_ev} device events: idle share "
        f"{1 - busy / wall_off:.3f} of the unprofiled wall")
    for k, t, c in dev_us[:25]:
        log(f"[profile]   {t / 1e3:10.3f} ms  {100 * t / 1e6 / busy:5.1f}%  x{c:<7d} {k[:96]}")
    for op, shapes, n, ms in ops_by_shape(prof)[:8]:
        log(f"[profile]   {op} {shapes[:80]}: {ms:.3f} ms over {n} calls")


@torch.no_grad()
def check_scatter_add(idx, vals, rows, indices, what):
    """A scatter-add form against its plain version on indices that hold its
    statement.  "unique": exact.  "sorted" and "any": each row within
    (n - 1) 2^-24 sum|v| of the exact (f64) sum, n = the row's entry count
    (any order of n f32 terms is), and within n 2^-24 sum|v| of the plain
    version (the check of PRs 1-4); "sorted" also bitwise the same on a
    second call.  Returns (max |err| vs plain, worst err / bound vs exact)."""
    from tngp_torch.kernels import scatter as ks

    got = ks.scatter_add(idx, vals, rows, indices=indices)
    plain = ks.scatter_add_plain(idx, vals, rows)
    err = max_abs(got, plain)
    if indices == "unique":
        if err != 0.0:
            raise SystemExit(f"scatter_add_unique ({what}) not exact: {err}")
        return err, 0.0
    slot = torch.where((idx >= 0) & (idx < rows), idx, rows)
    C = vals.shape[1]

    def f64_sum(v):
        z = torch.zeros((rows + 1, C), dtype=torch.float64, device=v.device)
        return z.index_add_(0, slot, v.double())[:rows]

    exact, sabs = f64_sum(vals), f64_sum(vals.abs())
    n = torch.bincount(slot, minlength=rows + 1)[:rows].double()[:, None]
    dev_exact = (got.double() - exact).abs()
    tol = (n - 1).clamp(min=0) * 2.0**-24 * sabs
    if not bool((dev_exact <= tol).all()):
        raise SystemExit(f"scatter_add_{indices} ({what}) beyond (n-1) 2^-24 sum|v| of the "
                         f"exact sum: {float(dev_exact.max())}")
    if not bool(((got.double() - plain.double()).abs() <= n * 2.0**-24 * sabs + 1e-30).all()):
        raise SystemExit(f"scatter_add_{indices} ({what}) beyond n 2^-24 sum|v| of plain: {err}")
    if indices == "sorted" and not torch.equal(got, ks.scatter_add(idx, vals, rows,
                                                                   indices=indices)):
        raise SystemExit(f"scatter_add_sorted ({what}) differs between two calls")
    return err, float((dev_exact / tol.clamp(min=1e-300)).max())


@torch.no_grad()
def check_dx(xyz4, wob, table, g_sorted, spec, block, what):
    """The input-gradient kernel against its plain version.  Both form, per
    sample and dimension, the same L*C f32 products g * d (d bit for bit: the
    same bf16 roundings of derivative weights and table values, the 8
    corners summed in order); the kernel adds them in (level, channel)
    order within a group of levels and the groups in order, the plain
    version in torch's.  Any order of n terms is within (n - 1) 2^-24
    sum|term| of the exact sum, so the two are within 2 (L*C) 2^-24
    sum|g * d| of each other.  Padding slots must be exactly 0 and a second
    call must give the same bits.  Returns (max |err|, worst err / bound)."""
    from tngp_torch.kernels import window_encoder as kw

    got = kw.window_encode_dx(xyz4, wob, table, g_sorted, spec, block)
    plain = kw.window_encode_dx_plain(xyz4, wob, table, g_sorted, spec, block)
    d = kw.dx_features(xyz4, wob, table, spec, block)
    tol = 2 * spec.output_dim * 2.0**-24 * (g_sorted.T[None].abs() * d.abs()).sum(1).double()
    err = (got.double() - plain.double()).abs()
    if not bool((err <= tol).all()):
        raise SystemExit(f"window_encode_dx ({what}) beyond the reordering bound: "
                         f"{float(err.max())}")
    if not bool((got[:, xyz4[:, 3] == 0] == 0).all()):
        raise SystemExit(f"window_encode_dx ({what}): a padding slot is not zero")
    if not torch.equal(got, kw.window_encode_dx(xyz4, wob, table, g_sorted, spec, block)):
        raise SystemExit(f"window_encode_dx ({what}) differs between two calls")
    return float(err.max()), float((err / tol.clamp(min=1e-30)).max())


def dnerf_step_check(tr, model, what: str) -> dict:
    """One D-NeRF batch through the loss and its backward, through the
    kernels and again through the plain versions, and the input-gradient
    kernel on that step's own inputs (`check_dx`).  Fails on a non-finite
    gradient entry, a loss beyond 1e-5 relative, a gradient beyond 3e-2
    norm-relative (the NGP step's tolerances: the kernels' f32 summation
    order flips single bf16 roundings in the MLPs) or an input gradient
    beyond its reordering bound.  Returns the deform net's largest |grad|
    through the kernels (`deform_max`: the caller decides what a zero
    means), the errors and the input gradient's inputs (`dx_args`)."""
    from tngp_torch import kernels
    from tngp_torch.kernels import window_encoder as kw

    batch = tr.sample_batch()
    captured = {}
    real_dx = kw.window_encode_dx

    def capturing_dx(*a, **k):
        captured["args"] = a[:4]
        return real_dx(*a, **k)

    def grads():
        tr.optimizer.zero_grad(set_to_none=True)
        loss, npts, _ = tr.loss_on_batch(batch)
        loss.backward()
        return float(loss.detach()), [p.grad.clone() for p in tr.params], int(npts)

    kw.window_encode_dx = capturing_dx
    try:
        loss_k, grads_k, npts = grads()
    finally:
        kw.window_encode_dx = real_dx
    with kernels.plain_versions():
        loss_p, grads_p, _ = grads()
    tr.optimizer.zero_grad(set_to_none=True)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    rels = {n: rel_err(a, b) for n, a, b in zip(names, grads_k, grads_p)}
    deform_max = float(torch.stack([g.abs().max() for n, g in zip(names, grads_k)
                                    if n.startswith("deform_net")]).max())  # NaN propagates
    nonfinite = {n: int((~torch.isfinite(g)).sum()) for n, g in zip(names, grads_k)
                 if not bool(torch.isfinite(g).all())}
    about = (f"the batch: time {float(batch['time']):.3f}, {npts} samples, loss {loss_k}, "
             f"deform-net max |grad| {deform_max}")
    if nonfinite or deform_max != deform_max:
        raise SystemExit(f"D-NeRF step ({what} net): non-finite gradient entries {nonfinite}; "
                         + about)
    if not abs(loss_k - loss_p) <= 1e-5 * abs(loss_p):
        raise SystemExit(f"D-NeRF step ({what} net), kernels vs plain: loss {loss_k} vs "
                         f"{loss_p}; " + about)
    if not max(rels.values()) <= 3e-2:
        raise SystemExit(f"D-NeRF step ({what} net), kernels vs plain: gradient errors {rels}; "
                         + about)
    dx_args = tuple(a.detach() for a in captured["args"])
    err_dx, worst_dx = check_dx(*dx_args, model.encoder.spec, model.encoder.block,
                                f"a D-NeRF step's inputs, {what} net")
    log(f"[dnerf] one step on the {what} net, kernels vs plain path: loss {loss_k:.8f} vs "
        f"{loss_p:.8f}; gradient norm-relative errors "
        + ", ".join(f"{n} {v:.2e}" for n, v in rels.items())
        + f" (<= 3e-2); deform-net max |grad| {deform_max:.3e}; window_encode_dx on this "
        f"step's inputs (M_pad = {dx_args[0].shape[0]}) max|err| {err_dx:.3g}, worst "
        f"err/bound {worst_dx:.3f}, bitwise the same on a second call")
    return dict(deform_max=deform_max, rels=rels, err_dx=err_dx, worst_dx=worst_dx,
                dx_args=dx_args)


def dnerf_phase(dev, ds, seed: int) -> dict:
    """D-NeRF training at full width, as scripts/bench_dnerf_step.py drives
    it: the flagship encoder with position gradients, a 5x128 bf16 deform
    MLP, 4096 rays/step, bench.py's render config, a time grid of
    DNERF_TIME_SIZE slices updated every 16 steps, no budget tiers; the NGP
    step under the same pinned config on the static scene `ds` is its
    yardstick (JAX's bar: <= 2x).  Shows that every kernel of the path
    launched and the input-gradient kernel once per backward, that the loss
    halves, that a step makes no host sync, and one step through the kernels
    against the plain versions (`dnerf_step_check`) on a freshly built net,
    whose deform net must get a gradient, and after training, where a dead
    deform net is reported; reports rays/s, ms/step, the ratio, the
    time-grid update's wall and the EMA PSNR over the views at their own
    times."""
    from tngp_torch import kernels
    from tngp_torch.data import make_synthetic_dynamic_dataset
    from tngp_torch.models import DNeRFNetwork, NGPNetwork
    from tngp_torch.render import RenderConfig
    from tngp_torch.train import DNeRFTrainer, Trainer
    from tngp_torch.utils import TrainConfig

    info = kernels.KERNELS
    t0 = time.time()
    dds = make_synthetic_dynamic_dataset(n_frames=DNERF_FRAMES, H=DNERF_RES, W=DNERF_RES,
                                         seed=0, device=dev)
    log(f"[dnerf] {DNERF_FRAMES} x {DNERF_RES} x {DNERF_RES} views of the dynamic blob scene "
        f"(times 0..1) rendered in {time.time() - t0:.2f} s (mean {dds.images.mean():.4f})")
    cfg_p = RenderConfig(bound=1.0, grid_size=GRID_SIZE, max_steps=512, K=128, min_near=0.05,
                         compact_fraction=0.25, density_thresh=1.0, march_dense=True)
    pinned = TrainConfig(num_rays=N_RAYS, iters=100_000, adaptive_budget=False, seed=seed)

    def pinned_run(tr, label):
        """DNERF_WARM untimed then DNERF_TIMED timed steps (grid updates
        included, as bench_dnerf_step.py times them).  Returns (losses of
        all steps, timed wall, launches in the timed steps)."""
        torch.cuda.synchronize()
        t0 = time.time()
        lw, _, _ = tr.run_steps(DNERF_WARM)
        torch.cuda.synchronize()
        log(f"[dnerf] {label}: {DNERF_WARM} untimed steps {time.time() - t0:.2f} s")
        kernels.reset_launch_counts()
        t0 = time.time()
        lt, pts, kept = tr.run_steps(DNERF_TIMED)
        torch.cuda.synchronize()
        dt = time.time() - t0
        counts = {name: k.launches for name, k in info.items()}
        log(f"[dnerf] {label}: {DNERF_TIMED} timed steps {dt:.3f} s, "
            f"{1e3 * dt / DNERF_TIMED:.2f} ms/step, {DNERF_TIMED * N_RAYS / dt:,.1f} train "
            f"rays/s; demand {float(pts.float().mean()):,.0f} rungs/step, "
            f"{float(kept.mean()):,.0f} of {N_RAYS} rays kept (M = {tr.tier_M}); "
            f"launches {counts}")
        return torch.cat([lw, lt]), dt, counts

    # the gradient flow through the kernels, on a freshly built net (its own
    # trainer, so that the timed run below trains as it did): one full
    # time-grid update, then one batch
    fresh_model = DNeRFNetwork(bound=1.0, encoding="hashgrid_window",
                               compute_dtype=torch.bfloat16, device=dev, seed=seed)
    fresh = DNeRFTrainer(fresh_model, dds, cfg_p, pinned, time_size=DNERF_TIME_SIZE,
                         update_interval=16, device=dev)
    fresh.update_grid()
    fresh_check = dnerf_step_check(fresh, fresh_model, "fresh")
    if not fresh_check["deform_max"] > 0:
        raise SystemExit(f"D-NeRF step on the fresh net: the deform net's largest |grad| is "
                         f"{fresh_check['deform_max']} (must be > 0): no gradient reaches it")
    del fresh, fresh_model

    ngp_p = Trainer(NGPNetwork(bound=1.0, compute_dtype=torch.bfloat16, device=dev, seed=seed),
                    ds, cfg_p, pinned, device=dev)
    _, dt_ngp, _ = pinned_run(ngp_p, "NGP, pinned config")
    del ngp_p
    dmodel = DNeRFNetwork(bound=1.0, encoding="hashgrid_window", compute_dtype=torch.bfloat16,
                          device=dev, seed=seed)
    dtr = DNeRFTrainer(dmodel, dds, cfg_p, pinned, time_size=DNERF_TIME_SIZE, update_interval=16,
                       device=dev)
    # each grid update between two CUDA events on the stream, read after the
    # run: no host sync, so the timed steps run as in the NGP run
    grid_events = []
    update_grid = dtr.update_grid

    def timed_update_grid():
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        full = dtr._grid_updates < dtr.full_grid_updates
        a.record()
        update_grid()
        b.record()
        grid_events.append((a, b, full))

    dtr.update_grid = timed_update_grid
    losses_d, dt_dnerf, launches_dnerf = pinned_run(dtr, "D-NeRF")
    dtr.update_grid = update_grid
    ratio = dt_dnerf / dt_ngp
    n_full = sum(f for _, _, f in grid_events)
    walls = [a.elapsed_time(b) / 1e3 for a, b, _ in grid_events]
    log(f"[dnerf] time-grid updates: {len(walls)} over {dtr.global_step} steps, {n_full} full "
        f"({DNERF_TIME_SIZE} slices x {GRID_SIZE}^3 cells each), wall on the stream (CUDA "
        f"events) {statistics.mean(walls):.3f} s mean, {min(walls):.3f}-{max(walls):.3f} s, "
        f"{sum(walls):.3f} s in all")
    log(f"[dnerf] D-NeRF / NGP step time under the same pinned config: {ratio:.3f}x "
        f"(JAX's bar in scripts/bench_dnerf_step.py: <= 2)")
    for name in ("bin_dest", "scatter_add_unique", "scatter_add_sorted", "window_encode_fwd",
                 "window_encode_bwd", "window_encode_dx"):
        if launches_dnerf[name] <= 0:
            raise SystemExit(f"a kernel of the D-NeRF path never launched: {launches_dnerf}")
    if not (launches_dnerf["window_encode_dx"] == launches_dnerf["window_encode_bwd"]
            == DNERF_TIMED):
        raise SystemExit(f"window_encode_dx did not run once per backward and step: "
                         f"{launches_dnerf}")
    first16, last16 = float(losses_d[:16].mean()), float(losses_d[-16:].mean())
    log(f"[dnerf] loss first 16 steps {first16:.6f}, last 16 {last16:.6f}")
    if not (np.isfinite(first16) and last16 < 0.5 * first16):
        raise SystemExit(f"D-NeRF: the loss did not fall below half: {first16} -> {last16}")
    if not all(bool(torch.isfinite(p).all()) for p in dtr.params + dtr.ema_params):
        raise SystemExit("D-NeRF: a parameter is not finite after training")

    step_syncs = []
    with host_sync_log() as caught:
        plain_step = dtr.train_step

        def counted_dstep():
            before = n_syncs(caught)
            out = plain_step()
            step_syncs.append(n_syncs(caught) - before)
            return out

        dtr.train_step = counted_dstep
        dtr.run_steps(DNERF_SYNC_STEPS)
        dtr.train_step = plain_step
    log(f"[dnerf] host syncs over {DNERF_SYNC_STEPS} further steps: inside train_step "
        f"{sum(step_syncs)} ({max(step_syncs)} max per step)")
    if sum(step_syncs) != 0:
        raise SystemExit(f"D-NeRF train_step made host syncs: {step_syncs}")

    trained = dnerf_step_check(dtr, dmodel, "trained")
    if trained["deform_max"] == 0:
        log(f"[dnerf] the deform net died in training: its largest |grad| on this batch is 0 "
            f"(reported, not a failure: the kernels were held on the fresh net above)")

    t0 = time.time()
    psnr_d = dtr.evaluate(dds)
    log(f"[dnerf] PSNR with the EMA weights over the {DNERF_FRAMES} views at their own times "
        f"after {dtr.global_step} steps: {psnr_d:.2f} dB ({time.time() - t0:.2f} s)")
    if not np.isfinite(psnr_d):
        raise SystemExit("D-NeRF: the evaluation PSNR is not finite")
    return dict(dt_dnerf=dt_dnerf, dt_ngp=dt_ngp, ratio=ratio,
                rays_s=DNERF_TIMED * N_RAYS / dt_dnerf, psnr=psnr_d, launches=launches_dnerf,
                fresh=fresh_check, trained=trained)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="profile one partial grid update, one eval frame and ten training "
                         "steps as well and print device time by kernel")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; this run needs one", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tngp_torch import kernels
    from tngp_torch.data import full_image_rays, make_blob_field, make_synthetic_dataset, orbit_poses
    from tngp_torch.diagnostics import bench_grid_update, device_parity
    from tngp_torch.diagnostics.kernel_times import (
        bin_dest_bytes,
        card,
        device_ms,
        encoder_bytes,
        encoder_calls,
        encoder_inputs,
        events_ms,
        host_us,
    )
    from tngp_torch.kernels import scatter as ks
    from tngp_torch.kernels import window_encoder as kw
    from tngp_torch.kernels import int_mul
    from tngp_torch.models import NGPNetwork
    from tngp_torch.ops.grid_utils import packbits
    from tngp_torch.ops.window_table import WindowSpec, sample_tiles
    from tngp_torch.render import (
        FieldFns,
        OccupancyGrid,
        RenderConfig,
        cell_centers_cf,
        dilated_chunk_grid,
        render_rays_eval,
    )
    from tngp_torch.train import Trainer
    from tngp_torch.utils import TrainConfig

    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    info = kernels.KERNELS

    # ---- 1. build ----------------------------------------------------------
    t0 = time.time()
    kernels.load_all()
    log(f"[build] {len(info)} kernels built and loaded in {time.time() - t0:.1f} s")

    # ---- 2. kernels vs plain versions at the paths' shapes -----------------
    gen = torch.Generator(device="cpu").manual_seed(args.seed)
    spec = WindowSpec.create(desired_resolution=2048)  # flagship: 749 windows
    L, C = spec.num_levels, spec.level_dim
    BLOCK = kw.DEFAULT_BLOCK
    M = 393_216  # 4096 rays x K 128 x eval_budget 0.75: the full query bucket
    x01 = torch.rand((3, M), generator=gen).to(dev)
    table = torch.randn((spec.n_windows, C, 128, 64), generator=gen).to(dev)

    # the bin sort, exactly: its destinations and block tiles against the
    # plain bin_dest and its first stage's ranks and histograms against the
    # plain ranks, on the eval's samples, every sample in one tile, and
    # samples with NaN (and infinite) coordinates
    x01_nan = x01.clone()
    x01_nan[0, ::7], x01_nan[1, 1::5], x01_nan[2, 2::9] = float("nan"), float("inf"), -float("inf")
    for what, x_b in (("eval samples", x01), ("one tile", x01 * 0.24),
                      ("NaN and infinite coordinates", x01_nan)):
        dest_b, tob_b, rank_b, tot_b = kw.bin_dest_stages(x_b)
        d_ref, t_ref = kw.bin_dest_ref(x_b)
        rank_p, tot_p = kw.bin_ranks_plain(kw._padded_keys(sample_tiles(x_b)))
        if not (torch.equal(dest_b, d_ref) and torch.equal(tob_b, t_ref)
                and torch.equal(rank_b, rank_p) and torch.equal(tot_b, tot_p)):
            raise SystemExit(f"bin_dest ({what}) disagrees with the plain bin_dest")
    dest, tob = kw.bin_dest(x01)
    M_pad = kw.padded_size(M, BLOCK)
    payload = torch.cat([x01, torch.ones((1, M), device=dev)]).T.contiguous()
    err_sort, _ = check_scatter_add(dest, payload, M_pad, "unique", "payload sort")
    xyz4 = ks.scatter_add(dest, payload, M_pad, indices="unique")

    wob = kw._wob_local(spec, tob)
    feats_k = kw.window_encode_fwd(xyz4, wob, table, spec, BLOCK)
    feats_p = kw.window_encode_fwd_plain(xyz4, wob, table, spec, BLOCK)
    err_enc = max_abs(feats_k, feats_p)
    # tolerance: the kernel and the plain version sum the 8 bf16-exact corner
    # products in another order; for N(0,1) table values (|v| < 6.5 over 12M
    # draws) and weights summing to 1 that is below 2 * 7 * 2^-24 * 6.5 = 5.4e-6
    if not err_enc <= 6e-6:
        raise SystemExit(f"window_encode_fwd disagrees with its plain version: {err_enc}")

    # the compositor's per-ray reduction: ascending ray ids; the same inputs
    # through the general (atomic) form, which no path calls yet
    rid = torch.sort(torch.randint(0, N_RAYS, (M,), generator=gen)).values.to(dev)
    vals5 = torch.rand((M, 5), generator=gen).to(dev)
    err_comp, worst_comp = check_scatter_add(rid, vals5, N_RAYS, "sorted", "per-ray reduction")
    err_any, worst_any = check_scatter_add(rid, vals5, N_RAYS, "any", "per-ray inputs")
    # the eval round update: Na = 1024 alive-ray slots, ascending, fill N - 1
    Na = N_RAYS // 4
    live = torch.nonzero(torch.rand(N_RAYS, generator=gen) < 0.2)[:Na, 0]
    sel_r = torch.cat([live, torch.full((Na - live.numel(),), N_RAYS - 1)]).to(dev)
    delta6 = torch.randn((Na, 6), generator=gen).to(dev)
    err_round, worst_round = check_scatter_add(sel_r, delta6, N_RAYS, "sorted", "round update")
    log(f"[check] eval shapes: bin_dest exact (and its ranks and histograms) on the eval's "
        f"samples, one tile and NaN coordinates, payload sort "
        f"(scatter_add_unique, C = 4) exact, window_encode_fwd max|err| {err_enc:.3g} "
        f"(<= 6e-6); per-ray reduction (scatter_add_sorted, C = 5) max|err| vs plain "
        f"{err_comp:.3g}, worst err/bound vs the exact sum {worst_comp:.3f}, bitwise the same "
        f"on a second call; round update (scatter_add_sorted, C = 6) {err_round:.3g}, "
        f"{worst_round:.3f}; per-ray inputs through scatter_add_any {err_any:.3g}, "
        f"{worst_any:.3f} (bound (n-1) 2^-24 sum|v| per row)")

    # training shapes: the top budget tier, 4096 rays x K 128 x 0.25
    Mt = 131_072
    Mt_pad = kw.padded_size(Mt, BLOCK)

    def sorted_inputs(x01_t, g_t):
        """(xyz4, wob, g rows, g_sorted) of the encoder's backward, as
        `window_encode_binned` and its autograd backward make them."""
        dest_t, tob_t = kw.bin_dest(x01_t)
        m = x01_t.shape[1]
        m_pad = kw.padded_size(m, BLOCK)
        pay = torch.cat([x01_t, torch.ones((1, m), device=dev)]).T.contiguous()
        g_rows = g_t.T.contiguous()  # [M, LC]
        return (ks.scatter_add(dest_t, pay, m_pad, indices="unique"), kw._wob_local(spec, tob_t),
                dest_t, g_rows, ks.scatter_add(dest_t, g_rows, m_pad, indices="unique"))

    def bwd_addresses(xyz4_t, wob_t):
        """Flat table index [L, 8, M_pad] (channel 0) of every corner."""
        return torch.stack([kw.sorted_corner_addresses(xyz4_t, wob_t, spec, BLOCK, l)[0]
                            for l in range(L)])

    def check_bwd(xyz4_t, wob_t, g_sorted_t, what):
        """The backward kernel against its plain version.  Both sum the same
        n bf16-rounded terms of a table entry in f32, the kernel in whatever
        order its atomics land; any order is within (n - 1) 2^-24 sum|term|
        of the exact sum, so two orders are within twice that of each other."""
        got = kw.window_encode_bwd(xyz4_t, wob_t, g_sorted_t, spec, BLOCK)
        plain = kw.window_encode_bwd_plain(xyz4_t, wob_t, g_sorted_t, spec, BLOCK)
        sabs = kw.window_encode_bwd_plain(xyz4_t, wob_t, g_sorted_t.abs(), spec, BLOCK)
        addr = bwd_addresses(xyz4_t, wob_t)
        live = (xyz4_t[:, 3] > 0).expand(L, 8, -1).reshape(-1).float()
        n = torch.zeros(table.numel(), device=dev).index_add_(0, addr.reshape(-1), live)
        # counted at channel 0's addresses; the other channels take the same terms
        n = n.reshape(spec.n_windows, C, -1)[:, :1].expand(-1, C, -1).reshape(got.shape)
        tol_t = 2.0 * torch.clamp(n - 1, min=0).double() * 2.0**-24 * sabs.double() + 1e-30
        err = max_abs(got, plain)
        if not bool(((got.double() - plain.double()).abs() <= tol_t).all()):
            raise SystemExit(f"window_encode_bwd ({what}) beyond the reordering bound: {err}")
        if not bool(((got == 0) == (plain == 0)).all()):
            raise SystemExit(f"window_encode_bwd ({what}): zero pattern differs from plain")
        return err, float(n.max())

    x01_t = torch.rand((3, Mt), generator=gen).to(dev)
    g_t = torch.randn((L * C, Mt), generator=gen).to(dev)
    xyz4_t, wob_t, dest_t, g_rows_t, g_sorted_t = sorted_inputs(x01_t, g_t)
    err_gsort, _ = check_scatter_add(dest_t, g_rows_t, Mt_pad, "unique", "cotangent sort")
    if not torch.equal(g_sorted_t[dest_t], g_rows_t):
        raise SystemExit("scatter_add_unique (cotangent sort) lost a row")
    err_bwd, n_max = check_bwd(xyz4_t, wob_t, g_sorted_t, "uniform samples")
    log(f"[check] train shapes (M = {Mt}, M_pad = {Mt_pad}): cotangent sort "
        f"(scatter_add_unique) [{Mt}, {L * C}] -> [{Mt_pad}, {L * C}] exact, window_encode_bwd max|err| "
        f"{err_bwd:.3g} (each entry <= 2 (n-1) 2^-24 sum|term|, n up to {n_max:.0f})")

    # samples outside the unit cube, as D-NeRF's x + dx gives them: dense
    # corner rows outside the window contribute nothing in all three kernels
    x01_o = (torch.rand((3, Mt), generator=gen) * 1.12 - 0.06).to(dev)
    g_o = torch.randn((L * C, Mt), generator=gen).to(dev)
    xyz4_o, wob_o, _, _, g_sorted_o = sorted_inputs(x01_o, g_o)
    err_enc_o = max_abs(kw.window_encode_fwd(xyz4_o, wob_o, table, spec, BLOCK),
                        kw.window_encode_fwd_plain(xyz4_o, wob_o, table, spec, BLOCK))
    if not err_enc_o <= 6e-6:
        raise SystemExit(f"window_encode_fwd (x01 in [-0.06, 1.06]) vs plain: {err_enc_o}")
    err_bwd_o, _ = check_bwd(xyz4_o, wob_o, g_sorted_o, "x01 in [-0.06, 1.06]")
    err_dx_o, worst_dx_o = check_dx(xyz4_o, wob_o, table, g_sorted_o, spec, BLOCK,
                                    "x01 in [-0.06, 1.06]")
    outside = float(((x01_o < 0) | (x01_o > 1)).any(dim=0).float().mean())
    log(f"[check] x01 uniform in [-0.06, 1.06] (M = {Mt}, {outside:.3f} outside the cube): "
        f"window_encode_fwd max|err| {err_enc_o:.3g} (<= 6e-6), window_encode_bwd max|err| "
        f"{err_bwd_o:.3g} (reordering bound), window_encode_dx max|err| {err_dx_o:.3g}, "
        f"worst err/bound {worst_dx_o:.3f} (<= 2 (L*C) 2^-24 sum|g d| per sample and dimension)")

    # the encoder's other inputs, which phase 7 times too: a small eval
    # bucket (M = 4096, mostly padding, so its pieces gather from global
    # memory) and every sample in one tile (one window per level takes all)
    enc_cases = encoder_inputs(args.seed, ("small_bucket", "crowded"))
    for what, (xyz4_c, wob_c, g_sorted_c) in enc_cases.items():
        err_f = max_abs(kw.window_encode_fwd(xyz4_c, wob_c, table, spec, BLOCK),
                        kw.window_encode_fwd_plain(xyz4_c, wob_c, table, spec, BLOCK))
        if not err_f <= 6e-6:
            raise SystemExit(f"window_encode_fwd ({what}) vs plain: {err_f}")
        err_b, _ = check_bwd(xyz4_c, wob_c, g_sorted_c, what)
        err_x, worst_x = check_dx(xyz4_c, wob_c, table, g_sorted_c, spec, BLOCK, what)
        log(f"[check] {what} (M = {int((xyz4_c[:, 3] > 0).sum())}, M_pad = {xyz4_c.shape[0]}): "
            f"window_encode_fwd max|err| {err_f:.3g} (<= 6e-6), window_encode_bwd max|err| "
            f"{err_b:.3g} (reordering bound, zero pattern equal), window_encode_dx max|err| "
            f"{err_x:.3g}, worst err/bound {worst_x:.3f}")

    # the set-scatter, exactly: the occupancy update's resample write
    # (rand_idx ++ occ_idx, repeats concentrated on the occupied cells), all
    # skips, a ragged M with skips and another init, and M = 0
    Hg = bench_grid_update.H
    H3g, Ng = Hg**3, Hg**3 // 4
    gen_g = torch.Generator(device=dev).manual_seed(args.seed + 2)
    grid_g = bench_grid_update.occupied_grid(Hg, gen_g)
    rand_idx = torch.randint(0, H3g, (Ng,), generator=gen_g, device=dev)
    idx_rs = torch.cat([rand_idx, bench_grid_update.occupied_cells(grid_g, gen_g)])
    vals_rs = torch.rand((2 * Ng,), generator=gen_g, device=dev)
    m_odd = 2 * Ng - 77
    idx_odd = torch.randint(0, H3g, (m_odd,), generator=gen_g, device=dev)
    idx_odd = torch.where(torch.rand((m_odd,), generator=gen_g, device=dev) < 0.1, -1, idx_odd)
    set_cases = {
        "resample-shaped": (idx_rs, vals_rs, -1.0),
        "all-skip": (torch.full_like(idx_rs, -1), vals_rs, -1.0),
        f"M = {m_odd} with 10% skips, init 0": (idx_odd, vals_rs[:m_odd], 0.0),
        "M = 0": (idx_rs[:0], vals_rs[:0], -1.0),
    }
    for what, (i_s, v_s, init_s) in set_cases.items():
        got = ks.scatter_set_flat(i_s, v_s, H3g, init_s)
        bad = int((got != ks.scatter_set_flat_plain(i_s, v_s, H3g, init_s)).sum())
        if bad:
            raise SystemExit(f"scatter_set_flat ({what}) differs from its plain version in "
                             f"{bad} cells")
    dup_rs = int((torch.bincount(idx_rs, minlength=H3g) > 1).sum())
    log(f"[check] set-scatter into {H3g:,} cells exact against its plain version: "
        + ", ".join(set_cases) + f" (the resample-shaped input repeats {dup_rs:,} cells)")

    # ---- 2b. the device-parity entry (int-mul probe and encoder probes) ------
    kernels.reset_launch_counts()
    t0 = time.time()
    if device_parity.main() != 0:
        raise SystemExit("device parity failed")
    launches_parity = {name: k.launches for name, k in info.items()}
    log(f"[parity] python -m tngp_torch.diagnostics.device_parity passed in "
        f"{time.time() - t0:.1f} s; launches {launches_parity}")
    if min(launches_parity[n] for n in device_parity.KERNELS) <= 0:
        raise SystemExit(f"a kernel of the parity path never launched: {launches_parity}")

    # ---- 2c. the grid-update stage bench at full width ----------------------
    kernels.reset_launch_counts()
    t0 = time.time()
    bench = bench_grid_update.main(seed=args.seed)
    launches_grid = {name: k.launches for name, k in info.items()}
    log(f"[grid] python -m tngp_torch.diagnostics.bench_grid_update in {time.time() - t0:.1f} s: "
        "stage ms " + ", ".join(f"{k} {v:.4f}" for k, v in bench.times_ms.items())
        + f"; set-scatter checks {bench.checks}; launches {launches_grid}")
    if bench.rc != 0:
        raise SystemExit(f"the grid-update bench failed its set-scatter checks: {bench.checks}")
    if min(launches_grid[n] for n in bench_grid_update.KERNELS) <= 0:
        raise SystemExit(f"a kernel of the grid-update path never launched: {launches_grid}")
    if args.profile:
        net_g = NGPNetwork(bound=1.0, compute_dtype=torch.bfloat16, device=dev, seed=args.seed)
        dens_g = FieldFns.from_model(net_g).density

        def grid_update():
            bench_grid_update.partial_update(grid_g, dens_g, Hg, gen_g, "resample")

        grid_update()
        torch.cuda.synchronize()
        t0 = time.time()
        grid_update()
        torch.cuda.synchronize()
        profile_device(grid_update, f"one partial (resample) grid update, H = {Hg}",
                       time.time() - t0)

    # ---- 3. eval path, random weights: 800x800 frames ----------------------
    model = NGPNetwork(bound=1.0, compute_dtype=torch.bfloat16, device=dev, seed=args.seed)
    cfg = RenderConfig(bound=1.0, grid_size=GRID_SIZE, max_steps=512, K=128, min_near=0.05,
                       compact_fraction=0.25, density_thresh=1.0, march_dense=True,
                       march_group=16)
    t0 = time.time()
    ds = make_synthetic_dataset(n_frames=12, H=128, W=128, seed=0, device=dev)
    log(f"[data] 12 x 128 x 128 views of the blob scene rendered on the card in "
        f"{time.time() - t0:.2f} s (mean {ds.images.mean():.4f})")
    # bench.py's loop: constant lr 1e-2, tiers f/4, f/2, f, full grid updates
    # for the first 32 steps
    tc = TrainConfig(num_rays=N_RAYS, lr=1e-2, seed=args.seed, adaptive_overdrive=False)
    trainer = Trainer(model, ds, cfg, tc, device=dev, constant_lr=True, full_grid_updates=2)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise SystemExit("the trainer must leave TF32 off")
    grid0 = trainer.grid
    blob = make_blob_field(0, device=dev)
    density = blob.density(None, cell_centers_cf(0, cfg.bound, cfg.grid_size, device=dev))[None]
    trainer.set_grid(OccupancyGrid(
        density_grid=density, bitfield=packbits(density, cfg.density_thresh).reshape(-1),
        mean_density=density.mean(), iter_density=torch.zeros((), dtype=torch.int64, device=dev)))
    bitfield = trainer.grid.bitfield
    occ_frac = float((density > cfg.density_thresh).float().mean().item())
    dgrid = dilated_chunk_grid(bitfield, cfg)
    R = RES  # render_image scales the dataset's intrinsics: focal 0.9 R, centre R / 2
    poses = orbit_poses(4, radius=2.35, elevation=0.3)

    def timed_frame(pose, use_ema, label):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        img, _ = trainer.render_image(pose, use_ema=use_ema, chunk=N_RAYS, W=R, H=R)
        dt = time.time() - t0  # render_image returns host arrays: the device is done
        counts = {name: k.launches for name, k in info.items()}
        st = trainer.last_render_stats
        if img.shape != (R, R, 3) or not np.isfinite(img).all():
            raise SystemExit(f"{label}: rendered image is not a finite [R, R, 3] array")
        for name in ("scatter_add_unique", "scatter_add_sorted", "bin_dest",
                     "window_encode_fwd"):
            if counts[name] <= 0:
                raise SystemExit(f"{label}: a kernel of the eval path never launched: {counts}")
        log(f"[eval] {label}: one {R}x{R} frame {dt:.3f} s, {R * R / dt:,.1f} rays/s; "
            f"{st['samples']:,} samples queried ({st['valid_samples']:,} valid, "
            f"{st['valid_samples'] / (R * R):.1f} per ray), {st['rounds']} residual rounds over "
            f"{st['chunks']} chunks; launches {counts}; image finite, range "
            f"[{img.min():.4f}, {img.max():.4f}]")
        return dt, counts, st

    t0 = time.time()
    trainer.render_image(poses[0], use_ema=False, chunk=N_RAYS, W=R, H=R)
    log(f"[eval] warm-up frame {time.time() - t0:.2f} s (occupancy {occ_frac:.4f})")
    dt_rand, launches_eval, _ = timed_frame(poses[1], False, "random weights")
    log("[eval] note: a randomly initialised field never saturates transmittance, so no "
        "ray terminates early; that rays/s is a worst case for the march and the field query")

    # one chunk through the kernels and through the plain versions, on the card
    field = trainer.field
    intr800 = np.array([0.9 * R, 0.9 * R, R / 2, R / 2], np.float32)
    o, d = full_image_rays(poses[1], intr800, R, R, device=dev)
    s0 = max(0, (R // 2) * R - N_RAYS // 2)  # centred on the middle row: hits the object
    sl = slice(s0, s0 + N_RAYS)
    out_k = render_rays_eval(field, None, o[sl], d[sl], bitfield, cfg, dilated_grid=dgrid)
    with kernels.plain_versions():
        out_p = render_rays_eval(field, None, o[sl], d[sl], bitfield, cfg, dilated_grid=dgrid)
    err_chunk = max_abs(out_k["image"], out_p["image"])
    ws_mean = float(out_k["weights_sum"].mean().item())
    # tolerance: the kernels reorder f32 sums (encoder corners, per-ray adds);
    # a feature on a bf16 rounding boundary then rounds the other way in the
    # bf16 MLP, moving that sample's sigma/rgb by about one bf16 ulp
    if not err_chunk <= 2e-3 or out_k["valid_samples"] != out_p["valid_samples"]:
        raise SystemExit(f"chunk render: kernels vs plain max|err| {err_chunk}")
    log(f"[eval] one {N_RAYS}-ray chunk, kernels vs plain path on the card: image "
        f"max|err| {err_chunk:.3g} (<= 2e-3), mean weights_sum {ws_mean:.4f}, "
        f"{out_k['valid_samples']} samples, {out_k['rounds']} rounds")
    if args.profile:
        profile_device(lambda: trainer.render_image(poses[2], use_ema=False, chunk=N_RAYS,
                                                    W=R, H=R),
                       "one 800x800 eval frame, random weights", dt_rand)

    # ---- 4. training path ---------------------------------------------------
    trainer.set_grid(grid0)
    torch.cuda.synchronize()
    t0 = time.time()
    loss_w, pts_w, kept_w = trainer.run_steps(WARM_STEPS)
    torch.cuda.synchronize()
    log(f"[train] {WARM_STEPS} untimed steps {time.time() - t0:.2f} s; tier M = {trainer.tier_M}")
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    loss_t, pts_t, kept_t = trainer.run_steps(TIMED_STEPS)
    torch.cuda.synchronize()
    dt_train = time.time() - t0
    launches_train = {name: k.launches for name, k in info.items()}
    train_rays_s = TIMED_STEPS * N_RAYS / dt_train
    losses = torch.cat([loss_w, loss_t])
    first16, last16 = float(losses[:16].mean()), float(losses[-16:].mean())
    occ_end = float((trainer.grid.density_grid > min(float(trainer.grid.mean_density),
                                                     cfg.density_thresh)).float().mean())
    valid_per_step = float(torch.clamp(pts_t, max=trainer.tier_M).float().mean())
    log(f"[train] {TIMED_STEPS} timed steps {dt_train:.3f} s: {train_rays_s:,.1f} train rays/s "
        f"({1e3 * dt_train / TIMED_STEPS:.2f} ms/step, grid updates and tier reads included); "
        f"tier M at the end {trainer.tier_M}; demand {float(pts_t.float().mean()):,.0f} valid "
        f"rungs/step, {valid_per_step:,.0f} samples/step inside the budget, "
        f"{float(kept_t.mean()):,.0f} of {N_RAYS} rays kept; loss first 16 steps "
        f"{first16:.6f}, last 16 {last16:.6f}; occupancy at the end {occ_end:.4f}; "
        f"launches {launches_train}")
    if min(launches_train[n] for n in ("scatter_add_unique", "scatter_add_sorted", "bin_dest",
                                       "window_encode_fwd", "window_encode_bwd")) <= 0:
        raise SystemExit(f"a kernel of the training path never launched: {launches_train}")

    # host syncs, counted over two further grid-update intervals (outside the
    # timed steps, so that the counting costs them nothing)
    reads0 = trainer.host_reads
    step_syncs = []
    with host_sync_log() as caught:
        plain_step = trainer.train_step

        def counted_step():
            before = n_syncs(caught)
            out = plain_step()
            step_syncs.append(n_syncs(caught) - before)
            return out

        trainer.train_step = counted_step
        n_before = n_syncs(caught)
        trainer.run_steps(SYNC_STEPS)
        syncs_total = n_syncs(caught) - n_before
        trainer.train_step = plain_step
    log(f"[train] host syncs over {SYNC_STEPS} further steps: inside train_step "
        f"{sum(step_syncs)} ({max(step_syncs)} max per step); at the 16-step boundaries "
        f"{syncs_total - sum(step_syncs)} syncs for {trainer.host_reads - reads0} tier reads")
    if sum(step_syncs) != 0:
        raise SystemExit(f"train_step made host syncs: {step_syncs}")
    if not (np.isfinite(first16) and last16 < 0.5 * first16):
        raise SystemExit(f"the loss did not fall below half: {first16} -> {last16}")
    if not occ_end > 0:
        raise SystemExit("the occupancy grid is empty after training")
    if not all(bool(torch.isfinite(p).all()) for p in trainer.params + trainer.ema_params):
        raise SystemExit("a parameter is not finite after training")

    # one step's gradients: through the kernels, and through the plain versions
    batch = trainer.sample_batch()
    captured = {}
    real_bwd = kw.window_encode_bwd

    def capturing_bwd(xyz4_c, wob_c, g_sorted_c, *a, **k):
        captured["args"] = (xyz4_c, wob_c, g_sorted_c)
        return real_bwd(xyz4_c, wob_c, g_sorted_c, *a, **k)

    def step_grads():
        trainer.optimizer.zero_grad(set_to_none=True)
        loss, _, _ = trainer.loss_on_batch(batch)
        loss.backward()
        return float(loss.detach()), [p.grad.clone() for p in trainer.params]

    kw.window_encode_bwd = capturing_bwd
    try:
        loss_k, grads_k = step_grads()
    finally:
        kw.window_encode_bwd = real_bwd
    with kernels.plain_versions():
        loss_p, grads_p = step_grads()
    trainer.optimizer.zero_grad(set_to_none=True)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    rels = {n: rel_err(a, b) for n, a, b in zip(names, grads_k, grads_p)}
    if not all(bool(torch.isfinite(g).all()) for g in grads_k):
        raise SystemExit("a gradient is not finite")
    # tolerances: the two paths differ by the kernels' f32 summation order
    # (features, per-ray sums, table gradient).  The loss averages that out
    # (1e-5 relative).  In the bf16 MLPs a feature on a rounding boundary
    # rounds the other way and single backward products flip by a bf16 ulp
    # (2^-7), so every gradient, the table's included (its cotangents come
    # through the MLP), is held to the norm-relative 3e-2 that the CPU parity
    # test states for bf16; the backward kernel alone is held to the pure
    # reordering bound on this step's own inputs just below.
    if not abs(loss_k - loss_p) <= 1e-5 * abs(loss_p):
        raise SystemExit(f"one step, kernels vs plain: loss {loss_k} vs {loss_p}")
    if not max(rels.values()) <= 3e-2:
        raise SystemExit(f"one step, kernels vs plain: gradient errors {rels}")
    xyz4_r, wob_r, g_sorted_r = captured["args"]
    err_bwd_real, n_max_real = check_bwd(xyz4_r, wob_r, g_sorted_r, "a training step's samples")
    Mr_pad = xyz4_r.shape[0]
    log(f"[train] one step, kernels vs plain path on the card: loss {loss_k:.8f} vs "
        f"{loss_p:.8f}; gradient norm-relative errors "
        + ", ".join(f"{n} {v:.2e}" for n, v in rels.items())
        + f" (<= 3e-2); window_encode_bwd on this step's inputs (M_pad = {Mr_pad}) max|err| "
        f"{err_bwd_real:.3g} within the reordering bound (n up to {n_max_real:.0f})")

    img, _ = trainer.render_image(ds.poses[0])
    psnr_steps = trainer.global_step
    psnr = -10.0 * np.log10(max(float(np.mean((img - ds.images[0]) ** 2)), 1e-12))
    if not np.isfinite(img).all():
        raise SystemExit("the trained 128x128 view is not finite")
    log(f"[train] training view 0 at 128x128 with the EMA weights after "
        f"{psnr_steps} steps: PSNR {psnr:.2f} dB vs its ground truth")

    if args.profile:
        g0 = trainer.global_step
        profile_device(lambda: trainer.run_steps(10),
                       f"ten training steps (steps {g0}..{g0 + 9}, tier M = {trainer.tier_M})",
                       10 * dt_train / TIMED_STEPS)

    # ---- 5. eval path, trained EMA weights ---------------------------------
    dt_trained, launches_eval2, st2 = timed_frame(poses[1], True, "trained EMA weights")
    log(f"[eval] 800x800 rays/s: random weights {R * R / dt_rand:,.1f}, trained weights "
        f"{R * R / dt_trained:,.1f} (the trained occupancy grid, {occ_end:.4f} occupied)")

    # ---- 6. D-NeRF training at full width (scripts/bench_dnerf_step.py) -----
    dn = dnerf_phase(dev, ds, args.seed)
    dt_dnerf, dt_ngp, ratio = dn["dt_dnerf"], dn["dt_ngp"], dn["ratio"]
    dnerf_rays_s, psnr_d, launches_dnerf = dn["rays_s"], dn["psnr"], dn["launches"]
    xyz4_x, wob_x, table_x, g_sorted_x = dn["trained"]["dx_args"]
    err_dx_real = dn["trained"]["err_dx"]

    # ---- 7. timing at the paths' shapes ------------------------------------
    # per callable: ms (CUDA events around 20 back-to-back calls), host_us
    # (200 calls, no sync) and, at the end of the phase because the
    # profiler's host cost lingers, device_ms (profiler device events)
    table_win = model.encoder.embeddings.detach()
    visited = sum(int(torch.unique(wob[l]).numel()) for l in range(L))
    # per live sample and level: positions + per-corner weight and sums
    enc_ops = int((xyz4[:, 3] > 0).sum()) * L * (10 + 8 * (3 + 2 * C))
    rows, to_profile = [], []

    def row(name, kernel, launches_n, err, fn_k, fn_p, fn_lib, nbytes, ops, rate, shapes=None,
            **extra):
        """One kernel's timings; `shapes` maps a label to (call, bytes bound
        ms) of the same kernel on other inputs, timed too (ms, device_ms)."""
        b_ms, b_by = bound(nbytes, ops, rate)
        r = dict(name=name, kernel=kernel, route="cuda", source=info[kernel].source,
                 replaces=info[kernel].replaces, launches=launches_n, max_abs_err=err,
                 ms=events_ms(fn_k), host_us=host_us(fn_k), plain_ms=events_ms(fn_p),
                 bound_ms=b_ms, bound_by=b_by,
                 library_ms=None if fn_lib is None else events_ms(fn_lib),
                 library_host_us=None if fn_lib is None else host_us(fn_lib), **extra)
        shapes = shapes or {}
        r["shapes"] = {label: dict(ms=events_ms(fn), bound_ms=b)
                       for label, (fn, b) in shapes.items()}
        rows.append(r)
        to_profile.append((r, fn_k, fn_lib, {label: fn for label, (fn, _) in shapes.items()}))
        lib = "-" if fn_lib is None else f"{r['library_ms']:.4f}"
        log(f"[time] {name:34s} {r['ms']:9.4f} ms  host {r['host_us']:7.2f} us  plain "
            f"{r['plain_ms']:9.4f} ms  library {lib} ms  bound {b_ms:.4f} ms ({b_by})"
            + "".join(f"; {label} {t['ms']:.4f} ms (bound {t['bound_ms']:.4f})"
                      for label, t in r["shapes"].items()))

    # the encoder on phase 2's other inputs and a training step's, timed as
    # `kernel_times.py` times them: label -> (call, bytes bound ms)
    enc_t = encoder_calls(table=table_win, train=(xyz4_r, wob_r, g_sorted_r), inputs=enc_cases)

    def enc_shapes(direction, labels):
        return {label: enc_t[f"window_encode_{direction}_{label}"][::2] for label in labels}

    row("window_encode_fwd", "window_encode_fwd", launches_eval["window_encode_fwd"], err_enc,
        lambda: kw.window_encode_fwd(xyz4, wob, table_win, spec, BLOCK),
        lambda: kw.window_encode_fwd_plain(xyz4, wob, table_win, spec, BLOCK),
        None, encoder_bytes("fwd", xyz4, wob, spec, BLOCK), enc_ops, F32_OPS_PER_S, path="eval",
        launches_train=launches_train["window_encode_fwd"],
        shapes=enc_shapes("fwd", ("small_bucket", "crowded", "train")),
        shape=f"xyz4 [{M_pad}, 4], table [749, 2, 128, 64] ({visited} windows visited)"
              f" -> [32, {M_pad}]")
    # the whole bin sort, its three kernels in one call: bytes of x01 in and
    # dest and tob out, the histograms once; a handful of integer operations
    # per sample.  Its device time is the sum over its device operations,
    # counted in `device_events`
    keys_top = sample_tiles(x01)
    NBk = -(-M // kw.RANK_BS)
    row("bin_dest", "bin_dest", launches_eval["bin_dest"], 0.0,
        lambda: kw.bin_dest(x01), lambda: kw.bin_dest_ref(x01),
        lambda: torch.argsort(keys_top, stable=True), bin_dest_bytes(M, BLOCK), M * 30,
        INT32_OPS_PER_S, path="eval", launches_train=launches_train["bin_dest"],
        library_call="argsort (stable) of the tile keys",
        shape=f"x01 [3, {M}] -> dest [{M}], tob [{M_pad // BLOCK}] (key blocks [{NBk}, 512], "
              f"histograms [{NBk}, 64])")

    def add_row(name, indices, launches_n, err, idx, vals, rows_out, **extra):
        """A scatter-add form.  Bytes: idx and vals read once, the output
        written once; one add per element."""
        m, c = vals.shape
        row(name, f"scatter_add_{indices}", launches_n, err,
            lambda: ks.scatter_add(idx, vals, rows_out, indices=indices),
            lambda: ks.scatter_add_plain(idx, vals, rows_out),
            lambda: torch.zeros((rows_out, c), device=dev).index_add_(0, idx, vals),
            m * 8 + m * c * 4 + rows_out * c * 4, m * c, F32_OPS_PER_S,
            library_call="index_add_ into zeros", shape=f"[{m}, {c}] -> [{rows_out}, {c}]",
            **extra)

    # launches: the unique form's over the frame are the payload sorts; in
    # the timed steps one cotangent sort per backward, the rest payload sorts
    add_row("scatter_add_unique", "unique", launches_eval["scatter_add_unique"], err_sort,
            dest, payload, M_pad, path="eval", call="encoder payload sort (unique indices)",
            launches_train=launches_train["scatter_add_unique"])
    add_row("scatter_add_sorted", "sorted", launches_eval["scatter_add_sorted"], err_comp,
            rid, vals5, N_RAYS, path="eval", worst_err_over_bound=worst_comp,
            call="compositor per-ray reduction (nondecreasing indices); the frame's count "
                 "includes the round updates", launches_train=launches_train["scatter_add_sorted"])
    add_row("scatter_add_unique_cotangent_sort", "unique", launches_train["window_encode_bwd"],
            err_gsort, dest_t, g_rows_t, Mt_pad, path="train",
            call="encoder backward: cotangent sort (unique indices), one per backward")
    add_row("scatter_add_sorted_round_update", "sorted", launches_eval["scatter_add_sorted"],
            err_round, sel_r, delta6, N_RAYS, path="eval", worst_err_over_bound=worst_round,
            call=f"eval round update: Na = {Na} alive-ray slots, ascending, fill N - 1 (the "
                 "frame's count includes the per-ray reductions)")
    add_row("scatter_add_any", "any", launches_parity["scatter_add_any"], err_any, rid, vals5,
            N_RAYS, path="device parity", worst_err_over_bound=worst_any,
            call="general indices (atomics): no caller on the training or eval path yet; "
                 "timed on the per-ray reduction's inputs, the atomics' contended case")

    # the backward kernel, on the inputs a training step gave it (captured
    # above), on uniform samples at the top tier and on the other inputs.
    # Bytes: samples, cotangents and block windows in, the whole gradient
    # table written once.
    def bwd_library(xyz4_b, wob_b, g_sorted_b):
        """The nearest single library call: `index_add_` of precomputed flat
        rows and values into the zeroed table (it does not compute the rows,
        the weights or the bf16 rounding, so it is not the same function)."""
        addr = bwd_addresses(xyz4_b, wob_b)  # [L, 8, M_pad]
        ws = torch.stack([kw.sorted_corner_addresses(xyz4_b, wob_b, spec, BLOCK, l)[1]
                          for l in range(L)])
        g = g_sorted_b.reshape(-1, L, C).permute(1, 2, 0)  # [L, C, M_pad]
        vals = (ws[:, None] * g[:, :, None]).to(torch.bfloat16).float()  # [L, C, 8, M_pad]
        idx = (addr[:, None] + torch.arange(C, device=dev).view(1, C, 1, 1) * 8192).reshape(-1)
        vals = vals.reshape(-1)
        return lambda: torch.zeros(table.numel(), device=dev).index_add_(0, idx, vals)

    lib_real = bwd_library(xyz4_r, wob_r, g_sorted_r)
    ms_uniform = events_ms(lambda: kw.window_encode_bwd(xyz4_t, wob_t, g_sorted_t, spec, BLOCK))
    n_live = int((xyz4_r[:, 3] > 0).sum())
    n_grad = int(((xyz4_r[:, 3] > 0) & (g_sorted_r != 0).any(dim=1)).sum())
    row("window_encode_bwd", "window_encode_bwd", launches_train["window_encode_bwd"],
        err_bwd_real,
        lambda: kw.window_encode_bwd(xyz4_r, wob_r, g_sorted_r, spec, BLOCK),
        lambda: kw.window_encode_bwd_plain(xyz4_r, wob_r, g_sorted_r, spec, BLOCK),
        lib_real, encoder_bytes("bwd", xyz4_r, wob_r, spec, BLOCK),
        n_live * L * (10 + 8 * (3 + 2 * C)),
        F32_OPS_PER_S, path="train", library_call="index_add_ of precomputed rows and values "
        "(nearest call, not the same function)", ms_uniform_top_tier=ms_uniform,
        max_abs_err_uniform=err_bwd, shapes=enc_shapes("bwd", ("small_bucket", "crowded")),
        shape=f"xyz4 [{Mr_pad}, 4] ({n_live} samples, {n_grad} with a nonzero cotangent), "
              f"g_sorted [{Mr_pad}, {L * C}] -> [749, 2, 128, 64]")
    log(f"[time] window_encode_bwd (its zeroing kernel included) on uniform samples at the "
        f"top tier: {ms_uniform:.4f} ms")

    # the input-gradient kernel, on the inputs a D-NeRF step gave it and on
    # the uniform samples above.  Bytes: `encoder_bytes("dx")`.  Operations:
    # per live sample and level positions (12), 3 derivative weights per
    # corner (4 each) and per channel 8 rounded loads and 3 x 8 multiply-adds
    # and 3 contractions.
    dx_bytes = encoder_bytes("dx", xyz4_x, wob_x, spec, BLOCK)
    n_live_x = int((xyz4_x[:, 3] > 0).sum())
    dx_ops = n_live_x * L * (12 + 8 * 3 * 4 + C * (8 + 3 * 8 * 2 + 3 * 2))
    ms_dx_uniform = events_ms(
        lambda: kw.window_encode_dx(xyz4_o, wob_o, table, g_sorted_o, spec, BLOCK))
    row("window_encode_dx", "window_encode_dx", launches_dnerf["window_encode_dx"], err_dx_real,
        lambda: kw.window_encode_dx(xyz4_x, wob_x, table_x, g_sorted_x, spec, BLOCK),
        lambda: kw.window_encode_dx_plain(xyz4_x, wob_x, table_x, g_sorted_x, spec, BLOCK),
        None, dx_bytes, dx_ops, F32_OPS_PER_S, path="dnerf",
        library_call="none: no single PyTorch call computes the derivative-weight encode "
        "and its contraction", ms_uniform_oor=ms_dx_uniform, max_abs_err_uniform_oor=err_dx_o,
        bytes=dx_bytes, shapes=enc_shapes("dx", ("small_bucket", "crowded")),
        shape=f"xyz4 [{xyz4_x.shape[0]}, 4] ({n_live_x} samples), g_sorted "
              f"[{xyz4_x.shape[0]}, {L * C}], table [749, 2, 128, 64] -> gx [3, "
              f"{xyz4_x.shape[0]}]")
    # the set-scatter on the inputs the grid-update bench compared (2N random
    # writes into H^3 cells; its checks, exact against plain, passed above).
    # Bytes the function needs: idx once, the winning value of each written
    # cell, the output once; the kernel moves `kernel_bytes` (the int32
    # winner array written, hit by the atomics and read again on top).
    idx_b, vals_b = bench.scatter_args
    n_written = bench.checks["written_cells"]
    m_b = idx_b.numel()
    row("scatter_set", "scatter_set", launches_grid["scatter_set"], bench.checks["max_abs_err"],
        lambda: ks.scatter_set_flat(idx_b, vals_b, H3g),
        lambda: ks.scatter_set_flat_plain(idx_b, vals_b, H3g),
        lambda: torch.full((H3g,), -1.0, device=dev).index_put_((idx_b,), vals_b),
        m_b * 8 + n_written * 4 + H3g * 4, m_b, INT32_OPS_PER_S, path="grid-update bench",
        library_call="index_put_ (its winner on a repeated index is unspecified: not the "
        "same function)", kernel_bytes=H3g * 4 * 3 + m_b * (8 + 4) + n_written * 4,
        shape=f"idx [{m_b}] int64, vals [{m_b}] f32 -> [{H3g}] f32 ({n_written:,} cells "
              f"written)")
    xi = torch.arange(1 << 13, dtype=torch.int32, device=dev).reshape(8, -1)
    err_int = max_abs(int_mul.int_mul_hash(xi), int_mul.int_mul_hash_plain(xi))
    if err_int != 0.0:
        raise SystemExit(f"int_mul_hash disagrees with its plain version: {err_int}")
    row("int_mul_probe", "int_mul_probe", launches_parity["int_mul_probe"], err_int,
        lambda: int_mul.int_mul_hash(xi), lambda: int_mul.int_mul_hash_plain(xi), None,
        xi.numel() * 8, xi.numel() * 3, INT32_OPS_PER_S, path="device parity",
        shape="int32 [8, 1024] -> int32 [8, 1024] (exact)")
    missing = set(info) - {r["kernel"] for r in rows}
    if missing:
        raise SystemExit(f"registered kernels without a timing row: {sorted(missing)}")

    for r, fn_k, fn_lib, shape_fns in to_profile:
        r["device_ms"], r["device_events"], r["device_ms_method"] = device_ms(fn_k)
        r["library_device_ms"] = None if fn_lib is None else device_ms(fn_lib)[0]
        for label, fn in shape_fns.items():
            r["shapes"][label]["device_ms"] = device_ms(fn)[0]
        lib_dev = r["library_device_ms"]
        log(f"[time] {r['name']:34s} device {r['device_ms']:9.4f} ms ({r['device_ms_method']}, "
            f"{r['device_events']} device events per call); library device "
            f"{'-' if lib_dev is None else f'{lib_dev:.4f}'} ms"
            + "".join(f"; {label} device {t['device_ms']:.4f} ms"
                      for label, t in r["shapes"].items()))

    # ---- 8. report ---------------------------------------------------------
    smi = card()
    log(f"[result] train {train_rays_s:,.1f} rays/s (tier M {trainer.tier_M}, PSNR {psnr:.2f} dB "
        f"after {psnr_steps} steps); eval 800x800 {R * R / dt_rand:,.1f} rays/s "
        f"random weights, {R * R / dt_trained:,.1f} rays/s trained weights "
        f"({st2['valid_samples'] / (R * R):.1f} samples per ray, {st2['rounds']} residual rounds); "
        f"D-NeRF {dnerf_rays_s:,.1f} train rays/s ({1e3 * dt_dnerf / DNERF_TIMED:.2f} ms/step, "
        f"{ratio:.3f}x the pinned NGP step of {1e3 * dt_ngp / DNERF_TIMED:.2f} ms), PSNR "
        f"{psnr_d:.2f} dB over 12 views")
    print(f"card: {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
