#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (`tngp_torch`) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--profile]

Phases (any failure exits non-zero and prints no result line):
  1. build every CUDA kernel from `tngp_torch/csrc/`;
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes the two paths give it: the eval render (encoder forward
     M = 393,216 samples of the flagship spec, bin ranks, scatter-add for the
     encoder's payload sort and the compositor's per-ray reduction) and the
     training step (encoder backward and the cotangent sort at the top
     budget tier, M = 131,072);
  3. eval path, random weights from --seed: one warm-up and one timed
     800x800 frame of the flagship-width instant-NGP network through
     `Trainer.render_image` on bench.py's blob-scene occupancy grid; show
     that every eval kernel launched, and hold one 4096-ray chunk against
     the plain path on the card;
  4. training path: the same network trained on 12 views of 128x128 of the
     blob scene (rendered here, on the card) with bench.py's loop: 4096
     rays/step, lr 1e-2, grid update and budget-tier read every 16 steps;
     200 untimed and 100 timed steps; show that all four kernels launched in
     the timed steps, that the loss fell and everything stayed finite, and
     (over 32 further steps) that no step made a host sync; hold one step's gradients through the kernels
     against the same step through the plain versions;
  5. eval path again with the trained EMA weights: one timed 800x800 frame;
  6. time each kernel, its plain version and the nearest single PyTorch call
     at the paths' shapes, beside the least time the card could take;
  7. print the card's name and power limit, the kernel table as one JSON
     line, and `{"ok": true, "device": ...}` last.

`--profile` adds a profiled eval frame and ten profiled training steps with
device time by kernel and the idle share.

It needs a CUDA card and the rest of the repository next to it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

RES = 800  # frame side, the reference's test resolution
WARM_STEPS, TIMED_STEPS = 200, 100  # training: untimed, then timed
SYNC_STEPS = 32  # further steps under the host-sync log
N_RAYS = 4096  # rays per training step and per eval chunk
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
INT32_OPS_PER_S = 16.7e12  # H100 SXM int32: 64 per clock per SM x 132 SMs x 1.98 GHz


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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
    """Run `fn` under torch.profiler; print device time by kernel and the
    idle share of `wall_off`, the same work's wall time with the profiler
    off (the profiler's host cost inflates the profiled wall)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="profile one eval frame and ten training steps as well and print "
                         "device time by kernel")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; this run needs one", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tngp_torch import kernels
    from tngp_torch.data import full_image_rays, make_blob_field, make_synthetic_dataset, orbit_poses
    from tngp_torch.kernels import scatter as ks
    from tngp_torch.kernels import window_encoder as kw
    from tngp_torch.models import NGPNetwork
    from tngp_torch.ops.grid_utils import packbits
    from tngp_torch.ops.window_table import WindowSpec, sample_tiles
    from tngp_torch.render import (
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

    keyp = kw._padded_keys(sample_tiles(x01))
    rank_k, tot_k = kw.bin_ranks(keyp)
    rank_p, tot_p = kw.bin_ranks_plain(keyp)
    err_rank = max(max_abs(rank_k, rank_p), max_abs(tot_k, tot_p))
    if err_rank != 0.0:
        raise SystemExit(f"bin_ranks disagrees with its plain version: {err_rank}")

    dest, tob = kw.bin_dest(x01)
    d_ref, t_ref = kw.bin_dest_ref(x01)
    if not (torch.equal(dest, d_ref) and torch.equal(tob, t_ref)):
        raise SystemExit("bin_dest through the kernel disagrees with the plain bin_dest")
    M_pad = kw.padded_size(M, BLOCK)
    payload = torch.cat([x01, torch.ones((1, M), device=dev)]).T.contiguous()
    xyz4 = ks.scatter_add(dest, payload, M_pad)
    err_sort = max_abs(xyz4, ks.scatter_add_plain(dest, payload, M_pad))
    if err_sort != 0.0:
        raise SystemExit(f"scatter_add (unique indices) not exact: {err_sort}")

    wob = kw._wob_local(spec, tob)
    feats_k = kw.window_encode_fwd(xyz4, wob, table, spec, BLOCK)
    feats_p = kw.window_encode_fwd_plain(xyz4, wob, table, spec, BLOCK)
    err_enc = max_abs(feats_k, feats_p)
    # tolerance: the kernel and the plain version sum the 8 bf16-exact corner
    # products in another order; for N(0,1) table values (|v| < 6.5 over 12M
    # draws) and weights summing to 1 that is below 2 * 7 * 2^-24 * 6.5 = 5.4e-6
    if not err_enc <= 6e-6:
        raise SystemExit(f"window_encode_fwd disagrees with its plain version: {err_enc}")

    rid = torch.sort(torch.randint(0, N_RAYS, (M,), generator=gen)).values.to(dev)
    vals5 = torch.rand((M, 5), generator=gen).to(dev)
    comp_k = ks.scatter_add(rid, vals5, N_RAYS)
    comp_p = ks.scatter_add_plain(rid, vals5, N_RAYS)
    # tolerance: any summation order of n terms is within (n-1) 2^-24 sum|v|
    # of any other; per ray, n = its sample count
    cnt = torch.bincount(rid, minlength=N_RAYS).double()[:, None]
    tol = cnt * 2.0**-24 * ks.scatter_add_plain(rid, vals5.abs(), N_RAYS).double()
    err_comp = max_abs(comp_k, comp_p)
    if not bool(((comp_k.double() - comp_p.double()).abs() <= tol + 1e-30).all()):
        raise SystemExit(f"scatter_add (sorted indices) beyond reordering bound: {err_comp}")
    log(f"[check] eval shapes: bin_ranks exact, bin_dest exact, scatter_add sort exact, "
        f"window_encode_fwd max|err| {err_enc:.3g} (<= 6e-6), "
        f"scatter_add per-ray max|err| {err_comp:.3g} (<= (n-1) 2^-24 sum|v|)")

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
        return (ks.scatter_add(dest_t, pay, m_pad), kw._wob_local(spec, tob_t), dest_t, g_rows,
                ks.scatter_add(dest_t, g_rows, m_pad))

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
    err_gsort = max_abs(g_sorted_t, ks.scatter_add_plain(dest_t, g_rows_t, Mt_pad))
    if err_gsort != 0.0 or not torch.equal(g_sorted_t[dest_t], g_rows_t):
        raise SystemExit(f"scatter_add (cotangent sort) not exact: {err_gsort}")
    err_bwd, n_max = check_bwd(xyz4_t, wob_t, g_sorted_t, "uniform samples")
    log(f"[check] train shapes (M = {Mt}, M_pad = {Mt_pad}): cotangent sort "
        f"[{Mt}, {L * C}] -> [{Mt_pad}, {L * C}] exact, window_encode_bwd max|err| "
        f"{err_bwd:.3g} (each entry <= 2 (n-1) 2^-24 sum|term|, n up to {n_max:.0f})")

    # ---- 3. eval path, random weights: 800x800 frames ----------------------
    model = NGPNetwork(bound=1.0, compute_dtype=torch.bfloat16, device=dev, seed=args.seed)
    cfg = RenderConfig(bound=1.0, grid_size=128, max_steps=512, K=128, min_near=0.05,
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
        for name in ("scatter_add", "bin_ranks", "window_encode_fwd"):
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
    if min(launches_train.values()) <= 0:
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

    # ---- 6. timing at the paths' shapes ------------------------------------
    table_win = model.encoder.embeddings.detach()
    visited = sum(int(torch.unique(wob[l]).numel()) for l in range(L))
    enc_bytes = M_pad * 16 + wob.numel() * 4 + L * C * M_pad * 4 + visited * C * 8192 * 4
    enc_ops = M_pad * L * (10 + 8 * (3 + 2 * C))  # positions + per-corner weight and sums
    rows = []

    def row(name, kernel, launches_n, err, fn_k, fn_p, fn_lib, nbytes, ops, rate, **extra):
        ms, plain_ms = cuda_time_ms(fn_k), cuda_time_ms(fn_p)
        lib_ms = cuda_time_ms(fn_lib) if fn_lib is not None else None
        b_ms, b_by = bound(nbytes, ops, rate)
        rows.append(dict(name=name, route="cuda", source=info[kernel].source,
                         replaces=info[kernel].replaces, launches=launches_n, max_abs_err=err,
                         ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms, **extra))
        log(f"[time] {name:26s} {ms:9.4f} ms  plain {plain_ms:9.4f} ms  library "
            f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} ms  bound {b_ms:.4f} ms ({b_by})")

    row("window_encode_fwd", "window_encode_fwd", launches_eval["window_encode_fwd"], err_enc,
        lambda: kw.window_encode_fwd(xyz4, wob, table_win, spec, BLOCK),
        lambda: kw.window_encode_fwd_plain(xyz4, wob, table_win, spec, BLOCK),
        None, enc_bytes, enc_ops, F32_OPS_PER_S, path="eval",
        launches_train=launches_train["window_encode_fwd"],
        shape=f"xyz4 [{M_pad}, 4], table [749, 2, 128, 64] ({visited} windows visited)"
              f" -> [32, {M_pad}]")
    NBk = keyp.numel() // kw.RANK_BS
    row("bin_ranks", "bin_ranks", launches_eval["bin_ranks"], err_rank,
        lambda: kw.bin_ranks(keyp), lambda: kw.bin_ranks_plain(keyp),
        lambda: torch.argsort(keyp, stable=True),
        keyp.numel() * 8 + NBk * 64 * 4, keyp.numel() * 20, INT32_OPS_PER_S, path="eval",
        launches_train=launches_train["bin_ranks"],
        shape=f"keys [{NBk}, 512] -> rank [{NBk}, 512], tot [{NBk}, 64]")
    row("scatter_add", "scatter_add", launches_eval["scatter_add"], err_sort,
        lambda: ks.scatter_add(dest, payload, M_pad),
        lambda: ks.scatter_add_plain(dest, payload, M_pad),
        lambda: torch.zeros((M_pad, 4), device=dev).index_add_(0, dest, payload),
        M * 8 + M * 16 + M_pad * 16, M * 4, F32_OPS_PER_S, path="eval",
        launches_train=launches_train["scatter_add"],
        call="encoder payload sort (unique indices)", shape=f"[{M}, 4] -> [{M_pad}, 4]")
    row("scatter_add_composite", "scatter_add", launches_eval["scatter_add"], err_comp,
        lambda: ks.scatter_add(rid, vals5, N_RAYS),
        lambda: ks.scatter_add_plain(rid, vals5, N_RAYS),
        lambda: torch.zeros((N_RAYS, 5), device=dev).index_add_(0, rid, vals5),
        M * 8 + M * 20 + N_RAYS * 20, M * 5, F32_OPS_PER_S, path="eval",
        launches_train=launches_train["scatter_add"],
        call="compositor per-ray reduction (nondecreasing indices)",
        shape=f"[{M}, 5] -> [{N_RAYS}, 5]")
    # one cotangent sort per backward: this caller's share of the scatter-add launches
    row("scatter_add_cotangent_sort", "scatter_add", launches_train["window_encode_bwd"],
        err_gsort,
        lambda: ks.scatter_add(dest_t, g_rows_t, Mt_pad),
        lambda: ks.scatter_add_plain(dest_t, g_rows_t, Mt_pad),
        lambda: torch.zeros((Mt_pad, L * C), device=dev).index_add_(0, dest_t, g_rows_t),
        Mt * 8 + Mt * L * C * 4 + Mt_pad * L * C * 4, Mt * L * C, F32_OPS_PER_S, path="train",
        call="encoder backward: cotangent sort (unique indices), one per backward, of the "
             f"{launches_train['scatter_add']} scatter-add launches of all callers in the "
             "timed steps",
        shape=f"[{Mt}, {L * C}] -> [{Mt_pad}, {L * C}]")

    # the backward kernel, on the inputs a training step gave it (captured
    # above) and on uniform samples at the top tier.  Bytes: samples, cotangents
    # and block windows in, the whole gradient table written once (the
    # zero-fill is that write; the atomics touch only the visited rows).
    def bwd_bytes(m_pad):
        return m_pad * 16 + m_pad * L * C * 4 + L * (m_pad // BLOCK) * 4 + table.numel() * 4

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
    zero_ms = cuda_time_ms(lambda: torch.zeros_like(table), reps=10)
    ms_uniform = cuda_time_ms(lambda: kw.window_encode_bwd(xyz4_t, wob_t, g_sorted_t, spec, BLOCK))
    n_live = int((xyz4_r[:, 3] > 0).sum())
    n_grad = int(((xyz4_r[:, 3] > 0) & (g_sorted_r != 0).any(dim=1)).sum())
    row("window_encode_bwd", "window_encode_bwd", launches_train["window_encode_bwd"],
        err_bwd_real,
        lambda: kw.window_encode_bwd(xyz4_r, wob_r, g_sorted_r, spec, BLOCK),
        lambda: kw.window_encode_bwd_plain(xyz4_r, wob_r, g_sorted_r, spec, BLOCK),
        lib_real, bwd_bytes(Mr_pad), Mr_pad * L * (10 + 8 * (3 + 2 * C)), F32_OPS_PER_S,
        path="train", library_call="index_add_ of precomputed rows and values (nearest call, "
        "not the same function)", ms_uniform_top_tier=ms_uniform, max_abs_err_uniform=err_bwd,
        zero_fill_ms=zero_ms,
        shape=f"xyz4 [{Mr_pad}, 4] ({n_live} samples, {n_grad} with a nonzero cotangent), "
              f"g_sorted [{Mr_pad}, {L * C}] -> [749, 2, 128, 64]")
    log(f"[time] window_encode_bwd includes the 49.1 MB zero-fill, {zero_ms:.4f} ms alone; "
        f"uniform samples at the top tier: {ms_uniform:.4f} ms")

    # ---- 7. report ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[result] train {train_rays_s:,.1f} rays/s (tier M {trainer.tier_M}, PSNR {psnr:.2f} dB "
        f"after {psnr_steps} steps); eval 800x800 {R * R / dt_rand:,.1f} rays/s "
        f"random weights, {R * R / dt_trained:,.1f} rays/s trained weights "
        f"({st2['valid_samples'] / (R * R):.1f} samples per ray, {st2['rounds']} residual rounds)")
    print(f"card: {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
