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
     same on a second call wherever it is held), the frame renderer's widest
     residual round (bin sort exactly and forward, M = 524,288; the unique
     scatter-add's round update of 65,536 slots into the 655,360-ray frame
     exactly, unused slots dropped, and the sorted form's per-ray reduction
     of 524,288 samples into 65,536 rays), and the set-scatter exactly on
     the occupancy update's resample-shaped input (rand_idx ++ occ_idx on a
     ~10% occupied 128^3 grid), an all-skip input, a ragged M and M = 0;
     and the general scatter-add at the golden hash grid's table-gradient
     shapes (`hash_any_inputs`: level 0 of the default tiled grid,
     1,048,576 entries into 4,920 rows; its level 15, into 2^19 rows; a
     level of the hyper variant's 5-D grid, 4,194,304 entries; level 0 of
     the background grid, 16,384 entries into 296 rows), each entry within
     (n-1) 2^-24 sum|v| of the exact sum (n its nonzero terms), through the
     design `any_form` picks and through every other design that can take
     the shape (`check_any_forms`; the deterministic "owner" design bitwise
     the same on a second call, no -0.0 anywhere), and on the designs' edge
     cases (`any_edge_checks`: outputs just under and just over a block's
     shared memory, a row of 219,096 adds among zero rows, indices out of
     range, n = 0, C = 1 and 3, unaligned vals; and, bitwise equal to the
     plain version, integer values on a hot row, where any order of the
     adds is exact); every phase below that captures the form's inputs (6d,
     6f, 6g, 6h) holds the design each call dispatches to on it, and each
     other design on one call that can take it (`check_any_calls`);
  2b. the device-parity entry, `tngp_torch.diagnostics.device_parity.main()`
     (the int-mul probe exact, the encoder kernels against independent plain
     versions, each scatter-add form against the exact sum);
  2c. the grid-update stage bench, `tngp_torch.diagnostics.bench_grid_update
     .main()` at full width (H = 128, 2N = 1,048,576 queries, the flagship
     network): its stage times, the set-scatter kernel exactly equal to its
     plain version (a failed check fails the run), and every kernel of its
     path launched;
  2d. the march kernels (`march_phase`): `march_rays_chunked` on CUDA
     tensors against its plain version at an 800x800 frame's first-pass
     shape and a TensoRF training step's (`kernel_times.march_inputs`),
     every output bit for bit; the kernels' ms, the plain version's ms,
     the host us of a call and the bound in bytes (the device ms comes in
     phase 7's row);
  3. eval path, random weights from --seed: warm-up frames and
     `FrameRenderer.warmup`, then one timed 800x800 frame of the
     flagship-width instant-NGP network through `Trainer.render_image` (the
     frame renderer, 4096-ray first-pass chunks) on bench.py's blob-scene
     occupancy grid, with its residual rounds, tier sequence and host reads
     (at most 1 + first-pass chunks + rounds); the same frame through the
     plain versions, held to it within image 1e-4 and depth 1e-3 on all but
     1e-4 of the pixels, those within 1e-2; the same pose through
     `render_image_chunked` (the per-chunk `render_rays_eval` loop), timed
     and held to the frame within image 1e-4 and depth 1e-3 on all but 1e-4
     of the pixels, those within 1e-2 (rays that the two paths restart at
     different points; rays a round cap left alive apart); show that
     every eval kernel launched in each, and hold one 4096-ray chunk
     against the plain path on the card;
  3b. one 800x800 frame of NGP on the golden hash grid (`encoding="hashgrid"`)
     with the background model (bg_radius 2), random weights, through
     `Trainer.render_image` on phase 3's occupancy grid: timed, held to the
     same frame through the plain versions at phase 3's tolerances, and
     no table-gradient scatter (`scatter_add_any`) launched in it;
  4. training path: the same network trained on 12 views of 128x128 of the
     blob scene (rendered here, on the card) with bench.py's loop: 4096
     rays/step, lr 1e-2, grid update and budget-tier read every 16 steps;
     200 untimed and 100 timed steps; show that its four kernels launched in
     the timed steps, that the loss fell and everything stayed finite, and
     (over 32 further steps) that no step made a host sync; hold one step's
     gradients through the kernels against the same step through the plain
     versions;
  5. eval path again with the trained EMA weights: phase 3's frame pair;
  6. D-NeRF training at full width with scripts/bench_dnerf_step.py's
     config (`dnerf_phase`): the pinned NGP step, then D-NeRF on 12 views of
     128x128 of the dynamic blob scene, 32 untimed and 48 timed steps each;
     rays/s, ms/step, their ratio, the time-grid update's wall (CUDA events
     on the stream, no host sync in the timed steps), the loss
     halving, no host sync in a step, the input-gradient kernel once per
     backward, one step through the kernels against the plain versions on
     a freshly built net (whose deform net must get a nonzero gradient) and
     again after training (where a deform net that died in training is
     reported, not failed), and the EMA PSNR over the 12 views at their own
     times;
  6b. `bench_torch.py`'s `main` at its defaults but for the warm-up
     (TNGP_BENCH_WARMUP=256, cut from 1,024; 100 timed steps, the chunked
     eval and eval800 through the frame renderer): its JSON line, every
     number finite, its kernels launched;
  6c. the NGP entry point (`cli_phase`): the blob scene written as a
     blender-format PNG dataset, `tngp_torch.cli.main_nerf.main` with the
     CLI's default render flags (bound 2: 2 cascades, dt_gamma 1/128) and
     -O for 300 iterations: the loss halves, a validation PSNR, checkpoints
     rotated, the path's kernels launched; `--ckpt latest` resumes at the
     saved epoch and step with a first EMA render bitwise equal to the
     first run's last and trains on; `--test` writes PNG frames and a mesh
     with faces; then `--encoding tiledgrid --bg_radius 2` for 96
     iterations: the loss falls, a validation PSNR, scatter_add_any once
     per level of both grids in every backward; `--error_map` for 96
     iterations: the loss falls, the map moves off its ones, and a resumed
     run starts from it bit for bit; `--no_grid --bound 1` for 48
     iterations at 128 + 128 samples a ray (M = 1,048,576 a step): no grid
     update, the loss falls, a validation PSNR through the chunked
     grid-free eval, ms/step, one step through the kernels against the
     plain path, and that step's bin sort exactly, its forward and its
     table gradient held to their plain versions on its own inputs; `--gui`
     on run 1's workspace in a thread, driven with urllib: rgb, depth and a
     train request, each a PNG that the port's codec decodes to the
     dataset's size, the train request advancing the step;
  6d. D-NeRF at its defaults (`dnerf_default_phase`): `DNeRFNetwork(bound=1)`
     on the golden tiled grid (16 levels x 2^19 rows, position gradients)
     with bf16 MLPs, on phase 6's scene, time grid (16 slices, cut from the
     CLI's 64 for time) and pinned config: one step through the kernels
     against the plain versions on a freshly built net (a nonzero deform
     gradient; each level's table-gradient scatter within the reordering
     bound), the first full time-grid update's wall, 32 untimed and 48
     timed steps (ms/step and rays/s beside phase 6's), the loss halving,
     scatter_add_any once per level in every backward, no host sync in a
     step, the EMA PSNR; then the basis and hyper variants for 16 steps
     each (finite, falling loss; the kernel once per level per backward);
  6e. the D-NeRF entry point (`dnerf_cli_phase`): phase 6's dynamic scene
     written as a D-NeRF dataset (a `time` per frame), then
     `tngp_torch.cli.main_dnerf.main` with the CLI's default flags and -O
     for 96 iterations (validation every 4 epochs) with --time_size 16
     (cut from 64): the loss halves, a validation PSNR, the kernel once per
     level per backward,
     `--ckpt latest` resumes bitwise and trains on, `--test` writes frames,
     `--gui` serves PNG frames at two times that differ;
  6f. SDF at full width (`sdf_phase`): `SDFNetwork` (16 levels x 2^19
     rows, 3x64 f32 MLP) on `main_sdf sphere`'s mesh, 2^18 samples a step,
     lr 1e-4: one step through the kernels against the plain path (the loss
     and MLP gradients bitwise, each of the 16 levels' scatter_add_any on
     the step's own inputs within the reordering bound), no host sync in a
     step, 3 x 25 timed steps (cut from main_sdf's 20 x 100: ms/step,
     samples/s, the host's share building labels), the loss falling, one
     bf16 (`--fp16`) epoch, the mesh at 128^3 (cut from 512^3) with its
     median vertex radius within 0.12 of the sphere's, then `python -m
     tngp_torch.cli.main_sdf sphere` for 2 epochs of 10 steps (mesh at
     128^3) and a resumed run bitwise from its checkpoint;
  6g. TensoRF at full width (`tensorf_phase`): `TensoRFNetwork` VM at the
     CLI's defaults (resolution0 128, ranks 16 / 48, colour features 27,
     3x128 bf16 MLP) on phase 4's scene and render config, 4096 rays a
     step, density_thresh 10 (the CLI's), lr 1e-2, milestones (128, 176,
     224, 272, 320) (cut from the CLI's 2000-7000) towards resolution1 300:
     a step through the kernels
     against the plain path (each of its 12 factor gradients'
     `scatter_add_any` on the step's own inputs within the reordering
     bound), 64 timed steps at 128 (12 launches a step), the five shrinks
     and upsamples (one must crop; the last ends at the 300^3 voxel budget),
     the same check and 64 timed steps at the last resolution, the loss
     falling, the EMA PSNR over the 12 views; CP at ranks 96 / 288 for 32
     steps (6 launches a step, its check); then `main_tensorf` on the blob
     scene as a blender dataset at the CLI's defaults with
     `--upsample_model_steps 48` (appended to the five defaults: one
     upsample, to the 300^3 budget) for 96 iterations, `--ckpt latest`
     resuming across that upsample bitwise, and `--cp` for 24;
  6h. CCNeRF at full width (`ccnerf_phase`): `CCConfig` defaults
     (resolution 128, SH degree 4, five groups), 4096 rays x 128 slots of
     the slab march (max_steps 512), lr1 2e-2 / lr2 1e-3: a step through the
     kernels against the plain path (its 30 factor gradients within the
     reordering bound), 64 timed steps (30 launches a step), each of the five
     prefixes' losses on a fixed batch falling; `cc_finalize` keeping the
     frame within 1e-3, the five default `--rank_levels` compressions'
     PSNR and parameter counts, a two-object `CCScene` frame on its own
     occupancy grid; `main_ccnerf` at the CLI's defaults for 48 iterations
     (six `cc_models` files), then `--compose` (six objects, finite);
     then `tngp_torch.diagnostics.tensor_steps` in a subprocess (its own
     profiler session): the device ms a step of the same trainers (TensoRF
     VM at 128 and at its last resolution, CCNeRF), and the idle share of
     each, 1 - that / the phase's own ms/step;
  6i. the other render paths at full width (`render_paths_phase`): the
     flagship network and bench.py's render config with march_group 8 (the
     CLI's default) on phase 4's scene, one trainer per training path: the
     grouped slab march with the global budget (`march_dense=False`), without
     it (`compact_fraction=1`: 524,288 slab slots a step through the slab
     compositor) and the stream march (`march_chunk=0`); 16 untimed and 32
     timed steps each (ms/step, the loss falling, everything finite), no host
     sync in a step over 16 further steps, no tier read on the slab paths,
     one step through the kernels against the plain versions and each kernel
     it launched on that step's own inputs; then 800x800 frames of phase 5's
     trained weights with `march_chunk=0` (the stream first pass and the
     grouped slab residual rounds) and with `eval_stream=False` (the
     full-width round loop): time, rounds, host reads, each held at phase
     3's criterion to the same frame through the plain versions and to
     phase 5's frame-renderer frame, the rays a round cap left alive apart;
     then `main_nerf` with `--no_march_dense` (48 iterations and a bitwise
     `--ckpt latest` resume), `--march_chunk 0` and `--compact_fraction 1`
     (48 each): the loss falls, a finite validation PSNR;
  6j. the window encoder's f32 form, the hard scene, data parallelism and
     CLIP (`hard_dp_clip_phase`): the f32 form of the three encoder kernels
     against their plain f32 versions (phase 2's tolerances) at phase 4's
     step shape, on samples outside the cube and on a D-NeRF step's inputs;
     D-NeRF under TNGP_MXU_F32=1 for 16 steps (the f32 input gradient once
     per backward, no bf16-form launch); `python -m
     tngp_torch.scripts.train_hard`'s first 1,000 steps (cut from 30,000,
     under the 30,000 steps' lr schedule) bf16 and `--mxu_f32` (ms/step, a
     falling loss, validation PSNR above 30 dB, which a field stalled at
     the first epoch's loss fails, each run's kernels of its own form
     only), `bench_eval --frames 2` on the bf16
     checkpoint (rays/s, rounds, cut rays); `Trainer(mesh=make_mesh())` over
     NCCL at world size 1 against `Trainer()` (the first batch at phase 4's
     tolerances, 32 steps' losses within 1e-4 of the loss, no host sync in a
     step); two gloo ranks on the card
     (`tngp_torch.diagnostics.dp_ranks`, kernels already built) whose summed
     gradients match one process's over the whole batch and whose weights
     stay bitwise equal over 8 steps; `main_nerf --rand_pose 4 --clip_text
     ... --clip_model_path stub` for 48 iterations (12 finite CLIP losses)
     and one CLIP step through the kernels against the plain versions;
  7. time each kernel (one row per scatter-add form and caller), its plain
     version and the nearest single PyTorch call at the paths' shapes (the
     scatter-adds' at the frame round's, the first pass's under `shapes`;
     under the chunked loop's round update, the sorted form on the frame
     round's update with the fill n - 1): ms
     (CUDA events around 20 back-to-back calls), host_us (200 calls without
     a sync) and, last, device_ms (profiler device events, or CUDA graph
     replays where the profiler records none, as after --profile's
     profiles), beside the least time the card could take
     (`tngp_torch.diagnostics.kernel_times`); the bin sort's row is the
     whole `bin_dest` call, its device operations counted, and so is the
     march's (`march_chunked`, phase 2d's first pass; the step's under
     `shapes`); the encoder rows
     also time the small width, one tile and (forward) a training step's
     inputs under `shapes` (`kernel_times.encoder_calls` on
     `encoder_inputs`, the inputs `kernel_times.py` times); the golden
     grid's table-gradient rows count the launches at their own level's
     shape (one a step), the whole path's under `launches_all_levels`, and
     phase 3b's frame's under `launches_per_frame`; the SDF step's level 0
     and level 15 have rows of their own, and the grid-free step's bin sort,
     forward and table gradient theirs (`_grid_free`); so do the grid
     samples' factor gradients on phases 6g and 6h's captures: TensoRF VM's
     colour plane and line at the last resolution, CP's rank-288 line, and
     CCNeRF's rank-64 line with its masked slots on the two centre rows;
     and the encoder's forward and table gradient on phase 6i's
     `compact_fraction=1` step (524,288 samples, `_slab`); and the f32
     forms (`_f32`: the forward and table gradient at phase 4's step shape,
     the input gradient on a D-NeRF step's inputs, each beside its bf16
     form's time on the same inputs);
  7b. `main_nerf synthetic --profile DIR` for 2 epochs: a non-empty Chrome
     trace of the first (last, because after a profile the profiler records
     nothing more in the process);
  8. print the card's name and power limit, the kernel table as one JSON
     line, and `{"ok": true, "device": ...}` last.

`--profile` adds a profiled partial grid update (resample, H = 128), a
profiled eval frame, ten profiled training steps, a profiled golden-grid
frame (3b) and a profiled full D-NeRF time-grid update on the golden grid
(6d), with device time by kernel, the idle share and the golden grid's
share (its spans `tngp.encoder.hash_grid` / `tngp.encoder.hash_grid.backward`).

It needs a CUDA card and the rest of the repository next to it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
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
DNERF_WARM, DNERF_TIMED = 32, 48  # D-NeRF and pinned NGP: untimed, then timed
DNERF_SYNC_STEPS = 16
BENCH_WARMUP = 256  # bench_torch.py's warm-up steps (its default 1,024)
DNERF_FRAMES, DNERF_RES, DNERF_TIME_SIZE = 12, 128, 16  # bench_dnerf_step.py's scene and grid
GRID_SIZE = 128  # occupancy grid side, bench.py's render config
N_RAYS = 4096  # rays per training step and per eval chunk
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
INT32_OPS_PER_S = 16.7e12  # H100 SXM int32: 64 per clock per SM x 132 SMs x 1.98 GHz


T_START = time.time()


def log(msg: str) -> None:
    """Prints `msg` after the seconds since the script started."""
    print(f"{time.time() - T_START:7.1f} {msg}", flush=True)


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


def step_host_syncs(tr, steps: int):
    """`steps` further steps of trainer `tr` under torch's sync debug mode.
    Returns (the syncs inside each `train_step`, the syncs in all)."""
    step_syncs = []
    with host_sync_log() as caught:
        plain_step = tr.train_step

        def counted_step():
            before = n_syncs(caught)
            out = plain_step()
            step_syncs.append(n_syncs(caught) - before)
            return out

        tr.train_step = counted_step
        try:
            tr.run_steps(steps)
        finally:
            tr.train_step = plain_step
        total = n_syncs(caught)
    return step_syncs, total


def profile_device(fn, label: str, wall_off: float) -> None:
    """Run `fn` under torch.profiler; print device time by kernel, the
    idle share of `wall_off`, the same work's wall time with the profiler
    off (the profiler's host cost inflates the profiled wall), the
    cumsums' device time by input shape, and the device time inside the
    golden grid's spans (`tngp.encoder.hash_grid` and
    `tngp.encoder.hash_grid.backward`, opened in `tngp_torch.ops.hashgrid`)
    with its share."""
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
    # and not the annotation spans (the optimizer's, the program's), whose
    # device-side rows cover the device timeline from their first kernel to
    # their last, gaps included
    dev_us = [(e.key, e.device_time_total, e.count) for e in prof.key_averages()
              if e.device_type == cuda_t and e.device_time_total > 0
              and not e.key.startswith(("Optimizer.", "tngp."))]
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
    # a span's host-side row sums the device time of the kernels launched
    # inside it
    for e in prof.key_averages():
        if (e.key.startswith("tngp.encoder.hash_grid") and e.device_type != cuda_t
                and e.device_time_total > 0):
            log(f"[profile]   span {e.key}: {e.device_time_total / 1e3:.3f} ms device time over "
                f"{e.count} calls, {100 * e.device_time_total / 1e6 / busy:.1f}% of the device "
                f"busy time")


@torch.no_grad()
def check_scatter_add(idx, vals, rows, indices, what, form=None):
    """A scatter-add form against its plain version on indices that hold its
    statement.  "unique": exact.  "sorted" and "any": each entry within
    (n - 1) 2^-24 sum|v| of the exact (f64) sum, n = its nonzero terms (any
    order of n f32 terms is; adding a zero rounds nothing, and counting the
    zeros would loosen the bound on CCNeRF's rows of masked-slot zeros),
    and so within twice that of the plain
    version, `index_add_` in the atomics' order (the two errors can take
    opposite signs, so from n = 3 on two orders can differ by more than the
    n 2^-24 sum|v| that earlier checks stated); "sorted" and the any form's
    deterministic design ("owner") also bitwise the same on a second call.
    `form` forces a design of the any form (`scatter_add_any_as`); None
    takes the one `any_form` picks.
    Returns (max |err| vs plain, worst err / bound vs exact)."""
    from tngp_torch.kernels import scatter as ks

    def call():
        if form is not None:
            return ks.scatter_add_any_as(idx, vals, rows, form)
        return ks.scatter_add(idx, vals, rows, indices=indices)

    got = call()
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
    n = f64_sum((vals != 0).double())
    dev_exact = (got.double() - exact).abs()
    tol = (n - 1).clamp(min=0) * 2.0**-24 * sabs
    if not bool((dev_exact <= tol).all()):
        raise SystemExit(f"scatter_add_{indices} ({what}) beyond (n-1) 2^-24 sum|v| of the "
                         f"exact sum: {float(dev_exact.max())}")
    if not bool(((got.double() - plain.double()).abs() <= 2.0 * tol + 1e-30).all()):
        raise SystemExit(f"scatter_add_{indices} ({what}) beyond 2 (n-1) 2^-24 sum|v| of "
                         f"plain: {err}")
    design = form or (ks.any_form(*vals.shape, rows).form if indices == "any" else None)
    if (indices == "sorted" or design == "owner") and not torch.equal(got, call()):
        raise SystemExit(f"scatter_add_{indices} ({what}, {design or indices}) differs between "
                         f"two calls")
    if indices == "any" and bool(((got == 0) & torch.signbit(got)).any()):
        raise SystemExit(f"scatter_add_{indices} ({what}, {design or indices}) holds a -0.0, "
                         f"which an add into +0.0 never gives")
    return err, float((dev_exact / tol.clamp(min=1e-300)).max())


ANY_DESIGNS_RUN: dict = {}  # path -> the any form's launches by design in its timed run


def note_any_designs(path: str) -> None:
    """Keep the any form's launches by design since the last reset under
    `path` (phase 7's rows list them)."""
    from tngp_torch import kernels

    ANY_DESIGNS_RUN[path] = dict(kernels.KERNELS["scatter_add_any"].forms)


def calls_summary(per: dict, took: dict) -> str:
    """`check_any_calls`' designs: the calls each took, and the worst
    err/bound of the designs held on one call beside them."""
    return ("dispatched " + ", ".join(f"{f} {n}" for f, n in took.items())
            + "; on one call each: "
            + (", ".join(f"{f} worst {w:.3f}" for f, (_, w) in per.items()) or "none"))


def designs_summary(checks_all) -> str:
    """Each design's worst err/bound over `check_any_forms` results and the
    calls it took."""
    worst: dict = {}
    for _, per in checks_all:
        for f, (_, w) in per.items():
            n, w0 = worst.get(f, (0, 0.0))
            worst[f] = (n + 1, max(w0, w))
    return ", ".join(f"{f} on {n} worst {w:.3f}" for f, (n, w) in worst.items())


@torch.no_grad()
def check_any_forms(idx, vals, rows, what) -> tuple:
    """`check_scatter_add` of the any form as dispatched and of every design
    that can take the shape.  Returns the dispatch's (max |err| vs plain,
    worst err / bound) and {design: the same}."""
    from tngp_torch.kernels import scatter as ks

    per = {f: check_scatter_add(idx, vals, rows, "any", f"{what}, {f}", form=f)
           for f in ks.any_designs(*vals.shape, rows)}
    return check_scatter_add(idx, vals, rows, "any", what), per


@torch.no_grad()
def check_any_calls(calls, what) -> tuple:
    """`check_scatter_add` of the any form as dispatched on each of a step's
    captured calls [(idx, vals, rows)], and of each design that no call
    dispatched to on the first call that can take it (every design is held
    at every shape in the kernel phase).  Returns the calls' (max |err| vs
    plain, worst err / bound), {design: the same} of those extra checks,
    and {design: calls dispatched to it}."""
    from tngp_torch.kernels import scatter as ks

    checks = [check_scatter_add(i, v, r, "any", f"{what} {k}")
              for k, (i, v, r) in enumerate(calls)]
    took: dict = {}
    for _, v, r in calls:
        f = ks.any_form(*v.shape, r).form
        took[f] = took.get(f, 0) + 1
    per = {}
    for f in ks.ANY_FORMS:
        if f in took:
            continue
        k = next((k for k, (_, v, r) in enumerate(calls) if f in ks.any_designs(*v.shape, r)),
                 None)
        if k is not None:
            i, v, r = calls[k]
            per[f] = check_scatter_add(i, v, r, "any", f"{what} {k}, {f}", form=f)
    return checks, per, took


@torch.no_grad()
def check_any_exact(idx, vals, rows, what) -> list:
    """Every design of the any form, and the dispatch, bitwise equal to the
    plain version on integer-valued vals whose every partial sum stays
    below 2^24, so that any order of the adds is exact: a design that drops
    or repeats an add on a contended row fails here whatever the reordering
    bound allows.  No -0.0 in the output.  Returns the designs held."""
    from tngp_torch.kernels import scatter as ks

    plain = ks.scatter_add_plain(idx, vals, rows)
    designs = ks.any_designs(*vals.shape, rows)
    for f in [*designs, None]:
        got = (ks.scatter_add(idx, vals, rows, indices="any") if f is None
               else ks.scatter_add_any_as(idx, vals, rows, f))
        name = f or f"dispatch ({ks.any_form(*vals.shape, rows).form})"
        if not torch.equal(got, plain):
            bad = got != plain
            raise SystemExit(f"scatter_add_any ({what}, {name}) not exact on integer values: "
                             f"{int(bad.sum())} entries differ, max |err| {max_abs(got, plain)}")
        if bool(((got == 0) & torch.signbit(got)).any()):
            raise SystemExit(f"scatter_add_any ({what}, {name}) holds a -0.0")
    return designs


@torch.no_grad()
def check_dx(xyz4, wob, table, g_sorted, spec, block, what, mxu_f32=False):
    """The input-gradient kernel against its plain version.  Both form, per
    sample and dimension, the same L*C f32 products g * d (d bit for bit: the
    same bf16 roundings of derivative weights and table values, the 8
    corners summed in order); the kernel adds them in (level, channel)
    order within a group of levels and the groups in order, the plain
    version in torch's.  Any order of n terms is within (n - 1) 2^-24
    sum|term| of the exact sum, so the two are within 2 (L*C) 2^-24
    sum|g * d| of each other.  Padding slots must be exactly 0 and a second
    call must give the same bits.  With `mxu_f32` the f32 forms: the same
    products without the bf16 roundings.  Returns (max |err|, worst err /
    bound)."""
    from tngp_torch.kernels import window_encoder as kw

    f32 = dict(mxu_f32=mxu_f32)
    got = kw.window_encode_dx(xyz4, wob, table, g_sorted, spec, block, **f32)
    plain = kw.window_encode_dx_plain(xyz4, wob, table, g_sorted, spec, block, **f32)
    d = kw.dx_features(xyz4, wob, table, spec, block, **f32)
    tol = 2 * spec.output_dim * 2.0**-24 * (g_sorted.T[None].abs() * d.abs()).sum(1).double()
    err = (got.double() - plain.double()).abs()
    if not bool((err <= tol).all()):
        raise SystemExit(f"window_encode_dx ({what}) beyond the reordering bound: "
                         f"{float(err.max())}")
    if not bool((got[:, xyz4[:, 3] == 0] == 0).all()):
        raise SystemExit(f"window_encode_dx ({what}): a padding slot is not zero")
    if not torch.equal(got, kw.window_encode_dx(xyz4, wob, table, g_sorted, spec, block, **f32)):
        raise SystemExit(f"window_encode_dx ({what}) differs between two calls")
    return float(err.max()), float((err / tol.clamp(min=1e-30)).max())


@contextlib.contextmanager
def capturing(module, name: str, store: list):
    """Inside this scope `module.<name>` appends each call's positional
    arguments to `store` and calls through."""
    real = getattr(module, name)

    def wrapper(*a, **k):
        store.append(a)
        return real(*a, **k)

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, real)


def step_kernels_vs_plain(tr, model, label: str, capture) -> dict:
    """One batch of trainer `tr` through the loss and its backward,
    through the kernels (inside the scope `capture`) and again through the
    plain versions.  Fails on a non-finite gradient entry, a loss beyond
    1e-5 relative or a gradient beyond 3e-2 norm-relative (the NGP step's
    tolerances: the kernels' f32 summation order flips single bf16
    roundings in the MLPs).  Returns the losses, the gradient errors, the
    deform net's largest |grad| through the kernels (`deform_max`, None for
    a model without one: the caller decides what a zero means) and a line
    about the batch."""
    from tngp_torch import kernels

    batch = tr.sample_batch()

    def grads():
        tr.optimizer.zero_grad(set_to_none=True)
        loss, npts, _ = tr.loss_on_batch(batch)
        loss.backward()
        return float(loss.detach()), [p.grad.clone() for p in tr.params], int(npts)

    with capture:
        loss_k, grads_k, npts = grads()
    with kernels.plain_versions():
        loss_p, grads_p, _ = grads()
    tr.optimizer.zero_grad(set_to_none=True)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    rels = {n: rel_err(a, b) for n, a, b in zip(names, grads_k, grads_p)}
    deform = [g.abs().max() for n, g in zip(names, grads_k) if n.startswith("deform_net")]
    deform_max = float(torch.stack(deform).max()) if deform else None  # NaN propagates
    nonfinite = {n: int((~torch.isfinite(g)).sum()) for n, g in zip(names, grads_k)
                 if not bool(torch.isfinite(g).all())}
    at = "" if "time" not in batch else f"time {float(batch['time']):.3f}, "
    about = (f"the batch: {at}{npts} samples, loss {loss_k}, "
             f"deform-net max |grad| {deform_max}")
    if nonfinite or deform_max != deform_max:
        raise SystemExit(f"{label}: non-finite gradient entries {nonfinite}; " + about)
    if not abs(loss_k - loss_p) <= 1e-5 * abs(loss_p):
        raise SystemExit(f"{label}, kernels vs plain: loss {loss_k} vs {loss_p}; " + about)
    if not max(rels.values()) <= 3e-2:
        raise SystemExit(f"{label}, kernels vs plain: gradient errors {rels}; " + about)
    return dict(loss_k=loss_k, loss_p=loss_p, rels=rels, deform_max=deform_max)


def dnerf_step_check(tr, model, what: str) -> dict:
    """`step_kernels_vs_plain` on the window encoder, and the input-gradient
    kernel on that step's own inputs (`check_dx`), which fails beyond its
    reordering bound.  Returns the deform net's largest |grad| through the
    kernels (`deform_max`), the errors and the input gradient's inputs
    (`dx_args`)."""
    from tngp_torch.kernels import window_encoder as kw

    calls = []
    st = step_kernels_vs_plain(tr, model, f"D-NeRF step ({what} net)",
                               capturing(kw, "window_encode_dx", calls))
    dx_args = tuple(a.detach() for a in calls[-1][:4])
    err_dx, worst_dx = check_dx(*dx_args, model.encoder.spec, model.encoder.block,
                                f"a D-NeRF step's inputs, {what} net")
    log(f"[dnerf] one step on the {what} net, kernels vs plain path: loss {st['loss_k']:.8f} vs "
        f"{st['loss_p']:.8f}; gradient norm-relative errors "
        + ", ".join(f"{n} {v:.2e}" for n, v in st["rels"].items())
        + f" (<= 3e-2); deform-net max |grad| {st['deform_max']:.3e}; window_encode_dx on this "
        f"step's inputs (M_pad = {dx_args[0].shape[0]}) max|err| {err_dx:.3g}, worst "
        f"err/bound {worst_dx:.3f}, bitwise the same on a second call")
    return dict(deform_max=st["deform_max"], rels=st["rels"], err_dx=err_dx, worst_dx=worst_dx,
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
    pinned = TrainConfig(num_rays=N_RAYS, iters=100_000, adaptive_budget=False, seed=seed,
                         use_checkpoint="scratch")

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

    ngp_p = Trainer(NGPNetwork(encoding="hashgrid_window",
                               bound=1.0, compute_dtype=torch.bfloat16, device=dev, seed=seed),
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

    step_syncs, _ = step_host_syncs(dtr, DNERF_SYNC_STEPS)
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
                fresh=fresh_check, trained=trained, dds=dds, cfg=cfg_p, tc=pinned)


def hash_any_inputs(dev, gen) -> dict:
    """The golden grid's table gradient at the shapes its backward hands
    `scatter_add(..., indices="any")`: label -> (idx, vals, rows) of one
    level, vals = corner weight x an N(0, 1) cotangent, C = 2.  A D-NeRF
    training step's 131,072 samples through level 0 of the default tiled
    spec (dense: 8 corners into 4,920 rows, ~213 adds a row) and through
    level 15 (wrapped into 2^19 rows); the hyper variant's 5-D grid at
    level 8 (32 corners into 2^19 rows); levels 0-3 of the background grid
    (4 corners x 4,096 rays into 296, 6,728, 166,464 and 2^19 rows)."""
    from tngp_torch.ops import hashgrid as hg

    d3 = hg.HashGridSpec.create(desired_resolution=2048, gridtype="tiled")
    d5 = hg.HashGridSpec.create(input_dim=5, desired_resolution=2048, gridtype="tiled")
    bg = hg.HashGridSpec.create(input_dim=2, num_levels=4, desired_resolution=2048)
    out = {}
    for label, spec, level, m in (("level0_dense", d3, 0, 131_072),
                                  ("level15_wrapped", d3, 15, 131_072),
                                  ("hyper5d_level8", d5, 8, 131_072),
                                  *((f"bg_level{lv}", bg, lv, N_RAYS) for lv in range(4))):
        x = torch.rand((spec.input_dim, m), generator=gen).to(dev)
        idx, w, _, _ = hg._level_geometry(spec, level, x)
        g = torch.randn((m, spec.level_dim), generator=gen).to(dev)
        vals = (w[:, :, None] * g[None]).reshape(-1, spec.level_dim).contiguous()
        out[label] = (idx.reshape(-1), vals, spec.offsets[level + 1] - spec.offsets[level])
    return out


@torch.no_grad()
def any_edge_checks(dev, gen) -> tuple:
    """Every design of the any form (`check_any_forms`) on the cases its
    kernels must get right beside the paths' shapes: outputs just under
    and just over one block's shared memory (C = 2, 1,048,576 adds), a
    [1,048,576, 64] -> [128, 64] line with a row of 219,096 adds (CCNeRF's
    centre row, here nonzero) and a fifth of its vals rows all zero (half
    of those -0.0), negative and out-of-range indices (to +-2^40), n = 0,
    C = 1 and 3, and vals that are not 16-byte aligned.  Then every design
    bitwise equal to the plain version (`check_any_exact`) on the hot row
    and zero rows with integer values in [-4, 4]: the line's [128, 64] and
    level 0's [4,920, 2] with runs of consecutive entries on one row, as a
    ray's samples share a cell.  Returns label -> (the dispatch's (max
    |err|, worst err/bound), the designs' results), and label -> the
    designs held exactly."""
    from tngp_torch.kernels import scatter as ks

    def rand(n, C, rows):
        return torch.randint(0, rows, (n,), generator=gen), torch.randn((n, C), generator=gen)

    cases = {}
    fit = ks.SMEM_BUDGET // 8  # rows of C = 2 that just fit
    for label, rows in (("budget_under", fit), ("budget_over", fit + 1)):
        cases[label] = (*rand(1_048_576, 2, rows), rows)
    n = 1_048_576
    idx, vals = rand(n, 64, 128)
    idx[torch.randperm(n, generator=gen)[:219_096]] = 63
    zero = torch.randperm(n, generator=gen)[:n // 5]
    vals[zero] = 0.0
    vals[zero[::2]] = -0.0
    cases["hot_row_and_zero_rows"] = (idx, vals, 128)
    idx, vals = rand(300_000, 16, 500)
    idx[::7], idx[3::11], idx[5::13], idx[6::17] = -1, -(2**40), 500, 2**40
    cases["out_of_range"] = (idx, vals, 500)
    cases["n0"] = (torch.zeros(0, dtype=torch.int64), torch.zeros((0, 8)), 300)
    for C in (1, 3):
        cases[f"C{C}"] = (*rand(400_000, C, 2000), 2000)
    out = {}
    for label, (i, v, r) in cases.items():
        out[label] = check_any_forms(i.to(dev), v.to(dev), r, f"edge case {label}")
    flat = torch.randn(300_001 * 4 + 1, generator=gen).to(dev)
    unaligned = flat[1:].view(300_001, 4)  # 4 bytes past a 16-byte boundary
    out["unaligned_C4"] = check_any_forms(
        torch.randint(0, 1000, (300_001,), generator=gen).to(dev), unaligned, 1000,
        "edge case unaligned_C4")
    exact = {}
    for label, C, rows in (("exact_hot_row_C64", 64, 128), ("exact_hot_row_runs_C2", 2, 4920)):
        if C == 2:  # runs of 1-29 entries on one row
            idx = torch.repeat_interleave(torch.randint(0, rows, (n // 4,), generator=gen),
                                          torch.randint(1, 30, (n // 4,), generator=gen))[:n]
        else:
            idx = torch.randint(0, rows, (n,), generator=gen)
        idx[torch.randperm(n, generator=gen)[:219_096]] = 63
        vals = torch.randint(-4, 5, (n, C), generator=gen).float()
        zero = torch.randperm(n, generator=gen)[:n // 5]
        vals[zero] = 0.0
        vals[zero[::2]] = -0.0
        exact[label] = check_any_exact(idx.to(dev), vals.to(dev), rows, f"edge case {label}")
    return out, exact


def hash_step_check(tr, model, what: str) -> dict:
    """`step_kernels_vs_plain` on the golden grid, and each level's
    table-gradient scatter (`scatter_add_any`) on that step's own inputs
    within the reordering bound (`check_scatter_add`).  Returns the deform
    net's largest |grad| (`deform_max`, None for the variants), the
    gradient errors and the worst err/bound over the levels."""
    from tngp_torch.ops import hashgrid as hg

    calls = []
    st = step_kernels_vs_plain(tr, model, f"golden-grid step ({what})",
                               capturing(hg, "scatter_add", calls))
    levels = model.encoder.spec.num_levels
    if len(calls) != levels:
        raise SystemExit(f"golden-grid step ({what}): {len(calls)} table-gradient scatters, "
                         f"not one per level ({levels})")
    checks, per, took = check_any_calls([(i.detach(), v.detach(), r) for i, v, r, *_ in calls],
                                        f"{what}, level")
    worst = max(w for _, w in checks)
    log(f"[dnerf-default] one step on the {what} net, kernels vs plain path: loss "
        f"{st['loss_k']:.8f} vs {st['loss_p']:.8f}; gradient norm-relative errors "
        + ", ".join(f"{n} {v:.2e}" for n, v in st["rels"].items())
        + f" (<= 3e-2); deform-net max |grad| {st['deform_max']}; the {levels} levels' "
        f"scatter_add_any on this step's inputs ({calls[0][0].numel():,} entries a level): "
        f"max|err| vs plain {max(e for e, _ in checks):.3g}, worst err/bound {worst:.3f}; "
        f"designs {calls_summary(per, took)}")
    return dict(deform_max=st["deform_max"], rels=st["rels"], worst_any=worst)


VARIANT_STEPS = 16  # the basis and hyper variants' steps in phase 6d


def dnerf_default_phase(dev, dn: dict, seed: int, profile: bool) -> dict:
    """D-NeRF at its defaults (the golden tiled grid of 16 levels x 2^19
    rows with position gradients, bf16 MLPs) at full width under phase 6's
    pinned config, scene and time grid: one step through the kernels
    against the plain versions on a freshly built net (`hash_step_check`,
    fatal unless the deform net gets a gradient), the first full time-grid
    update's wall, DNERF_WARM untimed and DNERF_TIMED timed steps (ms/step
    and rays/s beside phase 6's window-encoder D-NeRF), the loss halving,
    scatter_add_any once per level in every backward, no host sync in a
    step, the EMA PSNR; then the basis and hyper variants for VARIANT_STEPS
    steps each, their loss finite and falling, the kernel once per level in
    every backward.  `profile`: one full time-grid update under the
    profiler with the golden grid's share."""
    from tngp_torch import kernels
    from tngp_torch.models import DNeRFBasisNetwork, DNeRFHyperNetwork, DNeRFNetwork
    from tngp_torch.train import DNeRFTrainer

    dds, cfg_p, pinned = dn["dds"], dn["cfg"], dn["tc"]
    t_phase = time.time()

    def trainer(cls):
        model = cls(bound=1.0, compute_dtype=torch.bfloat16, device=dev, seed=seed)
        return model, DNeRFTrainer(model, dds, cfg_p, pinned, time_size=DNERF_TIME_SIZE,
                                   update_interval=16, device=dev)

    fresh_model, fresh = trainer(DNeRFNetwork)
    spec = fresh_model.encoder.spec
    if (type(fresh_model.encoder).__name__, spec.gridtype, spec.total_params) != (
            "GridEncoder", "tiled", 6_119_864):
        raise SystemExit(f"DNeRFNetwork's default encoder is not the tiled grid: {spec}")
    torch.cuda.synchronize()
    t0 = time.time()
    fresh.update_grid()
    torch.cuda.synchronize()
    dt_update = time.time() - t0
    log(f"[dnerf-default] first full time-grid update ({DNERF_TIME_SIZE} slices x "
        f"{GRID_SIZE}^3 cells through the golden grid): {dt_update:.3f} s")
    if profile:
        torch.cuda.synchronize()
        t0 = time.time()
        fresh.update_grid()
        torch.cuda.synchronize()
        profile_device(fresh.update_grid, "one full D-NeRF time-grid update, golden tiled grid",
                       time.time() - t0)
    fresh_check = hash_step_check(fresh, fresh_model, "fresh")
    if not fresh_check["deform_max"] > 0:
        raise SystemExit(f"golden-grid D-NeRF step on the fresh net: the deform net's largest "
                         f"|grad| is {fresh_check['deform_max']} (must be > 0)")
    del fresh, fresh_model

    def run(tr, label, warm, timed):
        """`warm` untimed and `timed` timed steps; returns (losses, wall of
        the timed steps, launches in them)."""
        torch.cuda.synchronize()
        t0 = time.time()
        lw = tr.run_steps(warm)[0] if warm else torch.zeros(0, device=dev)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t1 = time.time()
        lt, pts, kept = tr.run_steps(timed)
        torch.cuda.synchronize()
        dt = time.time() - t1
        counts = {name: k.launches for name, k in kernels.KERNELS.items()}
        note_any_designs({"DNeRFNetwork": "dnerf tiledgrid", "DNeRFBasisNetwork": "dnerf basis",
                          "DNeRFHyperNetwork": "dnerf hyper"}[type(tr.model).__name__])
        levels = tr.model.encoder.spec.num_levels
        log(f"[dnerf-default] {label}: {warm} untimed steps {t1 - t0:.2f} s, {timed} timed "
            f"steps {dt:.3f} s, {1e3 * dt / timed:.2f} ms/step, {timed * N_RAYS / dt:,.1f} train "
            f"rays/s; demand {float(pts.float().mean()):,.0f} rungs/step, "
            f"{float(kept.mean()):,.0f} of {N_RAYS} rays kept; launches {counts}")
        if counts["scatter_add_any"] != levels * timed:
            raise SystemExit(f"{label}: scatter_add_any launched {counts['scatter_add_any']} "
                             f"times, not once per level ({levels}) in each of {timed} backwards")
        return torch.cat([lw, lt]), dt, counts

    model, tr = trainer(DNeRFNetwork)
    losses, dt, launches = run(tr, "DNeRFNetwork (tiledgrid)", DNERF_WARM, DNERF_TIMED)
    first16, last16 = float(losses[:16].mean()), float(losses[-16:].mean())
    log(f"[dnerf-default] loss first 16 steps {first16:.6f}, last 16 {last16:.6f}; window-encoder "
        f"D-NeRF (phase 6) {1e3 * dn['dt_dnerf'] / DNERF_TIMED:.2f} ms/step, "
        f"{dn['rays_s']:,.1f} rays/s")
    if not (np.isfinite(first16) and last16 < 0.5 * first16):
        raise SystemExit(f"golden-grid D-NeRF: the loss did not fall below half: {first16} -> "
                         f"{last16}")
    step_syncs, _ = step_host_syncs(tr, DNERF_SYNC_STEPS)
    log(f"[dnerf-default] host syncs over {DNERF_SYNC_STEPS} further steps: inside train_step "
        f"{sum(step_syncs)} ({max(step_syncs)} max per step)")
    if sum(step_syncs) != 0:
        raise SystemExit(f"golden-grid D-NeRF train_step made host syncs: {step_syncs}")
    if not all(bool(torch.isfinite(p).all()) for p in tr.params + tr.ema_params):
        raise SystemExit("golden-grid D-NeRF: a parameter is not finite after training")
    t0 = time.time()
    psnr = tr.evaluate(dds)
    log(f"[dnerf-default] PSNR with the EMA weights over the {DNERF_FRAMES} views at their own "
        f"times after {tr.global_step} steps: {psnr:.2f} dB ({time.time() - t0:.2f} s)")
    if not np.isfinite(psnr):
        raise SystemExit("golden-grid D-NeRF: the evaluation PSNR is not finite")
    levels = model.encoder.spec.num_levels
    del model, tr

    variants = {}
    for cls in (DNeRFBasisNetwork, DNeRFHyperNetwork):
        vmodel, vtr = trainer(cls)
        vl, vdt, vcounts = run(vtr, f"{cls.__name__} ({vmodel.encoder.spec.input_dim}-D tiledgrid)",
                               0, VARIANT_STEPS)
        a, b = float(vl[:8].mean()), float(vl[-8:].mean())
        log(f"[dnerf-default] {cls.__name__}: loss first 8 steps {a:.6f}, last 8 {b:.6f}")
        if not (np.isfinite(vl.cpu().numpy()).all() and b < a):
            raise SystemExit(f"{cls.__name__}: the loss is not finite and falling: {a} -> {b}")
        variants[cls.__name__] = dict(dt=vdt, launches=vcounts, loss=(a, b),
                                      levels=vmodel.encoder.spec.num_levels)
        del vmodel, vtr
    wall = time.time() - t_phase
    log(f"[dnerf-default] phase 6d wall {wall:.1f} s")
    return dict(dt=dt, rays_s=DNERF_TIMED * N_RAYS / dt, launches=launches, psnr=psnr,
                levels=levels, fresh=fresh_check, variants=variants, dt_update=dt_update, wall=wall)


def resumed_run(label: str, run, render, img_last, end1, more_steps: int) -> None:
    """`run()`, a CLI run with --ckpt latest, must resume at `end1` (epoch,
    step) with a first EMA render (`render(trainer)`, taken as
    `Trainer.train` begins) bitwise equal to `img_last`, the previous run's
    last, and train `more_steps` steps on."""
    from tngp_torch.train import Trainer

    seen = {}
    real_train = Trainer.train

    def train_seen(self, max_epochs):
        seen["at"] = (self.epoch, self.global_step)
        seen["img"] = render(self)
        return real_train(self, max_epochs)

    Trainer.train = train_seen
    try:
        tr = run()
    finally:
        Trainer.train = real_train
    same = bool(np.array_equal(seen["img"], img_last))
    log(f"{label} run 2 (--ckpt latest): resumed at epoch {seen['at'][0]}, step "
        f"{seen['at'][1]} (run 1 ended at {end1}); its first EMA render bitwise equal to run "
        f"1's last: {same}; trained on to epoch {tr.epoch}, step {tr.global_step}")
    if seen["at"] != end1 or not same:
        raise SystemExit(f"{label} the resumed run did not start where run 1 ended")
    if tr.global_step != end1[1] + more_steps:
        raise SystemExit(f"{label} the resumed run did not train on: {tr.global_step}")


DNERF_CLI_ITERS = 96  # the D-NeRF CLI phase's first run: 8 epochs of the 12 views


def dnerf_cli_phase(dev, dds, seed: int) -> dict:
    """The D-NeRF entry point at its defaults: the dynamic blob scene `dds`
    written as a D-NeRF dataset (blender-format PNGs, a `time` per frame;
    val and test: 4 held views at their own times), then
    `tngp_torch.cli.main_dnerf.main` with the CLI's default flags (bound 2:
    2 cascades; dt_gamma 1/128; the default tiled-grid model; the time grid
    updated every 100 steps) and -O for DNERF_CLI_ITERS iterations with
    --time_size DNERF_TIME_SIZE.  Checks that the loss halves, a validation
    PSNR, scatter_add_any once per level in every backward, that --ckpt
    latest resumes at the saved epoch and step with a first EMA render
    bitwise equal to the first run's last and trains on, that --test
    writes the training poses' PNG frames, and that `--gui` serves PNG
    frames at two times that differ."""
    import shutil
    import tempfile

    from tngp_torch import kernels
    from tngp_torch.cli import main_dnerf
    from tngp_torch.data import make_time_blob_field, orbit_poses, render_gt_images

    t_phase = time.time()
    root = tempfile.mkdtemp(prefix="tngp_dnerf_cli_")
    try:
        H = W = dds.H
        held = orbit_poses(4, radius=2.35, elevation=0.3)
        held_t = np.array([0.1, 0.4, 0.6, 0.9], np.float32)
        held_imgs = np.stack([
            render_gt_images(make_time_blob_field(float(t), 0, device=dev), pose[None],
                             dds.intrinsics, H, W, 1.0, 256, device=dev)[0]
            for pose, t in zip(held, held_t)])
        write_blender_dataset(root, {"train": (dds.poses, dds.images, dds.times),
                                     "val": (held, held_imgs, held_t),
                                     "test": (held, held_imgs, held_t)},
                              W, float(dds.intrinsics[0]))
        ws = os.path.join(root, "ws")
        argv = [root, "-O", "--workspace", ws, "--seed", str(seed), "--eval_interval", "4",
                "--time_size", str(DNERF_TIME_SIZE)]
        log(f"[dnerf-cli] D-NeRF-format dynamic blob scene ({dds.num_frames} train views at "
            f"times 0..1, 4 val and test views at times {held_t.tolist()}, {H}x{W} PNGs) -> "
            f"python -m tngp_torch.cli.main_dnerf {' '.join(argv[1:])} --iters {DNERF_CLI_ITERS}")
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        tr1 = main_dnerf.main(argv + ["--iters", str(DNERF_CLI_ITERS)])
        torch.cuda.synchronize()
        dt1 = time.time() - t0
        launches = {name: k.launches for name, k in kernels.KERNELS.items()}
        losses, results = tr1.stats["loss"], tr1.stats["results"]
        psnr = tr1.evaluate(tr1.valid_dataset)
        levels = tr1.model.encoder.spec.num_levels
        log(f"[dnerf-cli] run 1: {tr1.global_step} steps over {tr1.epoch} epochs in {dt1:.1f} s "
            f"(validation and checkpoints included); epoch loss {losses[0]:.6f} -> "
            f"{losses[-1]:.6f}; validation PSNR {', '.join(f'{r:.2f}' for r in results)} dB, "
            f"at the end {psnr:.2f} dB; time grid {tuple(tr1.grid.density_grid.shape)}, "
            f"{tr1._grid_updates} updates; launches {launches}")
        if (tr1.cfg.cascades, tr1.cfg.bound, tr1.time_size) != (2, 2.0, DNERF_TIME_SIZE):
            raise SystemExit(f"[dnerf-cli] not the CLI's default config: {tr1.cfg}")
        if not (np.isfinite(losses[0]) and losses[-1] < 0.5 * losses[0]):
            raise SystemExit(f"[dnerf-cli] the loss did not fall below half: {losses[0]} -> "
                             f"{losses[-1]}")
        if not (results and all(np.isfinite(results)) and np.isfinite(psnr)):
            raise SystemExit(f"[dnerf-cli] no finite validation PSNR: {results}, {psnr}")
        if launches["scatter_add_any"] != levels * tr1.global_step:
            raise SystemExit(f"[dnerf-cli] scatter_add_any launched {launches['scatter_add_any']} "
                             f"times, not {levels} per step over {tr1.global_step} steps")
        t_val = float(held_t[0])
        img_last, _ = tr1.render_image(held[0], time=t_val)
        end1 = (tr1.epoch, tr1.global_step)
        del tr1

        resumed_run("[dnerf-cli]", lambda: main_dnerf.main(
            argv + ["--iters", str(DNERF_CLI_ITERS + 2 * dds.num_frames), "--ckpt", "latest"]),
            lambda tr: tr.render_image(held[0], time=t_val)[0], img_last, end1,
            2 * dds.num_frames)

        main_dnerf.main(argv + ["--test"])
        frames = sorted(f for f in os.listdir(os.path.join(ws, "results")) if f.endswith(".png"))
        log(f"[dnerf-cli] --test: {len(frames)} PNG frames of the training poses")
        if len(frames) != dds.num_frames:
            raise SystemExit(f"[dnerf-cli] --test wrote {len(frames)} frames")

        # the viewer's time field: two times of one pose give two frames
        replies, _ = viewer_drive("[dnerf-cli] --gui", main_dnerf.main, argv, [
            {"theta": 1.2, "phi": 0.9, "radius": 2.4, "mode": "rgb", "time": t,
             "dynres": False} for t in (0.1, 0.9)])
        if not (all(st["has_time"] for _, st, _ in replies)
                and all(img.shape == (H, W, 3) for img, _, _ in replies)
                and not np.array_equal(replies[0][0], replies[1][0])):
            raise SystemExit("[dnerf-cli] --gui: no time axis, or the time did not move the frame")
        wall = time.time() - t_phase
        log(f"[dnerf-cli] phase 6e wall {wall:.1f} s")
        return dict(dt=dt1, psnr=psnr, launches=launches, wall=wall)
    finally:
        shutil.rmtree(root, ignore_errors=True)


CLI_SCALE = 0.33  # the CLI's default --scale


def write_blender_dataset(root: str, splits: dict, W: int, focal: float) -> float:
    """Write `splits` (name -> (poses, images, times or None)) under `root`
    as a blender-format dataset of PNGs (`utils/image_io.py`) whose
    transform_matrixes give back the poses through `nerf_matrix_to_ngp` at
    the CLI's --scale, each frame with its `time` where times are given (a
    D-NeRF dataset).  Returns the largest pose error after the round trip;
    fails beyond 1e-6."""
    from tngp_torch.data import nerf_matrix_to_ngp
    from tngp_torch.utils.image_io import write_png

    scale = CLI_SCALE

    def ngp_to_nerf(p):
        """The inverse of `nerf_matrix_to_ngp` at `scale`, zero offset."""
        m = np.eye(4)
        m[1, :3], m[1, 3] = [p[0, 0], -p[0, 1], -p[0, 2]], p[0, 3] / scale
        m[2, :3], m[2, 3] = [p[1, 0], -p[1, 1], -p[1, 2]], p[1, 3] / scale
        m[0, :3], m[0, 3] = [p[2, 0], -p[2, 1], -p[2, 2]], p[2, 3] / scale
        return m

    worst = 0.0
    for split, (poses, imgs, times) in splits.items():
        os.makedirs(os.path.join(root, split))
        frames = []
        for i, (pose, img) in enumerate(zip(poses, imgs)):
            write_png(os.path.join(root, split, f"r_{i}.png"),
                      np.clip(np.rint(np.asarray(img) * 255), 0, 255).astype(np.uint8))
            m = ngp_to_nerf(np.asarray(pose, np.float64))
            worst = max(worst, float(np.abs(nerf_matrix_to_ngp(m, scale) - pose).max()))
            frame = {"file_path": f"./{split}/r_{i}", "transform_matrix": m.tolist()}
            if times is not None:
                frame["time"] = float(times[i])
            frames.append(frame)
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 2 * float(np.arctan(W / (2 * focal))),
                       "frames": frames}, f)
    if not worst <= 1e-6:
        raise SystemExit(f"[cli] the written transform_matrixes miss the scene's poses by "
                         f"{worst}")
    return worst


CLI_ITERS = 300  # the CLI phase's first run: 25 epochs of the 12 views (--test's mesh needs them)
CLI_TILED_ITERS = 96  # its golden-grid run: 8 epochs


def cli_tiledgrid_run(root: str, seed: int) -> dict:
    """Run 4 of the CLI phase: `main_nerf --encoding tiledgrid --bg_radius 2
    -O` for CLI_TILED_ITERS iterations on the dataset at `root`, in a fresh
    workspace.  Checks that the loss falls, the validation PSNR is finite,
    and that every backward adds the table gradients of the 16 levels and
    of the background grid's 4 through scatter_add_any."""
    from tngp_torch import kernels
    from tngp_torch.cli import main_nerf

    ws_t = os.path.join(root, "ws_tiled")
    argv_t = [root, "-O", "--workspace", ws_t, "--seed", str(seed), "--eval_interval", "10",
              "--encoding", "tiledgrid", "--bg_radius", "2", "--iters", str(CLI_TILED_ITERS)]
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    tr4 = main_nerf.main(argv_t)
    torch.cuda.synchronize()
    dt4 = time.time() - t0
    launches_t = {name: k.launches for name, k in kernels.KERNELS.items()}
    note_any_designs("ngp tiledgrid + bg cli")
    losses_t = tr4.stats["loss"]
    psnr_t = tr4.evaluate(tr4.valid_dataset)
    log(f"[cli] run 4 (--encoding tiledgrid --bg_radius 2): {tr4.global_step} steps over "
        f"{tr4.epoch} epochs in {dt4:.1f} s (evaluation, test renders and mesh included); "
        f"epoch loss {losses_t[0]:.6f} -> {losses_t[-1]:.6f}; validation PSNR "
        f"{psnr_t:.2f} dB; launches {launches_t}")
    if not (np.isfinite(losses_t).all() and losses_t[-1] < losses_t[0]):
        raise SystemExit(f"[cli] run 4: the loss did not fall: {losses_t}")
    if not (np.isfinite(psnr_t) and type(tr4.model.encoder).__name__ == "GridEncoder"
            and tr4.model.bg_radius == 2.0):
        raise SystemExit(f"[cli] run 4: PSNR {psnr_t}, encoder "
                         f"{type(tr4.model.encoder).__name__}, bg {tr4.model.bg_radius}")
    per_step = tr4.model.encoder.spec.num_levels + tr4.model.encoder_bg.spec.num_levels
    if launches_t["scatter_add_any"] != per_step * tr4.global_step:
        raise SystemExit(f"[cli] run 4: scatter_add_any launched "
                         f"{launches_t['scatter_add_any']} times, not {per_step} per step "
                         f"over {tr4.global_step} steps")
    return dict(dt_tiled=dt4, psnr_tiled=psnr_t, launches_tiled=launches_t,
                levels_tiled=per_step, steps_tiled=tr4.global_step)


CLI_EM_ITERS = 96  # the CLI phase's --error_map run: 8 epochs of the 12 views
CLI_NOGRID_ITERS = 48  # its --no_grid run: 4 epochs
CLI_OPTION_FLAGS = ["--eval_interval", "100", "--skip_test_render", "--mesh_resolution", "64"]


def cli_error_map_run(root: str, seed: int) -> dict:
    """`main_nerf --error_map -O` for CLI_EM_ITERS iterations on the dataset at
    `root`, in a fresh workspace: the loss falls, the map moves off its ones
    and stays finite, the path's kernels launch; a second run with `--ckpt
    latest` starts from the saved map bit for bit and trains on."""
    from tngp_torch import kernels
    from tngp_torch.cli import main_nerf
    from tngp_torch.train import Trainer

    argv = [root, "-O", "--workspace", os.path.join(root, "ws_em"), "--seed", str(seed),
            "--error_map", *CLI_OPTION_FLAGS]
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    tr = main_nerf.main(argv + ["--iters", str(CLI_EM_ITERS)])
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = {name: k.launches for name, k in kernels.KERNELS.items()}
    em = tr.error_map.clone()
    moved = float((em != 1.0).float().mean())
    losses = tr.stats["loss"]
    log(f"[cli] --error_map: {tr.global_step} steps in {dt:.1f} s (evaluation and mesh "
        f"included); epoch loss {losses[0]:.6f} -> {losses[-1]:.6f}; map {tuple(em.shape)}, "
        f"{moved:.4f} of its entries moved, range [{float(em.min()):.3g}, "
        f"{float(em.max()):.3g}]; tier M {tr.tier_M} (tiers {tr._tier_M}); launches {launches}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise SystemExit(f"[cli] --error_map: the loss did not fall: {losses}")
    if not (moved > 0 and bool(torch.isfinite(em).all()) and tuple(em.shape) == (
            tr.n_frames, 128 * 128)):
        raise SystemExit(f"[cli] --error_map: the map did not move or is not finite: {moved}")
    for name in ("scatter_add_unique", "scatter_add_sorted", "bin_dest", "window_encode_fwd",
                 "window_encode_bwd"):
        if launches[name] <= 0:
            raise SystemExit(f"[cli] --error_map: a kernel of the path never launched: "
                             f"{launches}")
    end1 = (tr.epoch, tr.global_step)
    del tr
    seen = {}
    real_train = Trainer.train

    def train_seen(self, max_epochs):
        seen["at"] = (self.epoch, self.global_step)
        seen["map"] = self.error_map.clone()
        return real_train(self, max_epochs)

    Trainer.train = train_seen
    try:
        tr2 = main_nerf.main(argv + ["--iters", str(CLI_EM_ITERS + 12), "--ckpt", "latest"])
    finally:
        Trainer.train = real_train
    same = bool(torch.equal(seen["map"], em))
    log(f"[cli] --error_map --ckpt latest: resumed at {seen['at']} (run 1 ended at {end1}), "
        f"the map bit for bit: {same}; trained on to step {tr2.global_step}")
    if seen["at"] != end1 or not same or tr2.global_step != end1[1] + 12:
        raise SystemExit("[cli] --error_map: the resumed run did not restore the map")
    return dict(dt_em=dt, moved_em=moved, steps_em=end1[1], launches_em=launches)


def cli_no_grid_run(root: str, seed: int) -> dict:
    """`main_nerf --no_grid --bound 1 -O` for CLI_NOGRID_ITERS iterations at
    the CLI's default 128 + 128 samples a ray (4096 rays: M = 1,048,576
    samples a step, the window encoder's widest input; bound 1 gives the
    flagship encoder spec of phases 2-5): no grid update, a falling loss, a
    finite validation PSNR through the chunked grid-free eval; 16 further
    steps timed; one step through the kernels against the plain path
    (`step_kernels_vs_plain`), whose bin sort, forward and table-gradient
    inputs it returns for phase 7's checks and rows."""
    from tngp_torch import kernels
    from tngp_torch.cli import main_nerf
    from tngp_torch.kernels import window_encoder as kw

    argv = [root, "-O", "--workspace", os.path.join(root, "ws_nogrid"), "--seed", str(seed),
            "--no_grid", "--bound", "1", "--iters", str(CLI_NOGRID_ITERS), *CLI_OPTION_FLAGS]
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    tr = main_nerf.main(argv)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = {name: k.launches for name, k in kernels.KERNELS.items()}
    losses = tr.stats["loss"]
    samples = tr.tc.num_rays * (tr.cfg.num_steps + tr.cfg.upsample_steps)
    torch.cuda.synchronize()
    t1 = time.time()
    tr.run_steps(16)
    torch.cuda.synchronize()
    ms_step = (time.time() - t1) / 16 * 1e3
    t2 = time.time()
    psnr = tr.evaluate(tr.valid_dataset)
    dt_eval = time.time() - t2
    log(f"[cli] --no_grid: {CLI_NOGRID_ITERS} steps in {dt:.1f} s (evaluation and mesh "
        f"included), {samples:,} samples a step ({tr.cfg.num_steps} + "
        f"{tr.cfg.upsample_steps} a ray); epoch loss {losses[0]:.6f} -> {losses[-1]:.6f}; "
        f"16 more steps {ms_step:.2f} ms/step ({tr.tc.num_rays * 1e3 / ms_step:,.0f} rays/s); "
        f"validation PSNR {psnr:.2f} dB ({tr.valid_dataset.num_frames} views in "
        f"{dt_eval:.2f} s, chunked uniform eval); grid updates {tr._grid_updates}; "
        f"launches {launches}")
    if tr.use_grid or tr._grid_updates != 0 or launches["scatter_set"] != 0:
        raise SystemExit("[cli] --no_grid: the run updated an occupancy grid")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0] and np.isfinite(psnr)):
        raise SystemExit(f"[cli] --no_grid: losses {losses}, PSNR {psnr}")
    for name in ("scatter_add_unique", "bin_dest", "window_encode_fwd", "window_encode_bwd"):
        if launches[name] <= 0:
            raise SystemExit(f"[cli] --no_grid: a kernel of the path never launched: {launches}")

    calls = {"bin_dest": [], "window_encode_fwd": [], "window_encode_bwd": []}

    @contextlib.contextmanager
    def capture():
        with contextlib.ExitStack() as stack:
            for name, store in calls.items():
                stack.enter_context(capturing(kw, name, store))
            yield

    st = step_kernels_vs_plain(tr, tr.model, "grid-free step", capture())
    # the last forward calls are the fine pass's (the coarse pass's come first)
    x01 = calls["bin_dest"][-1][0].detach()
    xyz4, wob, table = (a.detach() for a in calls["window_encode_fwd"][-1][:3])
    g_sorted = calls["window_encode_bwd"][-1][2].detach()
    if x01.shape[1] != samples:
        raise SystemExit(f"[cli] --no_grid: the step encoded {x01.shape[1]} samples, not "
                         f"{samples}")
    log(f"[cli] --no_grid, one step through the kernels vs the plain path (M = "
        f"{x01.shape[1]:,}, M_pad = {xyz4.shape[0]:,}): loss {st['loss_k']:.8f} vs "
        f"{st['loss_p']:.8f}; gradient norm-relative errors "
        + ", ".join(f"{n} {v:.2e}" for n, v in st["rels"].items()) + " (<= 3e-2)")
    return dict(dt_nogrid=dt, ms_step_nogrid=ms_step, psnr_nogrid=psnr,
                launches_nogrid=launches, steps_nogrid=CLI_NOGRID_ITERS + 16,
                grid_free=(x01, xyz4, wob, table, g_sorted, tr.model.encoder.spec))


def viewer_drive(label: str, main, argv: list, bodies: list) -> tuple[list, object]:
    """`main(argv)` with `--gui` on a free localhost port, in a thread;
    `POST /render` each of `bodies`.  Each reply must be `image/png` that
    the port's codec decodes to the size its `X-Stats` reports.  Stops the
    viewer.  Returns ([(image, stats, seconds)], the trainer)."""
    import socket
    import threading
    import urllib.request

    from tngp_torch.cli.viewer import stop_viewers
    from tngp_torch.utils.image_io import decode_png

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    out = {}

    def serve():
        try:
            out["trainer"] = main(argv + ["--gui", "--gui_port", str(port)])
        except BaseException as e:  # reported below
            out["error"] = e

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{port}"
    page, deadline = None, time.time() + 300
    replies = []
    try:
        while page is None and time.time() < deadline and t.is_alive():
            try:
                page = urllib.request.urlopen(url + "/", timeout=5).read()
            except OSError:
                time.sleep(0.5)
        if not page or b"image/png" not in page:
            raise SystemExit(f"{label} the viewer served no page: {out.get('error')}")
        for body in bodies:
            req = urllib.request.Request(url + "/render", data=json.dumps(body).encode(),
                                         method="POST")
            t0 = time.time()
            with urllib.request.urlopen(req, timeout=600) as resp:
                ctype, st = resp.headers["Content-Type"], json.loads(resp.headers["X-Stats"])
                data = resp.read()
            img = decode_png(data)
            if ctype != "image/png" or img.shape != (st["H"], st["W"], 3):
                raise SystemExit(f"{label} {body}: {ctype}, {img.shape} for {st}")
            replies.append((img, st, time.time() - t0))
    finally:
        stop_viewers()
        t.join(timeout=120)
    if t.is_alive() or "error" in out:
        raise SystemExit(f"{label} the viewer did not stop cleanly: {out.get('error')}")
    for body, (img, st, sec) in zip(bodies, replies):
        log(f"{label} POST /render {json.dumps(body)}: {st['W']}x{st['H']} PNG in "
            f"{sec * 1e3:.0f} ms (render {st['render_ms']:.0f} ms"
            + (f", train {st['train_steps']} steps in {st['train_ms']:.0f} ms to step "
               f"{st['global_step']}" if "train_ms" in st else "") + ")")
    return replies, out["trainer"]


def cli_viewer_run(root: str, ws: str, H: int, W: int, step: int) -> dict:
    """`main_nerf -O --gui` on the workspace `ws` (its latest checkpoint, at
    global step `step`): an rgb frame, a depth frame and a train request,
    each a PNG of the dataset's size (the throttle off), the train request
    advancing the step."""
    from tngp_torch.cli import main_nerf

    bodies = [{"theta": 1.2, "phi": 0.9, "radius": 2.4, "mode": "rgb", "dynres": False},
              {"theta": 1.2, "phi": 0.9, "radius": 2.4, "mode": "depth", "dynres": False},
              {"theta": 0.4, "phi": 1.1, "radius": 2.4, "mode": "rgb", "train": True,
               "dynres": False}]
    replies, tr = viewer_drive("[cli] --gui", main_nerf.main, [root, "-O", "--workspace", ws],
                               bodies)
    st_t = replies[2][1]
    if any(img.shape != (H, W, 3) for img, _, _ in replies):
        raise SystemExit(f"[cli] --gui: frames of {[r[0].shape for r in replies]}, not "
                         f"{(H, W, 3)}")
    if not (st_t["train_steps"] > 0 and st_t["global_step"] == tr.global_step > step):
        raise SystemExit(f"[cli] --gui: the train request did not advance the step: {st_t}")
    if not (replies[1][0][..., 0] == replies[1][0][..., 2]).all():
        raise SystemExit("[cli] --gui: the depth frame is not gray")
    return dict(gui_ms=[round(sec * 1e3, 1) for _, _, sec in replies])


SDF_EPOCHS, SDF_STEPS = 3, 25  # timed epochs x steps (main_sdf's defaults: 20 x 100)
SDF_SAMPLES = 2**18  # main_sdf's --num_samples
SDF_LR = 1e-4  # main_sdf's --lr
SDF_MESH_RES = 128  # cut from main_sdf's --mesh_resolution 512
SDF_CLI_EPOCHS, SDF_CLI_STEPS = 2, 10  # the CLI runs: 2 epochs of 10 steps, then one more


def sdf_phase(dev, seed: int) -> dict:
    """The SDF entry point's path at full width: `SDFNetwork` (16 levels x
    2^19 rows, 3x64 f32 MLP) on `main_sdf sphere`'s mesh, 2^18 samples a
    step, lr 1e-4.  One step through the kernels against the plain path: the
    loss and the MLP's gradients bitwise equal (no kernel touches them), and
    each of the 16 levels' table-gradient scatters (`scatter_add_any`) on
    that step's own inputs within the reordering bound.  No host sync inside
    a step.  SDF_EPOCHS x SDF_STEPS timed steps (ms/step, samples/s, the
    host's share in `SDFDataset.sample`, the kernel once per level per step),
    the epoch loss falling; the bf16 MLP (`--fp16`) for one epoch; the mesh at
    SDF_MESH_RES^3 with its median vertex radius within 0.12 of the
    normalised sphere's; then `python -m tngp_torch.cli.main_sdf sphere` for
    SDF_CLI_EPOCHS epochs of SDF_CLI_STEPS steps and a resumed run that
    starts from its weights, EMA and Adam state bit for bit.  Returns the
    numbers and two levels' scatter inputs for phase 7."""
    import shutil
    import tempfile

    from tngp_torch import kernels
    from tngp_torch.cli import main_sdf
    from tngp_torch.data.sdf import SDFDataset, sphere_mesh
    from tngp_torch.models import SDFNetwork
    from tngp_torch.native import load_obj
    from tngp_torch.ops import hashgrid as hg
    from tngp_torch.ops.losses import mape_loss
    from tngp_torch.train.sdf_trainer import SDFTrainer
    from tngp_torch.utils import TrainConfig

    t_phase = time.time()
    root = tempfile.mkdtemp(prefix="tngp_sdf_")
    try:
        verts, faces = sphere_mesh(64, 0.6)
        ds = SDFDataset(vertices=verts, faces=faces, num_samples=SDF_SAMPLES, size=SDF_STEPS)
        rad = float(np.linalg.norm(ds.vertices, axis=1).mean())
        model = SDFNetwork(device=dev, seed=seed)
        tc = TrainConfig(name="sdf", workspace=os.path.join(root, "ws"), seed=seed,
                         eval_interval=1, use_checkpoint="scratch")
        tr = SDFTrainer(model, ds, tc, lr=SDF_LR, device=dev)
        spec = model.encoder.spec
        n_params = sum(p.numel() for p in tr.params)
        log(f"[sdf] SDFNetwork: {spec.num_levels} levels x {spec.level_dim}, "
            f"{spec.total_params:,} table rows ({4 * spec.total_params * spec.level_dim / 2**20:.1f}"
            f" MiB f32), {n_params:,} parameters; sphere mesh {len(verts)} vertices, "
            f"{len(faces)} faces (normalised radius {rad:.4f}); {SDF_SAMPLES:,} samples a step")

        # one step through the kernels against the plain path
        x, y = tr.upload(*ds.sample(123))
        calls = []

        def grads():
            tr.optimizer.zero_grad(set_to_none=True)
            loss = mape_loss(tr.model.cf(x)[0], y)
            loss.backward()
            return loss.detach().clone(), [p.grad.clone() for p in tr.params]

        with capturing(hg, "scatter_add", calls):
            loss_k, g_k = grads()
        with kernels.plain_versions():
            loss_p, g_p = grads()
        tr.optimizer.zero_grad(set_to_none=True)
        names = [n for n, p in model.named_parameters()]
        if len(calls) != spec.num_levels:
            raise SystemExit(f"[sdf] {len(calls)} table-gradient scatters in a step, not one per "
                             f"level ({spec.num_levels})")
        if not torch.equal(loss_k, loss_p) or not all(
                torch.equal(a, b) for n, a, b in zip(names, g_k, g_p) if n != "encoder.embeddings"):
            raise SystemExit("[sdf] the loss or an MLP gradient differs between the kernels and "
                             "the plain path")
        checks, per, took = check_any_calls(
            [(i.detach(), v.detach(), r) for i, v, r, *_ in calls], "SDF step, level")
        worst = max(w for _, w in checks)
        rel_tab = rel_err(g_k[0], g_p[0])
        log(f"[sdf] one step, kernels vs plain path: loss {float(loss_k):.8f} bitwise equal, MLP "
            f"gradients bitwise equal, table gradient norm-relative {rel_tab:.2e}; the "
            f"{spec.num_levels} levels' scatter_add_any on this step's inputs "
            f"({calls[0][0].numel():,} entries a level; level 0 into {calls[0][2]:,} rows, level "
            f"15 into {calls[15][2]:,}): max|err| vs plain {max(e for e, _ in checks):.3g}, "
            f"worst err/bound {worst:.3f}; designs {calls_summary(per, took)}")
        captured = {"level0": tuple(a.detach() if torch.is_tensor(a) else a for a in calls[0][:3]),
                    "level15": tuple(a.detach() if torch.is_tensor(a) else a
                                     for a in calls[15][:3])}
        errs = {"level0": checks[0], "level15": checks[15]}
        del calls, g_k, g_p

        # host syncs inside a step (the upload is outside it)
        syncs, up_syncs = [], 0
        with host_sync_log() as caught:
            for k in range(4):
                before = n_syncs(caught)
                xb, yb = tr.upload(*ds.sample(1000 + k))
                up_syncs += n_syncs(caught) - before
                before = n_syncs(caught)
                tr.train_step(xb, yb)
                syncs.append(n_syncs(caught) - before)
        log(f"[sdf] host syncs inside each of 4 steps: {syncs}; in the uploads: {up_syncs}")
        if any(syncs):
            raise SystemExit(f"[sdf] a step made a host sync: {syncs}")

        # timed epochs
        label_s = []
        real_sample = ds.sample

        def timed_sample(seed_):
            t0 = time.perf_counter()
            out = real_sample(seed_)
            label_s.append(time.perf_counter() - t0)
            return out

        ds.sample = timed_sample
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(SDF_EPOCHS):
            tr.epoch += 1
            tr.train_one_epoch()
        torch.cuda.synchronize()
        dt = time.time() - t0
        ds.sample = real_sample
        steps = SDF_EPOCHS * SDF_STEPS
        launches = {name: k.launches for name, k in kernels.KERNELS.items()}
        note_any_designs("sdf")
        losses = tr.stats["loss"]
        ms_step = dt / steps * 1e3
        host_share = sum(label_s) / dt
        valid = tr.evaluate()
        log(f"[sdf] {steps} steps ({SDF_EPOCHS} epochs of {SDF_STEPS}) in {dt:.2f} s: "
            f"{ms_step:.2f} ms/step, {SDF_SAMPLES * 1e3 / ms_step:,.0f} samples/s; the batch's "
            f"labels on the host (SDFDataset.sample: surface sampling and the BVH distance) "
            f"{1e3 * sum(label_s) / steps:.2f} ms/step, {host_share:.3f} of the step; epoch "
            f"loss {', '.join(f'{v:.5f}' for v in losses)}; validation mape {valid:.5f}; "
            f"launches {launches}")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise SystemExit(f"[sdf] the loss did not fall: {losses}")
        if launches["scatter_add_any"] != spec.num_levels * steps:
            raise SystemExit(f"[sdf] scatter_add_any launched {launches['scatter_add_any']} "
                             f"times, not {spec.num_levels} per step over {steps} steps")

        # the mesh
        t0 = time.time()
        path = tr.save_mesh(os.path.join(root, "mesh.obj"), resolution=SDF_MESH_RES)
        dt_mesh = time.time() - t0
        v2, f2 = load_obj(path)
        med = float(np.median(np.linalg.norm(v2, axis=1))) if len(v2) else float("nan")
        log(f"[sdf] save_mesh at {SDF_MESH_RES}^3 in {dt_mesh:.1f} s (the field on the card, "
            f"marching tetrahedra and the OBJ on the host): {len(v2):,} vertices, {len(f2):,} "
            f"faces; median vertex radius {med:.4f} vs the normalised sphere's {rad:.4f}")
        if not (len(f2) > 100 and abs(med - rad) < 0.12):
            raise SystemExit(f"[sdf] the mesh is not the sphere: {len(f2)} faces, median radius "
                             f"{med} vs {rad}")

        # the bf16 MLP (--fp16), one epoch
        tr16 = SDFTrainer(SDFNetwork(compute_dtype=torch.bfloat16, device=dev, seed=seed), ds,
                          tc, lr=SDF_LR, device=dev)
        torch.cuda.synchronize()
        t0 = time.time()
        loss16 = tr16.train_one_epoch()
        torch.cuda.synchronize()
        ms16 = (time.time() - t0) / SDF_STEPS * 1e3
        log(f"[sdf] bf16 MLP: one epoch of {SDF_STEPS} steps, {ms16:.2f} ms/step, loss "
            f"{loss16:.5f}")
        if not np.isfinite(loss16):
            raise SystemExit(f"[sdf] the bf16 MLP's loss is not finite: {loss16}")
        del tr16, tr, model

        # the entry point, and a resumed run
        ws = os.path.join(root, "ws_cli")
        argv = ["sphere", "--workspace", ws, "--seed", str(seed), "--epoch_size",
                str(SDF_CLI_STEPS), "--mesh_resolution", "128"]
        t0 = time.time()
        tr1 = main_sdf.main(argv + ["--epochs", str(SDF_CLI_EPOCHS)])
        dt_cli = time.time() - t0
        end1 = (tr1.epoch, tr1.global_step)
        state1 = [p.detach().clone() for p in tr1.params] + [e.clone() for e in tr1.ema_params] + [
            tr1.optimizer.state[p][k].clone() for p in tr1.params
            for k in ("exp_avg", "exp_avg_sq")]
        del tr1
        seen = {}
        real_train = SDFTrainer.train

        def train_seen(self, max_epochs):
            seen["at"] = (self.epoch, self.global_step)
            seen["state"] = [p.detach().clone() for p in self.params] + [
                e.clone() for e in self.ema_params] + [
                self.optimizer.state[p][k].clone() for p in self.params
                for k in ("exp_avg", "exp_avg_sq")]
            return real_train(self, max_epochs)

        SDFTrainer.train = train_seen
        try:
            tr2 = main_sdf.main(argv + ["--epochs", str(SDF_CLI_EPOCHS + 1)])
        finally:
            SDFTrainer.train = real_train
        same = len(seen["state"]) == len(state1) and all(
            torch.equal(a, b) for a, b in zip(seen["state"], state1))
        ckpts = sorted(f for f in os.listdir(os.path.join(ws, "checkpoints"))
                       if f.endswith(".npz"))
        log(f"[sdf] python -m tngp_torch.cli.main_sdf {' '.join(argv)} --epochs "
            f"{SDF_CLI_EPOCHS}: {end1[1]} steps in {dt_cli:.1f} s (checkpoints and a 128^3 mesh "
            f"included); --epochs {SDF_CLI_EPOCHS + 1} resumed at {seen['at']}, weights, EMA "
            f"and Adam state bit for bit: {same}; trained on to {(tr2.epoch, tr2.global_step)}; "
            f"checkpoints {ckpts}")
        if (seen["at"] != end1 or not same
                or tr2.global_step != end1[1] + SDF_CLI_STEPS
                or not os.path.exists(os.path.join(ws, "results", "mesh.ply"))):
            raise SystemExit("[sdf] the CLI's resumed run did not start where run 1 ended")
        wall = time.time() - t_phase
        log(f"[sdf] phase 6f wall {wall:.1f} s")
        return dict(ms_step=ms_step, samples_s=SDF_SAMPLES * 1e3 / ms_step,
                    host_share=host_share, losses=losses, ms16=ms16, radius=med, rad=rad,
                    faces=len(f2), dt_mesh=dt_mesh, launches=launches, steps=steps,
                    levels=spec.num_levels, captured=captured, errs=errs, wall=wall)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# TensoRF (phase 6g): milestones cut from the CLI's (2000, 3000, 4000, 5500,
# 7000) so that the run reaches resolution1 = 300 in TF_STEPS steps
TF_TIMED = 64  # TensoRF: timed steps at 128 and at the last resolution
TF_CP_STEPS = 32  # the CP model's steps (ranks 96 / 288)
TF_CLI_ITERS = 96  # main_tensorf's first run: 8 epochs of the 12 views, an upsample at 48
TF_CLI_UPSAMPLE = 48  # appended to the CLI's five milestones (its append quirk)
CC_TIMED = 64  # CCNeRF: timed steps
CC_CLI_ITERS = 48  # main_ccnerf: 4 epochs of the 12 views
RANK_LEVELS = ((8, 0, 8, 0), (16, 2, 16, 2), (32, 4, 32, 16), (64, 8, 64, 32), (64, 16, 64, 64))


def grid_sample_check(tr, model, label: str) -> dict:
    """`step_kernels_vs_plain` on a batch of trainer `tr`, capturing every
    plane and line gradient the grid samples hand to `scatter_add`; each
    capture's `scatter_add_any` within the reordering bound against the
    plain version (`check_scatter_add`).  Returns the step's errors, the
    captures (idx, vals, rows) and the worst err/bound."""
    from tngp_torch.ops import grid_sample as gs

    calls = []
    st = step_kernels_vs_plain(tr, model, label, capturing(gs, "scatter_add", calls))
    caps = [tuple(a.detach() if torch.is_tensor(a) else a for a in c[:3]) for c in calls]
    checks, per, took = check_any_calls(caps, f"{label}, factor gradient")
    worst = max(w for _, w in checks)
    log(f"{label}, kernels vs plain path: loss {st['loss_k']:.8f} vs {st['loss_p']:.8f}; "
        f"gradient norm-relative errors max {max(st['rels'].values()):.2e} (<= 3e-2); "
        f"{len(caps)} factor gradients through scatter_add_any on this step's inputs "
        f"(shapes {sorted({(tuple(v.shape), r) for _, v, r in caps})}): max|err| vs plain "
        f"{max(e for e, _ in checks):.3g}, worst err/bound {worst:.3f}; designs "
        f"{calls_summary(per, took)}")
    return dict(caps=caps, errs=checks, worst=worst, rels=st["rels"])


def timed_steps(tr, steps: int, path: str) -> tuple:
    """`steps` steps of `tr` between two synchronizes, the launch counts
    reset first; the any form's designs noted under `path`.  Returns
    (seconds, losses, launches)."""
    from tngp_torch import kernels

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    losses, _, _ = tr.run_steps(steps)
    torch.cuda.synchronize()
    dt = time.time() - t0
    note_any_designs(path)
    return dt, losses, {n: k.launches for n, k in kernels.KERNELS.items()}


def step_device_times(cfg, seed: int) -> dict:
    """`tngp_torch.diagnostics.tensor_steps` in a subprocess (its own
    profiler session: this process's is kept for phase 7b): the device ms a
    step of the trainers of phases 6g (TensoRF VM at 128 and at its last
    resolution) and 6h (CCNeRF), built there by the same functions on the
    same scene and render config (`cfg`, checked here)."""
    import subprocess

    from tngp_torch.diagnostics import tensor_steps

    if tensor_steps.render_config() != cfg:
        raise SystemExit(f"tensor_steps: its render config is not this run's: "
                         f"{tensor_steps.render_config()} vs {cfg}")
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.time()
    p = subprocess.run([sys.executable, "-m", "tngp_torch.diagnostics.tensor_steps", "--seed",
                        str(seed)], cwd=here, capture_output=True, text=True, timeout=600)
    if p.returncode != 0:
        raise SystemExit(f"tensor_steps failed ({p.returncode}):\n{p.stdout[-3000:]}\n"
                         f"{p.stderr[-3000:]}")
    for ln in p.stderr.splitlines():
        if ln.startswith("# "):
            log(f"[device] {ln[2:]}")
    out = json.loads(p.stdout.strip().splitlines()[-1])
    for name in ("tensorf_first", "tensorf_last", "ccnerf"):
        r = out[name]
        log(f"[device] {name} (resolution {r['resolution']}, from step {r['step'] - out['steps']}): "
            f"{r['device_ms_per_step']:.3f} ms of device time a step over {out['steps']} "
            f"profiled steps")
        if not r["device_ms_per_step"] > 0.0:
            raise SystemExit(f"tensor_steps: no device time recorded for {name}: {r}")
    for k, ms, n in out["top_kernels_all_three"]:
        log(f"[device]   {ms:10.3f} ms x{n:<6d} {k}")
    log(f"[device] tensor_steps subprocess {time.time() - t0:.1f} s")
    return out


def idle_share(device: dict, name: str, wall_ms: float, label: str) -> float:
    """1 - the profiled device ms a step of `name` / the phase's own wall
    a step (`wall_ms`, the host clock, unprofiled), logged with both."""
    dev_ms = device[name]["device_ms_per_step"]
    share = 1.0 - dev_ms / wall_ms
    log(f"[idle] {label}: {wall_ms:.2f} ms/step (the phase's timed window) against "
        f"{dev_ms:.3f} ms of device time a step (tensor_steps): idle share {share:.3f}")
    if not share < 1.0:
        raise SystemExit(f"[idle] {label}: no device time")
    return share


def tensorf_phase(dev, ds, cfg, seed: int) -> dict:
    """TensoRF at full width (phase 6g): `tensor_steps.tensorf_trainer`,
    `TensoRFNetwork` VM at the CLI's defaults (resolution0 128, ranks 16 /
    48, colour features 27, 3x128 bf16 MLP) on the blob scene `ds`, 4096
    rays a step, bench.py's render config `cfg` with the CLI's
    density_thresh 10, lr 1e-2, milestones TF_MILESTONES towards
    resolution1 300.  After TF_WARM steps, one step
    through the kernels against the plain path (each factor gradient's
    scatter_add_any on that step's inputs within the reordering bound);
    TF_TIMED timed steps at 128, the kernel 12 times a step; on to TF_STEPS
    across the five shrinks and upsamples (at least one shrink must crop,
    the last must end at the 300^3 voxel budget); the same check and
    TF_TIMED timed steps at the last resolution, 12 launches a step; the
    loss falls and the EMA's PSNR over the 12 views.  Then CP at ranks 96 /
    288 for TF_CP_STEPS steps (6 launches a step, its check), and the entry
    point (`tensorf_cli_runs`).  Returns the numbers and the captures phase
    7 times."""
    import shutil
    import tempfile

    from tngp_torch.diagnostics.tensor_steps import (TF_MILESTONES, TF_STEPS, TF_WARM,
                                                     tensorf_trainer)
    from tngp_torch.models import TensoRFNetwork
    from tngp_torch.train import TensoRFTrainer

    t_phase = time.time()
    tr = tensorf_trainer(ds, cfg, seed, dev)
    model, cfg, tc = tr.model, tr.cfg, tr.tc
    n_params = sum(p.numel() for p in tr.params)
    log(f"[tensorf] VM {model.resolution}, ranks {model.sigma_rank} / {model.color_rank}, "
        f"{n_params:,} parameters; milestones {TF_MILESTONES} -> {tr.upsample_resolutions}")
    loss_w, _, _ = tr.run_steps(TF_WARM)
    first = grid_sample_check(tr, model, "[tensorf] a VM step at 128")
    if len(first["caps"]) != 12:
        raise SystemExit(f"[tensorf] {len(first['caps'])} factor gradients in a VM step, not 12")
    del first
    dt1, loss1, la1 = timed_steps(tr, TF_TIMED, "tensorf vm 128")
    ms1 = dt1 / TF_TIMED * 1e3
    if la1["scatter_add_any"] != 12 * TF_TIMED:
        raise SystemExit(f"[tensorf] scatter_add_any {la1['scatter_add_any']} times in "
                         f"{TF_TIMED} steps, not 12 a step")
    loss_m, _, _ = tr.run_steps(TF_STEPS - tr.global_step)
    ups = tr.upsamples
    for u in ups:
        log(f"[tensorf] step {u['step']}: {u['old']} -> shrunk {u['shrunk']} -> {u['new']}, "
            f"box {[round(a, 3) for a in u['aabb']]} (threshold {u['thresh']:.3f})")
    res = tuple(tr.model.resolution)
    if [u["step"] for u in ups] != list(TF_MILESTONES):
        raise SystemExit(f"[tensorf] upsamples at {[u['step'] for u in ups]}")
    if not any(u["shrunk"] != u["old"] for u in ups):
        raise SystemExit("[tensorf] no shrink cropped the factors")
    if not abs(np.prod(res) / 300**3 - 1) < 0.05:
        raise SystemExit(f"[tensorf] the last resolution {res} is not the 300^3 budget")
    last = grid_sample_check(tr, tr.model, f"[tensorf] a VM step at {res}")
    dt2, loss2, la2 = timed_steps(tr, TF_TIMED, "tensorf vm")
    ms2 = dt2 / TF_TIMED * 1e3
    if la2["scatter_add_any"] != 12 * TF_TIMED:
        raise SystemExit(f"[tensorf] scatter_add_any {la2['scatter_add_any']} times at the "
                         f"last resolution, not 12 a step")
    losses = torch.cat([loss_w, loss1, loss_m, loss2]).tolist()
    first16, last16 = float(np.mean(losses[:16])), float(np.mean(losses[-16:]))
    psnr = tr.evaluate(ds)
    log(f"[tensorf] {TF_TIMED} timed steps at 128: {ms1:.2f} ms/step, "
        f"{N_RAYS * 1e3 / ms1:,.0f} rays/s; at {res}: {ms2:.2f} ms/step, "
        f"{N_RAYS * 1e3 / ms2:,.0f} rays/s (grid updates included); scatter_add_any 12 a step "
        f"in both; loss first 16 steps {first16:.6f}, last 16 {last16:.6f}; EMA PSNR over the "
        f"12 views {psnr:.2f} dB after {tr.global_step} steps")
    if not (np.isfinite(losses).all() and last16 < first16 and np.isfinite(psnr)):
        raise SystemExit(f"[tensorf] the loss did not fall: {first16} -> {last16}, PSNR {psnr}")
    plane = max((c for c in last["caps"] if c[2] > 1000), key=lambda c: c[1].shape[1])
    line = max((c for c in last["caps"] if c[2] <= 1000), key=lambda c: c[1].shape[1])
    errs = {id(c): e for c, e in zip(last["caps"], last["errs"])}
    out = dict(ms1=ms1, ms2=ms2, res=res, psnr=psnr, launches=la2, steps=TF_TIMED,
               plane=plane, line=line, plane_err=errs[id(plane)], line_err=errs[id(line)])
    del tr, model, last

    # CP at the CLI's --cp ranks
    cp = TensoRFNetwork(bound=1.0, decomposition="cp", sigma_rank=(96,) * 3,
                        color_rank=(288,) * 3, compute_dtype=torch.bfloat16, device=dev,
                        seed=seed)
    tr = TensoRFTrainer(cp, ds, cfg, tc, upsample_model_steps=(), device=dev)
    tr.run_steps(1)  # the first grid update
    chk = grid_sample_check(tr, cp, "[tensorf] a CP step at 128")
    if len(chk["caps"]) != 6:
        raise SystemExit(f"[tensorf] {len(chk['caps'])} factor gradients in a CP step, not 6")
    dt3, loss3, la3 = timed_steps(tr, TF_CP_STEPS, "tensorf cp")
    ms3 = dt3 / TF_CP_STEPS * 1e3
    loss3 = loss3.tolist()
    log(f"[tensorf] CP (ranks 96 / 288): {TF_CP_STEPS} steps, {ms3:.2f} ms/step, loss "
        f"{loss3[0]:.6f} -> {np.mean(loss3[-8:]):.6f}; scatter_add_any {la3['scatter_add_any']}")
    if la3["scatter_add_any"] != 6 * TF_CP_STEPS or not np.isfinite(loss3).all():
        raise SystemExit(f"[tensorf] CP: scatter_add_any {la3['scatter_add_any']} times, "
                         f"loss {loss3[-1]}")
    cp_line = max(chk["caps"], key=lambda c: c[1].shape[1])
    cerrs = {id(c): e for c, e in zip(chk["caps"], chk["errs"])}
    out.update(ms_cp=ms3, cp_line=cp_line, cp_line_err=cerrs[id(cp_line)], launches_cp=la3,
               steps_cp=TF_CP_STEPS)
    del tr, cp, chk

    root = tempfile.mkdtemp(prefix="tngp_tensorf_cli_")
    try:
        out.update(tensorf_cli_runs(dev, ds, root, seed))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["wall"] = time.time() - t_phase
    log(f"[tensorf] phase 6g wall {out['wall']:.1f} s")
    return out


def blender_root(dev, ds, root: str) -> list:
    """The blob scene `ds` as a blender-format dataset under `root` (12
    train views; 4 held views for val and test).  Returns the held poses."""
    from tngp_torch.data import orbit_poses
    from tngp_torch.data.synthetic import make_blob_field, render_gt_images

    held = orbit_poses(4, radius=2.35, elevation=0.3)
    held_imgs = render_gt_images(make_blob_field(0, device=dev), held, ds.intrinsics, ds.H,
                                 ds.W, 1.0, 512, device=dev)
    write_blender_dataset(root, {"train": (ds.poses, ds.images, None),
                                 "val": (held, held_imgs, None),
                                 "test": (held, held_imgs, None)}, ds.W, float(ds.intrinsics[0]))
    return held


def tensorf_cli_runs(dev, ds, root: str, seed: int) -> dict:
    """`tngp_torch.cli.main_tensorf.main` on the blob scene as a blender
    dataset with the CLI's defaults (bound 2: 2 cascades, dt_gamma 1/128,
    resolution0 128, resolution1 300) and -O: TF_CLI_ITERS iterations with
    `--upsample_model_steps TF_CLI_UPSAMPLE` (appended to the five default
    milestones, so the run upsamples once, straight to the 300^3 budget),
    then `--ckpt latest` resumes across that upsample (the module rebuilt to
    the checkpoint's resolution and box, the first EMA render bitwise equal
    to run 1's last) and trains on; then `--cp` for 24 iterations."""
    from tngp_torch.cli import main_tensorf

    held = blender_root(dev, ds, root)
    ws = os.path.join(root, "ws_tf")
    argv = [root, "-O", "--workspace", ws, "--seed", str(seed), "--eval_interval", "10",
            "--upsample_model_steps", str(TF_CLI_UPSAMPLE)]
    t0 = time.time()
    tr1 = main_tensorf.main(argv + ["--iters", str(TF_CLI_ITERS)])
    dt1 = time.time() - t0
    losses = tr1.stats["loss"]
    log(f"[tensorf-cli] python -m tngp_torch.cli.main_tensorf {' '.join(argv[1:])} --iters "
        f"{TF_CLI_ITERS}: {tr1.global_step} steps in {dt1:.1f} s (checkpoints and the "
        f"validation images included); milestones {tr1.upsample_model_steps}; upsamples "
        f"{[(u['step'], u['shrunk'], u['new']) for u in tr1.upsamples]}; epoch loss "
        f"{losses[0]:.6f} -> {losses[-1]:.6f}")
    if (tr1.cfg.cascades, tr1.cfg.bound) != (2, 2.0) or [u["step"] for u in tr1.upsamples] != [
            TF_CLI_UPSAMPLE]:
        raise SystemExit(f"[tensorf-cli] not the CLI's defaults, or no upsample: {tr1.cfg}, "
                         f"{tr1.upsamples}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise SystemExit(f"[tensorf-cli] the loss did not fall: {losses}")
    psnr = tr1.evaluate(tr1.valid_dataset)
    img_last, _ = tr1.render_image(held[0])
    end1, res1 = (tr1.epoch, tr1.global_step), tuple(tr1.model.resolution)
    del tr1
    resumed_run("[tensorf-cli]", lambda: main_tensorf.main(
        argv + ["--iters", str(TF_CLI_ITERS + 2 * ds.num_frames)]),
        lambda tr: tr.render_image(held[0])[0], img_last, end1, 2 * ds.num_frames)
    tr_cp = main_tensorf.main([root, "-O", "--cp", "--workspace", os.path.join(root, "ws_cp"),
                               "--seed", str(seed), "--iters", "24"])
    lcp = tr_cp.stats["loss"]
    log(f"[tensorf-cli] --cp: {tr_cp.global_step} steps, ranks {tr_cp.model.sigma_rank} / "
        f"{tr_cp.model.color_rank}, epoch loss {', '.join(f'{v:.6f}' for v in lcp)}; run 1's "
        f"validation PSNR {psnr:.2f} dB at {res1}")
    if tr_cp.model.decomposition != "cp" or not (np.isfinite(lcp).all() and np.isfinite(psnr)):
        raise SystemExit(f"[tensorf-cli] --cp: {tr_cp.model.decomposition}, {lcp}")
    return dict(cli_psnr=psnr)


def cc_prefix_losses(tr, batch) -> list:
    """The MSE of each of the cc_cfg.K prefixes on `batch`, no gradient."""
    with torch.no_grad():
        tr.loss_on_batch(batch)
    return batch["prefix_losses"].tolist()


def ccnerf_phase(dev, ds, cfg, seed: int) -> dict:
    """CCNeRF at full width (phase 6h): `tensor_steps.ccnerf_trainer`,
    `CCConfig` defaults (resolution 128, SH degree 4, five groups) on the
    blob scene `ds`, 4096 rays a step,
    K 128 slots, max_steps 512, lr1 2e-2 / lr2 1e-3.  One step through the
    kernels against the plain path after the first grid update (each of the
    30 factor gradients' scatter_add_any on that step's inputs within the
    reordering bound); CC_WARM untimed and CC_TIMED timed steps, 30 launches
    a step; each of the five prefixes' losses on a fixed batch (drawn after
    the first step) falling.  Then `cc_finalize`: the full-rank frame kept; the five
    default `--rank_levels` compressions rendered (PSNR over the 12 views,
    parameter count); a two-object `CCScene` frame on its own occupancy
    grid; and the entry point (`ccnerf_cli_runs`)."""
    import shutil
    import tempfile

    from tngp_torch.data import full_image_rays
    from tngp_torch.diagnostics.tensor_steps import CC_WARM, ccnerf_trainer
    from tngp_torch.models.ccnerf import CCNeRF, CCScene, cc_compress, cc_finalize, count_params
    from tngp_torch.render import FieldFns, dilated_chunk_grid
    from tngp_torch.render.frame_eval import FrameRenderer
    from tngp_torch.render.occupancy import create, update_density_grid

    t_phase = time.time()
    tr = ccnerf_trainer(ds, cfg, seed, dev)
    cc_cfg = tr.cc_cfg
    n_params = sum(p.numel() for p in tr.params)
    log(f"[ccnerf] CCConfig {cc_cfg}: {n_params:,} parameters; {N_RAYS} rays x {cfg.K} slots "
        f"a step, max_steps {cfg.max_steps}")
    loss_0, _, _ = tr.run_steps(1)  # the first grid update
    probe = tr.sample_batch()
    pl0 = cc_prefix_losses(tr, probe)
    chk = grid_sample_check(tr, tr.model, "[ccnerf] a CC step")
    if len(chk["caps"]) != 30:
        raise SystemExit(f"[ccnerf] {len(chk['caps'])} factor gradients in a CC step, not 30")
    line = max((c for c in chk["caps"] if c[2] <= 1000), key=lambda c: c[1].shape[1])
    line_err = {id(c): e for c, e in zip(chk["caps"], chk["errs"])}[id(line)]
    centre = torch.bincount(line[0], minlength=line[2])
    del chk
    loss_w, _, _ = tr.run_steps(CC_WARM)
    dt, loss_t, la = timed_steps(tr, CC_TIMED, "ccnerf")
    ms = dt / CC_TIMED * 1e3
    pl1 = cc_prefix_losses(tr, probe)
    log(f"[ccnerf] {CC_TIMED} timed steps: {ms:.2f} ms/step, {N_RAYS * 1e3 / ms:,.0f} rays/s "
        f"(grid updates included); scatter_add_any {la['scatter_add_any']} times (30 a step); "
        f"loss {float(loss_0[0]):.6f} -> {float(loss_t[-8:].mean()):.6f}; the five prefixes' "
        f"MSE on a fixed batch {[round(v, 6) for v in pl0]} -> {[round(v, 6) for v in pl1]}; "
        f"the line gradient's busiest rows {centre.topk(2).indices.tolist()} take "
        f"{int(centre.topk(2).values.sum()):,} of {line[0].numel():,} adds")
    if la["scatter_add_any"] != 30 * CC_TIMED:
        raise SystemExit(f"[ccnerf] scatter_add_any {la['scatter_add_any']} times, not 30 a step")
    if not all(b < a for a, b in zip(pl0, pl1)):
        raise SystemExit(f"[ccnerf] a prefix's loss did not fall: {pl0} -> {pl1}")

    # finalize, the compressions, a composed scene
    H, W = ds.H, ds.W
    pose = ds.poses[0]
    img_full, _ = tr.render_image(pose, use_ema=False)
    fparams, fcfg = cc_finalize(tr.model.numpy_params(), tr.cc_cfg)
    tr.set_model(CCNeRF(fcfg, fparams, device=dev))
    img_fin, _ = tr.render_image(pose, use_ema=False)
    fin_err = float(np.abs(img_fin - img_full).max())
    log(f"[ccnerf] cc_finalize: one group of ranks {fcfg.rank_vec_density} / "
        f"{fcfg.rank_mat_density} / {fcfg.rank_vec} / {fcfg.rank_mat}; the frame of view 0 "
        f"within {fin_err:.2e} of the trained field's")
    if not fin_err <= 1e-3:
        raise SystemExit(f"[ccnerf] the finalized field's frame differs by {fin_err}")
    levels = []
    for ranks in RANK_LEVELS:
        cparams, ccfg = cc_compress(fparams, fcfg, ranks)
        tr.set_model(CCNeRF(ccfg, cparams, device=dev))
        psnr = tr.evaluate(ds)
        levels.append((ranks, count_params(cparams), psnr))
    tr.set_model(CCNeRF(fcfg, fparams, device=dev))
    psnr_full = tr.evaluate(ds)
    log(f"[ccnerf] compressions (ranks dv, dm, cv, cm: parameters, PSNR over the 12 views): "
        + "; ".join(f"{r}: {n:,}, {p:.2f} dB" for r, n, p in levels)
        + f"; full {count_params(fparams):,}, {psnr_full:.2f} dB")
    if not all(np.isfinite(p) for _, _, p in levels):
        raise SystemExit(f"[ccnerf] a compression's PSNR is not finite: {levels}")
    scene = CCScene(device=dev)
    for i in range(2):
        ang = 0.7 * i
        R = np.array([[np.cos(ang), 0, -np.sin(ang)], [0, 1, 0],
                      [np.sin(ang), 0, np.cos(ang)]], np.float32)
        scene.add(fparams, fcfg, R=R, s=1.0 / (1 + 0.3 * i),
                  t=np.array([0.4 * i - 0.4, 0, 0], np.float32))
    field = FieldFns(sigma_rgb=lambda p, x, d: scene.sigma_rgb_cf(x, d),
                     density=lambda p, x: scene.density_cf(x)["sigma"])
    gen = torch.Generator(device=dev).manual_seed(seed)
    grid = update_density_grid(create(cfg.cascades, cfg.grid_size, device=dev), None, gen,
                               density_fn=field.density, bound=cfg.bound,
                               grid_size=cfg.grid_size, density_thresh=cfg.density_thresh,
                               full=True)
    o, d = full_image_rays(torch.as_tensor(pose, device=dev), torch.as_tensor(
        ds.intrinsics, device=dev), H, W, device=dev)
    with torch.no_grad():
        img_s, _ = FrameRenderer(field, cfg, chunk=4096).render(
            None, o, d, grid.bitfield, dilated_chunk_grid(grid.bitfield, cfg), None)
    img_s = img_s.reshape(H, W, 3).cpu().numpy()
    occ = float((grid.density_grid > cfg.density_thresh).float().mean())
    log(f"[ccnerf] a two-object CCScene frame of view 0 ({H}x{W}, its own grid {occ:.4f} "
        f"occupied): mean {img_s.mean():.4f}, differs from the one object's by "
        f"{float(np.abs(img_s - img_fin).mean()):.4f} on average")
    if not (np.isfinite(img_s).all() and np.abs(img_s - img_fin).mean() > 1e-4):
        raise SystemExit("[ccnerf] the composed frame is not finite or not another frame")
    del tr, scene
    root = tempfile.mkdtemp(prefix="tngp_ccnerf_cli_")
    try:
        ccnerf_cli_runs(dev, ds, root, seed)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall = time.time() - t_phase
    log(f"[ccnerf] phase 6h wall {wall:.1f} s")
    return dict(ms=ms, launches=la, steps=CC_TIMED, line=line, line_err=line_err,
                centre=int(centre.topk(2).values.sum()), psnr_full=psnr_full)


def ccnerf_cli_runs(dev, ds, root: str, seed: int) -> None:
    """`tngp_torch.cli.main_ccnerf.main` on the blob scene as a blender
    dataset with the CLI's defaults (bound 2, `CCConfig(bound=2)`) and -O
    for CC_CLI_ITERS iterations: the full model and the five default
    compressions in `<workspace>/cc_models/`; then `--compose` builds the
    six-object demo scene, whose density and colour at 4096 points are
    finite."""
    from tngp_torch.cli import main_ccnerf

    blender_root(dev, ds, root)
    ws = os.path.join(root, "ws_cc")
    argv = [root, "-O", "--workspace", ws, "--seed", str(seed)]
    t0 = time.time()
    tr = main_ccnerf.main(argv + ["--iters", str(CC_CLI_ITERS)])
    dt = time.time() - t0
    files = sorted(os.listdir(os.path.join(ws, "cc_models")))
    losses = tr.stats["loss"]
    log(f"[ccnerf-cli] python -m tngp_torch.cli.main_ccnerf {' '.join(argv[1:])} --iters "
        f"{CC_CLI_ITERS}: {tr.global_step} steps in {dt:.1f} s; epoch loss "
        f"{', '.join(f'{v:.6f}' for v in losses)}; cc_models {files}")
    if len(files) != 6 or not np.isfinite(losses).all():
        raise SystemExit(f"[ccnerf-cli] {files}, {losses}")
    del tr
    scene = main_ccnerf.main(argv + ["--compose"])
    x = torch.rand((3, 4096), device=dev) * 2.0 - 1.0
    d = torch.nn.functional.normalize(torch.randn((3, 4096), device=dev), dim=0)
    with torch.no_grad():
        sig, rgb = scene.sigma_rgb_cf(x, d)
    log(f"[ccnerf-cli] --compose: {len(scene.objects)} objects; density at 4096 points in "
        f"[{float(sig.min()):.3g}, {float(sig.max()):.3g}]")
    if len(scene.objects) != 6 or not (torch.isfinite(sig).all() and torch.isfinite(rgb).all()):
        raise SystemExit("[ccnerf-cli] --compose did not give a finite six-object scene")


# The other render paths (phase 6i): each trainer's untimed, timed and
# host-sync steps, and the CLI runs' iterations (48 = 4 epochs of the 12 views)
RP_WARM, RP_TIMED, RP_SYNC = 16, 32, 16
RP_CLI = (("--no_march_dense", ["--no_march_dense"], 48),
          ("--march_chunk 0", ["--march_chunk", "0"], 48),
          ("--compact_fraction 1", ["--compact_fraction", "1"], 48))


def frame_agreement(a_img, a_dep, b_img, b_dep, mask):
    """Pixels beyond image 1e-4 or depth 1e-3 among `mask`, and the largest
    image and depth errors there (phase 3's criterion: at most 1e-4 of the
    pixels beyond, those within 1e-2)."""
    d_i = np.abs(a_img - b_img).max(axis=-1)[mask]
    d_d = np.abs(a_dep - b_dep)[mask]
    if not d_i.size:
        return 0, 0.0, 0.0
    return int(((d_i > 1e-4) | (d_d > 1e-3)).sum()), float(d_i.max()), float(d_d.max())


def render_paths_phase(dev, ds, cfg, trainer, frame5, check_bwd, seed: int) -> dict:
    """The other render paths at full width (phase 6i): the flagship network
    and bench.py's render config with `march_group` 8 (the CLI's default)
    on phase 4's scene.  Three trainers, one per training path: the grouped
    slab march with the global budget (`march_dense=False`: `compact_mask`,
    the stream compositor on the gaps), without it (`compact_fraction=1`:
    `composite_rays_cf` over all 4096 x 128 = 524,288 slots) and the stream
    march (`march_chunk=0`: `compact_mask_hier`); each RP_WARM untimed and
    RP_TIMED timed steps (ms/step, the loss falling, everything finite), no
    host sync inside a step over RP_SYNC further steps, no tier read on the
    slab paths, and one step through the kernels against the plain versions
    (phase 4's tolerances) with each kernel it launched held to its plain
    version on that step's own inputs.  Then two 800x800 frames of phase
    5's trained weights through `Trainer.render_image`: `march_chunk=0`
    (the stream first pass and the grouped slab residual rounds) and
    `eval_stream=False` (the full-width round loop), each timed with its
    rounds and host reads, and held at phase 3's criterion to the same
    frame through the plain versions and to phase 5's frame-renderer frame
    `frame5` (image, depth, cut rays), the rays a round cap left alive in
    either set apart.  Then `main_nerf` on the blob scene as a blender
    dataset with each flag of RP_CLI: the loss falls, a finite validation
    PSNR; the `--no_march_dense` run resumes with `--ckpt latest` bitwise.
    Returns the numbers, and the `compact_fraction=1` step's encoder inputs
    and launches for phase 7's rows."""
    import shutil
    import tempfile

    from tngp_torch import kernels
    from tngp_torch.cli import main_nerf
    from tngp_torch.data import orbit_poses
    from tngp_torch.kernels import window_encoder as kw
    from tngp_torch.models import NGPNetwork
    from tngp_torch.ops import composite as comp_mod
    from tngp_torch.train import Trainer
    from tngp_torch.utils import TrainConfig

    t_phase = time.time()
    info = kernels.KERNELS
    base = dataclasses.replace(cfg, march_group=8)
    paths = {"slab_budget": dataclasses.replace(base, march_dense=False),
             "slab_all": dataclasses.replace(base, march_dense=False, compact_fraction=1.0),
             "stream": dataclasses.replace(base, march_chunk=0)}
    tc = TrainConfig(num_rays=N_RAYS, lr=1e-2, seed=seed, adaptive_overdrive=False,
                     use_checkpoint="scratch")
    out = {"train": {}, "eval": {}, "cli": {}}
    for name, pcfg in paths.items():
        model = NGPNetwork(encoding="hashgrid_window", bound=1.0, compute_dtype=torch.bfloat16,
                           device=dev, seed=seed)
        tr = Trainer(model, ds, pcfg, tc, device=dev, constant_lr=True, full_grid_updates=2)
        tiered = len(tr._tier_M) > 1
        if tiered != pcfg.march_dense or (tr._dgrid is None) != (pcfg.march_chunk == 0):
            raise SystemExit(f"[paths] {name}: tiers {tr._tier_M}, dilated grid "
                             f"{tr._dgrid is not None} for {pcfg}")
        loss_w, _, _ = tr.run_steps(RP_WARM)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        loss_t, pts, kept = tr.run_steps(RP_TIMED)
        torch.cuda.synchronize()
        dt = time.time() - t0
        launches = {k: v.launches for k, v in info.items()}
        step_syncs, _ = step_host_syncs(tr, RP_SYNC)
        losses = torch.cat([loss_w, loss_t])
        first16, last16 = float(losses[:16].mean()), float(losses[-16:].mean())
        need = ["scatter_add_unique", "bin_dest", "window_encode_fwd", "window_encode_bwd"]
        if pcfg.compact_fraction < 1.0:
            need.append("scatter_add_sorted")  # the stream compositor's per-ray sums
        log(f"[paths] train {name} (march_dense {pcfg.march_dense}, compact_fraction "
            f"{pcfg.compact_fraction}, march_group {pcfg.march_group}, march_chunk "
            f"{pcfg.march_chunk}): {RP_TIMED} timed steps {1e3 * dt / RP_TIMED:.2f} ms/step "
            f"({RP_TIMED * N_RAYS / dt:,.1f} rays/s) after {RP_WARM}; budget M {tr.tier_M} "
            f"(tiers {tr._tier_M}); demand {float(pts.float().mean()):,.0f} valid rungs a step, "
            f"{float(kept.float().mean()):,.0f} of {N_RAYS} rays kept; loss first 16 "
            f"{first16:.6f}, last 16 {last16:.6f}; host syncs inside train_step over "
            f"{RP_SYNC} further steps {sum(step_syncs)}, tier reads {tr.host_reads}; "
            f"launches {launches}")
        if sum(step_syncs) != 0:
            raise SystemExit(f"[paths] {name}: train_step made host syncs: {step_syncs}")
        if not tiered and tr.host_reads != 0:
            raise SystemExit(f"[paths] {name}: {tr.host_reads} tier reads on a path without tiers")
        if not (np.isfinite(first16) and last16 < first16):
            raise SystemExit(f"[paths] {name}: the loss did not fall: {first16} -> {last16}")
        if not all(bool(torch.isfinite(p).all()) for p in tr.params + tr.ema_params):
            raise SystemExit(f"[paths] {name}: a parameter is not finite")
        if min(launches[k] for k in need) <= 0:
            raise SystemExit(f"[paths] {name}: a kernel of the path never launched: {launches}")

        calls = {"bin_dest": [], "window_encode_fwd": [], "window_encode_bwd": [],
                 "scatter_add": [], "scatter_add_composite": []}

        @contextlib.contextmanager
        def capture():
            with contextlib.ExitStack() as stack:
                for k in ("bin_dest", "window_encode_fwd", "window_encode_bwd", "scatter_add"):
                    stack.enter_context(capturing(kw, k, calls[k]))
                stack.enter_context(capturing(comp_mod, "scatter_add",
                                              calls["scatter_add_composite"]))
                yield

        st = step_kernels_vs_plain(tr, model, f"[paths] {name} step", capture())
        x01 = calls["bin_dest"][-1][0].detach()
        d_k, t_k = kw.bin_dest(x01)
        d_r, t_r = kw.bin_dest_ref(x01)
        if not (torch.equal(d_k, d_r) and torch.equal(t_k, t_r)):
            raise SystemExit(f"[paths] {name}: bin_dest disagrees with the plain bin_dest")
        xyz4, wob, table = (a.detach() for a in calls["window_encode_fwd"][-1][:3])
        spec, block = calls["window_encode_fwd"][-1][3:5]
        err_fwd = max_abs(kw.window_encode_fwd(xyz4, wob, table, spec, block),
                          kw.window_encode_fwd_plain(xyz4, wob, table, spec, block))
        if not err_fwd <= 6e-6:
            raise SystemExit(f"[paths] {name}: window_encode_fwd vs plain {err_fwd}")
        g_sorted = calls["window_encode_bwd"][-1][2].detach()
        err_bwd, n_max, zd = check_bwd(xyz4, wob, g_sorted, f"[paths] {name} step")
        scat = []
        for (idx, vals, rows), indices in (
                [(c[:3], "unique") for c in calls["scatter_add"]]
                + [(c[:3], "sorted") for c in calls["scatter_add_composite"]]):
            scat.append(check_scatter_add(idx.detach(), vals.detach(), rows, indices,
                                          f"[paths] {name} step")[0])
        log(f"[paths] {name}, one step through the kernels vs the plain path: loss "
            f"{st['loss_k']:.8f} vs {st['loss_p']:.8f}; gradient norm-relative errors "
            + ", ".join(f"{n} {v:.2e}" for n, v in st["rels"].items())
            + f" (<= 3e-2); on the step's own inputs (M = {x01.shape[1]:,}, M_pad = "
            f"{xyz4.shape[0]:,}): bin_dest exact, window_encode_fwd max|err| {err_fwd:.3g} "
            f"(<= 6e-6), window_encode_bwd {err_bwd:.3g} within the reordering bound (n up to "
            f"{n_max:.0f}; zeros differ in {zd} of n >= 3), {len(scat)} scatter-adds "
            f"({len(calls['scatter_add'])} unique, {len(calls['scatter_add_composite'])} "
            f"sorted) max|err| {max(scat):.3g} within their bounds")
        out["train"][name] = dict(ms=1e3 * dt / RP_TIMED, first16=first16, last16=last16,
                                  launches=launches, tiers=tr._tier_M, M=tr.tier_M)
        if name == "slab_all":
            out["slab_inputs"] = dict(xyz4=xyz4, wob=wob, table=table, g_sorted=g_sorted,
                                      spec=spec, err_fwd=err_fwd, err_bwd=err_bwd,
                                      launches=launches, steps=RP_TIMED, M=x01.shape[1])
        del tr, model

    # ---- eval: phase 5's trained weights on two other eval paths ------------
    img5, dep5, cut5 = frame5
    R = RES
    pose = orbit_poses(4, radius=2.35, elevation=0.3)[1]  # phase 5's pose
    cfg0 = trainer.cfg
    try:
        for label, over in (("march_chunk 0", dict(march_chunk=0)),
                            ("eval_stream False", dict(eval_stream=False))):
            trainer.set_cfg(dataclasses.replace(cfg0, march_group=8, **over))
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            img, dep = trainer.render_image(pose, use_ema=True, chunk=N_RAYS, W=R, H=R)
            dt = time.time() - t0
            launches = {k: v.launches for k, v in info.items()}
            st = dict(trainer.last_render_stats)
            cut = trainer.last_render_cut.cpu().numpy()
            with kernels.plain_versions():
                img_p, dep_p = trainer.render_image(pose, use_ema=True, chunk=N_RAYS, W=R, H=R)
            cut_p = trainer.last_render_cut.cpu().numpy()
            need = ["scatter_add_unique", "bin_dest", "window_encode_fwd"]
            if cfg0.eval_stream and "eval_stream" not in over:
                need.append("scatter_add_sorted")  # the first pass's compositor, the rounds
            n_p, ei_p, ed_p = frame_agreement(img, dep, img_p, dep_p, ~(cut | cut_p))
            n_5, ei_5, ed_5 = frame_agreement(img, dep, img5, dep5, ~(cut | cut5))
            log(f"[paths] eval {label} (march_group 8): one {R}x{R} frame of phase 5's trained "
                f"weights through Trainer.render_image {dt:.3f} s, {R * R / dt:,.1f} rays/s; "
                f"{st['rounds']} rounds over {st['chunks']} chunks, {st['host_reads']} host "
                f"reads, {st['samples']:,} samples queried ({st['valid_samples']:,} valid); "
                f"rays left alive by a round cap {int(cut.sum())} (plain {int(cut_p.sum())}, "
                f"phase 5 {int(cut5.sum())}); vs the plain versions: {n_p} pixels beyond image "
                f"1e-4 or depth 1e-3, max|err| image {ei_p:.3g}, depth {ed_p:.3g}; vs phase "
                f"5's frame renderer: {n_5} pixels beyond, max|err| image {ei_5:.3g}, depth "
                f"{ed_5:.3g} (at most {int(1e-4 * R * R)} beyond, those within 1e-2); launches "
                f"{launches}")
            if img.shape != (R, R, 3) or not np.isfinite(img).all():
                raise SystemExit(f"[paths] eval {label}: not a finite [R, R, 3] image")
            if min(launches[k] for k in need) <= 0:
                raise SystemExit(f"[paths] eval {label}: a kernel of the path never launched: "
                                 f"{launches}")
            for what, (n, ei, ed) in (("the plain versions", (n_p, ei_p, ed_p)),
                                      ("phase 5's frame", (n_5, ei_5, ed_5))):
                if n > 1e-4 * R * R or ei > 1e-2 or ed > 1e-2:
                    raise SystemExit(f"[paths] eval {label} vs {what}: {n} pixels beyond image "
                                     f"1e-4 or depth 1e-3, image {ei}, depth {ed}")
            out["eval"][label] = dict(dt=dt, rounds=st["rounds"], host_reads=st["host_reads"],
                                      chunks=st["chunks"], cut=int(cut.sum()), vs_plain=n_p,
                                      vs_frame5=n_5, launches=launches)
    finally:
        trainer.set_cfg(cfg0)

    # ---- the CLI with the flags -------------------------------------------
    root = tempfile.mkdtemp(prefix="tngp_paths_")
    try:
        held = blender_root(dev, ds, root)
        for i, (flag, argv_f, iters) in enumerate(RP_CLI):
            argv = [root, "-O", "--workspace", os.path.join(root, f"ws{i}"), "--seed", str(seed),
                    "--eval_interval", "4", "--skip_test_render", "--mesh_resolution", "64",
                    *argv_f]
            kernels.reset_launch_counts()
            t0 = time.time()
            tr = main_nerf.main(argv + ["--iters", str(iters)])
            dt = time.time() - t0
            launches = {k: v.launches for k, v in info.items()}
            losses, results = tr.stats["loss"], tr.stats["results"]
            log(f"[paths] main_nerf {flag}: {tr.global_step} steps in {dt:.1f} s (validation "
                f"and mesh included); march_dense {tr.cfg.march_dense}, compact_fraction "
                f"{tr.cfg.compact_fraction}, march_group {tr.cfg.march_group}, march_chunk "
                f"{tr.cfg.march_chunk}; epoch loss {losses[0]:.6f} -> {losses[-1]:.6f}; "
                f"validation PSNR {', '.join(f'{r:.2f}' for r in results)} dB; launches "
                f"{launches}")
            if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
                raise SystemExit(f"[paths] main_nerf {flag}: the loss did not fall: {losses}")
            if not (results and np.isfinite(results).all()):
                raise SystemExit(f"[paths] main_nerf {flag}: no finite validation PSNR")
            if min(launches[k] for k in ("bin_dest", "window_encode_fwd",
                                         "window_encode_bwd")) <= 0:
                raise SystemExit(f"[paths] main_nerf {flag}: a kernel never launched: "
                                 f"{launches}")
            out["cli"][flag] = dict(dt=dt, psnr=results[-1], loss=(losses[0], losses[-1]))
            if flag == "--no_march_dense":
                img_last, _ = tr.render_image(held[0])
                end1 = (tr.epoch, tr.global_step)
                del tr
                resumed_run(f"[paths] main_nerf {flag}", lambda: main_nerf.main(
                    argv + ["--iters", str(iters + 2 * ds.num_frames), "--ckpt", "latest"]),
                    lambda t: t.render_image(held[0])[0], img_last, end1, 2 * ds.num_frames)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["wall"] = time.time() - t_phase
    log(f"[paths] phase 6i wall {out['wall']:.1f} s")
    return out


def profile_cli_run(seed: int) -> dict:
    """`main_nerf synthetic -O --profile DIR` for 2 epochs of the 16-frame
    blob scene: the first epoch's torch.profiler trace must be a non-empty
    Chrome trace in DIR.  Run last: after a profile the profiler records
    nothing more in the process."""
    import shutil
    import tempfile

    from tngp_torch.cli import main_nerf

    root = tempfile.mkdtemp(prefix="tngp_profile_")
    try:
        pdir = os.path.join(root, "profile")
        t0 = time.time()
        main_nerf.main(["synthetic", "-O", "--workspace", os.path.join(root, "ws"), "--seed",
                        str(seed), "--iters", "32", "--profile", pdir, *CLI_OPTION_FLAGS])
        dt = time.time() - t0
        traces = [os.path.join(pdir, f) for f in os.listdir(pdir)] if os.path.isdir(pdir) else []
        size = os.path.getsize(traces[0]) if len(traces) == 1 else 0
        head = ""
        if size:
            with open(traces[0]) as f:
                head = f.read(64)
        log(f"[cli] --profile: 32 steps in {dt:.1f} s; trace {[os.path.basename(t) for t in traces]}"
            f" of {size:,} bytes")
        if size <= 0 or not head.lstrip().startswith("{"):
            raise SystemExit(f"[cli] --profile wrote no trace: {traces}")
        return dict(dt_profile=dt, trace_bytes=size)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def cli_phase(dev, ds, seed: int) -> dict:
    """The NGP entry point at full width: the blob scene `ds` written as a
    blender-format dataset of PNGs (`utils/image_io.py`) whose
    transform_matrixes give back its poses through `nerf_matrix_to_ngp` at
    the CLI's --scale, then `tngp_torch.cli.main_nerf.main` with the CLI's
    default render flags (bound 2: 2 cascades; dt_gamma 1/128) and -O (bf16
    MLPs) for CLI_ITERS iterations, validation every 10 epochs.  Checks that
    the loss falls, a validation PSNR is finite, checkpoints rotate to the
    newest two plus the best one, every kernel of the path launched; that a
    second run with --ckpt latest resumes at the saved epoch and step with a
    first EMA render bitwise equal to the first run's last one and trains
    on; that --test writes PNG frames and a mesh with faces; then the
    golden-grid run with the background model (`cli_tiledgrid_run`), the
    `--error_map` and `--no_grid` runs (`cli_error_map_run`,
    `cli_no_grid_run`) and the web viewer on run 1's workspace
    (`cli_viewer_run`)."""
    import shutil
    import tempfile

    from tngp_torch import kernels
    from tngp_torch.cli import main_nerf
    from tngp_torch.data import orbit_poses
    from tngp_torch.data.synthetic import make_blob_field, render_gt_images

    root = tempfile.mkdtemp(prefix="tngp_cli_")
    try:
        H = W = ds.H
        held = orbit_poses(4, radius=2.35, elevation=0.3)  # val and test views
        held_imgs = render_gt_images(make_blob_field(0, device=dev), held, ds.intrinsics, H, W,
                                     1.0, 512, device=dev)
        worst = write_blender_dataset(root, {"train": (ds.poses, ds.images, None),
                                             "val": (held, held_imgs, None),
                                             "test": (held, held_imgs, None)},
                                      W, float(ds.intrinsics[0]))
        ws = os.path.join(root, "ws")
        argv = [root, "-O", "--workspace", ws, "--seed", str(seed), "--eval_interval", "10"]
        log(f"[cli] blender-format blob scene ({ds.num_frames} train, {len(held)} val and test "
            f"views of {H}x{W} PNGs; poses back through nerf_matrix_to_ngp within {worst:.2g}) "
            f"-> python -m tngp_torch.cli.main_nerf {' '.join(argv[1:])} --iters {CLI_ITERS}")

        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        tr1 = main_nerf.main(argv + ["--iters", str(CLI_ITERS)])
        torch.cuda.synchronize()
        dt1 = time.time() - t0
        launches = {name: k.launches for name, k in kernels.KERNELS.items()}
        for name in ("scatter_add_unique", "scatter_add_sorted", "bin_dest",
                     "window_encode_fwd", "window_encode_bwd"):
            if launches[name] <= 0:
                raise SystemExit(f"[cli] a kernel of the CLI path never launched: {launches}")
        if (tr1.cfg.cascades, tr1.cfg.dt_gamma, tr1.cfg.bound) != (2, 1 / 128, 2.0):
            raise SystemExit(f"[cli] not the CLI's default render config: {tr1.cfg}")
        losses = tr1.stats["loss"]
        results = tr1.stats["results"]
        ckpts = sorted(os.listdir(os.path.join(ws, "checkpoints")))
        last_ep = f"ngp_ep{tr1.epoch:04d}.npz"
        want_ckpts = sorted([f"ngp_ep{tr1.epoch - 1:04d}.npz", last_ep, "ngp.pth.npz"])
        log(f"[cli] run 1: {tr1.global_step} steps over {tr1.epoch} epochs in {dt1:.1f} s "
            f"(mesh and renders included); epoch loss {losses[0]:.6f} -> {losses[-1]:.6f}; "
            f"validation PSNR {', '.join(f'{r:.2f}' for r in results)} dB (best "
            f"{tr1.stats['best_result']:.2f}); checkpoints {[c for c in ckpts if c.endswith('.npz')]}; "
            f"tier M {tr1.tier_M}; launches {launches}")
        if not (np.isfinite(losses[0]) and losses[-1] < 0.5 * losses[0]):
            raise SystemExit(f"[cli] the loss did not fall below half: {losses[0]} -> {losses[-1]}")
        if not (results and all(np.isfinite(results))):
            raise SystemExit(f"[cli] no finite validation PSNR: {results}")
        if [c for c in ckpts if c.endswith(".npz")] != want_ckpts:
            raise SystemExit(f"[cli] checkpoints did not rotate to {want_ckpts}: {ckpts}")
        val_pose = held[0]
        img_last, _ = tr1.render_image(val_pose)
        end1 = (tr1.epoch, tr1.global_step)
        del tr1

        resumed_run("[cli]", lambda: main_nerf.main(
            argv + ["--iters", str(CLI_ITERS + 2 * ds.num_frames), "--ckpt", "latest"]),
            lambda tr: tr.render_image(val_pose)[0], img_last, end1, 2 * ds.num_frames)

        # --test: the test poses as PNG frames and a mesh
        tr3 = main_nerf.main(argv + ["--test"])
        frames = sorted(f for f in os.listdir(os.path.join(ws, "results")) if f.endswith(".png"))
        mesh = os.path.join(ws, "meshes", f"ngp_{tr3.epoch}.ply")
        with open(mesh) as f:
            header = [next(f) for _ in range(9)]
        n_faces = int(next(ln for ln in header if ln.startswith("element face")).split()[-1])
        log(f"[cli] --test: {len(frames)} PNG frames, mesh {os.path.basename(mesh)} with "
            f"{n_faces} faces (epoch {tr3.epoch})")
        if len(frames) != len(held) or n_faces <= 0:
            raise SystemExit(f"[cli] --test wrote {len(frames)} frames and {n_faces} faces")

        run4 = cli_tiledgrid_run(root, seed)
        em = cli_error_map_run(root, seed)
        ng = cli_no_grid_run(root, seed)
        gui = cli_viewer_run(root, ws, H, W, CLI_ITERS + 2 * ds.num_frames)
        return dict(dt=dt1, psnr=results[-1], launches=launches, faces=n_faces, **run4, **em,
                    **ng, **gui)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# The window encoder's f32 form, the hard scene, data parallelism and CLIP
# (phase 6j): train_hard's steps (cut from the script's default 30,000; the
# lr schedule stays the 30,000 steps'), the validation PSNR they must reach
# (a field stalled at the first epoch's loss reads 19-22 dB), bench_eval's
# frames (its default 8), the D-NeRF steps of the f32 input gradient, the
# NCCL trainers' steps, the gloo ranks' steps and main_nerf's iterations
HARD_STEPS = 1000
HARD_PSNR_FLOOR = 30.0
HARD_EVAL_FRAMES = 2
F32_DNERF_STEPS = 16
DP_STEPS = 32
DP_RANK_STEPS = 8
CLIP_ITERS = 48


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def one_step_agreement(label, a, b) -> tuple:
    """(loss, kept, grads) of one batch by two routes, held to phase 4's
    tolerances (loss 1e-5 relative, every gradient 3e-2 norm-relative: the
    kernels' f32 summation order through the bf16 MLPs).  Returns (loss
    relative error, the largest gradient error)."""
    loss_err = abs(float(a[0]) - float(b[0])) / abs(float(b[0]))
    grad_err = max(rel_err(x, y) for x, y in zip(a[2], b[2]))
    if not (loss_err <= 1e-5 and grad_err <= 3e-2):
        raise SystemExit(f"[dp] {label}: loss {float(a[0])} vs {float(b[0])}, gradient error "
                         f"{grad_err}")
    return loss_err, grad_err


def hard_dp_clip_phase(dev, dn: dict, seed: int) -> dict:
    """Phase 6j: the f32 form's D-NeRF steps (every `window_encode_dx_f32`
    launch one per backward); `tngp_torch.scripts.train_hard` for the
    first HARD_STEPS steps of its 30,000-step schedule, bf16 and
    `--mxu_f32` (the f32 kernels launched only in the f32 run, the bf16
    ones only in the other; each run's validation PSNR above
    HARD_PSNR_FLOOR), `bench_eval` on the
    bf16 run's checkpoint; `Trainer(mesh=make_mesh())` over NCCL at world
    size 1 against `Trainer()` (the first batch at phase 4's tolerances, the
    loss curves within 1e-4 of the loss, no host sync in a step); two gloo ranks on the card (`tngp_torch.diagnostics.dp_ranks`,
    built kernels loaded, not rebuilt) whose summed gradients match one
    process's over the whole batch and whose weights stay bitwise equal;
    and `main_nerf` with CLIP guidance (stub embedder): finite CLIP losses
    and one CLIP step through the kernels against the plain versions."""
    import subprocess
    import tempfile

    from tngp_torch import kernels
    from tngp_torch.cli import main_nerf
    from tngp_torch.diagnostics.dp_ranks import dp_trainer, first_batch_grads
    from tngp_torch.models import DNeRFNetwork
    from tngp_torch.parallel import init_distributed, make_mesh
    from tngp_torch.scripts import bench_eval, train_hard
    from tngp_torch.train import DNeRFTrainer, Trainer

    info = kernels.KERNELS
    f32_names = ("window_encode_fwd_f32", "window_encode_bwd_f32", "window_encode_dx_f32")
    bf16_names = ("window_encode_fwd", "window_encode_bwd", "window_encode_dx")
    out = {}
    t_phase = time.time()

    def counts():
        return {name: k.launches for name, k in info.items()}

    # -- D-NeRF under TNGP_MXU_F32=1: the input gradient's f32 form on its path
    os.environ["TNGP_MXU_F32"] = "1"
    try:
        dmodel = DNeRFNetwork(bound=1.0, encoding="hashgrid_window",
                              compute_dtype=torch.bfloat16, device=dev, seed=seed)
    finally:
        os.environ.pop("TNGP_MXU_F32")
    if not dmodel.encoder.mxu_f32:
        raise SystemExit("[f32] TNGP_MXU_F32=1 did not select the f32 form of D-NeRF's encoder")
    dtr = DNeRFTrainer(dmodel, dn["dds"], dn["cfg"], dn["tc"], time_size=DNERF_TIME_SIZE,
                       update_interval=16, device=dev)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    lf, _, _ = dtr.run_steps(F32_DNERF_STEPS)
    torch.cuda.synchronize()
    c = counts()
    out["dnerf_f32"] = dict(ms=1e3 * (time.time() - t0) / F32_DNERF_STEPS, launches=c)
    if not (c["window_encode_dx_f32"] == F32_DNERF_STEPS and c["window_encode_fwd_f32"] > 0
            and max(c[n] for n in bf16_names) == 0 and bool(torch.isfinite(lf).all())):
        raise SystemExit(f"[f32] D-NeRF with TNGP_MXU_F32=1: launches {c}, losses {lf}")
    log(f"[f32] D-NeRF with TNGP_MXU_F32=1: {F32_DNERF_STEPS} steps (a full time-grid update "
        f"inside) {out['dnerf_f32']['ms']:.2f} ms/step, window_encode_dx_f32 once per backward "
        f"({c['window_encode_dx_f32']}), no bf16-form launch; launches {c}")
    del dtr, dmodel

    # -- the hard scene: train_hard bf16 and --mxu_f32, then bench_eval
    root = tempfile.mkdtemp(prefix="tngp_hard_")
    runs = {}
    for label, tag, flags in (("bf16", "base", []), ("f32", "f32", ["--mxu_f32"])):
        ws = os.path.join(root, f"hard_{tag}")
        kernels.reset_launch_counts()
        try:
            r = train_hard.train_hard(train_hard.build_parser().parse_args(
                ["--workspace", ws, "--tag", tag, *flags]), max_steps=HARD_STEPS)
        finally:
            os.environ.pop("TNGP_MXU_F32", None)
        c = counts()
        r["launches"] = c
        runs[label] = r
        own, other = (f32_names, bf16_names) if flags else (bf16_names, f32_names)
        if not (min(c[n] for n in own[:2]) > 0 and max(c[n] for n in other) == 0
                and r["mxu_f32"] == bool(flags)):
            raise SystemExit(f"[hard] {label}: the encoder ran the wrong form: launches {c}")
        el = r["epoch_losses"]
        if not (np.isfinite(r["final_psnr"]) and r["final_psnr"] > HARD_PSNR_FLOOR
                and el[-1] < el[0]):
            raise SystemExit(f"[hard] {label}: validation PSNR {r['final_psnr']} after "
                             f"{HARD_STEPS} steps (must exceed {HARD_PSNR_FLOOR} dB), epoch "
                             f"losses {el}")
        log(f"[hard] train_hard {label} ({' '.join(flags) or 'default'}): the first {HARD_STEPS} "
            f"steps of 30,000 "
            f"{r['ms_per_step']:.2f} ms/step (train loop), epoch losses {el}, validation PSNR "
            f"{r['final_psnr']:.2f} dB over the 5 held-out views, wall {r['wall_s']:.1f} s; "
            f"launches {c}")
    out["hard"] = runs
    kernels.reset_launch_counts()
    be = bench_eval.bench_eval(bench_eval.build_parser().parse_args(
        ["--workspace", os.path.join(root, "hard_base"), "--frames", str(HARD_EVAL_FRAMES)]))
    if be is None or not (np.isfinite(be["value"]) and be["value"] > 0):
        raise SystemExit(f"[hard] bench_eval failed: {be}")
    be["launches"] = counts()
    out["eval"] = be
    log(f"[hard] bench_eval on the bf16 run's checkpoint: {json.dumps(be)}")

    # -- NCCL at world size 1: Trainer(mesh=make_mesh()) against Trainer()
    if not init_distributed(f"localhost:{free_port()}", 1, 0, backend="nccl"):
        raise SystemExit("[dp] the NCCL process group did not come up")
    trs = {"mesh": dp_trainer(make_mesh(), dev, seed), "plain": dp_trainer(None, dev, seed),
           "plain again": dp_trainer(None, dev, seed)}
    first = {k: first_batch_grads(tr) for k, tr in trs.items()}
    if not all(int(f[1]) == N_RAYS for f in first.values()):
        raise SystemExit(f"[dp] the first batch dropped rays: {[int(f[1]) for f in first.values()]}")
    e_first = one_step_agreement("NCCL mesh vs Trainer() on the first batch", first["mesh"],
                                 first["plain"])
    curves, ms = {}, {}
    for k, tr in trs.items():
        torch.cuda.synchronize()
        t0 = time.time()
        curves[k], _, _ = tr.run_steps(DP_STEPS)
        torch.cuda.synchronize()
        ms[k] = 1e3 * (time.time() - t0) / DP_STEPS
    # two runs differ by the kernels' summation order, which Adam's
    # normalised steps carry into the weights: the first batch is held at
    # phase 4's tolerances above, the curves at 1e-4 of the loss (the gap of
    # the two unmeshed runs reported beside it)
    spread = float((curves["plain again"] - curves["plain"]).abs().max())
    diff = float((curves["mesh"] - curves["plain"]).abs().max())
    bound_c = 1e-4 * float(curves["plain"].abs().max())
    syncs, _ = step_host_syncs(trs["mesh"], 16)
    log(f"[dp] NCCL at world size 1: first batch loss rel err {e_first[0]:.3g}, gradients "
        f"{e_first[1]:.3g} (<= 1e-5, 3e-2); {DP_STEPS} steps {ms['mesh']:.2f} ms/step with the "
        f"mesh, {ms['plain']:.2f} / {ms['plain again']:.2f} without; losses max |diff| {diff:.3g} "
        f"(two unmeshed runs {spread:.3g}; held <= 1e-4 of the loss, {bound_c:.3g}); host syncs "
        f"over 16 steps "
        f"{syncs}")
    if not (diff <= bound_c and bool(torch.isfinite(curves["mesh"]).all())):
        raise SystemExit(f"[dp] the NCCL mesh's losses differ from the unmeshed run's: {diff}")
    if sum(syncs) != 0:
        raise SystemExit(f"[dp] a step under the NCCL mesh made host syncs: {syncs}")
    out["nccl"] = dict(ms=ms, loss_diff=diff, spread=spread, first=e_first, syncs=syncs)
    torch.distributed.destroy_process_group()
    del trs

    # -- two gloo ranks on the card
    rank_dir = tempfile.mkdtemp(prefix="tngp_ranks_")
    env = {**os.environ, "TNGP_COORDINATOR": f"localhost:{free_port()}",
           "TNGP_NUM_PROCESSES": "2"}
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tngp_torch.diagnostics.dp_ranks", rank_dir, "--steps",
         str(DP_RANK_STEPS), "--backend", "gloo"], env={**env, "TNGP_PROCESS_ID": str(r)},
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        raise SystemExit("[dp] a gloo rank failed:\n" + "\n".join(x[-4000:] for x in logs))
    ranks = [torch.load(os.path.join(rank_dir, f"rank{r}.pt")) for r in range(2)]
    wall_ranks = time.time() - t0
    if int(ranks[0]["kept"] + ranks[1]["kept"]) != N_RAYS:
        raise SystemExit(f"[dp] the gloo ranks dropped rays: {[r['kept'] for r in ranks]}")
    ref = (first["plain"][0], None, [g.cpu() for g in first["plain"][2]])
    e_ranks = one_step_agreement("two gloo ranks vs one process over the whole batch",
                                 (ranks[0]["loss"], None, ranks[0]["grads"]), ref)
    same = all(torch.equal(a, b) for key in ("grads", "params", "ema")
               for a, b in zip(ranks[0][key], ranks[1][key]))
    if not (same and torch.equal(ranks[0]["losses"], ranks[1]["losses"])):
        raise SystemExit("[dp] the two gloo ranks' gradients, weights or losses differ")
    out["gloo"] = dict(first=e_ranks, wall_s=wall_ranks, losses=ranks[0]["losses"].tolist())
    log(f"[dp] two gloo ranks on the card ({wall_ranks:.1f} s with start-up): the summed "
        f"gradients vs one process over the whole batch: loss rel err {e_ranks[0]:.3g}, "
        f"gradients {e_ranks[1]:.3g} (<= 1e-5, 3e-2); after {DP_RANK_STEPS} steps the ranks' "
        f"weights, EMA and losses bitwise equal (losses {ranks[0]['losses'].tolist()})")

    # -- CLIP guidance through main_nerf, the stub embedder
    closses = []
    real_clip = Trainer.run_clip_step

    def recorded(self):
        loss = real_clip(self)
        closses.append(loss)
        return loss

    ws = tempfile.mkdtemp(prefix="tngp_clip_")
    Trainer.run_clip_step = recorded
    kernels.reset_launch_counts()
    t0 = time.time()
    try:
        tr = main_nerf.main(["synthetic", "-O", "--iters", str(CLIP_ITERS), "--rand_pose", "4",
                             "--clip_text", "a red sphere", "--clip_model_path", "stub",
                             "--workspace", ws, "--eval_interval", "100",
                             "--skip_test_render", "--mesh_resolution", "64"])
    finally:
        Trainer.run_clip_step = real_clip
    wall_clip = time.time() - t0
    c_run = counts()
    if not (len(closses) == CLIP_ITERS // 4 and all(np.isfinite(closses))):
        raise SystemExit(f"[clip] CLIP losses {closses} (expected {CLIP_ITERS // 4} finite)")

    def clip_grads():
        tr.optimizer.zero_grad(set_to_none=True)
        loss = tr.clip_loss()
        loss.backward()
        return float(loss.detach()), None, [p.grad.clone() for p in tr.params]

    kernels.reset_launch_counts()
    k = clip_grads()
    c_step = counts()
    with kernels.plain_versions():
        p = clip_grads()
    tr.optimizer.zero_grad(set_to_none=True)
    e_clip = one_step_agreement("one CLIP step, kernels vs plain", k, p)
    if min(c_step[n] for n in ("bin_dest", "scatter_add_unique", "window_encode_fwd",
                               "window_encode_bwd")) <= 0:
        raise SystemExit(f"[clip] the CLIP step's kernels did not launch: {c_step}")
    torch.cuda.synchronize()
    t0 = time.time()
    tr.run_clip_step()
    ms_clip = 1e3 * (time.time() - t0)
    out["clip"] = dict(losses=closses, wall_s=wall_clip, ms_step=ms_clip, first=e_clip,
                       launches=c_run)
    log(f"[clip] main_nerf --rand_pose 4 --clip_text 'a red sphere' --clip_model_path stub: "
        f"{CLIP_ITERS} iterations in {wall_clip:.1f} s, {len(closses)} CLIP steps, losses "
        f"{closses[0]:.5f} -> {closses[-1]:.5f}; one CLIP step {ms_clip:.2f} ms (one host read); "
        f"kernels vs plain: loss rel err {e_clip[0]:.3g}, gradients {e_clip[1]:.3g} (<= 1e-5, "
        f"3e-2); the step's launches {c_step}")
    out["wall_s"] = time.time() - t_phase
    log(f"[6j] phase wall {out['wall_s']:.1f} s")
    return out


def march_phase(dev, seed: int) -> dict:
    """Phase 2d: the march kernels against `march_rays_chunked_plain` on the
    card at a frame's first pass and a TensoRF step's shapes, every output
    bit for bit (a float by its bits); per shape the kernels' ms (CUDA
    events), the plain version's, the host us of a call and the bound."""
    from tngp_torch.diagnostics.kernel_times import (
        events_ms,
        host_us,
        march_bytes,
        march_inputs,
    )
    from tngp_torch.kernels import plain_versions
    from tngp_torch.ops.march import march_rays_chunked

    out = {}
    for case in ("eval_first", "train"):
        args, kw = march_inputs(case, dev, seed)
        with plain_versions():
            want = march_rays_chunked(*args, **kw)
        got = march_rays_chunked(*args, **kw)
        torch.cuda.synchronize()
        bad = []
        for name in want._fields:
            a, b = getattr(got, name), getattr(want, name)
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            if not torch.equal(a, b.to(a.dtype)):
                bad.append(name)
        if bad:
            raise SystemExit(f"march kernels ({case}) differ from the plain version in {bad}")

        def call(a=args, k=kw):
            return march_rays_chunked(*a, **k)

        with plain_versions():
            plain_ms = events_ms(call, reps=3, warmup=1)
        N, M = args[0].shape[0], kw["M_budget"]
        nbytes = march_bytes(N, M, kw.get("noise") is not None)
        out[case] = dict(ms=events_ms(call), host_us=host_us(call), plain_ms=plain_ms,
                         bound_bytes=nbytes, bound_ms=bound(nbytes, 0, 1.0)[0],
                         m_eff=int(got.m_eff), num_points=int(got.num_points), call=call)
        log(f"[march] {case} (N {N:,}, M_budget {M:,}, G {kw['G']}): kernels = plain bit for "
            f"bit, m_eff {out[case]['m_eff']:,} of {out[case]['num_points']:,}; "
            f"{out[case]['ms']:.4f} ms, host {out[case]['host_us']:.1f} us, plain "
            f"{plain_ms:.3f} ms, bound {out[case]['bound_ms']:.4f} ms ({nbytes:,} B)")
    return out


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

    t_run = time.time()
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

    # the frame renderer's widest residual round: the 65,536 tier at 8
    # samples a ray (k_tier = max(8, min(64, 2^19 / 65,536))) queries up to
    # 524,288 samples, wider than the first pass's bucket above
    M_round = 524_288
    x01_r = torch.rand((3, M_round), generator=gen).to(dev)
    dest_r, tob_r, rank_r, tot_r = kw.bin_dest_stages(x01_r)
    d_ref_r, t_ref_r = kw.bin_dest_ref(x01_r)
    rank_pr, tot_pr = kw.bin_ranks_plain(kw._padded_keys(sample_tiles(x01_r)))
    if not (torch.equal(dest_r, d_ref_r) and torch.equal(tob_r, t_ref_r)
            and torch.equal(rank_r, rank_pr) and torch.equal(tot_r, tot_pr)):
        raise SystemExit(f"bin_dest (M = {M_round}) disagrees with the plain bin_dest")
    pay_r = torch.cat([x01_r, torch.ones((1, M_round), device=dev)]).T.contiguous()
    xyz4_round = ks.scatter_add(dest_r, pay_r, kw.padded_size(M_round, BLOCK), indices="unique")
    wob_round = kw._wob_local(spec, tob_r)
    err_enc_round = max_abs(kw.window_encode_fwd(xyz4_round, wob_round, table, spec, BLOCK),
                            kw.window_encode_fwd_plain(xyz4_round, wob_round, table, spec, BLOCK))
    if not err_enc_round <= 6e-6:
        raise SystemExit(f"window_encode_fwd (M = {M_round}) disagrees with its plain version: "
                         f"{err_enc_round}")
    log(f"[check] the frame round's top width (M = {M_round}): bin_dest exact, "
        f"window_encode_fwd max|err| {err_enc_round:.3g} (<= 6e-6)")
    del x01_r, dest_r, tob_r, pay_r, xyz4_round, wob_round

    # the compositor's per-ray reduction: ascending ray ids; the same inputs
    # through the general (atomic) form, which no path calls yet
    rid = torch.sort(torch.randint(0, N_RAYS, (M,), generator=gen)).values.to(dev)
    vals5 = torch.rand((M, 5), generator=gen).to(dev)
    err_comp, worst_comp = check_scatter_add(rid, vals5, N_RAYS, "sorted", "per-ray reduction")
    (err_any, worst_any), any_perray = check_any_forms(rid, vals5, N_RAYS, "per-ray inputs")
    # the golden grid's table gradient: scatter_add_any at the shapes its
    # backward gives it, each row within the reordering bound, through the
    # design the dispatch picks and through every other that can take it
    hash_any = hash_any_inputs(dev, gen)
    hash_any_all = {label: check_any_forms(i_h, v_h, r_h, f"hash grid {label}")
                    for label, (i_h, v_h, r_h) in hash_any.items()}
    hash_any_err = {label: c for label, (c, _) in hash_any_all.items()}
    log("[check] the golden grid's table-gradient scatters through scatter_add_any (C = 2): "
        + "; ".join(f"{label} [{hash_any[label][1].shape[0]:,}] -> [{hash_any[label][2]:,}] "
                    f"({ks.any_form(*hash_any[label][1].shape, hash_any[label][2]).form}) "
                    f"max|err| vs plain {e:.3g}, worst err/bound {w:.3f}"
                    for label, (e, w) in hash_any_err.items())
        + f" (bound (n-1) 2^-24 sum|v| per row); every design on them and on the per-ray "
        f"inputs: {designs_summary([*hash_any_all.values(), ((err_any, worst_any), any_perray)])}")
    any_edge, any_exact = any_edge_checks(dev, gen)
    log("[check] the any form's designs on its edge cases (each entry within (n-1) 2^-24 "
        "sum|v|, n its nonzero terms, the owner design bitwise the same on a second call, no "
        "-0.0): "
        + "; ".join(f"{label} worst {w:.3f} [{', '.join(f'{f} {x[1]:.3f}' for f, x in per.items())}]"
                    for label, ((_, w), per) in any_edge.items())
        + "; bitwise equal to the plain version on integer values (a row of 219,096 adds, a "
        "fifth of the rows zero): "
        + "; ".join(f"{label} {', '.join(d)} and the dispatch" for label, d in any_exact.items()))
    # the eval round update: Na = 1024 alive-ray slots, ascending, fill N - 1
    Na = N_RAYS // 4
    live = torch.nonzero(torch.rand(N_RAYS, generator=gen) < 0.2)[:Na, 0]
    sel_r = torch.cat([live, torch.full((Na - live.numel(),), N_RAYS - 1)]).to(dev)
    delta6 = torch.randn((Na, 6), generator=gen).to(dev)
    err_round, worst_round = check_scatter_add(sel_r, delta6, N_RAYS, "sorted", "round update")
    # the frame renderer's round at its widest tier, 65,536 alive-ray slots
    # of an 800x800 frame padded to 655,360 rays: the update stores each
    # slot's [65,536, 6] deltas into the frame state through the unique
    # form, unused slots given distinct rows past the frame, which it drops
    # (fewer rays alive than slots here); the per-ray reduction adds up to
    # k_tier = 8 samples a slot, padding slots carrying the slot count,
    # which drops them
    NA_F, N_F = 65_536, 655_360
    live_f = torch.nonzero(torch.rand(N_F, generator=gen) < 0.08)[:NA_F, 0]
    n_unused = NA_F - live_f.numel()
    sel_f = torch.cat([live_f, N_F + torch.arange(n_unused)]).to(dev)
    delta_f = torch.randn((NA_F, 6), generator=gen).to(dev)
    err_round_f, _ = check_scatter_add(sel_f, delta_f, N_F, "unique", "frame round update")
    # the same slots through the sorted form with the compaction's fill,
    # row n - 1: one warp sums the fill run and one searches per frame row
    # (timed in phase 7 beside the unique form)
    sel_fill = torch.where(sel_f < N_F, sel_f, N_F - 1)
    err_fill, worst_fill = check_scatter_add(sel_fill, delta_f, N_F, "sorted",
                                             "frame round update, fill n - 1")
    per_slot = torch.randint(0, 9, (NA_F,), generator=gen)
    rid_f = torch.repeat_interleave(torch.arange(NA_F), per_slot)
    rid_f = torch.cat([rid_f, torch.full((M_round - rid_f.numel(),), NA_F)]).to(dev)
    vals_f = torch.rand((M_round, 5), generator=gen).to(dev)
    err_comp_f, worst_comp_f = check_scatter_add(rid_f, vals_f, NA_F, "sorted",
                                                 "frame round per-ray reduction")
    log(f"[check] the frame round's scatters against scatter_add_plain: update [{NA_F}, 6] -> "
        f"[{N_F}, 6] ({live_f.numel()} alive, {n_unused} slots given dropped rows) through "
        f"scatter_add_unique exact; the same through scatter_add_sorted with the fill n - 1 "
        f"max|err| {err_fill:.3g}, worst err/bound {worst_fill:.3f}; per-ray reduction "
        f"[{M_round}, 5] ({int(per_slot.sum())} samples) -> [{NA_F}, 5] max|err| "
        f"{err_comp_f:.3g}, worst err/bound {worst_comp_f:.3f} (bound (n-1) 2^-24 sum|v| per "
        f"row; bitwise the same on a second call)")
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

    def check_bwd(xyz4_t, wob_t, g_sorted_t, what, mxu_f32=False):
        """The backward kernel against its plain version.  Both sum the same
        n bf16-rounded terms of a table entry in f32, the kernel in whatever
        order its atomics land; any order is within (n - 1) 2^-24 sum|term|
        of the exact sum, so two orders are within twice that of each other.
        An entry of at most two terms has one f32 sum in every order, so
        there the two are equal (zeros included: an entry that no sample
        touches is 0 in both), values below 2^-126 taken as 0 (an f32
        atomic add may flush them).  From three terms on, the order decides
        whether a cancellation leaves exactly 0 (tngp_torch/diagnostics/
        bwd_zero_pattern.py: one such entry in 17 of 4,800 training steps,
        n 3 to 63, each within the bound; in 3 of them the plain version on
        the card differed so from its own CPU run), so there the zeros that
        differ are counted.
        With `mxu_f32` the f32 forms (the same terms unrounded).
        Returns (max |err|, the largest n, entries of n >= 3 whose zeros
        differ)."""
        f32 = dict(mxu_f32=mxu_f32)
        got = kw.window_encode_bwd(xyz4_t, wob_t, g_sorted_t, spec, BLOCK, **f32)
        plain = kw.window_encode_bwd_plain(xyz4_t, wob_t, g_sorted_t, spec, BLOCK, **f32)
        sabs = kw.window_encode_bwd_plain(xyz4_t, wob_t, g_sorted_t.abs(), spec, BLOCK, **f32)
        addr = bwd_addresses(xyz4_t, wob_t)
        live = (xyz4_t[:, 3] > 0).expand(L, 8, -1).reshape(-1).float()
        n = torch.zeros(table.numel(), device=dev).index_add_(0, addr.reshape(-1), live)
        # counted at channel 0's addresses; the other channels take the same terms
        n = n.reshape(spec.n_windows, C, -1)[:, :1].expand(-1, C, -1).reshape(got.shape)
        tol_t = 2.0 * torch.clamp(n - 1, min=0).double() * 2.0**-24 * sabs.double() + 1e-30
        err = max_abs(got, plain)
        if not bool(((got.double() - plain.double()).abs() <= tol_t).all()):
            raise SystemExit(f"window_encode_bwd ({what}) beyond the reordering bound: {err}")

        def flushed(t):
            return torch.where(t.abs() < 2.0**-126, torch.zeros_like(t), t)

        few = n <= 2
        if not torch.equal(flushed(got)[few], flushed(plain)[few]):
            raise SystemExit(f"window_encode_bwd ({what}): an entry of at most two terms "
                             f"differs from plain")
        zeros_differ = int(((got == 0) != (plain == 0)).sum())
        return err, float(n.max()), zeros_differ

    x01_t = torch.rand((3, Mt), generator=gen).to(dev)
    g_t = torch.randn((L * C, Mt), generator=gen).to(dev)
    xyz4_t, wob_t, dest_t, g_rows_t, g_sorted_t = sorted_inputs(x01_t, g_t)
    err_gsort, _ = check_scatter_add(dest_t, g_rows_t, Mt_pad, "unique", "cotangent sort")
    if not torch.equal(g_sorted_t[dest_t], g_rows_t):
        raise SystemExit("scatter_add_unique (cotangent sort) lost a row")
    err_bwd, n_max, zd_bwd = check_bwd(xyz4_t, wob_t, g_sorted_t, "uniform samples")
    log(f"[check] train shapes (M = {Mt}, M_pad = {Mt_pad}): cotangent sort "
        f"(scatter_add_unique) [{Mt}, {L * C}] -> [{Mt_pad}, {L * C}] exact, window_encode_bwd max|err| "
        f"{err_bwd:.3g} (each entry <= 2 (n-1) 2^-24 sum|term|, n up to {n_max:.0f}; entries of "
        f"<= 2 terms equal; zeros differ in {zd_bwd} of n >= 3)")

    # samples outside the unit cube, as D-NeRF's x + dx gives them: dense
    # corner rows outside the window contribute nothing in all three kernels
    x01_o = (torch.rand((3, Mt), generator=gen) * 1.12 - 0.06).to(dev)
    g_o = torch.randn((L * C, Mt), generator=gen).to(dev)
    xyz4_o, wob_o, _, _, g_sorted_o = sorted_inputs(x01_o, g_o)
    err_enc_o = max_abs(kw.window_encode_fwd(xyz4_o, wob_o, table, spec, BLOCK),
                        kw.window_encode_fwd_plain(xyz4_o, wob_o, table, spec, BLOCK))
    if not err_enc_o <= 6e-6:
        raise SystemExit(f"window_encode_fwd (x01 in [-0.06, 1.06]) vs plain: {err_enc_o}")
    err_bwd_o, _, zd_bwd_o = check_bwd(xyz4_o, wob_o, g_sorted_o, "x01 in [-0.06, 1.06]")
    err_dx_o, worst_dx_o = check_dx(xyz4_o, wob_o, table, g_sorted_o, spec, BLOCK,
                                    "x01 in [-0.06, 1.06]")
    outside = float(((x01_o < 0) | (x01_o > 1)).any(dim=0).float().mean())
    log(f"[check] x01 uniform in [-0.06, 1.06] (M = {Mt}, {outside:.3f} outside the cube): "
        f"window_encode_fwd max|err| {err_enc_o:.3g} (<= 6e-6), window_encode_bwd max|err| "
        f"{err_bwd_o:.3g} (reordering bound; zeros differ in {zd_bwd_o} entries of n >= 3), "
        f"window_encode_dx max|err| {err_dx_o:.3g}, "
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
        err_b, _, zd_b = check_bwd(xyz4_c, wob_c, g_sorted_c, what)
        err_x, worst_x = check_dx(xyz4_c, wob_c, table, g_sorted_c, spec, BLOCK, what)
        log(f"[check] {what} (M = {int((xyz4_c[:, 3] > 0).sum())}, M_pad = {xyz4_c.shape[0]}): "
            f"window_encode_fwd max|err| {err_f:.3g} (<= 6e-6), window_encode_bwd max|err| "
            f"{err_b:.3g} (reordering bound; entries of <= 2 terms equal, zeros differ in "
            f"{zd_b} of n >= 3), window_encode_dx max|err| "
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
        net_g = NGPNetwork(encoding="hashgrid_window",
                           bound=1.0, compute_dtype=torch.bfloat16, device=dev, seed=args.seed)
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

    # ---- 2d. the march kernels at the first pass's and a step's shapes ------
    marches = march_phase(dev, args.seed)

    # ---- 3. eval path, random weights: 800x800 frames ----------------------
    model = NGPNetwork(encoding="hashgrid_window",
                       bound=1.0, compute_dtype=torch.bfloat16, device=dev, seed=args.seed)
    cfg = RenderConfig(bound=1.0, grid_size=GRID_SIZE, max_steps=512, K=128, min_near=0.05,
                       compact_fraction=0.25, density_thresh=1.0, march_dense=True,
                       march_group=16)
    t0 = time.time()
    ds = make_synthetic_dataset(n_frames=12, H=128, W=128, seed=0, device=dev)
    log(f"[data] 12 x 128 x 128 views of the blob scene rendered on the card in "
        f"{time.time() - t0:.2f} s (mean {ds.images.mean():.4f})")
    # bench.py's loop: constant lr 1e-2, tiers f/4, f/2, f, full grid updates
    # for the first 32 steps
    tc = TrainConfig(num_rays=N_RAYS, lr=1e-2, seed=args.seed, adaptive_overdrive=False,
                     use_checkpoint="scratch")
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

    def check_launched(counts, label):
        for name in ("scatter_add_unique", "scatter_add_sorted", "bin_dest",
                     "window_encode_fwd", "march_chunked"):
            if counts[name] <= 0:
                raise SystemExit(f"{label}: a kernel of the eval path never launched: {counts}")

    frames = {}  # label -> the frame renderer's (image, depth, cut rays)

    def timed_frame(pose, use_ema, label):
        """One 800x800 frame through `Trainer.render_image` (the frame
        renderer), then the same pose through `render_image_chunked` (the
        per-chunk `render_rays_eval` loop), each timed and its launches
        counted; the two held to tests/test_frame_eval.py:59-60's
        tolerances (image 1e-4, depth 1e-3)."""
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        img, dep = trainer.render_image(pose, use_ema=use_ema, chunk=N_RAYS, W=R, H=R)
        dt = time.time() - t0  # render_image returns host arrays: the device is done
        counts = {name: k.launches for name, k in info.items()}
        st = dict(trainer.last_render_stats)
        cut_f = trainer.last_render_cut.cpu().numpy()
        if img.shape != (R, R, 3) or not np.isfinite(img).all():
            raise SystemExit(f"{label}: rendered image is not a finite [R, R, 3] array")
        check_launched(counts, label)
        reads_bound = 1 + st["chunks_marched"] + st["rounds"]
        if st["host_reads"] > reads_bound:
            raise SystemExit(f"{label}: {st['host_reads']} host reads, more than 1 + "
                             f"first-pass chunks + rounds = {reads_bound}")
        log(f"[eval] {label}, frame renderer: one {R}x{R} frame {dt:.3f} s, "
            f"{R * R / dt:,.1f} rays/s; {st['rounds']} residual rounds at tiers {st['tiers']}, "
            f"{st['host_reads']} host reads (<= 1 + {st['chunks_marched']} first-pass chunks + "
            f"{st['rounds']} rounds = {reads_bound}), {st['chunks_marched']}/{st['chunks']} "
            f"chunks marched; {st['samples']:,} samples queried ({st['valid_samples']:,} valid, "
            f"{st['valid_samples'] / (R * R):.1f} per ray); launches {counts}; image finite, "
            f"range [{img.min():.4f}, {img.max():.4f}]")
        # the same frame through the plain versions, held to the frame
        # renderer's tolerances (image 1e-4, depth 1e-3) on all but 1e-4 of
        # the pixels: the kernels differ from them only in f32 summation
        # order, which moves a sample by at most a bf16 rounding flip in the
        # MLP (the chunk check's 2e-3 below); a flip that moves a ray across
        # T_thresh changes the alive set, so the rounds split other rays'
        # samples elsewhere, which the frame-vs-chunked check below bounds by
        # 1e-2 on those pixels
        t0 = time.time()
        with kernels.plain_versions():
            img_p, dep_p = trainer.render_image(pose, use_ema=use_ema, chunk=N_RAYS, W=R, H=R)
        dt_p = time.time() - t0
        st_p = dict(trainer.last_render_stats)
        d_i = np.abs(img - img_p).max(axis=-1)
        d_d = np.abs(dep - dep_p)
        n_tight = int(((d_i > 1e-4) | (d_d > 1e-3)).sum())
        log(f"[eval] {label}, frame renderer through the plain versions: {dt_p:.3f} s, "
            f"{st_p['rounds']} rounds at tiers {st_p['tiers']} (kernels {st['rounds']}), "
            f"{st_p['valid_samples']:,} valid samples (kernels {st['valid_samples']:,}); kernels "
            f"vs plain: max|err| image {float(d_i.max()):.3g}, depth {float(d_d.max()):.3g}; "
            f"{n_tight} pixels beyond image 1e-4 or depth 1e-3 (at most {int(1e-4 * R * R)}, "
            f"those within 1e-2)")
        if n_tight > 1e-4 * R * R or float(d_i.max()) > 1e-2 or float(d_d.max()) > 1e-2:
            raise SystemExit(f"{label}: the frame renderer, kernels vs plain versions: "
                             f"{n_tight} pixels beyond image 1e-4 or depth 1e-3, image "
                             f"{float(d_i.max())}, depth {float(d_d.max())}")
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        img_c, dep_c = trainer.render_image_chunked(pose, use_ema=use_ema, chunk=N_RAYS, W=R, H=R)
        dt_c = time.time() - t0
        counts_c = {name: k.launches for name, k in info.items()}
        st_c = dict(trainer.last_render_stats)
        cut_c = trainer.last_render_cut.cpu().numpy()
        check_launched(counts_c, f"{label}, chunked")
        # rays a round cap left alive render differently by design: the
        # chunked path stops each chunk after ceil(max_steps / K_eval) + 2
        # rounds; they are counted and shown apart, the rest held
        done = ~(cut_f | cut_c)
        n_out, err_img, err_dep = frame_agreement(img, dep, img_c, dep_c, done)
        log(f"[eval] {label}, chunked render_rays_eval: {dt_c:.3f} s, {R * R / dt_c:,.1f} "
            f"rays/s; {st_c['rounds']} residual rounds over {st_c['chunks']} chunks, "
            f"{st_c['host_reads']} host reads, {st_c['valid_samples']:,} valid samples (frame "
            f"renderer {st['valid_samples']:,}); rays left alive by a round cap: chunked "
            f"{int(cut_c.sum())}, frame renderer {int(cut_f.sum())}; on the other "
            f"{int(done.sum())} rays, frame renderer vs chunked: {n_out} pixels beyond image "
            f"1e-4 or depth 1e-3 (at most {int(1e-4 * R * R)}), max|err| image "
            f"{err_img:.3g}, depth {err_dep:.3g} (<= 1e-2)")
        # the tolerance: each path resumes a ray at the t where a pass or
        # round stopped it and restarts the rung ladder there, so where the
        # two split a ray's samples at different points the later rungs lie
        # an f32 rounding apart, and one that crosses an occupancy-cell
        # boundary joins or leaves the ray's samples (PERF.md section 6:
        # `tngp_torch/diagnostics/frame_parity.py` holds both against one
        # pass without restarts).  So image 1e-4 and depth 1e-3 hold on all
        # but 1e-4 of the pixels, and those differ by at most one sample's
        # share, 1e-2
        if n_out > 1e-4 * R * R or err_img > 1e-2 or err_dep > 1e-2:
            raise SystemExit(f"{label}: the frame renderer and the chunked path differ in "
                             f"{n_out} pixels, image {err_img}, depth {err_dep}")
        frames[label] = (img, dep, cut_f)
        return dt, counts, st, dt_c, counts_c, st_c

    t0 = time.time()
    trainer.render_image(poses[0], use_ema=False, chunk=N_RAYS, W=R, H=R)
    trainer.frame_renderer(N_RAYS).warmup(None, bitfield, R * R)
    trainer.render_image_chunked(poses[0], use_ema=False, chunk=N_RAYS, W=R, H=R)
    log(f"[eval] warm-up frames and FrameRenderer.warmup {time.time() - t0:.2f} s "
        f"(occupancy {occ_frac:.4f})")
    dt_rand, launches_eval, st1, dt_rand_c, launches_chunked, st1_c = timed_frame(
        poses[1], False, "random weights")
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

    # ---- 3b. one frame of NGP on the golden hash grid with the background --
    t_3b = time.time()
    cfg_h = dataclasses.replace(cfg, bg_radius=2.0)
    model_h = NGPNetwork(encoding="hashgrid", bg_radius=2.0, compute_dtype=torch.bfloat16,
                         device=dev, seed=args.seed)
    tr_h = Trainer(model_h, ds, cfg_h, tc, device=dev, constant_lr=True)
    tr_h.set_grid(trainer.grid)  # the blob scene's occupancy grid
    tr_h.render_image(poses[0], use_ema=False, chunk=N_RAYS, W=R, H=R)  # warm-up
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    img_h, dep_h = tr_h.render_image(poses[1], use_ema=False, chunk=N_RAYS, W=R, H=R)
    dt_hash = time.time() - t0
    launches_hash = {name: k.launches for name, k in info.items()}
    st_h = dict(tr_h.last_render_stats)
    with kernels.plain_versions():
        img_hp, dep_hp = tr_h.render_image(poses[1], use_ema=False, chunk=N_RAYS, W=R, H=R)
    d_i = np.abs(img_h - img_hp).max(axis=-1)
    d_d = np.abs(dep_h - dep_hp)
    n_tight = int(((d_i > 1e-4) | (d_d > 1e-3)).sum())
    log(f"[eval-hash] NGP on the golden hash grid with the background model (bg_radius 2), "
        f"random weights: one {R}x{R} frame through the frame renderer {dt_hash:.3f} s, "
        f"{R * R / dt_hash:,.1f} rays/s; {st_h['rounds']} residual rounds at tiers "
        f"{st_h['tiers']}, {st_h['host_reads']} host reads, {st_h['valid_samples']:,} valid "
        f"samples; launches {launches_hash}; kernels vs plain: max|err| image "
        f"{float(d_i.max()):.3g}, depth {float(d_d.max()):.3g}, {n_tight} pixels beyond image "
        f"1e-4 or depth 1e-3 (at most {int(1e-4 * R * R)}, those within 1e-2); image range "
        f"[{img_h.min():.4f}, {img_h.max():.4f}]; phase 3b wall {time.time() - t_3b:.1f} s")
    if img_h.shape != (R, R, 3) or not np.isfinite(img_h).all():
        raise SystemExit("golden-grid frame: not a finite [R, R, 3] image")
    if n_tight > 1e-4 * R * R or float(d_i.max()) > 1e-2 or float(d_d.max()) > 1e-2:
        raise SystemExit(f"golden-grid frame, kernels vs plain versions: {n_tight} pixels beyond "
                         f"image 1e-4 or depth 1e-3, image {float(d_i.max())}, depth "
                         f"{float(d_d.max())}")
    if min(launches_hash[n] for n in ("scatter_add_unique", "scatter_add_sorted")) <= 0:
        raise SystemExit(f"golden-grid frame: a kernel of the eval path never launched: "
                         f"{launches_hash}")
    # an eval frame takes no gradient: the table-gradient scatter stays idle
    launches_any_frame = launches_hash["scatter_add_any"]
    if launches_any_frame != 0:
        raise SystemExit(f"golden-grid frame: scatter_add_any launched {launches_any_frame} "
                         f"times in an eval frame (no backward runs there)")
    if args.profile:
        profile_device(lambda: tr_h.render_image(poses[2], use_ema=False, chunk=N_RAYS, W=R,
                                                 H=R),
                       "one 800x800 eval frame, golden hash grid with the background", dt_hash)
    del tr_h, model_h

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
                                       "window_encode_fwd", "window_encode_bwd",
                                       "march_chunked")) <= 0:
        raise SystemExit(f"a kernel of the training path never launched: {launches_train}")

    # host syncs, counted over two further grid-update intervals (outside the
    # timed steps, so that the counting costs them nothing)
    reads0 = trainer.host_reads
    step_syncs, syncs_total = step_host_syncs(trainer, SYNC_STEPS)
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
    err_bwd_real, n_max_real, zd_real = check_bwd(xyz4_r, wob_r, g_sorted_r,
                                                  "a training step's samples")
    Mr_pad = xyz4_r.shape[0]
    log(f"[train] one step, kernels vs plain path on the card: loss {loss_k:.8f} vs "
        f"{loss_p:.8f}; gradient norm-relative errors "
        + ", ".join(f"{n} {v:.2e}" for n, v in rels.items())
        + f" (<= 3e-2); window_encode_bwd on this step's inputs (M_pad = {Mr_pad}) max|err| "
        f"{err_bwd_real:.3g} within the reordering bound (n up to {n_max_real:.0f}; entries of "
        f"<= 2 terms equal; zeros differ in {zd_real} entries of n >= 3)")

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
    dt_trained, launches_eval2, st2, dt_trained_c, _, _ = timed_frame(poses[1], True,
                                                                      "trained EMA weights")
    log(f"[eval] 800x800 rays/s, frame renderer (chunked): random weights "
        f"{R * R / dt_rand:,.1f} ({R * R / dt_rand_c:,.1f}), trained weights "
        f"{R * R / dt_trained:,.1f} ({R * R / dt_trained_c:,.1f}) (the trained occupancy grid, "
        f"{occ_end:.4f} occupied)")

    # ---- 6. D-NeRF training at full width (scripts/bench_dnerf_step.py) -----
    dn = dnerf_phase(dev, ds, args.seed)
    dt_dnerf, dt_ngp, ratio = dn["dt_dnerf"], dn["dt_ngp"], dn["ratio"]
    dnerf_rays_s, psnr_d, launches_dnerf = dn["rays_s"], dn["psnr"], dn["launches"]
    xyz4_x, wob_x, table_x, g_sorted_x = dn["trained"]["dx_args"]
    err_dx_real = dn["trained"]["err_dx"]

    # ---- 6b. bench_torch.py at its defaults ---------------------------------
    import bench_torch

    kernels.reset_launch_counts()
    t0 = time.time()
    os.environ["TNGP_BENCH_WARMUP"] = str(BENCH_WARMUP)
    try:
        bench_line = bench_torch.main()
    finally:
        del os.environ["TNGP_BENCH_WARMUP"]
    launches_bench = {name: k.launches for name, k in info.items()}
    log(f"[bench] bench_torch.main() in {time.time() - t0:.1f} s: {json.dumps(bench_line)}; "
        f"launches {launches_bench}")
    per_frame = ("eval800_rounds", "eval800_rays_cut")
    if not all(np.isfinite(v) and v > 0 for k, v in bench_line.items()
               if k not in ("metric", "unit") + per_frame):
        raise SystemExit(f"bench_torch.py: a number is not finite and positive: {bench_line}")
    if not all(len(bench_line[k]) == 3 and min(bench_line[k]) >= 0 for k in per_frame):
        raise SystemExit(f"bench_torch.py: the timed frames' rounds or cut rays: {bench_line}")
    for name in ("scatter_add_unique", "scatter_add_sorted", "bin_dest", "window_encode_fwd",
                 "window_encode_bwd"):
        if launches_bench[name] <= 0:
            raise SystemExit(f"a kernel of bench_torch.py's path never launched: {launches_bench}")

    # ---- 6c. the NGP entry point (tngp_torch.cli.main_nerf) ---------------
    cli = cli_phase(dev, ds, args.seed)
    # the grid-free step's kernels on its own inputs (M = 1,048,576)
    x01_g, xyz4_g, wob_g, table_g, g_sorted_g, spec_g = cli["grid_free"]
    if spec_g != spec:
        raise SystemExit(f"[cli] --no_grid: not the flagship encoder spec: {spec_g}")
    Mg, Mg_pad = x01_g.shape[1], xyz4_g.shape[0]
    d_k, t_k = kw.bin_dest(x01_g)
    d_r, t_r = kw.bin_dest_ref(x01_g)
    if not (torch.equal(d_k, d_r) and torch.equal(t_k, t_r)):
        raise SystemExit("[cli] --no_grid: bin_dest disagrees with the plain bin_dest")
    err_fwd_g = max_abs(kw.window_encode_fwd(xyz4_g, wob_g, table_g, spec, BLOCK),
                        kw.window_encode_fwd_plain(xyz4_g, wob_g, table_g, spec, BLOCK))
    if not err_fwd_g <= 6e-6:
        raise SystemExit(f"[cli] --no_grid: window_encode_fwd disagrees with its plain version: "
                         f"{err_fwd_g}")
    err_bwd_g, n_max_g, zd_g = check_bwd(xyz4_g, wob_g, g_sorted_g, "grid-free step")
    log(f"[check] the grid-free step's inputs (M = {Mg:,}, M_pad = {Mg_pad:,}): bin_dest exact, "
        f"window_encode_fwd max|err| {err_fwd_g:.3g} (<= 6e-6), window_encode_bwd max|err| "
        f"{err_bwd_g:.3g} within the reordering bound (n up to {n_max_g:.0f}; zeros differ in "
        f"{zd_g} of n >= 3)")

    # ---- 6d. D-NeRF at its defaults: the golden tiled grid ------------------
    dd = dnerf_default_phase(dev, dn, args.seed, args.profile)

    # ---- 6e. the D-NeRF entry point (tngp_torch.cli.main_dnerf) -------------
    dcli = dnerf_cli_phase(dev, dn["dds"], args.seed)

    # ---- 6f. SDF at full width, and the SDF entry point ---------------------
    sdf = sdf_phase(dev, args.seed)

    # ---- 6g. TensoRF at full width, and the TensoRF entry point -------------
    tf = tensorf_phase(dev, ds, cfg, args.seed)

    # ---- 6h. CCNeRF at full width, and the CCNeRF entry point ---------------
    cc = ccnerf_phase(dev, ds, cfg, args.seed)
    steps_dev = step_device_times(cfg, args.seed)
    idle = {"tensorf_first": idle_share(steps_dev, "tensorf_first", tf["ms1"],
                                        "[tensorf] VM at 128"),
            "tensorf_last": idle_share(steps_dev, "tensorf_last", tf["ms2"],
                                       f"[tensorf] VM at {tf['res']}"),
            "ccnerf": idle_share(steps_dev, "ccnerf", cc["ms"], "[ccnerf]")}

    # ---- 6i. the other render paths at full width --------------------------
    paths = render_paths_phase(dev, ds, cfg, trainer, frames["trained EMA weights"], check_bwd,
                               args.seed)
    si = paths["slab_inputs"]
    if si["spec"] != spec:
        raise SystemExit(f"[paths] slab step: not the flagship encoder spec: {si['spec']}")

    # ---- 6j. the f32 forms, the hard scene, data parallelism, CLIP ----------
    # the f32 form of the three kernels against their plain f32 versions: the
    # forward and the table gradient at phase 4's step shape (the top tier's
    # 131,072 uniform samples), the forward also on samples outside the cube,
    # the input gradient on a D-NeRF step's inputs and on those samples; the
    # tolerances of phase 2 (the same terms, rounded alike, summed in another
    # order; for N(0, 1) values the forward's 8 corners below 5.4e-6)
    f32 = dict(mxu_f32=True)
    err_fwd_f32 = max(
        max_abs(kw.window_encode_fwd(x4, wb, table, spec, BLOCK, **f32),
                kw.window_encode_fwd_plain(x4, wb, table, spec, BLOCK, **f32))
        for x4, wb in ((xyz4_t, wob_t), (xyz4_o, wob_o)))
    if not err_fwd_f32 <= 6e-6:
        raise SystemExit(f"window_encode_fwd_f32 disagrees with its plain version: {err_fwd_f32}")
    err_bwd_f32, n_max_f32, zd_f32 = check_bwd(xyz4_t, wob_t, g_sorted_t,
                                               "f32 form, uniform samples", mxu_f32=True)
    err_dx_f32, worst_dx_f32 = check_dx(xyz4_x, wob_x, table_x, g_sorted_x, spec, BLOCK,
                                        "f32 form, a D-NeRF step's inputs", mxu_f32=True)
    err_dx_f32_o, worst_dx_f32_o = check_dx(xyz4_o, wob_o, table, g_sorted_o, spec, BLOCK,
                                            "f32 form, x01 in [-0.06, 1.06]", mxu_f32=True)
    log(f"[f32] the f32 forms against their plain f32 versions: window_encode_fwd_f32 max|err| "
        f"{err_fwd_f32:.3g} (<= 6e-6; M = {Mt} uniform and x01 in [-0.06, 1.06]), "
        f"window_encode_bwd_f32 {err_bwd_f32:.3g} (reordering bound, n up to {n_max_f32:.0f}; "
        f"entries of <= 2 terms equal; zeros differ in {zd_f32} of n >= 3), "
        f"window_encode_dx_f32 on a D-NeRF step's inputs {err_dx_f32:.3g}, worst err/bound "
        f"{worst_dx_f32:.3f}, on x01 in [-0.06, 1.06] {err_dx_f32_o:.3g}, {worst_dx_f32_o:.3f} "
        f"(bitwise the same on a second call)")
    hj = hard_dp_clip_phase(dev, dn, args.seed)

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

    def add_bytes(m, c, rows_out):
        """A scatter-add's bytes: idx and vals read once, the output written
        once."""
        return m * 8 + m * c * 4 + rows_out * c * 4

    def add_row(name, indices, launches_n, err, idx, vals, rows_out, others=None, **extra):
        """A scatter-add form; one add per element.  `others` maps a label
        to (idx, vals, rows) of the same form at another shape, timed too.
        The any form's rows name the design their shape takes (`design`)
        and the launches by design in their path's timed run
        (`designs_in_run`, from the counters of `scatter_add_any`)."""
        m, c = vals.shape
        if indices == "any":
            extra["design"] = ks.any_form(m, c, rows_out).form
            extra["designs_in_run"] = ANY_DESIGNS_RUN.get(extra.get("path"))
        lib_idx = torch.where(idx < rows_out, idx, rows_out)  # rows past the end: one overflow row
        shapes = {label: ((lambda i=i, v=v, r=r: ks.scatter_add(i, v, r, indices=indices)),
                          bound(add_bytes(*v.shape, r), v.numel(), F32_OPS_PER_S)[0])
                  for label, (i, v, r) in (others or {}).items()}
        if indices == "any":  # each design of the form on the same inputs
            for f in ks.any_designs(m, c, rows_out):
                shapes[f"design {f}"] = ((lambda f=f: ks.scatter_add_any_as(idx, vals, rows_out, f)),
                                         bound(add_bytes(m, c, rows_out), m * c, F32_OPS_PER_S)[0])
        row(name, f"scatter_add_{indices}", launches_n, err,
            lambda: ks.scatter_add(idx, vals, rows_out, indices=indices),
            lambda: ks.scatter_add_plain(idx, vals, rows_out),
            lambda: torch.zeros((rows_out + 1, c), device=dev).index_add_(0, lib_idx,
                                                                          vals)[:rows_out],
            add_bytes(m, c, rows_out), m * c, F32_OPS_PER_S,
            library_call="index_add_ into zeros with an overflow row (indices past the "
                         "end mapped to it beforehand)", shape=f"[{m}, {c}] -> [{rows_out}, {c}]",
            shapes=shapes, **extra)

    # launches: the unique form's over the frame are its payload sorts and
    # round updates; in the timed steps one cotangent sort per backward, the
    # rest payload sorts.  The sorted form's frame launches are one per-ray
    # reduction per query (first-pass chunk or round): its row times the
    # frame round's shape, the first pass's under `shapes`.  The chunked
    # loop's round update keeps the sorted form
    rounds1 = st1["rounds"]
    add_row("scatter_add_unique", "unique", launches_eval["scatter_add_unique"], err_sort,
            dest, payload, M_pad, path="eval", call="encoder payload sort (unique indices); "
            "the frame's count includes its round updates",
            launches_payload_sorts=launches_eval["scatter_add_unique"] - rounds1,
            launches_round_updates=rounds1, launches_train=launches_train["scatter_add_unique"])
    add_row("scatter_add_sorted", "sorted", launches_eval["scatter_add_sorted"], err_comp_f,
            rid_f, vals_f, NA_F, path="eval", worst_err_over_bound=worst_comp_f,
            call=f"compositor per-ray reduction (nondecreasing indices) of a frame round at "
                 f"the {NA_F:,} tier",
            launches_first_pass=launches_eval["scatter_add_sorted"] - rounds1,
            launches_rounds=rounds1, launches_train=launches_train["scatter_add_sorted"],
            others={f"first-pass chunk / chunked loop [{M}, 5] -> [{N_RAYS}, 5]":
                    (rid, vals5, N_RAYS)},
            max_abs_err_first_pass=err_comp, worst_err_over_bound_first_pass=worst_comp)
    add_row("scatter_add_unique_cotangent_sort", "unique", launches_train["window_encode_bwd"],
            err_gsort, dest_t, g_rows_t, Mt_pad, path="train",
            call="encoder backward: cotangent sort (unique indices), one per backward")
    add_row("scatter_add_unique_round_update", "unique", launches_eval["scatter_add_unique"],
            err_round_f, sel_f, delta_f, N_F, path="eval",
            call=f"frame round update: {NA_F:,} alive-ray slots into the {N_F:,}-ray frame, "
                 f"unused slots given distinct rows past the frame (the frame's count "
                 f"includes the payload sorts)",
            launches_round_updates=rounds1)
    add_row("scatter_add_sorted_round_update", "sorted", launches_chunked["scatter_add_sorted"],
            err_round, sel_r, delta6, N_RAYS, path="chunked eval", worst_err_over_bound=worst_round,
            call=f"the chunked loop's round update: Na = {Na} alive-ray slots, ascending, fill "
                 f"N - 1 (the chunked frame's count includes its per-ray reductions)",
            launches_round_updates=st1_c["rounds"],
            others={f"frame round [{NA_F}, 6] -> [{N_F}, 6], unused slots filled with row "
                    f"n - 1 ({n_unused} entries in its run)": (sel_fill, delta_f, N_F)},
            max_abs_err_frame_fill=err_fill, worst_err_over_bound_frame_fill=worst_fill)
    add_row("scatter_add_any", "any", launches_parity["scatter_add_any"], err_any, rid, vals5,
            N_RAYS, path="device parity", worst_err_over_bound=worst_any,
            call="general indices (atomics) on the per-ray reduction's inputs, the device-parity "
                 "probe's case; its path's shapes are the golden grid's rows below")
    # the golden grid's table gradient, one launch per level in each
    # backward: D-NeRF's default (16 levels, phase 6d), the hyper variant
    # (16), NGP on the tiled grid with the background (16 + 4, phase 6c's
    # run 4).  Each row's `launches` counts its own level's launches in that
    # run (one a step: the phases check every level's); the whole path's
    # are under `launches_all_levels`.  An eval frame launches none
    # (phase 3b's frame, `launches_per_frame`)
    hyper = dd["variants"]["DNeRFHyperNetwork"]
    for label, counts, levels, steps, path, what in (
            ("level0_dense", dd["launches"], dd["levels"], DNERF_TIMED, "dnerf tiledgrid",
             "level 0 of the default tiled grid (dense, 8 corners of a training step's 131,072 "
             "samples into 4,920 rows, ~213 adds a row)"),
            ("level15_wrapped", dd["launches"], dd["levels"], DNERF_TIMED, "dnerf tiledgrid",
             "level 15 of the default tiled grid (8 corners into 2^19 wrapped rows)"),
            ("hyper5d_level8", hyper["launches"], hyper["levels"], VARIANT_STEPS, "dnerf hyper",
             "level 8 of the hyper variant's 5-D tiled grid (32 corners into 2^19 rows)"),
            ("bg_level0", cli["launches_tiled"], cli["levels_tiled"], cli["steps_tiled"],
             "ngp tiledgrid + bg cli",
             "level 0 of the background's 2-D grid (4 corners x 4,096 rays into 296 rows)")):
        i_h, v_h, r_h = hash_any[label]
        e_h, w_h = hash_any_err[label]
        total = counts["scatter_add_any"]
        add_row(f"scatter_add_any_hash_{label}", "any", total // levels, e_h, i_h, v_h, r_h,
                path=path, worst_err_over_bound=w_h, launches_per_step=total // levels // steps,
                launches_all_levels=total, levels=levels, steps=steps,
                launches_per_frame=launches_any_frame, call=f"golden-grid table gradient: {what}")

    # the SDF step's table gradient, one launch per level in each backward:
    # level 0 (dense, 8 corners of 262,144 samples into 4,920 rows, ~426
    # adds a row) and level 15 (hashed into 2^19 rows), on the inputs the
    # phase's kernel check captured
    for label, what in (("level0", "level 0 (dense: 8 corners of the 2^18 samples into "
                                   "4,920 rows, ~426 adds a row)"),
                        ("level15", "level 15 (hashed: 8 corners into 2^19 rows)")):
        i_s, v_s, r_s = sdf["captured"][label]
        e_s, w_s = sdf["errs"][label]
        total = sdf["launches"]["scatter_add_any"]
        add_row(f"scatter_add_any_sdf_{label}", "any", total // sdf["levels"], e_s, i_s, v_s,
                r_s, path="sdf", worst_err_over_bound=w_s,
                launches_per_step=total // sdf["levels"] // sdf["steps"],
                launches_all_levels=total, levels=sdf["levels"], steps=sdf["steps"],
                call=f"SDF table gradient: {what}")

    # TensoRF's and CCNeRF's factor gradients (phases 6g, 6h), one launch per
    # factor in each backward (12 a VM step, 6 a CP step, 30 a CC step), on
    # the captures of each phase's kernel check; each row's `launches`
    # counts its own factor's (one a step), the whole path's under
    # `launches_all_factors`
    for label, cap, err, total, factors, steps, path, what in (
            ("tensorf_plane", tf["plane"], tf["plane_err"], tf["launches"]["scatter_add_any"],
             12, tf["steps"], "tensorf vm",
             f"TensoRF VM colour plane gradient at the last resolution {tf['res']}"),
            ("tensorf_line", tf["line"], tf["line_err"], tf["launches"]["scatter_add_any"], 12,
             tf["steps"], "tensorf vm",
             f"TensoRF VM colour line gradient at the last resolution {tf['res']}"),
            ("tensorf_cp_line", tf["cp_line"], tf["cp_line_err"],
             tf["launches_cp"]["scatter_add_any"], 6, tf["steps_cp"], "tensorf cp",
             "TensoRF CP colour line gradient (rank 288) at resolution 128"),
            ("ccnerf_line", cc["line"], cc["line_err"], cc["launches"]["scatter_add_any"], 30,
             cc["steps"], "ccnerf",
             f"CCNeRF group-0 line gradient (rank 64, align_corners=False; masked slots at "
             f"position 0: the two centre rows take {cc['centre']:,} of the adds)")):
        i_c, v_c, r_c = cap
        e_c, w_c = err
        add_row(f"scatter_add_any_{label}", "any", total // factors, e_c, i_c, v_c, r_c,
                path=path, worst_err_over_bound=w_c, launches_per_step=total // factors // steps,
                launches_all_factors=total, factors=factors, steps=steps,
                adds_per_row=i_c.numel() / r_c, call=f"grid-sample factor gradient: {what}")

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

    # the grid-free step's encoder (the --no_grid run of phase 6c: M =
    # 1,048,576 samples, 4096 rays x 128 + 128), its three kernels on that
    # step's own inputs
    n_live_g = int((xyz4_g[:, 3] > 0).sum())
    for name, kernel, err, fn_k, fn_p, fn_lib, nbytes, ops, rate, lib_call in (
            ("bin_dest_grid_free", "bin_dest", 0.0, lambda: kw.bin_dest(x01_g),
             lambda: kw.bin_dest_ref(x01_g),
             lambda: torch.argsort(sample_tiles(x01_g), stable=True), bin_dest_bytes(Mg, BLOCK),
             Mg * 30, INT32_OPS_PER_S, "argsort (stable) of the tile keys"),
            ("window_encode_fwd_grid_free", "window_encode_fwd", err_fwd_g,
             lambda: kw.window_encode_fwd(xyz4_g, wob_g, table_g, spec, BLOCK),
             lambda: kw.window_encode_fwd_plain(xyz4_g, wob_g, table_g, spec, BLOCK), None,
             encoder_bytes("fwd", xyz4_g, wob_g, spec, BLOCK),
             n_live_g * L * (10 + 8 * (3 + 2 * C)), F32_OPS_PER_S, None),
            ("window_encode_bwd_grid_free", "window_encode_bwd", err_bwd_g,
             lambda: kw.window_encode_bwd(xyz4_g, wob_g, g_sorted_g, spec, BLOCK),
             lambda: kw.window_encode_bwd_plain(xyz4_g, wob_g, g_sorted_g, spec, BLOCK),
             bwd_library(xyz4_g, wob_g, g_sorted_g),
             encoder_bytes("bwd", xyz4_g, wob_g, spec, BLOCK),
             n_live_g * L * (10 + 8 * (3 + 2 * C)), F32_OPS_PER_S,
             "index_add_ of precomputed rows and values (nearest call, not the same function)")):
        extra = {} if lib_call is None else {"library_call": lib_call}
        row(name, kernel, cli["launches_nogrid"][kernel], err, fn_k, fn_p, fn_lib, nbytes, ops,
            rate, path="ngp --no_grid cli", steps=cli["steps_nogrid"],
            shape=f"the grid-free step's {Mg:,} samples (M_pad {Mg_pad:,}, {n_live_g:,} live)",
            **extra)

    # the slab step's encoder (phase 6i, compact_fraction 1: every one of the
    # 4096 x 128 = 524,288 slab slots queried), on that step's own inputs
    xyz4_s, wob_s, table_s, g_sorted_s = si["xyz4"], si["wob"], si["table"], si["g_sorted"]
    n_live_s = int((xyz4_s[:, 3] > 0).sum())
    for name, kernel, err, fn_k, fn_p, fn_lib, nbytes, lib_call in (
            ("window_encode_fwd_slab", "window_encode_fwd", si["err_fwd"],
             lambda: kw.window_encode_fwd(xyz4_s, wob_s, table_s, spec, BLOCK),
             lambda: kw.window_encode_fwd_plain(xyz4_s, wob_s, table_s, spec, BLOCK), None,
             encoder_bytes("fwd", xyz4_s, wob_s, spec, BLOCK), None),
            ("window_encode_bwd_slab", "window_encode_bwd", si["err_bwd"],
             lambda: kw.window_encode_bwd(xyz4_s, wob_s, g_sorted_s, spec, BLOCK),
             lambda: kw.window_encode_bwd_plain(xyz4_s, wob_s, g_sorted_s, spec, BLOCK),
             bwd_library(xyz4_s, wob_s, g_sorted_s),
             encoder_bytes("bwd", xyz4_s, wob_s, spec, BLOCK),
             "index_add_ of precomputed rows and values (nearest call, not the same function)")):
        extra = {} if lib_call is None else {"library_call": lib_call}
        row(name, kernel, si["launches"][kernel], err, fn_k, fn_p, fn_lib, nbytes,
            n_live_s * L * (10 + 8 * (3 + 2 * C)), F32_OPS_PER_S,
            path="ngp slab march, compact_fraction 1 (phase 6i)", steps=si["steps"],
            shape=f"the slab step's {si['M']:,} samples (M_pad {xyz4_s.shape[0]:,}, "
                  f"{n_live_s:,} live)", **extra)

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
    # the f32 forms (phase 6j): the forward and the table gradient on phase
    # 4's step shape, launches from the `train_hard --mxu_f32` run; the input
    # gradient on a D-NeRF step's inputs, launches from the f32 D-NeRF steps.
    # Bounds as the bf16 forms' (the table is f32 in memory either way, 4 B
    # a value); each row also times the bf16 form on the same inputs
    n_live_t = int((xyz4_t[:, 3] > 0).sum())
    hard_f32 = hj["hard"]["f32"]["launches"]
    for name, err, fn_k, fn_p, fn_bf16, fn_lib, nbytes, ops, launches_n, path, extra in (
            ("window_encode_fwd_f32", err_fwd_f32,
             lambda: kw.window_encode_fwd(xyz4_t, wob_t, table_win, spec, BLOCK, **f32),
             lambda: kw.window_encode_fwd_plain(xyz4_t, wob_t, table_win, spec, BLOCK, **f32),
             lambda: kw.window_encode_fwd(xyz4_t, wob_t, table_win, spec, BLOCK), None,
             encoder_bytes("fwd", xyz4_t, wob_t, spec, BLOCK),
             n_live_t * L * (10 + 8 * (3 + 2 * C)), hard_f32["window_encode_fwd_f32"],
             "train_hard --mxu_f32", {}),
            ("window_encode_bwd_f32", err_bwd_f32,
             lambda: kw.window_encode_bwd(xyz4_t, wob_t, g_sorted_t, spec, BLOCK, **f32),
             lambda: kw.window_encode_bwd_plain(xyz4_t, wob_t, g_sorted_t, spec, BLOCK, **f32),
             lambda: kw.window_encode_bwd(xyz4_t, wob_t, g_sorted_t, spec, BLOCK),
             bwd_library(xyz4_t, wob_t, g_sorted_t),
             encoder_bytes("bwd", xyz4_t, wob_t, spec, BLOCK),
             n_live_t * L * (10 + 8 * (3 + 2 * C)), hard_f32["window_encode_bwd_f32"],
             "train_hard --mxu_f32",
             {"library_call": "index_add_ of precomputed rows and values (nearest call, not "
                              "the same function)"}),
            ("window_encode_dx_f32", err_dx_f32,
             lambda: kw.window_encode_dx(xyz4_x, wob_x, table_x, g_sorted_x, spec, BLOCK, **f32),
             lambda: kw.window_encode_dx_plain(xyz4_x, wob_x, table_x, g_sorted_x, spec, BLOCK,
                                               **f32),
             lambda: kw.window_encode_dx(xyz4_x, wob_x, table_x, g_sorted_x, spec, BLOCK), None,
             dx_bytes, dx_ops, hj["dnerf_f32"]["launches"]["window_encode_dx_f32"],
             "dnerf, TNGP_MXU_F32=1",
             {"library_call": "none: no single PyTorch call computes the derivative-weight "
                              "encode and its contraction"})):
        row(name, name, launches_n, err, fn_k, fn_p, fn_lib, nbytes, ops, F32_OPS_PER_S,
            path=path, ms_bf16_form=events_ms(fn_bf16),
            shape="phase 4's step shape: xyz4 [{:,}, 4] ({:,} samples)".format(
                xyz4_t.shape[0], n_live_t) if name != "window_encode_dx_f32" else
            f"a D-NeRF step: xyz4 [{xyz4_x.shape[0]}, 4] ({n_live_x} samples)", **extra)

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
    # the nearest single call: torch.mul of the int32 operands by P1 as an
    # int32 wraps as the uint32 product does, but it is one of the
    # function's two products (no XOR, no second product)
    p1 = torch.full_like(xi, int_mul.P1 - (1 << 32))
    if not torch.equal(torch.mul(xi, p1), (xi.long() * int_mul.P1 & 0xFFFFFFFF).to(
            torch.int64).sub((xi.long() * int_mul.P1 & 0x80000000) << 1).to(torch.int32)):
        raise SystemExit("torch.mul of int32 operands does not wrap as the uint32 product")
    row("int_mul_probe", "int_mul_probe", launches_parity["int_mul_probe"], err_int,
        lambda: int_mul.int_mul_hash(xi), lambda: int_mul.int_mul_hash_plain(xi),
        lambda: torch.mul(xi, p1), xi.numel() * 8, xi.numel() * 3, INT32_OPS_PER_S,
        path="device parity", shape="int32 [8, 1024] -> int32 [8, 1024] (exact)",
        library_call="torch.mul of the int32 operands by P1 (wraps as the uint32 product; "
                     "one of the two products, without the XOR: the nearest call, not the "
                     "same function)")
    # the chunked march: a frame's first pass, a training step's shape under
    # `shapes`; launches one a first-pass chunk and a round, one a step
    m_first, m_train = marches["eval_first"], marches["train"]

    def march_plain():
        with kernels.plain_versions():
            return m_first["call"]()

    row("march_chunked", "march_chunked", launches_eval["march_chunked"], 0.0,
        m_first["call"], march_plain, None, m_first["bound_bytes"], 0, INT32_OPS_PER_S,
        path="eval", launches_train=launches_train["march_chunked"],
        plain_ms_train=m_train["plain_ms"],
        shapes={"train": (m_train["call"], m_train["bound_ms"])},
        shape="65,536 rays of an orbit view, G 16, cap 8, M_budget 6,291,456 -> sel, "
              "sel_valid [6,291,456]; train: 16,384 rays, G 8, M_budget 524,288")
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

    # ---- 6c's --profile run, last: after a profile the profiler records
    # nothing more in this process
    prof = profile_cli_run(args.seed)

    # ---- 8. report ---------------------------------------------------------
    smi = card()
    log(f"[result] train {train_rays_s:,.1f} rays/s (tier M {trainer.tier_M}, PSNR {psnr:.2f} dB "
        f"after {psnr_steps} steps); eval 800x800 through the frame renderer "
        f"{R * R / dt_rand:,.1f} rays/s random weights, {R * R / dt_trained:,.1f} rays/s trained "
        f"weights ({st2['valid_samples'] / (R * R):.1f} samples per ray, {st2['rounds']} residual "
        f"rounds, {st2['host_reads']} host reads; chunked {R * R / dt_trained_c:,.1f} rays/s); "
        f"bench_torch.py {bench_line['value']:,.1f} train rays/s, eval800 "
        f"{bench_line['eval800_rays_per_s']:,.1f} rays/s; CLI PSNR {cli['psnr']:.2f} dB, mesh "
        f"{cli['faces']} faces; "
        f"D-NeRF {dnerf_rays_s:,.1f} train rays/s ({1e3 * dt_dnerf / DNERF_TIMED:.2f} ms/step, "
        f"{ratio:.3f}x the pinned NGP step of {1e3 * dt_ngp / DNERF_TIMED:.2f} ms), PSNR "
        f"{psnr_d:.2f} dB over 12 views; golden grid: NGP frame with the background "
        f"{R * R / dt_hash:,.1f} rays/s, D-NeRF default {dd['rays_s']:,.1f} train rays/s "
        f"({1e3 * dd['dt'] / DNERF_TIMED:.2f} ms/step, PSNR {dd['psnr']:.2f} dB), "
        f"D-NeRF CLI PSNR {dcli['psnr']:.2f} dB, NGP tiledgrid + bg CLI PSNR "
        f"{cli['psnr_tiled']:.2f} dB; NGP --no_grid {cli['ms_step_nogrid']:.2f} ms/step (PSNR "
        f"{cli['psnr_nogrid']:.2f} dB), --error_map map moved on {cli['moved_em']:.4f}, --gui "
        f"replies {cli['gui_ms']} ms, --profile trace {prof['trace_bytes']:,} bytes; SDF "
        f"{sdf['ms_step']:.2f} ms/step ({sdf['samples_s']:,.0f} samples/s, host labels "
        f"{sdf['host_share']:.3f} of the step; bf16 {sdf['ms16']:.2f} ms/step), loss "
        f"{sdf['losses'][0]:.5f} -> {sdf['losses'][-1]:.5f}, mesh median radius "
        f"{sdf['radius']:.4f} (sphere {sdf['rad']:.4f}); TensoRF VM {tf['ms1']:.2f} ms/step at "
        f"128, {tf['ms2']:.2f} at {tf['res']} (idle {idle['tensorf_first']:.3f}, "
        f"{idle['tensorf_last']:.3f}), EMA PSNR {tf['psnr']:.2f} dB, CP "
        f"{tf['ms_cp']:.2f} ms/step, CLI PSNR {tf['cli_psnr']:.2f} dB; CCNeRF {cc['ms']:.2f} "
        f"ms/step (idle {idle['ccnerf']:.3f}), full model {cc['psnr_full']:.2f} "
        f"dB; other render paths: "
        + ", ".join(f"{k} {v['ms']:.2f} ms/step" for k, v in paths["train"].items())
        + "; frames " + ", ".join(f"{k} {v['dt']:.3f} s ({v['rounds']} rounds, {v['host_reads']} "
                                   f"host reads)" for k, v in paths["eval"].items())
        + "; CLI PSNR " + ", ".join(f"{k} {v['psnr']:.2f} dB" for k, v in paths["cli"].items())
        + f"; the f32 form: train_hard {hj['hard']['f32']['ms_per_step']:.2f} ms/step, PSNR "
        f"{hj['hard']['f32']['final_psnr']:.2f} dB (bf16 {hj['hard']['bf16']['ms_per_step']:.2f} "
        f"ms/step, {hj['hard']['bf16']['final_psnr']:.2f} dB) after {HARD_STEPS} steps; "
        f"bench_eval {hj['eval']['value']:,.1f} rays/s; NCCL mesh "
        f"{hj['nccl']['ms']['mesh']:.2f} ms/step (unmeshed {hj['nccl']['ms']['plain']:.2f}); "
        f"CLIP step {hj['clip']['ms_step']:.2f} ms"
        + f"; run wall {time.time() - t_run:.1f} s")
    print(f"card: {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
