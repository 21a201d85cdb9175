"""Kernel timing on the card, three numbers per callable, and the kernels
timed with them at the main path's shapes.

    python3 tngp_torch/diagnostics/kernel_times.py [--root DIR] [--seed 0]
        [--train-inputs FILE] [--dnerf-inputs FILE] [--any-inputs FILE]

- `events_ms`: CUDA events around 20 back-to-back calls after 3 warm-ups,
  per call: the wall a caller sees per call, max(host, device);
- `device_ms`: the summed device time of the call's own device operations
  (kernels, memsets, copies) per call, and their count per call, from
  `torch.profiler`'s device events over 20 calls; where the profiler
  records none (it records nothing once an earlier large profile has run
  in the process, as `chip_smoke.py --profile`'s do), CUDA events around
  20 replays of a CUDA graph of one call;
- `host_us`: `time.perf_counter` around 200 calls with no synchronize, per
  call: the enqueue cost.

`chip_smoke.py` phase 7 times every kernel with these.  `main` times the
scatter-adds (payload sort [393,216, 4] -> [425,984, 4], per-ray reduction
[393,216, 5] -> [4096, 5], cotangent sort [131,072, 32] -> [163,840, 32],
round update [1024, 6] -> [4096, 6]), the set-scatter (1,048,576 writes into
128^3 cells), the int-mul probe, the whole bin sort `bin_dest` at the
eval's top width (393,216 samples; a stable `argsort` of their tile keys
beside it), the chunked march at a frame's first pass, a residual round
and a training step (`march_calls` on `march_inputs`), and the encoder
forward, table gradient and input gradient of the flagship spec at four
inputs (`encoder_calls` on `encoder_inputs`: the
eval's top width, a small eval bucket, samples all in one tile, and one
training step's inputs; the input gradient also on one D-NeRF step's)
through whichever `tngp_torch` it imports: `--root DIR` takes the package
from another checkout (say the parent commit's, unpacked into a
git-ignored directory), so two versions of the kernels and of the launch
path are timed on one card in one call.  The training step's inputs come
from `--train-inputs FILE` and the D-NeRF step's from `--dnerf-inputs FILE`
where those files exist; else they are captured (`TRAIN_STEPS` steps of
bench.py's training loop; `DNERF_STEPS` steps of `chip_smoke.py`'s D-NeRF
phase) and saved there with how they were made (a file made with another
seed or step count is refused), so the runs of one call time the same
inputs; keep the files in a git-ignored directory of the checkout, such as
`_archive/`.  With `--any-inputs FILE` it times only the general
scatter-add (`any_input_calls`), on the inputs of every path's calls that
`any_calls.py --save FILE` recorded: the dispatch and each of its designs,
so `--root` A/Bs the form on the paths' own tensors.  It prints the card's
name and power limit and one JSON line (rows carry their bound,
`bound_ms`).  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

import torch

REPS, WARMUP, HOST_CALLS = 20, 3, 200
TRAIN_STEPS = 300  # training steps before the captured table gradient
DNERF_STEPS = 64  # D-NeRF steps before the captured input gradient
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory


def events_ms(fn, reps: int = REPS, warmup: int = WARMUP) -> float:
    """ms per call from CUDA events around `reps` back-to-back calls."""
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """us of host time per call over `calls` calls with no synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def graph_replay_ms(fn, reps: int = REPS) -> float:
    """ms per replay of a CUDA graph captured around one call (warmed on a
    side stream first, as capture requires)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return events_ms(graph.replay, reps)


def device_ms(fn, reps: int = REPS, warmup: int = WARMUP) -> tuple[float, int | None, str]:
    """(device ms per call, device events per call, method): per distinct
    device-side event (kernel, memset, copy) that `torch.profiler` records
    over `reps` calls, its mean duration times its count per call, summed
    (means per event keep the number right where the profiler drops a few
    events); where it records none, `graph_replay_ms` (events unknown).
    The profiler's host cost lingers in the process, so a caller takes
    these after its other timings."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # device-side events only: the aten ops above them report the same time
    # again, and the program's spans' device-side rows cover their kernels
    cuda_t = torch.autograd.DeviceType.CUDA
    evs = [e for e in prof.key_averages() if e.device_type == cuda_t and e.device_time_total > 0
           and not e.key.startswith("tngp.")]
    if not evs:
        return graph_replay_ms(fn, reps), None, "graph replay"
    per_call = [max(1, round(e.count / reps)) for e in evs]
    return (sum(e.device_time_total / e.count * k for e, k in zip(evs, per_call)) / 1e3,
            sum(per_call), "profiler")


def card() -> str:
    """`nvidia-smi`'s name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def scatter_calls(seed: int = 0) -> dict:
    """name -> (kernel call, `index_add_` / `index_put_` call) at the main
    path's shapes, through the imported package's wrappers (a package whose
    `scatter_add` takes no `indices` runs its one form)."""
    from tngp_torch.diagnostics import bench_grid_update as bg
    from tngp_torch.kernels import int_mul
    from tngp_torch.kernels import scatter as ks
    from tngp_torch.kernels import window_encoder as kw

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(seed)
    stated = "indices" in inspect.signature(ks.scatter_add).parameters

    def add(idx, vals, rows, indices):
        kwargs = {"indices": indices} if stated else {}
        return (lambda: ks.scatter_add(idx, vals, rows, **kwargs),
                lambda: torch.zeros((rows, vals.shape[1]), device=dev).index_add_(0, idx, vals))

    M, Mt, N, Na = 393_216, 131_072, 4096, 1024
    x01 = torch.rand((3, M), generator=gen).to(dev)
    dest = kw.bin_dest(x01)[0]
    payload = torch.cat([x01, torch.ones((1, M), device=dev)]).T.contiguous()
    dest_t = kw.bin_dest(torch.rand((3, Mt), generator=gen).to(dev))[0]
    g_rows = torch.randn((Mt, 32), generator=gen).to(dev)
    rid = torch.sort(torch.randint(0, N, (M,), generator=gen)).values.to(dev)
    alive = torch.rand(N, generator=gen) < 0.2
    sel = torch.full((Na,), N - 1, dtype=torch.int64)
    live = torch.nonzero(alive)[:Na, 0]
    sel[:live.numel()] = live
    H3 = bg.H**3
    idx_s, vals_s = bg.scatter_inputs(H3, 2 * (H3 // 4), torch.Generator(device=dev)
                                      .manual_seed(seed + 1))
    xi = torch.arange(1 << 13, dtype=torch.int32, device=dev).reshape(8, -1)
    return {
        "payload_sort_unique_C4": add(dest, payload, kw.padded_size(M, kw.DEFAULT_BLOCK),
                                      "unique"),
        "per_ray_sorted_C5": add(rid, torch.rand((M, 5), generator=gen).to(dev), N, "sorted"),
        "cotangent_sort_unique_C32": add(dest_t, g_rows, kw.padded_size(Mt, kw.DEFAULT_BLOCK),
                                         "unique"),
        "round_update_sorted_C6": add(sel.to(dev), torch.rand((Na, 6), generator=gen).to(dev),
                                      N, "sorted"),
        "scatter_set": (lambda: ks.scatter_set_flat(idx_s, vals_s, H3),
                        lambda: torch.full((H3,), -1.0, device=dev).index_put_((idx_s,), vals_s)),
        "int_mul_probe": (lambda: int_mul.int_mul_hash(xi), None),
    }


def any_input_calls(path: str) -> dict:
    """name -> (kernel call, `index_add_` call, bound ms) of the general
    scatter-add on each call's inputs that `any_calls --save` wrote to
    `path`: the dispatch under the call's label, and each design of the form
    under "<label> <design>" where the imported package has them
    (`any_designs`).  The bound is bytes: idx (8 B) and vals (4C B) read
    once, the output (4C B a row) written once."""
    from tngp_torch.kernels import scatter as ks

    dev = torch.device("cuda")
    designs = getattr(ks, "any_designs", lambda n, C, rows: [])
    out = {}
    for label, (idx, vals, rows) in torch.load(path).items():
        idx, vals = idx.to(dev), vals.to(dev)
        n, C = vals.shape
        lib_idx = torch.where((idx >= 0) & (idx < rows), idx, rows)  # one overflow row
        b_ms = (n * (8 + 4 * C) + rows * C * 4) / HBM_BYTES_PER_S * 1e3
        out[label] = (
            lambda i=idx, v=vals, r=rows: ks.scatter_add(i, v, r, indices="any"),
            lambda i=lib_idx, v=vals, r=rows: torch.zeros((r + 1, v.shape[1]), device=dev)
            .index_add_(0, i, v),
            b_ms)
        for f in designs(n, C, rows):
            out[f"{label} {f}"] = (
                lambda i=idx, v=vals, r=rows, f=f: ks.scatter_add_any_as(i, v, r, f), None, b_ms)
    return out


def bin_dest_bytes(M: int, block: int) -> int:
    """Bytes the bin sort must move: x01 in (12 B) and dest out (8 B) per
    sample, the 64-bin histogram of each 512-key block (256 B) and tob out
    (8 B per block)."""
    from tngp_torch.kernels import window_encoder as kw

    return M * 20 + -(-M // 512) * 256 + kw.padded_size(M, block) // block * 8


def bin_dest_calls(seed: int = 0) -> dict:
    """name -> (call, stable `argsort` of the same tile keys, bound ms): the
    whole bin sort at the eval's top width (393,216 uniform samples)."""
    from tngp_torch.kernels import window_encoder as kw
    from tngp_torch.ops.window_table import sample_tiles

    gen = torch.Generator(device="cpu").manual_seed(seed + 4)
    M = 393_216
    x01 = torch.rand((3, M), generator=gen).to("cuda")
    keys = sample_tiles(x01)
    return {"bin_dest_top": (lambda: kw.bin_dest(x01), lambda: torch.argsort(keys, stable=True),
                             bin_dest_bytes(M, kw.DEFAULT_BLOCK) / HBM_BYTES_PER_S * 1e3)}


MARCH_CASES = ("eval_first", "eval_round", "train")


def march_inputs(case: str, device="cuda", seed: int = 0) -> tuple[tuple, dict]:
    """(args, kwargs) of `march_rays_chunked` at a main path's shape, on a
    128^3 grid (bound 1, max_steps 1024) whose occupancy is a ball of radius
    0.55 and 2% scattered cells: "eval_first", an 800x800 frame's first pass
    (a 256x256 orbit view: 65,536 rays, G 16, the cap of 8 live chunks a
    ray, 96 samples a ray, `eval_cb_mult` 6); "eval_round", a residual round
    at the 16,384-ray tier (every fourth ray of that view from 0.4 of its box
    segment, a 256-rung ladder window, 32 samples a ray); "train", a TensoRF
    training step (16,384 rays from the orbit sphere to random points of the
    box, noise, G 8, a budget of 524,288 samples)."""
    import torch.nn.functional as F

    from tngp_torch.data.rays import full_image_rays
    from tngp_torch.data.synthetic import orbit_poses
    from tngp_torch.ops.grid_utils import packbits
    from tngp_torch.ops.march import build_dilated_cell_grid, chunk_dilate
    from tngp_torch.ops.rays import near_far_from_aabb

    if case not in MARCH_CASES:
        raise ValueError(f"unknown march case {case!r}: one of {MARCH_CASES}")
    gen = torch.Generator(device="cpu").manual_seed(seed)
    H, bound, S = 128, 1.0, 1024
    ax = (torch.arange(H) + 0.5) / H * 2.0 - 1.0
    gx, gy, gz = torch.meshgrid(ax, ax, ax, indexing="ij")
    occ = (gx**2 + gy**2 + gz**2 < 0.55**2) | (torch.rand((H, H, H), generator=gen) < 0.02)
    bitfield = packbits(occ.reshape(-1).float(), 0.5).to(device)
    noise = None
    if case == "train":
        N, G = 16_384, 8
        o = 2.35 * F.normalize(torch.randn((N, 3), generator=gen), dim=1)
        d = F.normalize(torch.rand((N, 3), generator=gen) * 1.6 - 0.8 - o, dim=1)
        noise = torch.rand((N,), generator=gen).to(device)
    else:
        G = 16
        pose = orbit_poses(16, radius=2.35, elevation=0.3)[seed % 16]
        o, d = full_image_rays(pose, [230.0, 230.0, 128.0, 128.0], 256, 256, device="cpu")
        if case == "eval_round":
            o, d = o[::4].contiguous(), d[::4].contiguous()
    o, d = o.to(device), d.to(device)
    nears, fars = near_far_from_aabb(o, d, (-bound,) * 3 + (bound,) * 3, 0.05)
    N = o.shape[0]
    kw = dict(bound=bound, cascades=1, grid_size=H, dt_gamma=0.0, max_steps=S, G=G,
              dilated_grid=build_dilated_cell_grid(bitfield, bound=bound, cascades=1,
                                                   grid_size=H,
                                                   dilate=chunk_dilate(G, S, H, bound)))
    if case == "eval_first":
        M = N * 96
        kw.update(M_budget=M, chunk_budget=-(-int(6.0 * M) // G), ray_chunk_cap=8)
        t_start = nears
    elif case == "eval_round":
        kw.update(M_budget=N * 32, ladder_steps=256, ray_chunk_cap=8)
        t_start = nears + 0.4 * (fars - nears)
    else:
        kw.update(M_budget=524_288, noise=noise)
        t_start = nears
    return (o, d, t_start, fars, bitfield), kw


def march_bytes(N: int, M: int, noise: bool = False) -> int:
    """Bytes the chunked march must move: sel (8 B) and sel_valid (1 B)
    over the budget M and the two counts written; a ray's origin and
    direction (24 B), t_start and far (8 B) and noise (4 B) read, its t0,
    resume_t (8 B) and ray_mask (1 B) written.  The grids it probes are
    L2-resident and not counted."""
    return M * 9 + 16 + N * (24 + 8 + (4 if noise else 0) + 9)


def march_calls(seed: int = 0) -> dict:
    """name -> (call, None, bound ms): the chunked march through the
    imported package's `march_rays_chunked` at `march_inputs`'s cases."""
    from tngp_torch.ops.march import march_rays_chunked

    out = {}
    for case in MARCH_CASES:
        args, kw = march_inputs(case, seed=seed)
        nbytes = march_bytes(args[0].shape[0], kw["M_budget"], kw.get("noise") is not None)
        out[f"march_chunked_{case}"] = (
            lambda a=args, k=kw: march_rays_chunked(*a, **k), None,
            nbytes / HBM_BYTES_PER_S * 1e3)
    return out


def _load_made(path: str, seed: int, steps_key: str, steps: int):
    """The tensors saved at `path`, refused unless made with `seed` after
    `steps` steps; None where there is no file."""
    if not (path and os.path.exists(path)):
        return None
    d = torch.load(path, map_location="cuda")
    made = d.get("made", {})
    print(f"inputs: {path} made by {made}")
    if made.get("seed") != seed or made.get(steps_key) != steps:
        raise SystemExit(f"{path} holds inputs made by {made}, not seed {seed} after "
                         f"{steps} steps: remove it or pass another path")
    return d


def _save_made(path: str | None, tensors: dict, seed: int, steps_key: str, steps: int) -> None:
    import tngp_torch

    if path:
        made = {"seed": seed, steps_key: steps,
                "package": os.path.dirname(tngp_torch.__file__), "time": time.ctime()}
        torch.save({**tensors, "made": made}, path)
        print(f"inputs: saved to {path}, made by {made}")


def dnerf_inputs(path: str | None, seed: int = 0):
    """(xyz4, wob, table, g_sorted) that one D-NeRF step gave the input
    gradient: loaded from `path` where it exists, else captured after
    DNERF_STEPS steps of `chip_smoke.py`'s D-NeRF phase (the flagship encoder
    with position gradients, the 5x128 deform MLP, 12 views of 128x128 of the
    dynamic blob scene, 4096 rays/step, bench.py's render config, a 16 x
    128^3 time grid) and saved to `path` if one is given, as `train_inputs`
    saves its own."""
    d = _load_made(path, seed, "dnerf_steps", DNERF_STEPS)
    if d is not None:
        return d["xyz4"], d["wob"], d["table"], d["g_sorted"]
    from tngp_torch.data import make_synthetic_dynamic_dataset
    from tngp_torch.kernels import window_encoder as kw
    from tngp_torch.models import DNeRFNetwork
    from tngp_torch.render import RenderConfig
    from tngp_torch.train import DNeRFTrainer
    from tngp_torch.utils import TrainConfig

    dev = torch.device("cuda")
    dds = make_synthetic_dynamic_dataset(n_frames=12, H=128, W=128, seed=0, device=dev)
    cfg = RenderConfig(bound=1.0, grid_size=128, max_steps=512, K=128, min_near=0.05,
                       compact_fraction=0.25, density_thresh=1.0, march_dense=True)
    model = DNeRFNetwork(bound=1.0, encoding="hashgrid_window", compute_dtype=torch.bfloat16,
                         device=dev, seed=seed)
    tr = DNeRFTrainer(model, dds, cfg, TrainConfig(num_rays=4096, iters=100_000,
                                                   adaptive_budget=False, seed=seed,
                                                   use_checkpoint="scratch"),
                      time_size=16, update_interval=16, device=dev)
    tr.run_steps(DNERF_STEPS)
    captured = {}
    real = kw.window_encode_dx

    def capturing(xyz4, wob, table, g_sorted, *a, **k):
        captured["args"] = tuple(t.detach() for t in (xyz4, wob, table, g_sorted))
        return real(xyz4, wob, table, g_sorted, *a, **k)

    kw.window_encode_dx = capturing
    try:
        tr.run_steps(1)
    finally:
        kw.window_encode_dx = real
    args = captured["args"]
    _save_made(path, dict(zip(("xyz4", "wob", "table", "g_sorted"), args)), seed,
               "dnerf_steps", DNERF_STEPS)
    return args


def encoder_bytes(direction: str, xyz4, wob, spec, block: int) -> int:
    """Bytes the encoder function must move.  Per sample: xyz4 (16 B) and
    its L*C features (out for "fwd", cotangents in for "bwd" and "dx"; "dx"
    also writes 12 B of gx); wob once.  The table: "bwd" writes all of it
    once; "fwd" and "dx" read each entry (window, channel, row) that a live
    sample's corner weighs with a nonzero (derivative) weight once, which at
    a small width is far less than the windows the blocks visit."""
    from tngp_torch.kernels import window_encoder as kw

    L, C = spec.num_levels, spec.level_dim
    per_sample = 16 + 4 * L * C + (12 if direction == "dx" else 0)
    if direction == "bwd":
        table_entries = spec.n_windows * C * 8192
    else:
        table_entries = 0
        for l in range(L):
            geo = kw.sorted_corner_addresses(xyz4, wob, spec, block, l, deriv=direction == "dx")
            used = geo[2].ne(0).any(0) if direction == "dx" else geo[1].ne(0)
            table_entries += int(torch.unique(geo[0][used]).numel()) * C
    return xyz4.shape[0] * per_sample + wob.numel() * 4 + table_entries * 4


def bench_trainer(seed: int = 0, **render):
    """A trainer of bench.py's loop on the card, untrained: the flagship
    network, 12 views of 128x128 of the blob scene, 4096 rays/step;
    `render` overrides fields of its `RenderConfig`."""
    from tngp_torch.data import make_synthetic_dataset
    from tngp_torch.models import NGPNetwork
    from tngp_torch.render import RenderConfig
    from tngp_torch.train import Trainer
    from tngp_torch.utils import TrainConfig

    dev = torch.device("cuda")
    ds = make_synthetic_dataset(n_frames=12, H=128, W=128, seed=0, device=dev)
    cfg = RenderConfig(bound=1.0, grid_size=128, max_steps=512, K=128, min_near=0.05,
                       compact_fraction=0.25, density_thresh=1.0, march_dense=True, **render)
    return Trainer(NGPNetwork(encoding="hashgrid_window",
                              bound=1.0, compute_dtype=torch.bfloat16, device=dev, seed=seed),
                   ds, cfg, TrainConfig(num_rays=4096, lr=1e-2, seed=seed,
                                        adaptive_overdrive=False, use_checkpoint="scratch"),
                   device=dev, constant_lr=True, full_grid_updates=2)


def captured_bwd_inputs(tr):
    """(xyz4, wob, g_sorted) that the table gradient of `tr`'s next step
    is given (the step is taken)."""
    from tngp_torch.kernels import window_encoder as kw

    captured = {}
    real = kw.window_encode_bwd

    def capturing(xyz4, wob, g_sorted, *a, **k):
        captured["args"] = (xyz4.detach(), wob, g_sorted.detach())
        return real(xyz4, wob, g_sorted, *a, **k)

    kw.window_encode_bwd = capturing
    try:
        tr.run_steps(1)
    finally:
        kw.window_encode_bwd = real
    return captured["args"]


def train_inputs(path: str | None, seed: int = 0):
    """(xyz4, wob, g_sorted) that one training step gave the table gradient:
    loaded from `path` where it exists, else captured after TRAIN_STEPS
    steps of bench.py's loop (the flagship network, 12 views of 128x128 of
    the blob scene, 4096 rays/step) and saved to `path` if one is given,
    with what made it (seed, steps, capturing package, time).  A file made
    with another seed or step count is refused."""
    d = _load_made(path, seed, "train_steps", TRAIN_STEPS)
    if d is not None:
        return d["xyz4"], d["wob"], d["g_sorted"]
    tr = bench_trainer(seed)
    tr.run_steps(TRAIN_STEPS)
    xyz4, wob, g_sorted = captured_bwd_inputs(tr)
    _save_made(path, {"xyz4": xyz4, "wob": wob, "g_sorted": g_sorted}, seed, "train_steps",
               TRAIN_STEPS)
    return xyz4, wob, g_sorted


# label -> (samples, scale of the uniform x01 draw): the eval's top width
# (M_pad 425,984), a small eval bucket (M_pad 36,864, mostly padding) and
# every sample in one tile
ENCODER_INPUTS = {"top": (393_216, 1.0), "small_bucket": (4096, 1.0), "crowded": (131_072, 0.24)}


def encoder_inputs(seed: int = 0, labels=tuple(ENCODER_INPUTS)) -> dict:
    """label -> (xyz4, wob, g_sorted) of the flagship spec for each of
    `labels` (`ENCODER_INPUTS`), sorted as `window_encode_binned` sorts
    them, with N(0, 1) cotangents; the same tensors for the same seed."""
    from tngp_torch.kernels import window_encoder as kw
    from tngp_torch.ops.window_table import WindowSpec

    dev = torch.device("cuda")
    spec = WindowSpec.create(desired_resolution=2048)
    L, C, block = spec.num_levels, spec.level_dim, kw.DEFAULT_BLOCK
    gen = torch.Generator(device="cpu").manual_seed(seed + 3)
    out = {}
    for label, (m, scale) in ENCODER_INPUTS.items():
        x01 = (torch.rand((3, m), generator=gen) * scale).to(dev)
        g = torch.randn((kw.padded_size(m, block), L * C), generator=gen).to(dev)
        if label not in labels:
            continue
        dest, tob = kw.bin_dest(x01)
        payload = torch.cat([x01, torch.ones((1, m), device=dev)]).T
        xyz4 = torch.zeros((g.shape[0], 4), device=dev).index_copy_(0, dest, payload)
        out[label] = (xyz4, kw._wob_local(spec, tob), g)
    return out


def encoder_calls(seed: int = 0, train=None, table=None, inputs=None, dnerf=None) -> dict:
    """name -> (kernel call, None, bound ms): the encoder forward, table
    gradient and input gradient of the flagship spec on `table` (749
    windows; default a table drawn as the init draws it) at each of
    `inputs` (label -> (xyz4, wob, g_sorted); default `encoder_inputs(seed)`),
    the forward and table gradient at `train`, one training step's (xyz4,
    wob, g_sorted), and the input gradient at `dnerf`, one D-NeRF step's
    (xyz4, wob, table, g_sorted), where given."""
    from tngp_torch.kernels import window_encoder as kw
    from tngp_torch.ops.window_table import WindowSpec

    dev = torch.device("cuda")
    spec = WindowSpec.create(desired_resolution=2048)
    block = kw.DEFAULT_BLOCK
    if table is None:
        gen = torch.Generator(device="cpu").manual_seed(seed + 2)
        table = (torch.rand((spec.n_windows, spec.level_dim, 128, 64), generator=gen) * 2e-4
                 - 1e-4).to(dev)

    def bound(direction, xyz4, wob):
        return encoder_bytes(direction, xyz4, wob, spec, block) / HBM_BYTES_PER_S * 1e3

    def dx_call(xyz4, wob, tab, g_sorted):
        return (lambda: kw.window_encode_dx(xyz4, wob, tab, g_sorted, spec, block), None,
                bound("dx", xyz4, wob))

    calls = {}
    inputs = dict(encoder_inputs(seed) if inputs is None else inputs)
    for shape, (xyz4, wob, g_sorted) in inputs.items():
        calls[f"window_encode_dx_{shape}"] = dx_call(xyz4, wob, table, g_sorted)
    if train is not None:
        inputs["train"] = train
    for shape, (xyz4, wob, g_sorted) in inputs.items():
        calls[f"window_encode_fwd_{shape}"] = (
            lambda xyz4=xyz4, wob=wob: kw.window_encode_fwd(xyz4, wob, table, spec, block), None,
            bound("fwd", xyz4, wob))
        calls[f"window_encode_bwd_{shape}"] = (
            lambda xyz4=xyz4, wob=wob, g_sorted=g_sorted:
                kw.window_encode_bwd(xyz4, wob, g_sorted, spec, block), None,
            bound("bwd", xyz4, wob))
    if dnerf is not None:
        calls["window_encode_dx_dnerf"] = dx_call(*dnerf)
    return calls


def main(seed: int = 0, train_path: str | None = None, dnerf_path: str | None = None,
         any_path: str | None = None) -> int:
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA card visible; this run needs one", file=sys.stderr)
        return 2
    import tngp_torch

    if any_path:
        calls = any_input_calls(any_path)
    else:
        calls = {name: (k, lib, None) for name, (k, lib) in scatter_calls(seed).items()}
        calls.update(bin_dest_calls(seed))
        calls.update(march_calls(seed))
        calls.update(encoder_calls(seed, train_inputs(train_path, seed),
                                   dnerf=dnerf_inputs(dnerf_path, seed)))
    rows = {name: dict(ms=events_ms(k), host_us=host_us(k), bound_ms=b_ms,
                       library_ms=None if lib is None else events_ms(lib),
                       library_host_us=None if lib is None else host_us(lib))
            for name, (k, lib, b_ms) in calls.items()}
    for name, (k, lib, _) in calls.items():
        (rows[name]["device_ms"], rows[name]["device_events"],
         rows[name]["device_ms_method"]) = device_ms(k)
        if lib is not None:
            rows[name]["library_device_ms"] = device_ms(lib)[0]
    print(f"card: {card()}")
    print(json.dumps({"package": os.path.dirname(tngp_torch.__file__), "times": rows}))
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None,
                    help="import tngp_torch from this checkout (default: this one)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train-inputs", default=None,
                    help="load one training step's table-gradient inputs from this file, "
                         "or capture and save them there where it does not exist")
    ap.add_argument("--dnerf-inputs", default=None,
                    help="load one D-NeRF step's input-gradient inputs from this file, "
                         "or capture and save them there where it does not exist")
    ap.add_argument("--any-inputs", default=None,
                    help="time only the general scatter-add, on the calls' inputs that "
                         "`any_calls --save` wrote to this file")
    args = ap.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, os.path.abspath(args.root) if args.root else here)
    sys.exit(main(args.seed, args.train_inputs, args.dnerf_inputs, args.any_inputs))
