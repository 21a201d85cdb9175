"""Kernel timing on the card, three numbers per callable, and the scatter
kernels timed with them at the main path's shapes.

    python3 tngp_torch/diagnostics/kernel_times.py [--root DIR] [--seed 0]

- `events_ms`: CUDA events around 20 back-to-back calls after 3 warm-ups,
  per call: the wall a caller sees per call, max(host, device);
- `device_ms`: the summed device time of the call's own kernels, memsets
  included, per call, from `torch.profiler`'s device events over 20 calls;
  where the profiler records none (it records nothing once an earlier
  large profile has run in the process, as `chip_smoke.py --profile`'s
  do), CUDA events around 20 replays of a CUDA graph of one call;
- `host_us`: `time.perf_counter` around 200 calls with no synchronize, per
  call: the enqueue cost.

`chip_smoke.py` phase 7 times every kernel with these.  `main` times the
scatter-adds (payload sort [393,216, 4] -> [425,984, 4], per-ray reduction
[393,216, 5] -> [4096, 5], cotangent sort [131,072, 32] -> [163,840, 32],
round update [1024, 6] -> [4096, 6]), the set-scatter (1,048,576 writes into
128^3 cells) and the int-mul probe through whichever `tngp_torch` it
imports: `--root DIR` takes the package from another checkout (say the
parent commit's, unpacked into a git-ignored directory), so two versions of
the kernels and of the launch path are timed on one card in one call.  It
prints the card's name and power limit and one JSON line.  It needs a
CUDA card.
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
    # device-side events only: the aten ops above them report the same time again
    cuda_t = torch.autograd.DeviceType.CUDA
    evs = [e for e in prof.key_averages() if e.device_type == cuda_t and e.device_time_total > 0]
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


def main(seed: int = 0) -> int:
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA card visible; this run needs one", file=sys.stderr)
        return 2
    import tngp_torch

    calls = scatter_calls(seed)
    rows = {name: dict(ms=events_ms(k), host_us=host_us(k),
                       library_ms=None if lib is None else events_ms(lib),
                       library_host_us=None if lib is None else host_us(lib))
            for name, (k, lib) in calls.items()}
    for name, (k, lib) in calls.items():
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
    args = ap.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, os.path.abspath(args.root) if args.root else here)
    sys.exit(main(args.seed))
