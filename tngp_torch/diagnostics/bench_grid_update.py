"""Stage breakdown of a partial density-grid update on the card — the port of
`scripts/bench_grid_update.py`.

    python -m tngp_torch.diagnostics.bench_grid_update [--seed 0]

At the script's full width: H = 128 (H^3 = 2,097,152 cells), N = H^3 / 4
draws per half, the flagship `NGPNetwork(bound=1, bf16, hashgrid_window)`
with random weights from `--seed` (its own `torch.Generator`), on a grid
with about 10% of its cells occupied (density 20 u where u < 0.1, one
uniform u per cell, as the script makes it).  Each stage is timed between
CUDA events on the stream: 2 warm-up calls, then the mean of 10, every call
with fresh draws from one generator on the card.

  1. density query of 2N jittered points at random cells
     (`_cells_to_world_cf`, then `_chunked_density` in chunks of 2^17);
  2. the occupied-cell inverse CDF of N uniforms (`_occupied_rank_descend`);
  3. the set-scatter of 2N random values at random cells into H^3 cells,
     in three forms: the kernel (`scatter_set_flat`), its plain version and
     `index_put_`.  The kernel must equal the plain version exactly.
     `index_put_` leaves the winner of a repeated index unspecified, so it
     is held to less: a cell written at most once must match, a repeated
     cell must hold one of its candidate values, and how many repeated
     cells differ from the kernel is reported;
  4. a whole partial update, `update_density_grid(full=False)`, in the
     `resample` and the `slab` mode (density_thresh 10).

`main` prints one line per stage and returns the stage times and the checks
(`BenchReport`); its `rc` is non-zero if a check failed.  It needs a CUDA
card: on the CPU it would time PyTorch's CPU kernels.  The stage functions
take the network and H, so a test can run them small on the CPU.  Left out
from the JAX script: its salt argument (it only defeats JAX's caching of a
jitted call whose inputs do not change) and its jitted closures (PyTorch
runs eagerly).
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import replace
from typing import Callable, NamedTuple

import torch

from ..kernels.scatter import scatter_set_flat, scatter_set_flat_plain
from ..models import NGPNetwork
from ..render import FieldFns, OccupancyGrid, create, update_density_grid
from ..render.occupancy import (
    _cells_to_world_cf,
    _chunked_density,
    _idx_coords_cf,
    _sample_occupied_cells,
)

H = 128  # grid side
CHUNK = 2**17  # density-query chunk
DENSITY_THRESH = 10.0
WARMUP, ITERS = 2, 10
# the kernels this bench's stages launch (a caller checks that each ran)
KERNELS = ("scatter_set", "bin_dest", "scatter_add_unique", "window_encode_fwd")


class BenchReport(NamedTuple):
    rc: int  # 0 if every check passed
    times_ms: dict  # stage -> mean device ms per call
    checks: dict  # the set-scatter comparison (`compare_scatters`)
    scatter_args: tuple  # (idx, vals) that stage 3 scattered and compared


def occupied_grid(grid_size: int, generator: torch.Generator) -> OccupancyGrid:
    """A one-cascade grid with ~10% of its cells occupied."""
    u = torch.rand((1, grid_size**3), generator=generator, device=generator.device)
    grid = create(1, grid_size, device=generator.device)
    return replace(grid, density_grid=torch.where(u < 0.1, u * 20.0, 0.0))


@torch.no_grad()
def density_query(density_fn: Callable, grid_size: int,
                  generator: torch.Generator) -> torch.Tensor:
    """Density [2N] at 2N = 2 (H^3 // 4) random cells, jittered in the cell."""
    H3 = grid_size**3
    n2 = 2 * (H3 // 4)
    dev = generator.device
    idx = torch.randint(0, H3, (n2,), generator=generator, device=dev)
    jitter = torch.rand((3, n2), generator=generator, device=dev) * 2.0 - 1.0
    xyz = _cells_to_world_cf(_idx_coords_cf(idx, grid_size), 0, 1.0, grid_size, jitter)
    return _chunked_density(density_fn, None, xyz, CHUNK)


def occupied_cells(grid: OccupancyGrid, generator: torch.Generator) -> torch.Tensor:
    """N = H^3 // 4 cells [N] drawn uniformly over the occupied ones."""
    occ = grid.density_grid[0] > 0
    u01 = torch.rand((occ.shape[0] // 4,), generator=generator, device=generator.device)
    return _sample_occupied_cells(occ, u01)[0]


def scatter_inputs(num_cells: int, n: int, generator: torch.Generator):
    """(idx [n] int64 uniform over the cells, vals [n] f32 uniform in [0, 1))."""
    dev = generator.device
    idx = torch.randint(0, num_cells, (n,), generator=generator, device=dev)
    return idx, torch.rand((n,), generator=generator, device=dev)


def scatter_forms(idx: torch.Tensor, vals: torch.Tensor, num_cells: int) -> dict:
    """The three set-scatters of stage 3, as callables."""
    return {
        "kernel": lambda: scatter_set_flat(idx, vals, num_cells),
        "plain": lambda: scatter_set_flat_plain(idx, vals, num_cells),
        "index_put_": lambda: torch.full((num_cells,), -1.0, device=vals.device)
        .index_put_((idx,), vals),
    }


def compare_scatters(idx: torch.Tensor, vals: torch.Tensor, kernel: torch.Tensor,
                     plain: torch.Tensor, lib: torch.Tensor) -> dict:
    """Stage 3's comparison.  `mismatches` and `max_abs_err` (kernel vs
    plain), `single_mismatches` (cells written at most once, `index_put_` vs
    kernel) and `not_candidate` (repeated cells where `index_put_` holds none
    of the cell's values) must be 0; `written_cells`, `dup_cells` and
    `dup_differ` (repeated cells where `index_put_` kept another write than
    the last) are a report."""
    valid = idx >= 0
    cells, v = idx[valid], vals[valid]
    counts = torch.bincount(cells, minlength=kernel.shape[0])
    dup = counts > 1
    candidate = torch.zeros_like(dup).index_put_((cells[v == lib[cells]],),
                                                 torch.ones((), dtype=torch.bool,
                                                            device=dup.device))
    differ = lib != kernel
    return dict(
        mismatches=int((kernel != plain).sum()),
        max_abs_err=float((kernel - plain).abs().max()),
        written_cells=int((counts > 0).sum()),
        single_mismatches=int((~dup & differ).sum()),
        not_candidate=int((dup & ~candidate).sum()),
        dup_cells=int(dup.sum()),
        dup_differ=int((dup & differ).sum()),
    )


def checks_pass(checks: dict) -> bool:
    return checks["mismatches"] == checks["single_mismatches"] == checks["not_candidate"] == 0


def partial_update(grid: OccupancyGrid, density_fn: Callable, grid_size: int,
                   generator: torch.Generator, mode: str) -> OccupancyGrid:
    """Stage 4: one partial update (`resample` or `slab`) of `grid`."""
    return update_density_grid(grid, None, generator, grid_size=grid_size, full=False,
                               partial_mode=mode, density_fn=density_fn, bound=1.0,
                               density_thresh=DENSITY_THRESH, chunk=CHUNK)


def timed(fn: Callable):
    """(mean device ms of one call, the last call's result): WARMUP calls,
    then ITERS calls between two CUDA events on the current stream."""
    for _ in range(WARMUP):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(ITERS):
        out = fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / ITERS, out


def main(device="cuda", seed: int = 0) -> BenchReport:
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the grid-update bench times the card: it needs a CUDA device")
    H3, N = H**3, H**3 // 4
    with torch.cuda.device(device):
        print(f"# device: {torch.cuda.get_device_name(device)}", flush=True)
        model = NGPNetwork(encoding="hashgrid_window",
                           bound=1.0, compute_dtype=torch.bfloat16, device=device, seed=seed)
        field = FieldFns.from_model(model)
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        grid = occupied_grid(H, gen)
        occ_frac = float((grid.density_grid > 0).float().mean())
        print(f"# H = {H} ({H3:,} cells, {occ_frac:.4f} occupied), N = {N:,}", flush=True)
        times = {}

        def stage(name, label, fn):
            times[name], out = timed(fn)
            print(f"{label:34s} {times[name]:9.3f} ms", flush=True)
            return out

        stage("density_query", f"density query 2N = {2 * N:,}:",
              lambda: density_query(field.density, H, gen))
        stage("occupied_cdf", f"occupied inverse CDF, N = {N:,}:",
              lambda: occupied_cells(grid, gen))
        idx, vals = scatter_inputs(H3, 2 * N, gen)
        outs = {name: stage(f"scatter_{name}", f"set-scatter 2N, {name}:", fn)
                for name, fn in scatter_forms(idx, vals, H3).items()}
        checks = compare_scatters(idx, vals, outs["kernel"], outs["plain"], outs["index_put_"])
        print(f"# set-scatter: kernel vs plain {checks['mismatches']} mismatches; vs "
              f"index_put_ {checks['single_mismatches']} mismatches on cells written at "
              f"most once, {checks['dup_cells']:,} repeated cells of which "
              f"{checks['dup_differ']:,} keep another write, {checks['not_candidate']} "
              f"hold no candidate", flush=True)
        for mode in ("resample", "slab"):
            stage(f"partial_{mode}", f"partial update ({mode}):",
                  lambda mode=mode: partial_update(grid, field.density, H, gen, mode))
    ok = checks_pass(checks)
    print(f"# GRID-UPDATE BENCH {'OK' if ok else 'FAIL'}", flush=True)
    return BenchReport(0 if ok else 1, times, checks, (idx, vals))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    sys.exit(main(seed=ap.parse_args().seed).rc)
