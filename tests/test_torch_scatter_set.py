"""Port parity: `tngp_torch.kernels.scatter.scatter_set_flat` against the JAX
package's set-scatter.  On the CPU the port takes its plain version; it must
equal, exactly, the TPU kernel body `_scatter_set_kernel` run in interpret
mode, `scatter_set_flat_auto` (XLA's set on the CPU) and a sequential numpy
loop.  Also the stage functions of `tngp_torch.diagnostics.bench_grid_update`
at H = 16 on a small network."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tngp.kernels.scatter import _SET_BLK, _scatter_set_kernel
from tngp.kernels.scatter import scatter_set_flat as jax_scatter_set_flat
from tngp.kernels.scatter import scatter_set_flat_auto
from tngp_torch.diagnostics import bench_grid_update as bg
from tngp_torch.kernels.scatter import scatter_set_flat, scatter_set_flat_plain
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _interpret_kernel(idx, vals, num_cells, init):
    """`tngp.kernels.scatter.scatter_set_flat` with `interpret=True`: its
    padding, skip routing and specs (`scatter.py:212-235`), which the JAX
    function does not expose."""
    M = idx.shape[0]
    pad = (-M) % _SET_BLK
    idx = jnp.asarray(idx, jnp.int32)
    vals = jnp.asarray(vals, jnp.float32)
    if pad:
        idx = jnp.concatenate([idx, jnp.full((pad,), -1, jnp.int32)])
        vals = jnp.concatenate([vals, jnp.zeros((pad,), jnp.float32)])
    idx = jnp.where(idx < 0, num_cells, idx)
    rows = num_cells // 128 + 1
    out2 = pl.pallas_call(
        _scatter_set_kernel,
        grid=(idx.shape[0] // _SET_BLK,),
        in_specs=[
            pl.BlockSpec((_SET_BLK,), lambda i: (i,), memory_space=pltpu.SMEM),
            pl.BlockSpec((_SET_BLK,), lambda i: (i,), memory_space=pltpu.SMEM),
            pl.BlockSpec(memory_space=pltpu.SMEM),
        ],
        out_specs=pl.BlockSpec((rows, 128), lambda i: (0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((rows, 128), jnp.float32),
        interpret=True,
    )(idx, vals, jnp.full((1,), init, jnp.float32))
    return np.asarray(out2.reshape(-1)[:num_cells])


def _sequential(idx, vals, num_cells, init):
    out = np.full(num_cells, init, np.float32)
    for j, c in enumerate(idx):
        if c >= 0:
            out[c] = vals[j]
    return out


# (M, num_cells, share of -1 skips, init)
CASES = {
    "duplicates": (2 * 8192, 1024, 0.0, -1.0),
    "skips": (2 * 8192, 1024, 0.25, -1.0),
    "ragged_M": (8192 + 1000, 2048, 0.1, -1.0),
    "init": (3000, 512, 0.1, 0.75),
    "all_skip": (5000, 256, 1.0, -1.0),
}


def check_scatter_set_matches_interpret_kernel_xla_and_loop(case):
    """Exact (max error 0), the last write winning every repeated cell."""
    M, cells, skip, init = CASES[case]
    rng = np.random.default_rng(len(case))
    idx = rng.integers(0, cells, M)
    idx[rng.random(M) < skip] = -1
    vals = rng.normal(size=M).astype(np.float32)
    got = scatter_set_flat(torch.from_numpy(idx), torch.from_numpy(vals), cells, init).numpy()
    want = _sequential(idx, vals, cells, init)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _interpret_kernel(idx, vals, cells, init))
    auto = scatter_set_flat_auto(jnp.asarray(idx), jnp.asarray(vals), cells, init)
    np.testing.assert_array_equal(got, np.asarray(auto))
    if case == "duplicates":
        assert len(np.unique(idx)) < M // 8  # ~16 writes per cell


def check_scatter_set_num_cells_and_range_errors():
    """Both packages refuse num_cells % 128 != 0; the plain version refuses
    indices outside [-1, num_cells) and, as the kernel does, int32 indices."""
    idx, vals = torch.tensor([0, 5]), torch.ones(2)
    with pytest.raises(ValueError):
        scatter_set_flat(idx, vals, 1000)
    with pytest.raises(TypeError):
        scatter_set_flat(idx.int(), vals, 128)
    with pytest.raises(AssertionError):
        jax_scatter_set_flat(jnp.asarray([0, 5]), jnp.ones(2), 1000)
    for bad in ([0, 128], [-2, 3]):
        with pytest.raises(ValueError):
            scatter_set_flat_plain(torch.tensor(bad), vals, 128)
    torch.testing.assert_close(scatter_set_flat(idx[:0], vals[:0], 128, 2.0),
                               torch.full((128,), 2.0), rtol=0, atol=0)


def check_grid_update_bench_stages_on_a_small_network():
    """Each stage's shapes at H = 16 on a 2-level, 16-wide network; stage 3's
    comparison reports 0 mismatches, and its result equals the JAX package's
    set on the same inputs."""
    from tngp_torch.models import NGPNetwork
    from tngp_torch.render import FieldFns

    Hs = 16
    H3, N = Hs**3, Hs**3 // 4
    model = NGPNetwork(encoding="hashgrid_window",
                       num_levels=2, hidden_dim=16, hidden_dim_color=16, log2_hashmap_size=12,
                       device="cpu", seed=0)
    field = FieldFns.from_model(model)
    gen = torch.Generator().manual_seed(1)
    grid = bg.occupied_grid(Hs, gen)
    occ = grid.density_grid[0] > 0
    assert 0.05 < float(occ.float().mean()) < 0.15

    sigma = bg.density_query(field.density, Hs, gen)
    assert sigma.shape == (2 * N,) and bool(torch.isfinite(sigma).all())
    cells = bg.occupied_cells(grid, gen)
    assert cells.shape == (N,) and bool(occ[cells].all())

    idx, vals = bg.scatter_inputs(H3, 2 * N, gen)
    outs = {name: fn() for name, fn in bg.scatter_forms(idx, vals, H3).items()}
    assert all(o.shape == (H3,) for o in outs.values())
    checks = bg.compare_scatters(idx, vals, outs["kernel"], outs["plain"], outs["index_put_"])
    assert checks["mismatches"] == 0 and checks["max_abs_err"] == 0.0 and bg.checks_pass(checks)
    assert 0 < checks["dup_cells"] < checks["written_cells"] == int(torch.unique(idx).numel())
    want = scatter_set_flat_auto(jnp.asarray(idx.numpy()), jnp.asarray(vals.numpy()), H3)
    np.testing.assert_array_equal(outs["kernel"].numpy(), np.asarray(want))

    for mode in ("resample", "slab"):
        g2 = bg.partial_update(grid, field.density, Hs, gen, mode)
        assert g2.density_grid.shape == (1, H3) and g2.bitfield.shape == (H3 // 8,)
        assert bool(torch.isfinite(g2.density_grid).all()) and int(g2.iter_density) == 1


@pytest.mark.parametrize("case", list(CASES)[:4])
def test_scatter_set_matches_interpret_kernel_xla_and_loop(case):
    """Exact (max error 0), the last write winning every repeated cell
    (`test_torch_scatter_set_more.py` runs the last case)."""
    check_scatter_set_matches_interpret_kernel_xla_and_loop(case)
