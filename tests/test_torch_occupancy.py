"""Port parity: occupancy-grid maintenance of `tngp_torch` against the JAX
package — `mark_untrained_grid`, the occupied-cell inverse-CDF, and
`update_density_grid` (`full`, `resample`, `slab`) on the blob density with
the same random draws.  The JAX update takes a key; the test derives the
draws from that key exactly as the JAX function does and hands them to the
port as tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tngp.data.synthetic import make_blob_field as jax_blob_field
from tngp.data.synthetic import orbit_poses
from tngp.render import occupancy as jocc
from tngp_torch.convert import occupancy_grid_from_arrays
from tngp_torch.data.synthetic import make_blob_field
from tngp_torch.render import occupancy as tocc
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

H = 32
H3 = H**3
KW = dict(bound=1.0, grid_size=H, density_thresh=1.0)


def _to_port(state):
    return occupancy_grid_from_arrays(*(np.asarray(a) for a in (
        state.density_grid, state.bitfield, state.mean_density, state.iter_density)),
        device="cpu")


def test_mark_untrained_grid_exact():
    poses = orbit_poses(3, radius=1.2)  # close cameras: part of the box is unseen
    intr = np.array([60.0, 60.0, 16.0, 16.0], np.float32)
    want = jocc.mark_untrained_grid(jocc.create(1, H), jnp.asarray(poses), jnp.asarray(intr),
                                    bound=1.0, grid_size=H)
    got = tocc.mark_untrained_grid(tocc.create(1, H, device="cpu"), torch.from_numpy(poses),
                                   torch.from_numpy(intr), bound=1.0, grid_size=H)
    want = np.asarray(want.density_grid)
    assert 0.05 < np.mean(want < 0) < 0.95
    np.testing.assert_array_equal(got.density_grid.numpy(), want)


@pytest.mark.parametrize("n_cells", [H3, 128 * 40, 100])
def test_occupied_rank_descend_exact(n_cells):
    """The flat searchsorted against the JAX hierarchical descent (two- and
    three-level layouts and the tiny flat form), with explicit u, including
    the ends u = 0 and u = total."""
    rng = np.random.default_rng(n_cells)
    occ = rng.uniform(size=n_cells) < 0.2
    total = float(occ.sum())
    u = np.concatenate([rng.uniform(0, total, 500), [0.0, 1.0, total]]).astype(np.float32)
    want = jocc._occupied_rank_descend(jnp.asarray(occ), jnp.asarray(u))
    got = tocc._occupied_rank_descend(torch.from_numpy(occ), torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_draws(key, mode):
    """The draws `update_density_grid` makes from `key` for one cascade."""
    if mode == "full":
        _, jk = jax.random.split(key)
        return tocc.GridDraws(_t(jax.random.uniform(jk, (H3, 3), minval=-1.0, maxval=1.0).T))
    if mode == "slab":
        _, jk = jax.random.split(key)
        return tocc.GridDraws(_t(jax.random.uniform(jk, (H3 // 2, 3), minval=-1.0, maxval=1.0).T))
    N = H3 // 4
    _, k1, k2, jk = jax.random.split(key, 4)
    return tocc.GridDraws(
        _t(jax.random.uniform(jk, (2 * N, 3), minval=-1.0, maxval=1.0).T),
        _t(jax.random.randint(k1, (N,), 0, H3)).long(),
        _t(jax.random.uniform(k2, (N,))),
    )


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def after_full():
    """Both packages' grids after one full update from the marked grid."""
    poses = orbit_poses(4)
    intr = np.array([0.9 * 32, 0.9 * 32, 16.0, 16.0], np.float32)
    jstate = jocc.mark_untrained_grid(jocc.create(1, H), jnp.asarray(poses),
                                      jnp.asarray(intr), bound=1.0, grid_size=H)
    tstate = _to_port(jstate)
    key = jax.random.PRNGKey(5)
    jfield, tfield = jax_blob_field(0), make_blob_field(0, device="cpu")
    jnew = jocc.update_density_grid(jstate, None, key, density_fn=jfield.density, full=True,
                                    **KW)
    tnew = tocc.update_density_grid_from_draws(
        tstate, None, [_jax_draws(key, "full")], density_fn=tfield.density, full=True, **KW)
    return jfield, tfield, jnew, tnew


def _assert_states_match(tnew, jnew, skip=None):
    """Densities to f32 rounding of the blob field (exp and sums: 1e-5
    relative), the bitfield exact away from cells on the threshold."""
    tg, jg = tnew.density_grid.numpy(), np.asarray(jnew.density_grid)
    keep = np.ones(tg.shape, bool) if skip is None else ~skip
    np.testing.assert_allclose(tg[keep], jg[keep], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tnew.mean_density), float(jnew.mean_density), rtol=1e-5)
    assert int(tnew.iter_density) == int(jnew.iter_density)
    thresh = min(float(jnew.mean_density), KW["density_thresh"])
    near = np.abs(jg - thresh) <= 1e-5 * max(thresh, 1.0)
    tb = np.unpackbits(tnew.bitfield.numpy(), bitorder="little")
    jb = np.unpackbits(np.asarray(jnew.bitfield), bitorder="little")
    np.testing.assert_array_equal(tb[keep.ravel() & ~near.ravel()],
                                  jb[keep.ravel() & ~near.ravel()])
    assert near.mean() < 1e-3 and 0.02 < jb.mean() < 0.9


def check_update_density_grid_full_matches(after_full):
    _, _, jnew, tnew = after_full
    _assert_states_match(tnew, jnew)
    # untrained cells stay marked
    assert ((np.asarray(jnew.density_grid) < 0) == (tnew.density_grid.numpy() < 0)).all()


def check_update_density_grid_partial_matches(after_full, mode):
    """`resample` may write a cell twice (rand_idx ++ occ_idx); which value
    stays is unspecified in both packages.  Cells written once must match;
    a cell written twice must hold max(decayed old, one of its candidates)."""
    jfield, tfield, jold, _ = after_full
    told = _to_port(jold)  # start both from the JAX state: no drift carried over
    key = jax.random.PRNGKey(9)
    jnew = jocc.update_density_grid(jold, None, key, density_fn=jfield.density, full=False,
                                    partial_mode=mode, **KW)
    draws = _jax_draws(key, mode)
    tnew = tocc.update_density_grid_from_draws(
        told, None, [draws], density_fn=tfield.density, full=False, partial_mode=mode, **KW)
    if mode == "slab":
        _assert_states_match(tnew, jnew)
        return
    occ = told.density_grid[0] > 0
    occ_idx, total = tocc._sample_occupied_cells(occ, draws.u01)
    assert float(total) > 100
    idx = torch.cat([draws.rand_idx, occ_idx])
    counts = np.bincount(idx.numpy(), minlength=H3)
    dup = (counts > 1)[None, :]
    assert 0.01 < dup.mean() < 0.5
    # mean_density and the threshold see the duplicates: compare the rest
    tg, jg = tnew.density_grid.numpy(), np.asarray(jnew.density_grid)
    np.testing.assert_allclose(tg[~dup], jg[~dup], rtol=1e-5, atol=1e-6)
    xyz = tocc._cells_to_world_cf(tocc._idx_coords_cf(idx, H), 0, 1.0, H, draws.jitter)
    sig = tfield.density(None, xyz).numpy()
    old = told.density_grid[0].numpy()
    for cell in np.flatnonzero(dup[0])[:200]:
        if old[cell] < 0:
            assert tg[0, cell] == old[cell] and jg[0, cell] == old[cell]
            continue
        cands = np.maximum(old[cell] * 0.95, sig[idx.numpy() == cell])
        for val in (tg[0, cell], jg[0, cell]):
            assert np.isclose(cands, val, rtol=1e-5, atol=1e-6).any(), (cell, cands, val)
    np.testing.assert_allclose(float(tnew.mean_density), float(jnew.mean_density), rtol=1e-3)


def check_update_density_grid_draws_its_own_numbers(after_full):
    """The generator-driven entry point runs both modes and counts up."""
    _, tfield, _, tstate = after_full
    gen = torch.Generator().manual_seed(0)
    s1 = tocc.update_density_grid(tstate, None, gen, density_fn=tfield.density, full=False,
                                  **KW)
    s2 = tocc.update_density_grid(s1, None, gen, density_fn=tfield.density, full=True, **KW)
    assert int(s2.iter_density) == int(tstate.iter_density) + 2
    assert s2.bitfield.shape == (H3 // 8,) and s2.bitfield.dtype == torch.uint8
    assert 0.02 < float((s2.density_grid > 1.0).float().mean()) < 0.9
