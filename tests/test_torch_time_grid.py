"""Port parity for D-NeRF's time-extended occupancy grid and dynamic scene:
`time_slice_index` at its edges, `update_time_density_grid` (full and
partial) against the JAX package with the same draws, and
`make_synthetic_dynamic_dataset`.  The JAX update takes a key; the test
derives the draws from it exactly as the JAX function does (one key per
slice; per slice a time key, then the cascade's keys) and hands them to the
port.  The density is the blob scene's, shrunk with time so that the slices
differ."""

import jax
import numpy as np
import pytest
import torch

from tngp.data.synthetic import make_blob_field as jax_blob_field
from tngp.data.synthetic import make_synthetic_dynamic_dataset as jax_dynamic_dataset
from tngp.render import occupancy as jocc
from tngp_torch.convert import time_occupancy_grid_from_arrays
from tngp_torch.data import make_blob_field, make_synthetic_dynamic_dataset
from tngp_torch.render import occupancy as tocc
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

T, H = 4, 16
H3 = H**3
KW = dict(bound=1.0, grid_size=H, density_thresh=1.0)


def _jax_density(p, x_cf, t):
    return jax_blob_field(0).density(p, x_cf * (1.0 + 0.5 * t))


def _port_density(p, x_cf, t):
    return make_blob_field(0, device="cpu").density(p, x_cf * (1.0 + 0.5 * t))


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_draws(key, full):
    """The draws `update_time_density_grid` makes from `key` (one cascade)."""
    draws = []
    for k in jax.random.split(key, T):
        k, tk = jax.random.split(k)
        u = float(jax.random.uniform(tk))
        if full:
            _, jk = jax.random.split(k)
            cas = tocc.GridDraws(_t(jax.random.uniform(jk, (3, H3), minval=-1.0, maxval=1.0)))
        else:
            N = H3 // 4
            _, k1, k2, jk = jax.random.split(k, 4)
            cas = tocc.GridDraws(
                _t(jax.random.uniform(jk, (3, 2 * N), minval=-1.0, maxval=1.0)),
                _t(jax.random.randint(k1, (N,), 0, H3)).long(),
                _t(jax.random.uniform(k2, (N,))))
        draws.append(tocc.TimeSliceDraws(u, [cas]))
    return draws


def _to_port(state):
    return time_occupancy_grid_from_arrays(*(np.asarray(a) for a in (
        state.density_grid, state.bitfield, state.mean_density, state.iter_density)),
        device="cpu")


def _update(state, key, full):
    jnew = jocc.update_time_density_grid(state, None, key, density_fn=_jax_density,
                                         full=full, chunk=2048, **KW)
    tnew = tocc.update_time_density_grid_from_draws(
        _to_port(state), None, _jax_draws(key, full), density_fn=_port_density, full=full,
        chunk=2048, **KW)
    return jnew, tnew


def _assert_match(tnew, jnew, skip):
    """Densities to the blob field's f32 rounding (1e-5), the bitfield
    exact away from cells on either package's threshold, cells in `skip`
    left out."""
    tg, jg = tnew.density_grid.numpy(), np.asarray(jnew.density_grid)
    np.testing.assert_allclose(tg[~skip], jg[~skip], rtol=1e-5, atol=1e-6)
    thr = [min(float(m), KW["density_thresh"]) for m in (tnew.mean_density, jnew.mean_density)]
    near = (jg >= min(thr) - 1e-5 * max(thr[1], 1.0)) & (jg <= max(thr) + 1e-5 * max(thr[1], 1.0))
    keep = (~skip & ~near).reshape(T, -1)
    tb = np.unpackbits(tnew.bitfield.numpy(), axis=1, bitorder="little")
    jb = np.unpackbits(np.asarray(jnew.bitfield), axis=1, bitorder="little")
    assert tb.shape == jb.shape == (T, H3)
    np.testing.assert_array_equal(tb[keep], jb[keep])
    assert near.mean() < 1e-2 and 0.02 < jb.mean() < 0.9
    assert int(tnew.iter_density) == int(jnew.iter_density)


@pytest.mark.parametrize("t", [0.0, 0.0624, 0.0625, 0.5, 0.99999994, 1.0, -0.2, 1.5, 0.74])
def test_time_slice_index_edges(t):
    for size in (4, 16):
        assert tocc.time_slice_index(t, size) == int(jocc.time_slice_index(t, size))


def check_full_then_partial_time_grid_updates_match():
    """Full: every cell of every slice, exact draws, so every cell matches.
    Partial (`resample` per slice): `rand_idx ++ occ_idx` may name a cell
    twice, and which fresh density stays is unspecified in both packages
    (ROADMAP queue 3): such a cell must hold max(decayed old, one of its
    candidates) in each, the mean density may differ by what those choices
    can move it, and every other cell is held as above."""
    state = jocc.create_time(T, 1, H)
    jfull, tfull = _update(state, jax.random.PRNGKey(5), True)
    none = np.zeros((T, 1, H3), bool)
    _assert_match(tfull, jfull, none)
    assert not np.array_equal(np.asarray(jfull.bitfield[0]), np.asarray(jfull.bitfield[-1]))
    np.testing.assert_allclose(float(tfull.mean_density), float(jfull.mean_density), rtol=1e-5)

    key = jax.random.PRNGKey(9)
    jpart, tpart = _update(jfull, key, False)
    tg, jg = tpart.density_grid.numpy(), np.asarray(jpart.density_grid)
    old = tfull.density_grid.numpy()
    dup = np.zeros_like(none)
    spread = 0.0  # how far the packages' choices can move the grid's sum
    for s, sd in enumerate(_jax_draws(key, False)):
        d = sd.cascades[0]
        occ_idx, total = tocc._sample_occupied_cells(tfull.density_grid[s, 0] > 0, d.u01)
        assert float(total) > 100
        idx = torch.cat([d.rand_idx, occ_idx])
        counts = np.bincount(idx.numpy(), minlength=H3)
        dup[s, 0] = counts > 1
        f32 = np.float32
        t_val = float((f32(s) + f32(0.5)) / f32(T) + (f32(sd.t_u01) - f32(0.5)) / f32(T))
        sig = _port_density(None, tocc._cells_to_world_cf(tocc._idx_coords_cf(idx, H), 0, 1.0, H,
                                                          d.jitter), t_val).numpy()
        for cell in np.flatnonzero(counts > 1):
            if old[s, 0, cell] < 0:
                assert tg[s, 0, cell] == old[s, 0, cell] == jg[s, 0, cell]
                continue
            cands = np.maximum(old[s, 0, cell] * 0.95, sig[idx.numpy() == cell])
            for val in (tg[s, 0, cell], jg[s, 0, cell]):
                assert np.isclose(cands, val, rtol=1e-5, atol=1e-6).any(), (s, cell, cands, val)
            spread += cands.max() - cands.min()
    assert 0.01 < dup.mean() < 0.5
    _assert_match(tpart, jpart, dup)
    assert abs(float(tpart.mean_density) - float(jpart.mean_density)) <= (
        spread / tg.size + 1e-5 * float(jpart.mean_density))


def check_generator_driven_update_and_create_time():
    grid = tocc.create_time(T, 1, H, device="cpu")
    assert grid.density_grid.shape == (T, 1, H3) and grid.bitfield.shape == (T, H3 // 8)
    gen, rng = torch.Generator().manual_seed(0), np.random.default_rng(0)
    g1 = tocc.update_time_density_grid(grid, None, gen, rng, density_fn=_port_density,
                                       full=True, **KW)
    g2 = tocc.update_time_density_grid(g1, None, gen, rng, density_fn=_port_density,
                                       full=False, **KW)
    assert int(g2.iter_density) == 2 and g2.bitfield.dtype == torch.uint8
    assert 0.02 < float((g2.density_grid > 1.0).float().mean()) < 0.9


def check_dynamic_dataset_matches_jax():
    ds = make_synthetic_dynamic_dataset(n_frames=3, H=12, W=12, num_steps=48, device="cpu")
    want = jax_dynamic_dataset(n_frames=3, H=12, W=12, num_steps=48)
    np.testing.assert_array_equal(ds.times, want.times)
    np.testing.assert_array_equal(ds.poses, want.poses)
    np.testing.assert_array_equal(ds.intrinsics, want.intrinsics)
    assert ds.images.shape == (3, 12, 12, 3) and ds.images.dtype == np.float32
    np.testing.assert_allclose(ds.images, want.images, rtol=0, atol=1e-5)
    assert np.abs(ds.images[0] - ds.images[-1]).max() > 0.05  # the scene moves
