"""Port parity for the golden hash grid and the leaf ops of its slice:
`tngp_torch.ops.hashgrid` against `tngp.ops.hashgrid` (offsets at the
default specs, rows, the encode, the hand-written VJP's table and input
gradients, `input_grad=False`, the total-variation gradient), the
`GridEncoder` and `get_encoder`'s branches, `sph_from_ray`, the Morton codes
and the losses, on inputs made from numpy seeds.

Tolerances.  Rows, level offsets and Morton codes are integers: exact.
Corner weights: exact against the JAX geometry under `jit` (where XLA
computes x * scale + shift as one f32 FMA, the port's `_positions` gives the
same value).  The encode: 1e-6 absolute on N(0, 1) tables (the 2^D corner
products summed in another order).  The VJP: 1e-5 norm-relative (the JAX
backward runs op by op, where x * scale + shift rounds twice, so its
weights can differ from the forward's by an f32 ulp; and summation order).
`sph_from_ray`: 1e-6 (atan2 and sqrt in two libraries).  Losses: 1e-6
relative.

The cases that compile JAX programs per spec (rows, encode, VJP, the
total-variation gradient) and the losses' run from
test_torch_hashgrid_<spec>.py, files of at most four cases, which the
tier-1 run queues behind the longest JAX test file; their checks are
here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tngp.encoders import get_encoder as jax_get_encoder
from tngp.ops import grid_utils as jgu
from tngp.ops import hashgrid as J
from tngp.ops import losses as jl
from tngp.ops.rays import sph_from_ray as jax_sph_from_ray
from tngp_torch.encoders import GridEncoder, IdentityEncoder, get_encoder
from tngp_torch.ops import grid_utils as tgu
from tngp_torch.ops import hashgrid as T
from tngp_torch.ops import losses as tl
from tngp_torch.ops.rays import sph_from_ray
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# small specs of every kind the slice builds: hash and tiled, 2-D (the bg
# grid), 5-D (the hyper grid), align_corners with smoothstep; levels past
# the dense range hash or wrap (2^10-2^12 rows)
SPECS = {
    "hash3": dict(input_dim=3, num_levels=4, log2_hashmap_size=12, desired_resolution=256),
    "tiled3": dict(input_dim=3, num_levels=4, log2_hashmap_size=12, desired_resolution=256,
                   gridtype="tiled"),
    "align_smooth3": dict(input_dim=3, num_levels=3, log2_hashmap_size=11,
                          desired_resolution=128, align_corners=True,
                          interpolation="smoothstep"),
    "bg2": dict(input_dim=2, num_levels=4, log2_hashmap_size=10, desired_resolution=2048),
    "hyper5": dict(input_dim=5, num_levels=3, log2_hashmap_size=12, desired_resolution=64,
                   gridtype="tiled"),
}
_jit_geometry = jax.jit(J._level_geometry, static_argnums=(0, 1))


def specs(name, **over):
    kw = {**SPECS[name], **over}
    return J.HashGridSpec.create(**kw), T.HashGridSpec.create(**kw)


def inputs(spec, seed, B=3000, lo=-0.06, hi=1.06):
    """x01 [D, B] in [lo, hi] (outside the cube as D-NeRF's x + dx) and an
    N(0, 1) table."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, (spec.input_dim, B)).astype(np.float32)
    table = rng.normal(0, 1, (spec.total_params, spec.level_dim)).astype(np.float32)
    return x, table


def rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("kw", [
    dict(desired_resolution=2048),  # NGP and D-NeRF at bound 1
    dict(desired_resolution=4096),  # bound 2
    dict(input_dim=2, num_levels=4, desired_resolution=2048),  # the bg grid
    dict(input_dim=5, desired_resolution=2048, gridtype="tiled"),  # the hyper grid
], ids=["3d_2048", "3d_4096", "bg_2d", "hyper_5d"])
def test_offsets_at_default_specs(kw):
    js, ts = J.HashGridSpec.create(**kw), T.HashGridSpec.create(**kw)
    assert ts == T.HashGridSpec(**{k: getattr(js, k) for k in js.__dataclass_fields__})
    assert ts.offsets == js.offsets
    assert [ts.level_resolution(lv) for lv in range(ts.num_levels)] == [
        js.level_resolution(lv) for lv in range(js.num_levels)]
    if kw.get("input_dim") == 5:
        assert ts.total_params == 16 * 2**19  # every 5-D level wraps
    if kw == dict(desired_resolution=2048):
        assert ts.total_params == 6_119_864
    if kw.get("input_dim") == 2:
        assert ts.total_params == 697_776


def check_rows_and_weights_exact(name):
    """`_level_indices_cf` on integer corners (negative ones too) and the
    level geometry on x01 in [-0.06, 1.06] against the JAX rows and
    weights, exactly."""
    js, ts = specs(name)
    x, _ = inputs(js, 0)
    rng = np.random.default_rng(1)
    for lv in range(js.num_levels):
        cc = rng.integers(-40, 3000, (js.input_dim, 500)).astype(np.int32)
        want = np.asarray(J._level_indices_cf(js, lv, [jnp.asarray(c) for c in cc]))
        got = T._level_indices_cf(ts, lv, [torch.from_numpy(c) for c in cc]).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))
        ji, jw, _, _ = _jit_geometry(js, lv, jnp.asarray(x))
        ti, tw, _, _ = T._level_geometry(ts, lv, torch.from_numpy(x))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji).astype(np.int64))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def check_encode_matches_jax(name):
    js, ts = specs(name)
    x, table = inputs(js, 2)
    want = np.asarray(J.hash_encode_cf(jnp.asarray(x), jnp.asarray(table), js))
    got = T.hash_encode_cf(torch.from_numpy(x), torch.from_numpy(table), ts).numpy()
    assert got.shape == (ts.output_dim, x.shape[1])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    oob = ((x < 0) | (x > 1)).any(axis=0)
    assert oob.any() and not got[:, oob].any()
    xb = torch.from_numpy(np.ascontiguousarray(x.T))
    np.testing.assert_allclose(T.hash_encode(xb, torch.from_numpy(table), ts).numpy(), want.T,
                               rtol=0, atol=1e-6)


def _vjp_both(js, ts, x, table, g):
    jgx, jgt = jax.grad(lambda xx, tt: jnp.sum(J.hash_encode_cf_vjp(xx, tt, js) * g),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(table))
    xt = torch.from_numpy(x).requires_grad_(True)
    tt = torch.from_numpy(table).requires_grad_(True)
    (T.hash_encode_cf_vjp(xt, tt, ts) * torch.from_numpy(g)).sum().backward()
    return np.asarray(jgx), np.asarray(jgt), xt.grad, tt.grad


def check_vjp_matches_jax(name):
    """The table gradient (scatter-add over each level's rows) and dy_dx."""
    js, ts = specs(name)
    x, table = inputs(js, 3)
    g = np.random.default_rng(4).normal(0, 1, (js.output_dim, x.shape[1])).astype(np.float32)
    jgx, jgt, tgx, tgt = _vjp_both(js, ts, x, table, g)
    assert rel(tgt.numpy(), jgt) <= 1e-5 and rel(tgx.numpy(), jgx) <= 1e-5
    oob = ((x < 0) | (x > 1)).any(axis=0)
    assert not tgx.numpy()[:, oob].any() and np.abs(tgx.numpy()).max() > 0


def check_no_input_gradient_when_input_grad_is_off():
    """input_grad=False: no dy_dx (the port returns None where JAX returns
    zeros); the table gradient is unchanged."""
    js, ts = specs("hash3", input_grad=False)
    x, table = inputs(js, 5)
    g = np.random.default_rng(6).normal(0, 1, (js.output_dim, x.shape[1])).astype(np.float32)
    jgx, jgt, tgx, tgt = _vjp_both(js, ts, x, table, g)
    assert tgx is None and not jgx.any()
    assert rel(tgt.numpy(), jgt) <= 1e-5


def check_tv_grad_matches_jax(name):
    js, ts = specs(name)
    x, table = inputs(js, 7, lo=0.0, hi=1.0)
    want = np.asarray(J.hash_encode_tv_grad(jnp.asarray(x.T), jnp.asarray(table), js, 1e-3))
    got = T.hash_encode_tv_grad(torch.from_numpy(np.ascontiguousarray(x.T)),
                                torch.from_numpy(table), ts, 1e-3).numpy()
    assert np.abs(want).max() > 0 and rel(got, want) <= 1e-5


def check_grid_encoder_and_factory():
    """GridEncoder's channels-first and batch-first paths against the JAX
    module's on the same table; the factory's identity, Minkowski and
    unknown names."""
    kw = dict(num_levels=3, log2_hashmap_size=11, desired_resolution=256)
    jenc, jdim = jax_get_encoder("tiledgrid", **kw)
    tenc, tdim = get_encoder("tiledgrid", device="cpu", **kw)
    assert isinstance(tenc, GridEncoder) and tdim == jdim == 6
    assert tenc.spec.gridtype == "tiled" and tenc.embeddings.shape == (tenc.spec.total_params, 2)
    rng = np.random.default_rng(8)
    table = rng.normal(0, 1, tuple(tenc.embeddings.shape)).astype(np.float32)
    with torch.no_grad():
        tenc.embeddings.copy_(torch.from_numpy(table))
    x = rng.uniform(-1.5, 1.5, (3, 500)).astype(np.float32)  # bound 1.5
    p = {"params": {"embeddings": table}}
    want = np.asarray(jenc.apply(p, jnp.asarray(x), 1.5, method=type(jenc).cf))
    got = tenc.cf(torch.from_numpy(x), bound=1.5).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tenc(torch.from_numpy(np.ascontiguousarray(x.T)), 1.5)
                               .detach().numpy(),
                               np.asarray(jenc.apply(p, jnp.asarray(x.T), 1.5)), rtol=0, atol=1e-6)
    for name in (None, "none", "None"):
        ident, dim = get_encoder(name, input_dim=4)
        assert isinstance(ident, IdentityEncoder) and dim == 4
    with pytest.raises(NotImplementedError):
        get_encoder("hashgrid_minkowski")
    with pytest.raises(ValueError, match="unknown encoding"):
        get_encoder("no_such_encoder")


def check_sph_from_ray_matches_jax():
    rng = np.random.default_rng(9)
    o = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
    d = rng.normal(0, 1, (400, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = np.asarray(jax_sph_from_ray(jnp.asarray(o), jnp.asarray(d), 2.0))
    got = sph_from_ray(torch.from_numpy(o), torch.from_numpy(d), 2.0).numpy()
    assert got.shape == (400, 2) and np.abs(got).max() <= 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def check_morton3d_matches_jax_and_inverts():
    c = np.random.default_rng(10).integers(0, 1024, (1000, 3)).astype(np.int32)
    want = np.asarray(jgu.morton3d(jnp.asarray(c))).astype(np.int64)
    got = tgu.morton3d(torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tgu.morton3d_invert(got).numpy(), c)
    np.testing.assert_array_equal(
        np.asarray(jgu.morton3d_invert(jnp.asarray(want.astype(np.uint32)))), c)


def check_losses_match_jax():
    rng = np.random.default_rng(11)
    pred, tgt = rng.normal(0, 1, (2, 64, 3)).astype(np.float32)
    w = rng.uniform(0, 1, (16, 24)).astype(np.float32)
    m = np.sort(rng.uniform(0, 2, (16, 24)), axis=-1).astype(np.float32)
    cases = [
        (tl.mape_loss, jl.mape_loss, (pred, tgt)),
        (lambda a, b: tl.mape_loss(a, b, reduction="none"),
         lambda a, b: jl.mape_loss(a, b, reduction="none"), (pred, tgt)),
        (tl.huber_loss, jl.huber_loss, (pred, tgt)),
        (lambda a, b: tl.eff_distloss(a, b, 0.05), lambda a, b: jl.eff_distloss(a, b, 0.05),
         (w, m)),
    ]
    for tf, jf, (a, b) in cases:
        want = np.asarray(jf(jnp.asarray(a), jnp.asarray(b)))
        at = torch.from_numpy(a).requires_grad_(True)
        got = tf(at, torch.from_numpy(b))
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-7)
        got.sum().backward()
        jg = np.asarray(jax.grad(lambda aa: jnp.sum(jf(aa, jnp.asarray(b))))(jnp.asarray(a)))
        np.testing.assert_allclose(at.grad.numpy(), jg, rtol=1e-6, atol=1e-7)
