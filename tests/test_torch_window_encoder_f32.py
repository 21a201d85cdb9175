"""Port parity for the window encoder's true-f32 form (`mxu_f32=True`, the
JAX package's `Precision.HIGHEST` option, which `TNGP_MXU_F32=1` selects):
`tngp_torch`'s `window_encode_binned(mxu_f32=True, input_grads=True)` on the
CPU (the kernels' plain f32 versions) against the JAX package's
`window_encode_ref(emulate_bf16=False)` and its XLA-autodiff gradients, run
as one `jit` program; the option's two switches in both packages; and the
default bf16 form unchanged.

Tolerances.  Forward: 5e-6 absolute (the same f32 products of weights that
XLA's CPU may fuse differently, summed over 8 corners in another order, for
N(0, 1) table values).  Table and input gradients: 1e-5 norm-relative (the
same f32 products summed in another order; XLA's chain rule through the
weights orders the input gradient's factors differently)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tngp.encoders import get_encoder as jax_get_encoder
from tngp.ops.window_table import WindowSpec as JaxWindowSpec
from tngp.ops.window_table import window_encode_ref as jax_window_encode_ref
from tngp_torch.encoders import get_encoder
from tngp_torch.kernels import window_encoder as wk
from tngp_torch.ops import window_table as wt
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# level 0 dense (side 17), levels 1-3 hashed
SPEC_KW = dict(num_levels=4, level_dim=2, base_resolution=16, per_level_scale=2.0,
               log2_hashmap_size=12)
BLOCK = 64


def _inputs(spec, M=1024, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, size=(3, M)).astype(np.float32)
    table = rng.normal(size=(spec.total_rows, spec.level_dim)).astype(np.float32)
    g = rng.normal(size=(spec.output_dim, M)).astype(np.float32)
    return x, table, g


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _port(x, table, g, spec, mxu_f32):
    """Features, table gradient (canonical layout) and position gradient of
    the port's binned encoder on the CPU."""
    xt = torch.from_numpy(x).requires_grad_(True)
    win = wt.window_view(torch.from_numpy(table), spec).requires_grad_(True)
    feats = wk.window_encode_binned(xt, win, spec, BLOCK, input_grads=True, mxu_f32=mxu_f32)
    feats.backward(torch.from_numpy(g))
    return (feats.detach().numpy(), wt.window_unview(win.grad, spec).numpy(),
            xt.grad.numpy())


def test_f32_form_matches_the_jax_f32_reference():
    spec = wt.WindowSpec.create(**SPEC_KW)
    jspec = JaxWindowSpec.create(**SPEC_KW)
    x, table, g = _inputs(spec)

    def ref(x, table, g):
        feats, vjp = jax.vjp(
            lambda xx, tt: jax_window_encode_ref(xx, tt, jspec, emulate_bf16=False), x, table)
        gx, gt = vjp(g)
        return feats, gt, gx

    # op by op: under `jit` XLA's CPU fuses x * scale + shift into one FMA,
    # which moves a fine level's position by up to an ulp of 129 (7.6e-6)
    # and a feature by 1.5e-5 (measured); the kernels and the TPU kernels
    # round the product and the sum apart
    with jax.disable_jit():
        want = [np.asarray(a) for a in ref(jnp.asarray(x), jnp.asarray(table),
                                           jnp.asarray(g))]
    got = _port(x, table, g, spec, mxu_f32=True)
    assert np.abs(got[0] - want[0]).max() <= 5e-6
    assert _rel(got[1], want[1]) <= 1e-5
    assert _rel(got[2], want[2]) <= 1e-5
    # the same features as the port's own plain reference of the f32 numerics
    ref_t = wt.window_encode_ref(torch.from_numpy(x), torch.from_numpy(table), spec,
                                 emulate_bf16=False)
    assert np.abs(got[0] - ref_t.numpy()).max() <= 5e-6
    # and not the bf16 form's: the option changes the numbers
    bf16 = _port(x, table, g, spec, mxu_f32=False)
    assert np.abs(bf16[0] - want[0]).max() > 1e-4


def test_plain_f32_versions_agree_with_the_plain_references():
    """The three kernels' plain f32 versions on tile-sorted samples against
    the port's unsorted plain references (`window_encode_ref`,
    `window_table_grad_ref` with `emulate_bf16=False`), and the input
    gradient as the contraction of the f32 derivative-weight encode."""
    spec = wt.WindowSpec.create(**SPEC_KW)
    x, table, g = _inputs(spec, M=512, seed=1)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    win = wt.window_view(torch.from_numpy(table), spec)
    dest, tob = wk.bin_dest(xt, BLOCK)
    M_pad = wk.padded_size(x.shape[1], BLOCK)
    xyz4 = torch.zeros(M_pad, 4).index_copy_(0, dest, torch.cat([xt, torch.ones(1, 512)]).T)
    wob = wk._wob_local(spec, tob)
    g_sorted = torch.zeros(M_pad, spec.output_dim).index_copy_(0, dest, gt.T)
    feats = wk.window_encode_fwd(xyz4, wob, win, spec, BLOCK, mxu_f32=True)[:, dest]
    want = wt.window_encode_ref(xt, torch.from_numpy(table), spec, emulate_bf16=False)
    assert float((feats - want).abs().max()) <= 5e-6
    gtab = wt.window_unview(wk.window_encode_bwd(xyz4, wob, g_sorted, spec, BLOCK,
                                                 mxu_f32=True), spec)
    assert _rel(gtab, wt.window_table_grad_ref(xt, gt, spec, emulate_bf16=False)) <= 1e-6
    gx = wk.window_encode_dx(xyz4, wob, win, g_sorted, spec, BLOCK, mxu_f32=True)
    assert torch.equal(gx, (g_sorted.T[None] * wk.dx_features(
        xyz4, wob, win, spec, BLOCK, mxu_f32=True)).sum(1))


def test_option_and_environment_select_the_f32_form(monkeypatch):
    """`get_encoder(..., mxu_f32=True)` and `TNGP_MXU_F32=1` select the f32
    form in both packages; without either both stay bf16, and the port's
    default features are the bf16 plain reference's."""
    kw = dict(num_levels=2, log2_hashmap_size=12, desired_resolution=64)
    monkeypatch.delenv("TNGP_MXU_F32", raising=False)
    j_def, _ = jax_get_encoder("hashgrid_window", **kw)
    j_opt, _ = jax_get_encoder("hashgrid_window", mxu_f32=True, **kw)
    p_def, _ = get_encoder("hashgrid_window", device="cpu", **kw)
    p_opt, _ = get_encoder("hashgrid_window", device="cpu", mxu_f32=True, **kw)
    assert not j_def.mxu_f32 and not p_def.mxu_f32
    assert j_opt.mxu_f32 and p_opt.mxu_f32
    monkeypatch.setenv("TNGP_MXU_F32", "1")
    j_env, _ = jax_get_encoder("hashgrid_window", **kw)
    p_env, _ = get_encoder("hashgrid_window", device="cpu", **kw)
    assert j_env.mxu_f32 and p_env.mxu_f32
    monkeypatch.setenv("TNGP_MXU_F32", "0")
    assert not get_encoder("hashgrid_window", device="cpu", **kw)[0].mxu_f32

    x = torch.rand((3, 300), generator=torch.Generator().manual_seed(0)) * 2 - 1
    spec = p_def.spec
    p_def.embeddings.data.normal_(generator=torch.Generator().manual_seed(1))
    p_env.embeddings.data.copy_(p_def.embeddings.data)
    with torch.no_grad():
        f_def, f_env = p_def.cf(x), p_env.cf(x)
    x01 = (x + 1.0) / 2.0
    table = wt.window_unview(p_def.embeddings.detach(), spec)
    assert float((f_def - wt.window_encode_ref(x01, table, spec, emulate_bf16=True)).abs()
                 .max()) <= 5e-6
    assert float((f_env - wt.window_encode_ref(x01, table, spec)).abs().max()) <= 5e-6
    assert float((f_env - f_def).abs().max()) > 1e-5
