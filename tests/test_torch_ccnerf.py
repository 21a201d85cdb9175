"""Port parity for `tngp_torch/models/ccnerf.py` against
`tngp/models/ccnerf.py` on a small config (resolution (20, 24, 28), three
groups of ranks 8 / 0-2-4 for density and colour, SH degree 4) with the
same weights (the port's `cc_init`, handed to the JAX functions as numpy):

- the residual outputs [K, B] / [K, 3, B], the non-residual ones and the
  density at 256 points in [-1.1, 1.1]^3, and the gradient of every factor
  and projection of a weighted sum of the residual outputs (the JAX side
  one `jit` program, as the JAX trainer runs the field); tolerances 1e-5
  relative on the outputs, 1e-4 norm-relative on the gradients (f32
  summation order in the S projections and the scatter-adds, and XLA's
  fused multiply-adds);
- `cc_finalize` and `cc_compress` exactly (the same numpy);
- `CCScene` of two objects (one compressed) with rotations, scales and
  shifts, the JAX scene under `jit`: sigma, rgb and density within 1e-5
  relative (the transforms are f32 products; XLA's dot and the port's
  elementwise sum round apart);
- the `cc_models` pickles: a file the JAX package's `main_ccnerf` layout
  writes (its `CCConfig`) is read by the port into equal arrays and an
  equal config, the port's own file reads back, and a pickle naming
  another class is refused.
The cases compile JAX programs: this file has four."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tngp.models.ccnerf as jcc
from tngp_torch.models import ccnerf as tcc
from torch_tensorf_helpers import CC_SMALL, points, rel_err, small_cc_cfg
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

N = 256


def _jcfg(cfg):
    return jcc.CCConfig(**{k: getattr(cfg, k) for k in (*CC_SMALL, "degree", "bound")})


def _jparams(params):
    return {k: [jnp.asarray(u) for u in v] if isinstance(v, list) else jnp.asarray(v)
            for k, v in params.items()}


def _check_params(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], list):
            assert len(got[k]) == len(want[k]) == 3
            for a, b in zip(got[k], want[k]):
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_cc_outputs_and_every_gradient_match():
    cfg = small_cc_cfg()
    params = tcc.cc_init(cfg, seed=2)
    net = tcc.CCNeRF(cfg, params, device="cpu")
    jcfg, jp = _jcfg(cfg), _jparams(params)
    x, d = points(N, seed=6)
    xt, dt = torch.tensor(x), torch.tensor(d)
    rng = np.random.default_rng(7)
    wsig = rng.normal(size=(cfg.K, N)).astype(np.float32)
    wrgb = rng.normal(size=(cfg.K, 3, N)).astype(np.float32)

    def jloss(p, x, d):
        s, c = jcc.cc_sigma_rgb_cf(p, jcfg, x, d, residual=True)
        full = jcc.cc_sigma_rgb_cf(p, jcfg, x, d)
        dens = jcc.cc_density_cf(p, jcfg, x)
        return (s * wsig).sum() + (c * wrgb).sum(), (s, c, full, dens)

    (_, (js, jc, (js1, jc1), jdens)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jp, jnp.asarray(x), jnp.asarray(d))
    ts, tcol = net.sigma_rgb_cf(xt, dt, residual=True)
    assert ts.shape == (cfg.K, N) and tcol.shape == (cfg.K, 3, N)
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tcol.detach().numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)
    ((ts * torch.tensor(wsig)).sum() + (tcol * torch.tensor(wrgb)).sum()).backward()
    named = dict(net.named_parameters())
    for k, v in jg.items():
        for i, g in enumerate(v if isinstance(v, list) else [v]):
            name = f"{k}.{i}" if isinstance(v, list) else k
            assert rel_err(named[name].grad.numpy(), np.asarray(g)) <= 1e-4, name
            assert np.abs(np.asarray(g)).max() > 0, name
    with torch.no_grad():
        s1, c1 = net.sigma_rgb_cf(xt, dt)
        dens = net.density_cf(xt)["sigma"]
    np.testing.assert_allclose(s1.numpy(), np.asarray(js1), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(c1.numpy(), np.asarray(jc1), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dens.numpy(), np.asarray(jdens), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(s1.numpy(), ts[-1].detach().numpy())


def test_finalize_and_compress_are_exact():
    cfg = small_cc_cfg()
    params = tcc.cc_init(cfg, seed=3)
    jcfg = _jcfg(cfg)
    fp, fc = tcc.cc_finalize(params, cfg)
    jfp, jfc = jcc.cc_finalize(_jparams(params), jcfg)
    _check_params(fp, jfp)
    assert fc.K == jfc.K == 1 and fc.rank_mat == jfc.rank_mat
    for ranks in ((4, 2, 4, 2), (8, 0, 8, 4), (2, 4, 6, 0)):
        cp, cc = tcc.cc_compress(params, cfg, ranks)
        jcp, jcc_ = jcc.cc_compress(_jparams(params), jcfg, ranks)
        _check_params(cp, jcp)
        assert (cc.rank_vec_density, cc.rank_mat_density, cc.rank_vec, cc.rank_mat) == (
            jcc_.rank_vec_density, jcc_.rank_mat_density, jcc_.rank_vec, jcc_.rank_mat)
        assert tcc.count_params(cp) == sum(np.asarray(u).size
                                           for u in jax.tree_util.tree_leaves(jcp))
    # the finalized field keeps the full-rank output
    x, d = points(64, seed=8, lo=-0.9, hi=0.9)
    with torch.no_grad():
        a = tcc.CCNeRF(cfg, params, device="cpu").sigma_rgb_cf(torch.tensor(x), torch.tensor(d))
        b = tcc.CCNeRF(fc, fp, device="cpu").sigma_rgb_cf(torch.tensor(x), torch.tensor(d))
    for u, v in zip(a, b):
        np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=1e-4, atol=1e-6)


def test_cc_scene_matches():
    cfg = small_cc_cfg()
    objs = [tcc.cc_init(cfg, seed=4), tcc.cc_compress(tcc.cc_init(cfg, seed=5), cfg,
                                                      (6, 2, 8, 4))]
    objs[1], cfg1 = objs[1]
    scene = tcc.CCScene(device="cpu")
    jscene = jcc.CCScene()
    for i, (p, c) in enumerate(((objs[0], cfg), (objs[1], cfg1))):
        ang = 0.7 * (i + 1)
        R = np.array([[np.cos(ang), 0, -np.sin(ang)], [0, 1, 0],
                      [np.sin(ang), 0, np.cos(ang)]], np.float32)
        kw = dict(R=R, s=1.0 / (1 + 0.3 * i), t=np.array([0.4 * i - 0.4, 0.1, 0], np.float32))
        scene.add(p, c, **kw)
        jscene.add(_jparams(p), _jcfg(c), **kw)
    x, d = points(N, seed=9)
    with torch.no_grad():
        ts, trgb = scene.sigma_rgb_cf(torch.tensor(x), torch.tensor(d))
        tdens = scene.density_cf(torch.tensor(x))["sigma"]
    (js, jrgb), jdens = jax.jit(lambda x, d: (jscene.sigma_rgb_cf(x, d), jscene.density_cf(x)))(
        jnp.asarray(x), jnp.asarray(d))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(trgb.numpy(), np.asarray(jrgb), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tdens.numpy(), np.asarray(jdens), rtol=1e-5, atol=1e-6)


class _Other:
    pass


def test_cc_models_pickles(tmp_path):
    cfg = small_cc_cfg()
    jcfg = _jcfg(cfg)
    jfp, jfc = jcc.cc_finalize(_jparams(tcc.cc_init(cfg, seed=6)), jcfg)
    jcp, jcc_ = jcc.cc_compress(jfp, jfc, (4, 2, 4, 2))
    path = os.path.join(tmp_path, "rank_4_2_4_2.pkl")
    with open(path, "wb") as f:  # main_ccnerf's layout
        pickle.dump((jcp, jcc_), f)
    params, got_cfg = tcc.load_cc_model(path)
    _check_params(params, jcp)
    assert isinstance(got_cfg, tcc.CCConfig)
    assert {k: getattr(got_cfg, k) for k in vars(jcc_)} == vars(jcc_)
    mine = os.path.join(tmp_path, "mine.pkl")
    tcc.save_cc_model(mine, params, got_cfg)
    back, back_cfg = tcc.load_cc_model(mine)
    _check_params(back, params)
    assert back_cfg == got_cfg
    bad = os.path.join(tmp_path, "bad.pkl")
    with open(bad, "wb") as f:
        pickle.dump((params, _Other()), f)
    with pytest.raises(pickle.UnpicklingError, match="refused"):
        tcc.load_cc_model(bad)
