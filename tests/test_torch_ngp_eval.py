"""Port parity for the slice as a whole: a small instant-NGP network with
bf16 MLPs and the windowed grid encoder, its flax weights carried across by
`tngp_torch.convert`, then `sigma_rgb_cf` and the full `render_rays_eval`
(first pass + residual rounds) against the JAX package on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tngp.models import NGPNetwork as JaxNGP
from tngp.ops import packbits as jax_packbits
from tngp.render import FieldFns as JaxFieldFns
from tngp.render import RenderConfig as JaxRenderConfig
from tngp.render import dilated_chunk_grid as jax_dilated_chunk_grid
from tngp.render import render_rays_eval as jax_render_rays_eval
from tngp_torch.convert import ngp_state_dict_from_flax
from tngp_torch.models import NGPNetwork
from tngp_torch.render import FieldFns, RenderConfig, render_rays_eval

NET_KW = dict(num_levels=4, log2_hashmap_size=15, base_resolution=16)


@pytest.fixture(scope="module")
def nets():
    jnet = JaxNGP(encoding="hashgrid_window", compute_dtype=jnp.bfloat16, **NET_KW)
    params = jnet.init(jax.random.PRNGKey(3), jnp.zeros((8, 3)), jnp.ones((8, 3)) / np.sqrt(3))
    # give the table a scale that moves the density (the init is U(+-1e-4))
    emb = params["params"]["encoder"]["embeddings"]
    noise = np.random.default_rng(0).normal(0, 0.5, emb.shape).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, params)
    params["params"]["encoder"]["embeddings"] = noise
    tnet = NGPNetwork(compute_dtype=torch.bfloat16, device="cpu", **NET_KW)
    tnet.load_state_dict(ngp_state_dict_from_flax(params))
    return jnet, params, tnet


def test_convert_covers_every_parameter(nets):
    _, params, tnet = nets
    sd = ngp_state_dict_from_flax(params)
    assert set(sd) == set(tnet.state_dict())
    assert sd["encoder.embeddings"].shape == (13, 2, 128, 64)
    assert sd["sigma_net.dense_0"].shape == (8, 64)


def test_sigma_rgb_cf_matches(nets):
    """bf16 MLP outputs: both sides round every layer to bf16 but may sum a
    layer's 64 products in another order, so a rounding can flip one bf16
    ulp (2^-8 relative) — tolerance 2 bf16 ulps of the output's scale."""
    jnet, params, tnet = nets
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (3, 700)).astype(np.float32)
    d = rng.normal(size=(3, 700)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    sj, rj = jnet.apply(params, jnp.asarray(x), jnp.asarray(d), method=JaxNGP.sigma_rgb_cf)
    with torch.no_grad():
        st, rt = tnet.sigma_rgb_cf(torch.from_numpy(x), torch.from_numpy(d))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=2e-2, atol=1e-3)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=8e-3)
    # most values agree to the last bit
    assert np.mean(st.numpy() == np.asarray(sj)) > 0.9


def _sphere_bitfield(H, r=0.6):
    ax = (np.arange(H) + 0.5) / H * 2.0 - 1.0
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    occ = ((gx**2 + gy**2 + gz**2) < r**2).astype(np.float32).reshape(-1)
    return np.array(jax_packbits(jnp.asarray(occ), 0.5))


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = np.array([0.0, 0.0, -2.5]) + rng.normal(0, 0.05, size=(n, 3))
    target = rng.uniform(-0.5, 0.5, size=(n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    d[-4:] = [0.0, 1.0, 0.0]  # rays that miss the box
    return o, d


@pytest.mark.parametrize("eval_budget", [0.75, 0.05])
def test_render_rays_eval_matches(nets, eval_budget):
    """eval_budget 0.05 starves the first pass so residual rounds do most
    of the work (as tests/test_frame_eval.py:63); the result must not depend
    on it.  Tolerance 2e-4: the two packages composite in f32 in another
    order and a few samples' bf16 MLP outputs differ by one ulp (above);
    measured 1.3e-5 on this input.  Depth is normalised to [0, 1]."""
    jnet, params, tnet = nets
    kw = dict(bound=1.0, grid_size=16, max_steps=128, K=32, K_eval=16, min_near=0.05,
              march_chunk=8, eval_budget=eval_budget)
    jcfg, tcfg = JaxRenderConfig(**kw), RenderConfig(**kw)
    assert set(f.name for f in dataclasses.fields(jcfg)) == set(
        f.name for f in dataclasses.fields(tcfg))
    o, d = _rays(72, 2)
    bf = _sphere_bitfield(16)
    jfield = JaxFieldFns.from_model(jnet)
    jout = jax_render_rays_eval(jfield, params, jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(bf), jcfg,
                                dilated_grid=jax_dilated_chunk_grid(jnp.asarray(bf), jcfg))
    tout = render_rays_eval(FieldFns.from_model(tnet), None, torch.from_numpy(o),
                            torch.from_numpy(d), torch.from_numpy(bf), tcfg)
    np.testing.assert_allclose(tout["image"].numpy(), np.asarray(jout["image"]),
                               rtol=0, atol=2e-4)
    np.testing.assert_allclose(tout["weights_sum"].numpy(), np.asarray(jout["weights_sum"]),
                               rtol=0, atol=2e-4)
    np.testing.assert_allclose(tout["depth"].numpy(), np.asarray(jout["depth"]),
                               rtol=0, atol=2e-4)
    assert np.isfinite(tout["image"].numpy()).all()
    if eval_budget < 0.1:
        assert tout["rounds"] > 0
    np.testing.assert_allclose(tout["image"][-4:].numpy(), 1.0)  # missed rays: background
