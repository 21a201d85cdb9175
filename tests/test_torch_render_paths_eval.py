"""`render_rays_eval`'s other paths (`tngp_torch/render/renderer.py`)
against the JAX package's (`tngp/render/renderer.py:388-460, 525-713`), on
`test_torch_ngp_eval.py`'s small instant-NGP network (bf16 MLPs, the
windowed grid encoder, weights carried across by `tngp_torch.convert`),
its sphere occupancy (16^3) and 72 rays (four miss the box), K_eval 16:

- the stream eval with the chunked march off (`march_chunk=0`): the stream
  march and `compact_mask_hier` for the first pass, each ray resuming at
  its first budget-dropped rung, then the slab residual rounds over the
  alive rays (the grouped march, `march_group=8`), with the first pass's
  budget at 0.75 and starved to 0.05 (rays overflow it and the rounds do
  most of the work), and with the flat slab march in the rounds
  (`march_group=0`);
- the reference-style full-width round loop (`eval_stream=False`).

Tolerance 2e-4 on image, weights_sum and normalised depth, as
`test_torch_ngp_eval.py` states for the chunked eval: the two packages
composite in f32 in another order and a few samples' bf16 MLP outputs
differ by one ulp.  The JAX render runs as one `jit` program.  Each case
compiles it: this file has four cases."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ngp_eval import _rays, _sphere_bitfield, nets  # noqa: F401  (the fixture)
from tngp.render import FieldFns as JaxFieldFns
from tngp.render import RenderConfig as JaxRenderConfig
from tngp.render import render_rays_eval as jax_render_rays_eval
from tngp_torch.ops.rays import near_far_from_aabb
from tngp_torch.render import FieldFns, RenderConfig, render_rays_eval
from tngp_torch.render.renderer import _eval_stream_march
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

BASE = dict(bound=1.0, grid_size=16, max_steps=128, K=32, K_eval=16, min_near=0.05,
            march_chunk=0, march_group=8)


@pytest.mark.parametrize("over", [
    dict(eval_budget=0.75),
    dict(eval_budget=0.05),
    dict(eval_budget=0.05, march_group=0),
    dict(eval_stream=False),
], ids=["stream", "stream_starved", "stream_starved_flat", "round_loop"])
def test_eval_path_matches(nets, over):  # noqa: F811
    jnet, params, tnet = nets
    kw = dict(BASE, **over)
    jcfg, tcfg = JaxRenderConfig(**kw), RenderConfig(**kw)
    o, d = _rays(72, 2)
    bf = _sphere_bitfield(16)
    jfield = JaxFieldFns.from_model(jnet)
    jout = jax.jit(lambda p, o, d, b: jax_render_rays_eval(jfield, p, o, d, b, jcfg))(
        params, jnp.asarray(o), jnp.asarray(d), jnp.asarray(bf))
    tout = render_rays_eval(FieldFns.from_model(tnet), None, torch.from_numpy(o),
                            torch.from_numpy(d), torch.from_numpy(bf), tcfg)
    for name in ("image", "weights_sum", "depth"):
        np.testing.assert_allclose(tout[name].numpy(), np.asarray(jout[name]), rtol=0,
                                   atol=2e-4, err_msg=name)
    assert np.isfinite(tout["image"].numpy()).all() and float(tout["weights_sum"].max()) > 0.5
    np.testing.assert_allclose(tout["image"][-4:].numpy(), 1.0)  # missed rays: background
    assert not bool(tout["cut"].any())
    max_rounds = -(-tcfg.max_steps // tcfg.K_eval)
    assert 0 < tout["rounds"] <= max_rounds + (2 if tcfg.eval_stream else 0)
    assert tout["host_reads"] >= tout["rounds"] and tout["valid_samples"] > 0
    if tcfg.eval_budget < 0.1:
        # the first pass's march: the starved budget drops rays' samples
        # (they resume at their first dropped rung)
        nears, fars = near_far_from_aabb(torch.from_numpy(o), torch.from_numpy(d), tcfg.aabb,
                                         tcfg.min_near)
        cm = _eval_stream_march(torch.from_numpy(o), torch.from_numpy(d), nears, fars,
                                torch.from_numpy(bf), tcfg)
        assert int((~cm.ray_mask & (cm.resume_t < fars)).sum()) > 10
