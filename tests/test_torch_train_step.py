"""Port parity for the training slice as a whole: a small instant-NGP
network (4 levels, hidden 16, 2^12 rows per level) on the blob scene's
occupancy grid (32^3), 128 rays, K 16.  Same weights (through
`tngp_torch.convert`), same rays, same march noise, same targets: the
outputs of `render_rays_train`, the ray-masked loss and every parameter's
gradient against the JAX package; three optimiser steps with the per-step
EMA against optax Adam and the JAX EMA; and the `Trainer` itself.

The JAX encoder runs its binned Pallas path in interpret mode
(`TNGP_WIN_FORCE_BINNED`), so its table gradient is the TPU kernel's
(products rounded to bf16), the one the port's backward computes."""

import jax
import numpy as np
import pytest

from tngp.render import RenderConfig as JaxRenderConfig
from tngp_torch.convert import ngp_state_dict_from_flax
from tngp_torch.render import RenderConfig
from torch_train_helpers import (
    CFG_KW,
    N_RAYS,
    NAMES,
    jax_loss_fn,
    nets,
    rel_err,
    scene_inputs,
    torch_loss,
)


@pytest.fixture(autouse=True)
def _binned_jax_encoder(monkeypatch):
    monkeypatch.setenv("TNGP_WIN_FORCE_BINNED", "1")


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_train_render_loss_and_every_gradient_match(dtype_name):
    """Integers of the march exact; image 2e-4 as the eval test; then the
    loss and each parameter's gradient by norm-relative error.
    f32 MLPs: 1e-3 (f32 summation order in the MLPs, the compositor and the
    table gradient).  bf16 MLPs: both packages round every layer's output
    and every backward product to bf16 but sum in another order, so single
    roundings flip by a bf16 ulp (2^-7 relative) along the chain of five
    layers; measured 0.4-1.2e-2 here, limit 3e-2, and the loss, which
    averages them out, to 1e-3."""
    scene = scene_inputs()
    jnet, params, tnet = nets(dtype_name)
    jcfg, tcfg = JaxRenderConfig(**CFG_KW), RenderConfig(**CFG_KW)
    # op by op, not jitted: under jit XLA may keep excess precision where
    # the kernel rounds a product to bf16 (measured 5e-3 on the table gradient)
    (jloss, jout), jgrads = jax.value_and_grad(jax_loss_fn(jnet, scene, jcfg), has_aux=True)(
        params)
    tloss, tout = torch_loss(tnet, scene, tcfg)
    tloss.backward()

    assert int(tout["num_points"]) == int(jout["num_points"]) > 200
    np.testing.assert_array_equal(tout["ray_mask"].numpy(), np.asarray(jout["ray_mask"]))
    assert 0 < int(tout["ray_mask"].sum()) < N_RAYS  # the budget drops some rays
    img_tol = 2e-4 if dtype_name == "f32" else 8e-3
    np.testing.assert_allclose(tout["image"].detach().numpy(), np.asarray(jout["image"]),
                               rtol=0, atol=img_tol)
    np.testing.assert_allclose(tout["weights_sum"].detach().numpy(),
                               np.asarray(jout["weights_sum"]), rtol=0, atol=img_tol)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5 if dtype_name == "f32"
                               else 1e-3)

    want = ngp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    got = dict(tnet.named_parameters())
    assert set(want) == set(got) == set(NAMES)
    limit = 1e-3 if dtype_name == "f32" else 3e-2
    for name in NAMES:
        g, w = got[name].grad.numpy(), want[name].numpy()
        assert np.isfinite(g).all() and np.linalg.norm(w) > 0, name
        assert rel_err(g, w) <= limit, (name, rel_err(g, w))
    # table entries no sample touched have an exactly zero gradient in both
    gz, wz = got[NAMES[0]].grad.numpy() == 0, want[NAMES[0]].numpy() == 0
    assert (gz == wz).mean() > 0.999 and gz.mean() > 0.5


