"""Port parity for `tngp_torch/models/tensorf.py` `TensoRFNetwork` against
`tngp/models/tensorf.py`, VM and CP, f32 and bf16 MLPs: a small field
(resolution (12, 16, 20), ranks 2-5, colour features 6, hidden 16, the box
(-0.8, -0.9, -1.0)-(0.9, 0.8, 1.0), a [3, 16, 24] background plane) on the
same weights, at 256 points in [-1.1, 1.1]^3 (some outside the box):
`density_cf`, `sigma_rgb_cf` and `background_cf`, and the gradient of
every parameter of a weighted sum of them, the JAX side one `jit` program
a case (outputs and gradients together), as the JAX trainers run the field.

Tolerances:
- sigma (no MLP on its path): 1e-6 relative (the factor products and sums
  are the same f32 operations, which XLA may fuse into FMAs: measured 1.2e-7;
  `basis_mat`'s matmul and XLA's dot sum in other orders, which reaches rgb
  only);
- f32 MLPs: rgb and the background 1e-5 absolute; gradients 1e-4
  norm-relative (f32 summation order in the matmuls and the scatter-adds);
- bf16 MLPs: both packages round every layer's output to bf16 but sum in
  another order, so a rounding can flip by one bf16 ulp (2^-8 relative):
  rgb within 2e-2 absolute (a flip through the sigmoid), gradients 3e-2
  norm-relative as `tests/test_torch_train_step.py` holds them.

The cases compile JAX programs, so this file has four; the layout of the
colour encoding and the reference's background init are held in
`test_torch_tensorf_resize.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tngp.models.tensorf import TensoRFNetwork as JaxTensoRF
from tngp_torch.convert import ngp_state_dict_from_flax
from torch_tensorf_helpers import np_tree, points, rel_err, tensorf_nets
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

N = 256


def _outputs_jax(jnet, p, x, d, sph):
    sig, rgb = jnet.apply(p, x, d, method=JaxTensoRF.sigma_rgb_cf)
    dens = jnet.apply(p, x, method=JaxTensoRF.density_cf)["sigma"]
    bg = jnet.apply(p, sph, d, method=JaxTensoRF.background_cf)
    return sig, rgb, dens, bg


def _jax_outputs_and_grad(jnet):
    """The JAX outputs and the gradient of their weighted sum, one jitted
    program for `jnet`."""
    def jloss(p, x, d, sph, ws):
        outs = _outputs_jax(jnet, p, x, d, sph)
        return _weighted(outs, ws), outs

    return jax.jit(jax.value_and_grad(jloss, has_aux=True))


def _weighted(outs, ws):
    return sum((o.astype(jnp.float32) * w).sum() if isinstance(o, jax.Array)
               else (o.float() * w).sum() for o, w in zip(outs, ws))


@pytest.mark.parametrize("decomposition,dtype_name",
                         [("vm", "f32"), ("vm", "bf16"), ("cp", "f32"), ("cp", "bf16")])
def test_tensorf_outputs_and_every_gradient_match(decomposition, dtype_name):
    jnet, params, tnet = tensorf_nets(decomposition, dtype_name)
    x, d = points(N, seed=3)
    sph = np.random.default_rng(4).uniform(-1.05, 1.05, (2, N)).astype(np.float32)
    rng = np.random.default_rng(5)
    ws = [rng.normal(size=s).astype(np.float32) for s in ((N,), (3, N), (N,), (3, N))]

    (_, jouts), jgrad = _jax_outputs_and_grad(jnet)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(d),
        jnp.asarray(sph), [jnp.asarray(w) for w in ws])
    touts = (*tnet.sigma_rgb_cf(torch.tensor(x), torch.tensor(d)),
             tnet.density_cf(torch.tensor(x))["sigma"],
             tnet.background_cf(torch.tensor(sph), torch.tensor(d)))
    f32 = dtype_name == "f32"
    for name, a, b in zip(("sigma", "rgb", "density", "background"), touts, jouts):
        a, b = a.detach().float().numpy(), np.asarray(b, np.float32)
        if name in ("sigma", "density"):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 if f32 else 2e-2, err_msg=name)

    jgrad = ngp_state_dict_from_flax(np_tree(jgrad))
    loss = _weighted(touts, [torch.tensor(w) for w in ws])
    loss.backward()
    tol = 1e-4 if f32 else 3e-2
    named = dict(tnet.named_parameters())
    assert set(named) == set(jgrad)
    errs = {n: rel_err(named[n].grad.numpy(), jgrad[n].numpy()) for n in named}
    assert max(errs.values()) <= tol, errs
    assert all(np.abs(jgrad[n].numpy()).max() > 0 for n in named)

