"""Port parity for one TensoRF training step: `TensoRFTrainer.loss_on_batch`
(the base step's `render_rays_train` on the `march_dense` branch with the
trainer's dilated chunk grid and its one budget, the ray-masked MSE, plus
`l1_reg_weight` (1e-4) times the L1 density term), VM and CP, on a trainer
built on the CPU whose grid is set to the blob scene's occupancy bitfield
(32^3), against the JAX step's loss (`tngp/train/tensorf_trainer.py:84-92`:
`render_rays_train`, the masked MSE and `l1w * l1_density_loss`, written
out here because the package builds it inside its jitted step) under
`jit`, as the package runs it: the small TensoRF of `torch_tensorf_helpers`
(f32 MLPs, no background), 128 rays with explicit pixels, march noise and
targets (`torch_train_helpers.scene_inputs`).

The march's integers are exact (`tests/test_torch_march_chunked.py`), so
the same samples reach the field.  Tolerances: the loss 1e-5 relative;
each parameter's gradient 1e-4 norm-relative (f32 summation order in the
compositor's scans, the matmuls and the factor gradients' scatter-adds).
The cases compile JAX programs: this file has two."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tngp.render import RenderConfig as JaxRenderConfig
from tngp.train.tensorf_trainer import l1_density_loss as jax_l1
from tngp_torch.convert import flax_params_from_ngp_state_dict, ngp_state_dict_from_flax
from tngp_torch.data import NeRFDataset
from tngp_torch.render import OccupancyGrid, RenderConfig
import tngp_torch.train.trainer as trainer_mod
from tngp_torch.train import TensoRFTrainer
from tngp_torch.utils import TrainConfig
from torch_tensorf_helpers import np_tree, rel_err, tensorf_nets
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from torch_train_helpers import CFG_KW, H, N_RAYS, W, jax_loss_fn, scene_inputs

L1W = 1e-4


def _trainer(tnet, tcfg, bitfield):
    """A `TensoRFTrainer` on the CPU over `tnet` (no upsample milestone),
    its grid set to `bitfield`."""
    ds = NeRFDataset(poses=np.stack([np.eye(4, dtype=np.float32)] * 2),
                     intrinsics=np.array([0.9 * W, 0.9 * W, W / 2, H / 2], np.float32), H=H,
                     W=W, images=np.zeros((2, H, W, 3), np.float32))
    tr = TensoRFTrainer(tnet, ds, tcfg, TrainConfig(num_rays=N_RAYS, use_checkpoint="scratch"),
                        l1_reg_weight=L1W, upsample_model_steps=(), device="cpu")
    z = torch.zeros(())
    bits = torch.from_numpy(bitfield.copy())
    tr.set_grid(OccupancyGrid(density_grid=torch.zeros(1, bits.numel() * 8), bitfield=bits,
                              mean_density=z, iter_density=z.long()))
    return tr


@pytest.mark.parametrize("decomposition", ["vm", "cp"])
def test_tensorf_step_loss_and_every_gradient_match(decomposition, monkeypatch):
    scene = scene_inputs()
    jnet, params, tnet = tensorf_nets(decomposition, bg_radius=-1.0, aabb=())
    with torch.no_grad():  # factors large enough that the field has density to learn
        for n, p in tnet.named_parameters():
            if n.startswith("sigma_"):
                p.mul_(6.0)
    params = flax_params_from_ngp_state_dict(tnet.state_dict())
    jcfg, tcfg = JaxRenderConfig(**CFG_KW), RenderConfig(**CFG_KW)
    base = jax_loss_fn(jnet, scene, jcfg)

    def jloss(p):
        loss, out = base(p)
        return loss + L1W * jax_l1(p), {k: out[k] for k in ("num_points", "ray_mask")}

    (jl, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    tr = _trainer(tnet, tcfg, scene["bitfield"])
    batch = {"frame": 0, "rays_o": torch.from_numpy(scene["o"]),
             "rays_d": torch.from_numpy(scene["d"]), "gt_rgb": torch.from_numpy(scene["gt"]),
             "noise": torch.from_numpy(scene["noise"]), "bg": None}
    outs = []  # the trainer's render output, for its ray mask
    render = trainer_mod.render_rays_train
    monkeypatch.setattr(trainer_mod, "render_rays_train",
                        lambda *a, **k: outs.append(render(*a, **k)) or outs[-1])
    loss, npts, kept = tr.loss_on_batch(batch)
    loss.backward()

    assert int(npts) == int(jout["num_points"]) > 0 and len(outs) == 1
    np.testing.assert_array_equal(outs[0]["ray_mask"].numpy(), np.asarray(jout["ray_mask"]))
    assert float(kept) == float(np.asarray(jout["ray_mask"]).sum())
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want = ngp_state_dict_from_flax(np_tree(jgrad))
    named = dict(tnet.named_parameters())
    assert set(named) == set(want)
    errs = {n: rel_err(named[n].grad.numpy(), want[n].numpy()) for n in named}
    assert max(errs.values()) <= 1e-4, errs
    assert all(float(np.abs(want[n].numpy()).max()) > 0 for n in named), errs
