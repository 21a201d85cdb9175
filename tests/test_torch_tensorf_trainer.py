"""Port parity for `tngp_torch/train/tensorf_trainer.py` `TensoRFTrainer`'s
checkpoints and its shrink + upsample, against `tngp/train/tensorf_trainer.py`
on a small TensoRF (resolution 16, ranks 2-4, one upsample milestone, at
step 2, towards 24) over the synthetic scene (4 frames of 16x16).  The JAX trainer
takes no training step here (its step would compile a large program): its
grid gets a density block, its Adam state moments from one optax update on
fixed gradients, and its EMA other values than its weights, so that every
entry of a checkpoint is told apart.  All comparisons are exact:

- the shrink and upsample at the milestone (`before_step` against
  `maybe_upsample`) on the same weights and grid: the same shrunk box,
  resolution, factors, and a fresh optimizer and EMA;
- a JAX checkpoint written after an upsample loads into a port trainer built
  at the first resolution: the sidecar's geometry rebuilds the module first,
  then every entry (weights, Adam count and moments, EMA, grid) equals the
  file's, with an empty report, and the lr is the schedule's at the count;
- a port checkpoint written after its own upsample and two steps loads into
  a JAX trainer built at the first resolution the same way, with an empty
  report.
The JAX trainers compile small programs (the grid marking, the dilated
grid): this file has three cases."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from tngp.data import NeRFDataset as JaxNeRFDataset
from tngp.models.tensorf import TensoRFNetwork as JaxTensoRF
from tngp.render import RenderConfig as JaxRenderConfig
from tngp.train.checkpoint import load_checkpoint as jax_load_checkpoint
from tngp.train.tensorf_trainer import TensoRFTrainer as JaxTensoRFTrainer
from tngp.utils.config import TrainConfig as JaxTrainConfig
from tngp_torch.convert import flax_params_from_ngp_state_dict
from tngp_torch.data import NeRFDataset, make_synthetic_dataset
from tngp_torch.models import TensoRFNetwork
from tngp_torch.render import RenderConfig
from tngp_torch.train import TensoRFTrainer
from tngp_torch.utils import TrainConfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# the colour factors at the density factors' ranks: the JAX upsample's eager
# ops compile once for both kinds (the shrunk box keeps the axes apart)
NET_KW = dict(resolution=(16, 16, 16), sigma_rank=(2, 3, 4), color_rank=(2, 3, 4),
              color_feat_dim=6, hidden_dim=16)
CFG_KW = dict(bound=1.0, grid_size=16, max_steps=64, K=16, K_eval=16, min_near=0.05,
              compact_fraction=0.5, march_dense=True, eval_tiers=(256,), density_thresh=1.0)
STEPS = (2,)


@pytest.fixture(autouse=True)
def _port_init(monkeypatch):
    """The JAX trainers start from the port's initial weights for their
    module's shapes: flax's `init` would compile every factor's draw op by
    op (~13 s), and no comparison here depends on the initial values."""
    def init(self, key):
        net = TensoRFNetwork(**{**NET_KW, "resolution": tuple(self.model.resolution),
                                "aabb": tuple(self.model.aabb or ())}, device="cpu")
        return jax.tree_util.tree_map(jnp.asarray,
                                      flax_params_from_ngp_state_dict(net.state_dict()))

    monkeypatch.setattr(JaxTensoRFTrainer, "_init_params", init)


def _jax_trainer(ds, ws, use_checkpoint="scratch"):
    tc = JaxTrainConfig(name="tf", workspace=str(ws), iters=100, num_rays=128,
                        use_checkpoint=use_checkpoint)
    return JaxTensoRFTrainer(JaxTensoRF(**NET_KW), ds, JaxRenderConfig(**CFG_KW), tc,
                             upsample_model_steps=STEPS, resolution1=24)


def _port_trainer(ds, ws, use_checkpoint="scratch"):
    pds = NeRFDataset(poses=np.asarray(ds.poses), intrinsics=np.asarray(ds.intrinsics),
                      H=ds.H, W=ds.W, images=np.asarray(ds.images))
    tc = TrainConfig(name="tf", workspace=str(ws), iters=100, num_rays=128,
                     use_checkpoint=use_checkpoint)
    return TensoRFTrainer(TensoRFNetwork(**NET_KW, device="cpu", seed=3), pds,
                          RenderConfig(**CFG_KW), tc, upsample_model_steps=STEPS,
                          resolution1=24, device="cpu")


def _dress(jtr):
    """Grid with an occupied block, Adam moments, an EMA apart from the
    weights (module docstring)."""
    H = CFG_KW["grid_size"]
    g = np.random.default_rng(0).uniform(0.0, 0.5, (H, H, H)).astype(np.float32)
    g[2:13, 4:12, 3:14] += 5.0
    dg = jnp.asarray(g.reshape(1, -1))
    jtr.grid = dataclasses.replace(jtr.grid, density_grid=dg, mean_density=jnp.mean(dg))
    grads = jax.tree_util.tree_map(lambda p: np.sin(3.0 * np.asarray(p)) + 0.1, jtr.params)
    _, jtr.opt_state = jax.jit(jtr.tx.update)(grads, jtr.opt_state, jtr.params)
    jtr.ema_params = jax.tree_util.tree_map(lambda p: 0.5 * np.asarray(p) + 0.01, jtr.params)


def _check(want, got, where=""):
    if isinstance(want, dict):
        assert set(want) == set(got), (where, set(want) ^ set(got))
        for k in want:
            _check(want[k], got[k], f"{where}/{k}")
        return
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=where)


@pytest.fixture(scope="module")
def scene():
    """The blob scene (4 frames of 16x16) as the JAX package's dataset,
    rendered by the port (the JAX render would compile a program)."""
    ds = make_synthetic_dataset(n_frames=4, H=16, W=16, seed=0, num_steps=64, device="cpu")
    return JaxNeRFDataset(poses=ds.poses, intrinsics=ds.intrinsics, H=ds.H, W=ds.W,
                          images=ds.images)


def test_upsample_matches_the_jax_trainer(scene, tmp_path):
    jtr = _jax_trainer(scene, tmp_path / "j")
    _dress(jtr)
    jtr.save_checkpoint()
    tr = _port_trainer(scene, tmp_path / "j")
    assert tr.load_checkpoint(os.path.join(tmp_path, "j", "checkpoints", "tf_ep0000.npz")) == {
        "missing": [], "unexpected": [], "mismatched": []}
    for step in STEPS:
        jtr.global_step = tr.global_step = step
        jtr.maybe_upsample()
        tr.before_step()
        assert tuple(tr.model.resolution) == tuple(jtr.model.resolution)
        assert tr.model.aabb == tuple(float(a) for a in jtr.model.aabb)
        _check(serialization.to_state_dict(jax.tree_util.tree_map(np.asarray, jtr._payload())),
               tr._payload())
    up = tr.upsamples
    assert [u["step"] for u in up] == list(STEPS)
    assert up[0]["shrunk"] != up[0]["old"] and up[-1]["new"] == tuple(jtr.model.resolution)
    assert int(tr.optimizer.state.get(tr.params[0], {}).get("step", 0)) == 0


def test_port_resumes_a_jax_checkpoint_across_an_upsample(scene, tmp_path):
    jtr = _jax_trainer(scene, tmp_path)
    _dress(jtr)
    jtr.global_step = STEPS[0]
    jtr.maybe_upsample()
    _dress(jtr)
    jtr.save_checkpoint()
    tr = _port_trainer(scene, tmp_path, use_checkpoint="latest")
    assert tuple(tr.model.resolution) == tuple(jtr.model.resolution) != (16, 16, 16)
    _check(serialization.to_state_dict(jax.tree_util.tree_map(np.asarray, jtr._payload())),
           tr._payload())
    assert tr.global_step == STEPS[0]
    assert tr.scheduler.get_last_lr() == [1e-2 * 0.1 ** (1 / 100)]
    tr.run_steps(1)  # trains on at the checkpoint's shape
    assert tr.global_step == STEPS[0] + 1


def test_jax_resumes_a_port_checkpoint_across_an_upsample(scene, tmp_path):
    tr = _port_trainer(scene, tmp_path)
    tr.run_steps(STEPS[0] + 2)
    assert len(tr.upsamples) == 1
    path = tr.save_checkpoint()
    jtr = _jax_trainer(scene, tmp_path, use_checkpoint="latest")
    assert tuple(jtr.model.resolution) == tuple(tr.model.resolution) != (16, 16, 16)
    payload, meta = jax_load_checkpoint(path, jtr._payload())
    assert meta["_load_report"] == {"missing": [], "unexpected": [], "mismatched": []}
    _check(serialization.to_state_dict(jax.tree_util.tree_map(np.asarray, payload)),
           tr._payload())
    assert int(payload["opt_state"][0].count) == 2
