"""Port parity for `tngp_torch/train/cc_trainer.py` `CCTrainer` against
`tngp/train/cc_trainer.py`:

- one step's loss and every gradient (`loss_on_batch`: near/far, the slab
  march, the residual field, `composite_rays_cf` per prefix over a random
  background, the mean over prefixes) against the JAX step's loss function
  (`:125-172`) with the same rays, noise, targets and background, jitted
  as in the package, on the blob scene's 32^3 bitfield; the loss 1e-5
  relative, gradients 1e-4 norm-relative (f32 summation order in the
  projections, the compositor's cumsums and the scatter-adds);
- a JAX checkpoint (two-group Adam moments from one optax update on fixed
  gradients, an EMA apart from the weights, a grid with values) loads into
  a port trainer built with other ranks: the sidecar's ranks rebuild the
  field, then every entry equals the file's (the optax `multi_transform`
  state with its masked halves), with an empty report, and each group's lr
  is its schedule's at the count;
- a port checkpoint after two steps loads into the JAX trainer with an
  empty report and the port's values, both groups' counts 2.
The JAX cases compile small programs: this file has three cases."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import tngp.models.ccnerf as jcc
from tngp.data import NeRFDataset as JaxNeRFDataset
from tngp.ops import march_rays as jax_march_rays
from tngp.ops import near_far_from_aabb as jax_near_far
from tngp.ops.composite import composite_rays_cf as jax_composite
from tngp.render import RenderConfig as JaxRenderConfig
from tngp.train.cc_trainer import CCTrainer as JaxCCTrainer
from tngp.train.checkpoint import load_checkpoint as jax_load_checkpoint
from tngp.utils.config import TrainConfig as JaxTrainConfig
from tngp_torch.data import NeRFDataset, make_synthetic_dataset
from tngp_torch.models import ccnerf as tcc
from tngp_torch.render import OccupancyGrid, RenderConfig
from tngp_torch.train import CCTrainer
from tngp_torch.utils import TrainConfig
from torch_tensorf_helpers import CC_SMALL, rel_err, small_cc_cfg
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from torch_train_helpers import CFG_KW, H, N_RAYS, W, scene_inputs

CK_CFG = dict(bound=1.0, grid_size=16, max_steps=64, K=16, K_eval=16, min_near=0.05,
              compact_fraction=0.5, march_dense=True, eval_tiers=(256,))


def _jcfg(cfg):
    return jcc.CCConfig(**{k: getattr(cfg, k) for k in (*CC_SMALL, "degree", "bound")})


def _dataset(n=2, channels=4):
    return NeRFDataset(poses=np.stack([np.eye(4, dtype=np.float32)] * n),
                       intrinsics=np.array([0.9 * W, 0.9 * W, W / 2, H / 2], np.float32), H=H,
                       W=W, images=np.zeros((n, H, W, channels), np.float32))


def test_cc_step_loss_and_every_gradient_match():
    scene = scene_inputs()
    cfg = small_cc_cfg()
    tr = CCTrainer(cfg, _dataset(), RenderConfig(**CFG_KW),
                   TrainConfig(num_rays=N_RAYS, iters=1000, use_checkpoint="scratch"),
                   device="cpu", model=tcc.CCNeRF(cfg, device="cpu", seed=7))
    z = torch.zeros(())
    bits = torch.from_numpy(scene["bitfield"].copy())
    tr.set_grid(OccupancyGrid(density_grid=torch.zeros(1, bits.numel() * 8), bitfield=bits,
                              mean_density=z, iter_density=z.long()))
    bg = np.random.default_rng(3).uniform(size=(N_RAYS, 3)).astype(np.float32)
    batch = {"frame": 0, "rays_o": torch.from_numpy(scene["o"]),
             "rays_d": torch.from_numpy(scene["d"]), "gt_rgb": torch.from_numpy(scene["gt"]),
             "noise": torch.from_numpy(scene["noise"]), "bg": torch.from_numpy(bg)}
    loss, npts, kept = tr.loss_on_batch(batch)
    loss.backward()

    jcfg, rc = _jcfg(cfg), JaxRenderConfig(**CFG_KW)
    o, d = jnp.asarray(scene["o"]), jnp.asarray(scene["d"])
    nears, fars = jax_near_far(o, d, rc.aabb, rc.min_near)
    res = jax_march_rays(o, d, nears, fars, jnp.asarray(scene["bitfield"]), bound=rc.bound,
                         cascades=rc.cascades, grid_size=rc.grid_size, dt_gamma=rc.dt_gamma,
                         max_steps=rc.max_steps, K=rc.K, noise=jnp.asarray(scene["noise"]))
    Kc = cfg.K

    def jloss(p):
        sig, rgb = jcc.cc_sigma_rgb_cf(p, jcfg, res.xyzs_cf.reshape(3, -1),
                                       res.dirs_cf.reshape(3, -1), residual=True)
        sig = sig.reshape(Kc, N_RAYS, rc.K) * rc.density_scale
        rgb = rgb.reshape(Kc, 3, N_RAYS, rc.K)
        imgs = []
        for k in range(Kc):
            ws, _, image, _ = jax_composite(sig[k], rgb[k], res.dts, res.gaps, res.mask,
                                            rc.T_thresh)
            imgs.append(image + (1.0 - ws)[:, None] * jnp.asarray(bg))
        return jnp.mean((jnp.stack(imgs) - jnp.asarray(scene["gt"])[None]) ** 2)

    params = tr.model.numpy_params()
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jax.tree_util.tree_map(jnp.asarray, params))
    assert int(npts) == int(res.counts.sum()) > 0 and float(kept) == N_RAYS
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    named = dict(tr.model.named_parameters())
    for k, v in jg.items():
        for i, g in enumerate(v if isinstance(v, list) else [v]):
            name = f"{k}.{i}" if isinstance(v, list) else k
            assert rel_err(named[name].grad.numpy(), np.asarray(g)) <= 1e-4, name
            assert np.abs(np.asarray(g)).max() > 0, name


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


@pytest.fixture
def port_init(monkeypatch):
    """The JAX trainers start from the port's `cc_init` (numpy): the JAX
    one would compile each factor's draw op by op, and no comparison here
    depends on the initial values."""
    def init(self, key):
        return jax.tree_util.tree_map(jnp.asarray,
                                      tcc.cc_init(tcc.CCConfig(**vars(self.cc_cfg)), seed=5))

    monkeypatch.setattr(JaxCCTrainer, "_init_params", init)


def _jax_trainer(ds, ws, cfg, use_checkpoint="scratch"):
    tc = JaxTrainConfig(name="cc", workspace=str(ws), iters=100, num_rays=128,
                        use_checkpoint=use_checkpoint)
    return JaxCCTrainer(_jcfg(cfg), ds, JaxRenderConfig(**CK_CFG), tc)


def _port_trainer(ds, ws, cfg, use_checkpoint="scratch"):
    pds = NeRFDataset(poses=np.asarray(ds.poses), intrinsics=np.asarray(ds.intrinsics),
                      H=ds.H, W=ds.W, images=np.asarray(ds.images))
    tc = TrainConfig(name="cc", workspace=str(ws), iters=100, num_rays=128,
                     use_checkpoint=use_checkpoint)
    return CCTrainer(cfg, pds, RenderConfig(**CK_CFG), tc, device="cpu")


def test_port_loads_a_jax_checkpoint_with_other_ranks(scene, tmp_path, port_init):
    jtr = _jax_trainer(scene, tmp_path, small_cc_cfg())
    g = np.random.default_rng(0).uniform(0.0, 3.0, (1, 16**3)).astype(np.float32)
    jtr.grid = dataclasses.replace(jtr.grid, density_grid=jnp.asarray(g),
                                   mean_density=jnp.asarray(g.mean()))
    grads = jax.tree_util.tree_map(lambda p: np.sin(3.0 * np.asarray(p)) + 0.1, jtr.params)
    _, jtr.opt_state = jax.jit(jtr.tx.update)(grads, jtr.opt_state, jtr.params)
    jtr.ema_params = jax.tree_util.tree_map(lambda p: 0.5 * np.asarray(p) + 0.01, jtr.params)
    jtr.global_step = 1
    jtr.save_checkpoint()
    other = small_cc_cfg(rank_mat=(0, 3, 4), rank_vec_density=(6, 8, 8))
    tr = _port_trainer(scene, tmp_path, other, use_checkpoint="latest")
    assert tr.cc_cfg == small_cc_cfg()
    _check(serialization.to_state_dict(jax.tree_util.tree_map(np.asarray, jtr._payload())),
           tr._payload())
    assert tr.global_step == 1
    assert tr.scheduler.get_last_lr() == [2e-2 * 0.1 ** (1 / 100), 1e-3 * 0.1 ** (1 / 100)]
    assert [len(gr["params"]) for gr in tr.optimizer.param_groups] == [
        sum(3 for k in jtr.params if "_U_" in k), sum(1 for k in jtr.params if "_S_" in k)]


def test_jax_loads_a_port_checkpoint(scene, tmp_path, port_init):
    tr = _port_trainer(scene, tmp_path, small_cc_cfg())
    tr.run_steps(2)
    path = tr.save_checkpoint()
    jtr = _jax_trainer(scene, os.path.join(tmp_path, "j"), small_cc_cfg())
    payload, meta = jax_load_checkpoint(path, jtr._payload())
    assert meta["_load_report"] == {"missing": [], "unexpected": [], "mismatched": []}
    assert meta["geometry"]["rank_mat"] == list(small_cc_cfg().rank_mat)
    _check(serialization.to_state_dict(jax.tree_util.tree_map(np.asarray, payload)),
           tr._payload())
    for grp in ("U", "S"):
        assert int(payload["opt_state"].inner_states[grp].inner_state[0].count) == 2
