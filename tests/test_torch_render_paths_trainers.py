"""The trainers on the other render paths:

- `TensoRFTrainer.loss_on_batch` on the stream path (`march_chunk=0`), the
  grouped slab march with the global budget (`march_dense=False`) and
  without one (`compact_fraction=1`), against the JAX step's loss (the
  ray-masked MSE plus 1e-4 times the L1 density term) under `jit`, with
  `test_torch_tensorf_step.py`'s set-up and tolerances (the loss 1e-5
  relative, every parameter's gradient 1e-4 norm-relative; the demand and
  the ray mask exact);
- `Trainer` on `torch_train_helpers.py`'s small network and a 4-frame
  32x32 scene with the render paths of `RenderConfig()`'s defaults
  (`march_dense=False`, `compact_fraction=1`, `march_group=0`), of
  `--no_march_dense` (the grouped slab march and the budget) and of
  `--march_chunk 0` (the stream march): one sample budget and no tier read
  on the slab paths, the tier ladder on the stream path; the dilated chunk
  grid built only where the chunked march is on; 17 steps over two grid
  updates with no tensor read back inside `train_step` (counted as
  `test_torch_trainer.py` counts them), finite losses and weights, and a
  finite PSNR through the eval each config takes.

The TensoRF cases compile JAX programs: this file has four cases."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tngp_torch.train.trainer as trainer_mod
from test_torch_tensorf_step import L1W, _trainer
from tngp.render import RenderConfig as JaxRenderConfig
from tngp.train.tensorf_trainer import l1_density_loss as jax_l1
from tngp_torch.convert import flax_params_from_ngp_state_dict, ngp_state_dict_from_flax
from tngp_torch.data import make_synthetic_dataset
from tngp_torch.kernels import scatter
from tngp_torch.models import NGPNetwork
from tngp_torch.render import RenderConfig
from tngp_torch.train import Trainer
from tngp_torch.utils import TrainConfig
from torch_tensorf_helpers import np_tree, rel_err, tensorf_nets
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from torch_train_helpers import CFG_KW, N_RAYS, NET_KW, jax_loss_fn, scene_inputs

PATHS = {
    "stream": dict(march_dense=True, march_chunk=0),
    "slab_budget": dict(march_dense=False, march_group=8),
    "slab_all": dict(march_dense=False, march_group=8, compact_fraction=1.0),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_tensorf_step_on_the_other_paths(path, monkeypatch):
    scene = scene_inputs()
    jnet, params, tnet = tensorf_nets("vm", bg_radius=-1.0, aabb=())
    with torch.no_grad():  # factors large enough that the field has density to learn
        for n, p in tnet.named_parameters():
            if n.startswith("sigma_"):
                p.mul_(6.0)
    params = flax_params_from_ngp_state_dict(tnet.state_dict())
    kw = dict(CFG_KW, **PATHS[path])
    jcfg, tcfg = JaxRenderConfig(**kw), RenderConfig(**kw)
    base = jax_loss_fn(jnet, scene, jcfg)

    def jloss(p):
        loss, out = base(p)
        return loss + L1W * jax_l1(p), {k: out[k] for k in ("num_points", "ray_mask")}

    (jl, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    tr = _trainer(tnet, tcfg, scene["bitfield"])
    assert len(tr._tier_M) == 1  # no budget tiers for a subclass's step
    batch = {"frame": 0, "rays_o": torch.from_numpy(scene["o"]),
             "rays_d": torch.from_numpy(scene["d"]), "gt_rgb": torch.from_numpy(scene["gt"]),
             "noise": torch.from_numpy(scene["noise"]), "bg": None}
    outs = []
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
    errs = {n: rel_err(named[n].grad.numpy(), want[n].numpy()) for n in named}
    assert set(named) == set(want) and max(errs.values()) <= 1e-4, errs
    assert all(float(np.abs(want[n].numpy()).max()) > 0 for n in named), errs


def test_trainer_on_the_other_paths_reads_nothing_back_in_a_step(monkeypatch):
    ds = make_synthetic_dataset(n_frames=4, H=32, W=32, seed=0, num_steps=64, device="cpu")
    defaults = {f.name: getattr(RenderConfig(), f.name)
                for f in dataclasses.fields(RenderConfig)
                if f.name in ("march_dense", "compact_fraction", "march_group", "march_chunk")}
    assert defaults == dict(march_dense=False, compact_fraction=1.0, march_group=0,
                            march_chunk=8)
    reads = {"n": 0, "on": False}
    for attr in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__",
                 "__index__"):
        orig = getattr(torch.Tensor, attr)

        def counted(self, *a, _orig=orig, **k):
            reads["n"] += reads["on"]
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, attr, counted)
    statement_check = scatter._check_indices

    def cpu_statement_check(*a, **k):  # runs for CPU tensors only, never on the card
        on, reads["on"] = reads["on"], False
        try:
            return statement_check(*a, **k)
        finally:
            reads["on"] = on

    monkeypatch.setattr(scatter, "_check_indices", cpu_statement_check)
    for name, over in (("defaults", defaults), ("no_march_dense", PATHS["slab_budget"]),
                       ("march_chunk 0", PATHS["stream"])):
        cfg = RenderConfig(**dict(CFG_KW, **over))
        model = NGPNetwork(encoding="hashgrid_window", compute_dtype=torch.float32, device="cpu",
                           **NET_KW)
        tr = Trainer(model, ds, cfg, TrainConfig(num_rays=N_RAYS, iters=1000), device="cpu")
        tiered = cfg.march_dense and 0 < cfg.compact_fraction < 1
        assert (len(tr._tier_M) > 1) == tiered, name
        assert (tr._dgrid is None) == (cfg.march_chunk == 0), name
        step, opt_step = tr.train_step, tr.optimizer.step

        def train_step(_step=step):
            reads["on"] = True
            try:
                return _step()
            finally:
                reads["on"] = False

        def optimizer_step(*a, _opt_step=opt_step, **k):  # Adam's own host counters
            reads["on"] = False
            try:
                return _opt_step(*a, **k)
            finally:
                reads["on"] = True

        tr.train_step, tr.optimizer.step = train_step, optimizer_step
        losses, pts, kept = tr.run_steps(17)
        assert reads["n"] == 0, name
        assert tr.host_reads == int(tiered) and tr._grid_updates == 2, name
        assert np.isfinite(losses.numpy()).all() and int(pts[-1]) > 0, name
        assert all(torch.isfinite(p).all() for p in tr.params), name
        assert np.isfinite(tr.evaluate(ds)), name
