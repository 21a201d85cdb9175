"""The D-NeRF trainer of `tngp_torch`: three Adam + EMA steps over its
parameters (the deform net included) against optax and the JAX EMA, and
`DNeRFTrainer` itself on a tiny dynamic scene (time grid, grid updates, no
host read inside a step, `render_image(time=)`, `evaluate`).  One step
against the JAX package's is in `test_torch_dnerf.py`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tngp.train.ema import ema_init as jax_ema_init
from tngp.train.ema import ema_update as jax_ema_update
from tngp.train.trainer import make_optimizer as jax_make_optimizer
from tngp.utils.config import TrainConfig as JaxTrainConfig
from tngp_torch.convert import flax_params_from_ngp_state_dict, load_adam_state, \
    ngp_state_dict_from_flax
from tngp_torch.data import make_synthetic_dynamic_dataset
from tngp_torch.kernels import scatter
from tngp_torch.models import DNeRFNetwork
from tngp_torch.render import RenderConfig
from tngp_torch.train import DNeRFTrainer, ema_init, ema_update, make_optimizer
from tngp_torch.utils import TrainConfig
from torch_train_helpers import (
    CFG_KW,
    DNERF_BLOCK,
    DNERF_ENC_KW,
    DNERF_KW,
    dnerf_nets,
    port_dnerf_step,
    scene_inputs,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TIME = float(np.float32(0.6))  # a frame time (f32); slice 2 of 4


def test_three_adam_ema_steps_match_optax():
    """The optimiser over D-NeRF's parameters (deform net included): three
    steps that feed both optimisers the port's gradient at the port's
    current weights, from a carried-over optax state, with the decaying lr
    and the per-step EMA; f32 rounding, 1e-6."""
    scene = scene_inputs()
    _, params, tnet = dnerf_nets("f32")
    tr, batch, *_ = port_dnerf_step(tnet, scene, TIME)
    tc_kw = dict(lr=1e-2, iters=10, ema_decay=0.95)
    tx = jax_make_optimizer(JaxTrainConfig(**tc_kw))

    def port_grads():
        tnet.zero_grad(set_to_none=True)
        tr.loss_on_batch(batch)[0].backward()
        return flax_params_from_ngp_state_dict({n: p.grad for n, p in tnet.named_parameters()})

    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, port_grads()),
                                   opt_state, jparams)
    jparams = optax.apply_updates(jparams, updates)
    tnet.load_state_dict(ngp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jparams)))
    opt, sched = make_optimizer(tnet.parameters(), TrainConfig(**tc_kw))
    adam = opt_state[0]
    load_adam_state(opt, tnet, int(adam.count), jax.tree_util.tree_map(np.asarray, adam.mu),
                    jax.tree_util.tree_map(np.asarray, adam.nu))
    sched.step()
    tparams = list(tnet.parameters())
    jema, tema = jax_ema_init(jparams), ema_init(tparams)
    start = {n: p.detach().clone() for n, p in tnet.named_parameters()}
    for _ in range(3):
        grads = port_grads()
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), opt_state,
                                       jparams)
        jparams = optax.apply_updates(jparams, updates)
        jema = jax_ema_update(jema, jparams, 0.95)
        opt.step()
        sched.step()
        ema_update(tema, tparams, 0.95)
    want = ngp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    want_ema = ngp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jema))
    for (name, p), e in zip(tnet.named_parameters(), tema):
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(e.numpy(), want_ema[name].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=name + " (ema)")
        assert float((p.detach() - start[name]).abs().max()) > 1e-3, name


def test_trainer_trains_renders_at_a_time_and_a_step_reads_nothing_back(monkeypatch):
    """`DNeRFTrainer(device="cpu")` for 12 steps on a 3-frame 16x16 dynamic
    scene, grid updates at steps 0 and 8 (both full: fewer than 16 have
    run), no budget tiers; no tensor is read back inside `train_step` (the
    reads counted, and the CPU-only ones left out, as in
    `test_torch_trainer.py`); `render_image(time=)` and
    `evaluate` give finite images."""
    ds = make_synthetic_dynamic_dataset(n_frames=3, H=16, W=16, num_steps=32, device="cpu")
    model = DNeRFNetwork(encoding="hashgrid_window", device="cpu", **DNERF_KW, **DNERF_ENC_KW)
    model.encoder.block = DNERF_BLOCK
    cfg = dataclasses.replace(RenderConfig(**CFG_KW), grid_size=16)
    tr = DNeRFTrainer(model, ds, cfg, TrainConfig(num_rays=64, iters=1000), time_size=2,
                      update_interval=8, device="cpu")
    assert len(tr._tier_M) == 1 and len(tr._dgrids) == 2

    reads = {"n": 0, "on": False}
    for attr in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__",
                 "__index__"):
        orig = getattr(torch.Tensor, attr)

        def counted(self, *a, _orig=orig, **k):
            reads["n"] += reads["on"]
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, attr, counted)
    step, opt_step = tr.train_step, tr.optimizer.step

    def train_step():
        reads["on"] = True
        try:
            return step()
        finally:
            reads["on"] = False

    def optimizer_step(*a, **k):
        reads["on"] = False
        try:
            return opt_step(*a, **k)
        finally:
            reads["on"] = True

    tr.train_step, tr.optimizer.step = train_step, optimizer_step
    statement_check = scatter._check_indices

    def cpu_statement_check(*a, **k):
        on, reads["on"] = reads["on"], False
        try:
            return statement_check(*a, **k)
        finally:
            reads["on"] = on

    monkeypatch.setattr(scatter, "_check_indices", cpu_statement_check)
    losses, pts, kept = tr.run_steps(12)
    assert reads["n"] == 0
    assert tr.global_step == 12 and tr._grid_updates == 2 and int(tr.grid.iter_density) == 2
    assert tr.grid.bitfield.shape == (2, 16**3 // 8) and float(tr.grid.mean_density) > 0
    assert np.isfinite(losses.numpy()).all() and int(pts.max()) > 0
    monkeypatch.undo()
    img, dep = tr.render_image(ds.poses[1], time=float(ds.times[1]))
    assert img.shape == (16, 16, 3) and dep.shape == (16, 16) and np.isfinite(img).all()
    assert np.isfinite(tr.evaluate(ds))
