"""The optimiser, the EMA and the `Trainer` of `tngp_torch` against optax
Adam, the JAX EMA and the JAX package's training loop semantics, on the
small network and scene of `torch_train_helpers.py`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tngp.render import RenderConfig as JaxRenderConfig
from tngp.train.ema import ema_init as jax_ema_init
from tngp.train.ema import ema_update as jax_ema_update
from tngp.train.trainer import make_optimizer as jax_make_optimizer
from tngp.utils.config import TrainConfig as JaxTrainConfig
from tngp_torch.convert import (
    flax_params_from_ngp_state_dict,
    load_adam_state,
    ngp_state_dict_from_flax,
)
from tngp_torch.data import make_synthetic_dataset
from tngp_torch.models import NGPNetwork
from tngp_torch.render import RenderConfig
from tngp_torch.train import Trainer, ema_init, ema_update, make_optimizer
from tngp_torch.utils import TrainConfig
from torch_train_helpers import (
    CFG_KW,
    N_RAYS,
    NET_KW,
    jax_loss_fn,
    nets,
    scene_inputs,
    torch_loss,
)


@pytest.fixture(autouse=True)
def _binned_jax_encoder(monkeypatch):
    monkeypatch.setenv("TNGP_WIN_FORCE_BINNED", "1")


def test_three_optimizer_steps_with_ema_match_optax():
    """Adam(0.9, 0.99, eps 1e-15) with the decaying lr and the per-step EMA,
    from a carried-over optax state (count 1, nonzero moments).  Each of the
    three steps feeds BOTH optimisers the port's gradient at the port's
    current weights, so the comparison is of the optimiser arithmetic alone
    (bias correction, eps, schedule, EMA): f32 rounding, 1e-6.  Entries
    whose gradient was zero at every step must not move at all."""
    scene = scene_inputs()
    jnet, params, tnet = nets("f32")
    tcfg = RenderConfig(**CFG_KW)
    tc_kw = dict(lr=1e-2, iters=10, ema_decay=0.95)
    tx = jax_make_optimizer(JaxTrainConfig(**tc_kw))

    def port_grads():
        tnet.zero_grad(set_to_none=True)
        torch_loss(tnet, scene, tcfg)[0].backward()
        seen.append(tnet.encoder.embeddings.grad.numpy() != 0)
        return flax_params_from_ngp_state_dict(
            {n: p.grad for n, p in tnet.named_parameters()})

    seen = []  # every gradient of the table that either optimiser was fed

    # one optax step first, so that the carried state is not the initial one
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, port_grads()),
                                   opt_state, jparams)
    jparams = optax.apply_updates(jparams, updates)
    adam = opt_state[0]
    tnet.load_state_dict(ngp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jparams)))
    opt, sched = make_optimizer(tnet.parameters(), TrainConfig(**tc_kw))
    load_adam_state(opt, tnet, int(adam.count),
                    jax.tree_util.tree_map(np.asarray, adam.mu),
                    jax.tree_util.tree_map(np.asarray, adam.nu))
    sched.step()  # the schedule has seen one step too
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
        assert float((p.detach() - start[name]).abs().max()) > 1e-3, name  # it did move
    # lr after 1 + 3 steps of the decay to 0.1x over 10
    assert np.isclose(opt.param_groups[0]["lr"], 1e-2 * 0.1 ** 0.4)
    table = dict(tnet.named_parameters())["encoder.embeddings"].detach()
    untouched = ~np.any(seen, axis=0)
    assert untouched.mean() > 0.5
    np.testing.assert_array_equal(table.numpy()[untouched], start["encoder.embeddings"].numpy()[
        untouched])


def test_own_gradients_three_steps_stay_close_to_optax():
    """The same three steps with each package's OWN gradients (f32 MLPs; the
    JAX gradient jitted, for time, which lets XLA keep excess precision where
    the encoder's backward rounds to bf16: 5e-3 on the table gradient).
    Adam divides by sqrt(v), so an entry whose gradient is near zero can step
    either way, by at most lr per step: every entry stays within 3 * 2 * lr,
    at least 95% of each tensor's entries agree to 1e-4 (measured: 97.6% for
    the 128-entry first sigma layer, above 99% elsewhere), and the loss after
    the steps agrees to 1e-3 relative."""
    scene = scene_inputs()
    jnet, params, tnet = nets("f32")
    jcfg, tcfg = JaxRenderConfig(**CFG_KW), RenderConfig(**CFG_KW)
    tc_kw = dict(lr=1e-2, iters=10)
    tx = jax_make_optimizer(JaxTrainConfig(**tc_kw))
    loss_fn = jax_loss_fn(jnet, scene, jcfg)
    grad_fn = jax.jit(jax.grad(lambda p: loss_fn(p)[0]))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    opt, sched = make_optimizer(tnet.parameters(), TrainConfig(**tc_kw))
    for _ in range(3):
        g = grad_fn(jparams)
        updates, opt_state = tx.update(g, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.zero_grad(set_to_none=True)
        torch_loss(tnet, scene, tcfg)[0].backward()
        opt.step()
        sched.step()
    want = ngp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    for name, p in tnet.named_parameters():
        diff = np.abs(p.detach().numpy() - want[name].numpy())
        assert diff.max() <= 6e-2 and (diff <= 1e-4).mean() >= 0.95, (name, diff.max())
    jl = float(loss_fn(jparams)[0])
    tl = float(torch_loss(tnet, scene, tcfg)[0].detach())
    assert np.isclose(tl, jl, rtol=1e-3), (tl, jl)


def test_trainer_trains_and_a_step_reads_nothing_back(monkeypatch):
    """`Trainer(device="cpu")` for 20 steps on a 4-frame 32x32 dataset, over
    two grid updates (steps 0 and 16) and one tier read: the loss falls, and
    no tensor is read back to the host inside `train_step` (`.item()`,
    `.tolist()`, `.cpu()`, `.numpy()` and the bool/int/float conversions are
    counted; Adam's reads of its own host-side step counters are not device
    reads and are left out)."""
    ds = make_synthetic_dataset(n_frames=4, H=32, W=32, seed=0, num_steps=64, device="cpu")
    model = NGPNetwork(compute_dtype=torch.float32, device="cpu", **NET_KW)
    cfg = RenderConfig(**CFG_KW)
    tr = Trainer(model, ds, cfg, TrainConfig(num_rays=N_RAYS, iters=1000), device="cpu")
    assert tr.tier_M == 512 and tr._tier_M == [128, 256, 512, 1024]
    assert dataclasses.asdict(tr._tier_cfgs[2]) == dataclasses.asdict(cfg)

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
    losses, pts, kept = tr.run_steps(20)
    assert reads["n"] == 0
    assert tr.host_reads == 1 and tr.global_step == 20 and tr._grid_updates == 2
    assert int(tr.grid.iter_density) == 2
    losses = losses.numpy()
    assert np.isfinite(losses).all() and losses[-5:].mean() < losses[:5].mean()
    assert all(torch.isfinite(p).all() for p in tr.params)
    # the per-step EMA trails the weights
    assert any(float((e - p).abs().max()) > 0 for e, p in zip(tr.ema_params, tr.params))
    psnr = tr.evaluate(ds)
    assert np.isfinite(psnr) and tr.last_render_stats["chunks"] == 1


def test_set_grid_installs_the_grid_and_rebuilds_the_dilated_grid():
    """`Trainer.set_grid` is the one place the march's dilated grid is built:
    after it the trainer marches through the grid it was given (here the blob
    scene's analytic occupancy instead of the all-untrained start), and a
    step's loss on it is finite."""
    from tngp_torch.data import make_blob_field
    from tngp_torch.ops.grid_utils import packbits
    from tngp_torch.render import OccupancyGrid, cell_centers_cf, dilated_chunk_grid

    ds = make_synthetic_dataset(n_frames=2, H=16, W=16, seed=0, num_steps=32, device="cpu")
    model = NGPNetwork(compute_dtype=torch.float32, device="cpu", **NET_KW)
    cfg = RenderConfig(**CFG_KW)
    tr = Trainer(model, ds, cfg, TrainConfig(num_rays=N_RAYS, iters=1000), device="cpu")
    before = tr._dgrid.clone()
    dens = make_blob_field(0, device="cpu").density(
        None, cell_centers_cf(0, cfg.bound, cfg.grid_size, device="cpu"))[None]
    grid = OccupancyGrid(density_grid=dens,
                         bitfield=packbits(dens, cfg.density_thresh).reshape(-1),
                         mean_density=dens.mean(),
                         iter_density=torch.zeros((), dtype=torch.int64))
    tr.set_grid(grid)
    assert tr.grid is grid
    assert torch.equal(tr._dgrid, dilated_chunk_grid(grid.bitfield, cfg))
    assert not torch.equal(tr._dgrid, before)
    loss, npts, kept = tr.loss_on_batch(tr.sample_batch())
    assert torch.isfinite(loss) and int(npts) > 0 and int(kept) > 0
