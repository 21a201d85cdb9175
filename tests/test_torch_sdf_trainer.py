"""`SDFTrainer` of the port against the JAX package's, at the SDF network's
full width (16 levels of 2^19 rows, 3x64 MLP) on the 32^3 sphere with 2048
samples a step: three steps on the same batches, the staircase lr, the
checkpoint both ways and the 32^3 mesh.

Each step compares the port's loss and gradient with the JAX step's
(`jax.jit(jax.value_and_grad)` of its loss) at the same weights, then feeds
the port's gradient to both optimisers (optax's adam over the staircase
schedule, the JAX EMA), so that Adam and the EMA are compared on their
arithmetic alone.

Tolerances.  Loss: 1e-5 relative; gradients: 1e-3 norm-relative (the table
gradient's per-level scatter and the corner products summed in another
order); weights and EMA after Adam: 1e-6 (f32 rounding).  The mesh: the
same face count and vertices within 1e-4 (a vertex interpolates the field
between two lattice points)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from tngp.data.sdf import SDFDataset as JaxSDFDataset
from tngp.models import SDFNetwork as JaxSDFNetwork
from tngp.native import load_obj as jax_load_obj
from tngp.ops import mape_loss as jax_mape_loss
from tngp.train.ema import ema_update as jax_ema_update
from tngp.train.sdf_trainer import SDFTrainer as JaxSDFTrainer
from tngp.utils.config import TrainConfig as JaxTrainConfig
from tngp_torch.convert import flax_params_from_ngp_state_dict, ngp_state_dict_from_flax
from tngp_torch.data.sdf import SDFDataset, sphere_mesh
from tngp_torch.models import SDFNetwork
from tngp_torch.native import load_obj
from tngp_torch.train.sdf_trainer import SDFTrainer, staircase_lr
from tngp_torch.utils import TrainConfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

LR = 1e-3


def trainers(tmp_path, size=2, name="sdf"):
    """The JAX trainer (its own init, table N(0, 0.1)) and the port's on the
    same weights, datasets and config."""
    verts, faces = sphere_mesh(32, 0.6)
    kw = dict(name=name, eval_interval=1, use_checkpoint="scratch")
    jtr = JaxSDFTrainer(JaxSDFNetwork(), JaxSDFDataset(vertices=verts, faces=faces,
                                                       num_samples=2048, size=size),
                        JaxTrainConfig(workspace=str(tmp_path / "jax"), **kw), lr=LR)
    params = jax.tree_util.tree_map(np.asarray, jtr.params)
    emb = params["params"]["encoder"]["embeddings"]
    params["params"]["encoder"]["embeddings"] = np.random.default_rng(0).normal(
        0, 0.1, emb.shape).astype(np.float32)
    jtr.params = jax.tree_util.tree_map(jnp.asarray, params)
    jtr.ema_params = jax.tree_util.tree_map(jnp.asarray, params)
    jtr.opt_state = jtr.tx.init(jtr.params)
    tnet = SDFNetwork(device="cpu")
    tnet.load_state_dict(ngp_state_dict_from_flax(params))
    ttr = SDFTrainer(tnet, SDFDataset(vertices=verts, faces=faces, num_samples=2048, size=size),
                     TrainConfig(workspace=str(tmp_path / "port"), **kw), lr=LR, device="cpu")
    return jtr, ttr


def rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def assert_state(ttr, jparams, jema, tol=1e-6):
    want = ngp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    want_ema = ngp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jema))
    for (name, p), e in zip(ttr.model.named_parameters(), ttr.ema_params):
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=tol, atol=tol,
                                   err_msg=name)
        np.testing.assert_allclose(e.numpy(), want_ema[name].numpy(), rtol=tol, atol=tol,
                                   err_msg=name + " (ema)")


def test_three_steps_match_the_jax_step(tmp_path):
    jtr, ttr = trainers(tmp_path)
    model, tx = jtr.model, jtr.tx

    @jax.jit
    def value_and_grad(params, points_cf, sdfs):
        return jax.value_and_grad(
            lambda p: jax_mape_loss(model.apply(p, points_cf, method=type(model).cf)[0], sdfs)
        )(params)

    jparams, opt_state, jema = jtr.params, jtr.opt_state, jtr.ema_params
    start = {n: p.detach().clone() for n, p in ttr.model.named_parameters()}
    for step in range(3):
        pts, sdfs = ttr.dataset.sample(step)
        np.testing.assert_array_equal(pts, jtr.dataset.sample(step)[0])
        jloss, jgrad = value_and_grad(jparams, jnp.asarray(pts.T), jnp.asarray(sdfs[:, 0]))
        tloss = ttr.train_step(*ttr.upload(pts, sdfs))
        assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss)), (tloss, jloss)
        want = ngp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrad))
        got = {n: p.grad for n, p in ttr.model.named_parameters()}
        for n in want:
            assert np.linalg.norm(want[n].numpy()) > 0, n
            assert rel(got[n].numpy(), want[n].numpy()) <= 1e-3, (n, rel(got[n].numpy(),
                                                                         want[n].numpy()))
        port_grad = jax.tree_util.tree_map(jnp.asarray, flax_params_from_ngp_state_dict(got))
        updates, opt_state = tx.update(port_grad, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        jema = jax_ema_update(jema, jparams, jtr.tc.ema_decay)
        assert_state(ttr, jparams, jema)
    assert ttr.global_step == 3
    moved = (ttr.model.backbone.dense_0.detach() - start["backbone.dense_0"]).abs().max()
    assert float(moved) > 1e-3


def test_lr_is_optax_staircase_at_the_pre_update_count(tmp_path):
    """At size 1 (one step an epoch) the lr drops tenfold every 10 counts;
    the port sets it from `global_step` before each update."""
    sched = optax.exponential_decay(LR, transition_steps=10, decay_rate=0.1, staircase=True)
    for count in (0, 9, 10, 19, 20):
        assert np.isclose(staircase_lr(LR, count, 1), float(sched(count)), rtol=1e-6), count
    _, ttr = trainers(tmp_path, size=1)
    seen = []
    for _ in range(12):
        pts, sdfs = ttr.dataset.sample(ttr.global_step)
        ttr.train_step(*ttr.upload(pts, sdfs))
        seen.append(ttr.optimizer.param_groups[0]["lr"])
    assert np.allclose(seen, [float(sched(c)) for c in range(12)], rtol=1e-6)


def test_checkpoints_load_both_ways_exactly(tmp_path):
    """The JAX trainer's checkpoint (after two steps: nonzero Adam moments,
    count 2) loads into the port exactly, epoch and step included; one epoch
    more on the port, then its checkpoint loads into the JAX trainer
    exactly (the optax state's count in both of the chain's states)."""
    jtr, ttr = trainers(tmp_path)
    jtr.train(1)
    fresh = SDFTrainer(SDFNetwork(device="cpu", seed=7), ttr.dataset,
                       TrainConfig(workspace=str(tmp_path / "jax"), name="sdf",
                                   use_checkpoint="latest"), lr=LR, device="cpu")
    assert (fresh.epoch, fresh.global_step) == (1, 2)
    want = ngp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jtr.params))
    want_ema = ngp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jtr.ema_params))
    adam = jtr.opt_state[0]
    mu = ngp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, adam.mu))
    nu = ngp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, adam.nu))
    assert int(adam.count) == 2 and int(jtr.opt_state[1].count) == 2
    for (name, p), e in zip(fresh.model.named_parameters(), fresh.ema_params):
        assert torch.equal(p.detach(), want[name]) and torch.equal(e, want_ema[name]), name
        st = fresh.optimizer.state[p]
        assert int(st["step"]) == 2, name
        assert torch.equal(st["exp_avg"], mu[name]) and torch.equal(st["exp_avg_sq"], nu[name])

    fresh.tc = TrainConfig(workspace=str(tmp_path / "port"), name="sdf")
    fresh.train(2)
    jtr2 = JaxSDFTrainer(JaxSDFNetwork(), jtr.dataset,
                         JaxTrainConfig(workspace=str(tmp_path / "port"), name="sdf",
                                        use_checkpoint="latest"), lr=LR)
    assert (jtr2.epoch, jtr2.global_step) == (2, 4)
    assert int(jtr2.opt_state[0].count) == 4 and int(jtr2.opt_state[1].count) == 4
    got = ngp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jtr2.params))
    got_ema = ngp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jtr2.ema_params))
    got_nu = ngp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jtr2.opt_state[0].nu))
    for (name, p), e in zip(fresh.model.named_parameters(), fresh.ema_params):
        assert torch.equal(got[name], p.detach()) and torch.equal(got_ema[name], e), name
        assert torch.equal(got_nu[name], fresh.optimizer.state[p]["exp_avg_sq"]), name


def test_save_mesh_at_32_matches_jax(tmp_path):
    """Both trainers' EMA field (the same weights) meshed at 32^3: the same
    faces, vertices within 1e-4."""
    jtr, ttr = trainers(tmp_path)
    jpath = jtr.save_mesh(str(tmp_path / "jax.obj"), resolution=32)
    tpath = ttr.save_mesh(str(tmp_path / "port.obj"), resolution=32)
    jv, jf = jax_load_obj(jpath)
    tv, tf = load_obj(tpath)
    assert len(jf) > 100 and tf.shape == jf.shape
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-4)
    assert np.abs(tv).max() <= 1.0
    field = ttr.sdf_field(8, chunk=20)  # chunks that split the slices
    np.testing.assert_allclose(field, ttr.sdf_field(8), rtol=0, atol=1e-6)
