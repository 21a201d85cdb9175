"""Checkpoints cross between the packages: the port's msgpack codec against
flax's bytes, a checkpoint the JAX trainer wrote loaded by the port (every
entry exactly equal, one render within the eval tolerance), one the port
wrote loaded by the JAX package's `load_checkpoint` with an empty report,
and the rotation and the best checkpoint."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from tngp.data import make_synthetic_dataset
from tngp.models import NGPNetwork as JaxNGP
from tngp.render import RenderConfig as JaxRenderConfig
from tngp.train import Trainer as JaxTrainer
from tngp.train.checkpoint import load_checkpoint as jax_load_checkpoint
from tngp.utils.config import TrainConfig as JaxTrainConfig
from tngp_torch.data import NeRFDataset
from tngp_torch.models import NGPNetwork
from tngp_torch.render import RenderConfig
from tngp_torch.train import Trainer, latest_checkpoint, load_meta
from tngp_torch.utils import TrainConfig, msgpack_codec
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

NET_KW = dict(num_levels=4, log2_hashmap_size=12, hidden_dim=16, hidden_dim_color=16)
CFG_KW = dict(bound=1.0, grid_size=16, max_steps=64, K=16, K_eval=16, min_near=0.05,
              compact_fraction=0.5, march_dense=True, eval_tiers=(256,))


def test_codec_bytes_equal_flax():
    """One state dict with f32, bf16, int32 and uint8 arrays, numpy and
    Python scalars, nil, a long string and nested maps: `packb` gives
    flax's bytes (keys in sorted order, as `msgpack_serialize` writes them
    after its tree copy), and each side reads the other's back exactly."""
    rng = np.random.default_rng(0)
    bf = rng.normal(size=(3, 5)).astype(jnp.bfloat16)
    tree = {
        "a": {"f32": rng.normal(size=(4, 7)).astype(np.float32),
              "i32": np.arange(-150, 150, dtype=np.int32).reshape(3, 100),
              "u8": rng.integers(0, 256, 70000).astype(np.uint8)},
        "b": {"bf16": bf, "count": np.asarray(7, np.int32), "none": None, "py_float": 0.25,
              "py_int": -70000, "scalar": np.float32(1.5), "text": "x" * 40},
    }
    want = serialization.msgpack_serialize(copy.deepcopy(tree))
    port_tree = copy.deepcopy(tree)
    port_tree["b"]["bf16"] = torch.from_numpy(bf.view(np.int16)).view(torch.bfloat16)
    assert msgpack_codec.packb(port_tree) == want
    back = msgpack_codec.unpackb(want)
    for k in ("f32", "i32", "u8"):
        np.testing.assert_array_equal(back["a"][k], tree["a"][k])
        assert back["a"][k].dtype == tree["a"][k].dtype
    assert torch.equal(back["b"]["bf16"].view(torch.int16), torch.from_numpy(bf.view(np.int16)))
    assert back["b"]["scalar"] == np.float32(1.5) and type(back["b"]["scalar"]) is np.float32
    assert back["b"]["none"] is None and back["b"]["py_int"] == -70000
    assert back["b"]["count"].shape == () and back["b"]["count"].dtype == np.int32
    flax_back = serialization.msgpack_restore(msgpack_codec.packb(port_tree))
    assert flax_back["b"]["bf16"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(flax_back["b"]["bf16"], np.float32),
                                  bf.astype(np.float32))
    with pytest.raises(ValueError, match="chunked-array"):
        msgpack_codec.unpackb(msgpack_codec.packb({"__msgpack_chunked_array__": True}))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A tiny JAX trainer after 2 steps, its checkpoint on disk."""
    ws = str(tmp_path_factory.mktemp("jax_ws"))
    ds = make_synthetic_dataset(n_frames=4, H=16, W=16, seed=0, num_steps=64)
    model = JaxNGP(bound=1.0, encoding="hashgrid_window", compute_dtype=jnp.bfloat16, **NET_KW)
    tc = JaxTrainConfig(name="ck", workspace=ws, iters=100, num_rays=128, use_checkpoint="scratch")
    tr = JaxTrainer(model, ds, JaxRenderConfig(**CFG_KW), tc)
    tr.train_one_epoch(2)
    path = os.path.join(ws, "checkpoints", "ck_ep0000.npz")
    tr.save_checkpoint()
    assert os.path.exists(path)
    return tr, ds, path


def _port_trainer(ds, ws, name="ck", **tc_kw):
    pds = NeRFDataset(poses=np.asarray(ds.poses), intrinsics=np.asarray(ds.intrinsics),
                      H=ds.H, W=ds.W, images=np.asarray(ds.images))
    model = NGPNetwork(encoding="hashgrid_window",
                       bound=1.0, compute_dtype=torch.bfloat16, device="cpu", seed=1, **NET_KW)
    tc = TrainConfig(name=name, workspace=str(ws), iters=100, num_rays=128, **tc_kw)
    return Trainer(model, pds, RenderConfig(**CFG_KW), tc, device="cpu")


def test_port_loads_a_jax_checkpoint_exactly(jax_run, tmp_path):
    """Params, Adam moments and count, EMA and grid equal bit for bit; the
    report is empty; the 16x16 EMA render of both trainers (through each
    package's frame renderer) agrees within image 1e-4, depth 1e-3."""
    jtr, ds, path = jax_run
    tr = _port_trainer(ds, tmp_path, use_checkpoint="scratch")
    rep = tr.load_checkpoint(path)
    assert rep == {"missing": [], "unexpected": [], "mismatched": []}
    assert (tr.epoch, tr.global_step) == (jtr.epoch, jtr.global_step) == (0, 2)
    want = jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(jtr._payload()))
    got = tr._payload()

    def check(w, g, where):
        if isinstance(w, dict):
            assert set(w) == set(g), where
            for k in w:
                check(w[k], g[k], f"{where}/{k}")
            return
        np.testing.assert_array_equal(np.asarray(g), w, err_msg=where)

    check(want, got, "")
    assert int(tr.optimizer.state[tr.params[0]]["step"]) == 2
    assert tr._grid_updates == int(jtr.grid.iter_density) == 1
    jimg, jdep = jtr.render_image(ds.poses[1])
    timg, tdep = tr.render_image(ds.poses[1])
    np.testing.assert_allclose(timg, jimg, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tdep, jdep, rtol=1e-3, atol=1e-3)


def test_jax_loads_a_port_checkpoint_with_an_empty_report(jax_run, tmp_path):
    """The port trains 2 steps and saves; the JAX package's non-strict load
    of that file against its own trainer's payload reports nothing missing,
    unexpected or mismatched, and its values are the port's."""
    jtr, ds, _ = jax_run
    tr = _port_trainer(ds, tmp_path, use_checkpoint="scratch")
    tr.run_steps(2)
    path = tr.save_checkpoint()
    payload, meta = jax_load_checkpoint(path, jtr._payload())
    assert meta["_load_report"] == {"missing": [], "unexpected": [], "mismatched": []}
    assert meta["global_step"] == 2
    named = dict(tr.model.named_parameters())
    for net, leaves in payload["params"]["params"].items():
        for leaf, value in leaves.items():
            np.testing.assert_array_equal(np.asarray(value),
                                          named[f"{net}.{leaf}"].detach().numpy())
    np.testing.assert_array_equal(np.asarray(payload["grid"].bitfield),
                                  tr.grid.bitfield.numpy())
    assert int(payload["opt_state"][0].count) == 2


def test_rotation_best_checkpoint_and_resume(jax_run, tmp_path):
    """`train` with eval_interval 1 over 3 epochs of 2 steps: the newest
    max_keep = 2 epoch checkpoints stay, the best one has no grid, and a new
    trainer with use_checkpoint='latest' resumes at the last epoch and step
    with the same EMA weights and grid."""
    _, ds, _ = jax_run
    tr = _port_trainer(ds, tmp_path, eval_interval=1, steps_per_epoch=2)
    tr.valid_dataset = tr.dataset
    tr.train(3)
    ck = os.path.join(str(tmp_path), "checkpoints")
    assert sorted(f for f in os.listdir(ck) if f.endswith(".npz")) == [
        "ck.pth.npz", "ck_ep0002.npz", "ck_ep0003.npz"]
    with open(os.path.join(ck, "ck.pth.npz"), "rb") as f:
        best = msgpack_codec.unpackb(f.read())
    assert set(best) == {"params", "opt_state", "ema", "error_map"}
    assert load_meta(os.path.join(ck, "ck.pth.npz"))["stats"]["best_result"] == max(
        tr.stats["results"])
    assert latest_checkpoint(str(tmp_path), "ck").endswith("ck_ep0003.npz")
    tr2 = _port_trainer(ds, tmp_path)  # use_checkpoint='latest'
    assert (tr2.epoch, tr2.global_step) == (3, 6)
    for a, b in zip(tr2.ema_params, tr.ema_params):
        assert torch.equal(a, b)
    assert torch.equal(tr2.grid.bitfield, tr.grid.bitfield)
    assert tr2.scheduler.get_last_lr() == tr.scheduler.get_last_lr()
