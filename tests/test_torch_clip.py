"""CLIP guidance in the port against the JAX package
(`tngp/train/clip_guidance.py`, the trainer's CLIP step
`tngp/train/trainer.py:309-350`): the stub embedder given the JAX stub's
projection, its text tower, one CLIP step of the trainer on the same
weights, grid and pose, and the snapshot error of the non-stub embedder.

The step: a small golden-grid NGP (4 levels of 2^12 rows, hidden 16, f32)
on 3 frames of the 24x24 blob scene, 256 rays, so a 16x16 render (upsampled
to the stub's 32x32).  Tolerances: the stub's embedding 1e-6 (a 3,072-term
projection summed in another order; the resizes agree within 1.8e-7); the
loss 1e-5; the gradients 1e-3 norm-relative, 1e-2 for the table and the
first density layer (the render-path tests' tolerances,
`tests/test_torch_render_paths.py`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tngp.data import make_synthetic_dataset
from tngp.data.rays import full_image_rays as jax_full_image_rays
from tngp.models import NGPNetwork as JaxNGP
from tngp.render import RenderConfig as JaxRenderConfig
from tngp.render import render_rays_train as jax_render_rays_train
from tngp.train import Trainer as JaxTrainer
from tngp.train.clip_guidance import StubEmbedder as JaxStub
from tngp.utils.config import TrainConfig as JaxTrainConfig
from tngp_torch.convert import ngp_state_dict_from_flax, occupancy_grid_from_arrays
from tngp_torch.data import NeRFDataset
from tngp_torch.models import NGPNetwork
from tngp_torch.render import RenderConfig
from tngp_torch.train import Trainer
from tngp_torch.train.clip_guidance import CLIPLoss, StubEmbedder, make_embedder
from tngp_torch.utils import TrainConfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

NET_KW = dict(encoding="hashgrid", num_levels=4, log2_hashmap_size=12, hidden_dim=16,
              hidden_dim_color=16)
CFG_KW = dict(bound=1.0, grid_size=16, max_steps=64, K=16, K_eval=16, min_near=0.05,
              compact_fraction=0.5, march_dense=True)
N = 256
TEXT = "a red sphere"


def jax_projection():
    r = JaxStub.resolution
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (r * r * 3, JaxStub.embed_dim),
                                        jnp.float32) / np.sqrt(r * r * 3))


def test_stub_embedder_matches_jax():
    port = StubEmbedder(projection=jax_projection(), device="cpu")
    rng = np.random.default_rng(0)
    for side in (64, 16):  # downsampled (antialiased) and upsampled, as a 256-ray step's
        img = rng.uniform(size=(2, side, side, 3)).astype(np.float32)
        want = np.asarray(JaxStub().embed_images(jnp.asarray(img)))
        got = port.embed_images(torch.from_numpy(img)).numpy()
        assert np.abs(got - want).max() <= 1e-6
        assert np.allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
    np.testing.assert_array_equal(port.embed_text(TEXT), JaxStub().embed_text(TEXT))
    # the port's own default projection: seeded, of the stub's shape
    a, b = StubEmbedder(device="cpu"), StubEmbedder(device="cpu")
    assert a.projection.shape == (3072, 64) and torch.equal(a.projection, b.projection)


def test_non_stub_embedder_raises_the_snapshot_error(tmp_path):
    with pytest.raises(RuntimeError, match="--clip_model_path"):
        make_embedder("torch", str(tmp_path / "no_snapshot"), device="cpu")
    with pytest.raises(RuntimeError, match="--clip_model_path"):
        make_embedder("auto", "openai/clip-vit-base-patch16", device="cpu")
    with pytest.raises(RuntimeError, match="Point model_path at a local"):
        CLIPLoss(str(tmp_path / "no_snapshot"))  # the scorer loads the same way


def test_clip_step_matches_the_jax_step(tmp_path):
    ds = make_synthetic_dataset(n_frames=3, H=24, W=24, seed=0, num_steps=64)
    kw = dict(name="clip", iters=100, num_rays=N, use_checkpoint="scratch", bf16=False,
              rand_pose=3, clip_text=TEXT)
    jemb = JaxStub()
    jtr = JaxTrainer(JaxNGP(bound=1.0, **NET_KW), ds, JaxRenderConfig(**CFG_KW),
                     JaxTrainConfig(workspace=str(tmp_path / "jax"), **kw), clip_embedder=jemb)
    params = jax.tree_util.tree_map(np.asarray, jtr.params)
    emb = params["params"]["encoder"]["embeddings"]
    params["params"]["encoder"]["embeddings"] = np.random.default_rng(0).normal(
        0, 0.3, emb.shape).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    bitfield = jnp.full_like(jtr.grid.bitfield, 255)

    # the JAX step's loss, and its gradients through the same loss function
    from tngp.data.provider import rand_poses

    pose = jnp.asarray(rand_poses(np.random.default_rng(0), 1, radius=1.5)[0])
    side = 16
    intr = jnp.asarray([side * 0.7, side * 0.7, side / 2.0, side / 2.0], jnp.float32)
    text = jnp.asarray(jemb.embed_text(TEXT))
    copy = lambda t: jax.tree_util.tree_map(jnp.array, t)  # noqa: E731  (the step donates)
    _, _, jloss = jtr._clip_step(copy(jparams), jtr.tx.init(jparams), pose, text, bitfield)

    def loss_fn(p):
        o, d = jax_full_image_rays(pose, intr, side, side)
        out = jax_render_rays_train(jtr.field, p, o, d, bitfield, jtr.cfg)
        feats = jemb.embed_images(out["image"].reshape(1, side, side, 3))
        return -jnp.mean(feats @ text)

    jl2, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    assert abs(float(jl2) - float(jloss)) <= 1e-6

    pds = NeRFDataset(poses=np.asarray(ds.poses), intrinsics=np.asarray(ds.intrinsics),
                      H=ds.H, W=ds.W, images=np.asarray(ds.images))
    net = NGPNetwork(bound=1.0, device="cpu", **NET_KW)
    net.load_state_dict(ngp_state_dict_from_flax(params))
    ttr = Trainer(net, pds, RenderConfig(**CFG_KW),
                  TrainConfig(workspace=str(tmp_path / "port"), **kw), device="cpu",
                  clip_embedder=StubEmbedder(projection=jax_projection(), device="cpu"))
    g = jtr.grid
    ttr.set_grid(occupancy_grid_from_arrays(g.density_grid, np.asarray(bitfield),
                                            g.mean_density, g.iter_density, device="cpu"))
    before = [p.detach().clone() for p in ttr.params]
    loss = ttr.run_clip_step()
    assert abs(loss - float(jloss)) <= 1e-5, (loss, float(jloss))
    want = ngp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    names = [n for n, p in net.named_parameters() if p.requires_grad]
    for name, p in zip(names, ttr.params):
        ref = want[name]
        rel = float((p.grad - ref).norm() / ref.norm().clamp(min=1e-30))
        tol = 1e-2 if name in ("encoder.embeddings", "sigma_net.dense_0") else 1e-3
        assert rel <= tol, (name, rel)
    # one Adam step moved the weights, and left the EMA and the grid alone
    assert any(not torch.equal(a, p) for a, p in zip(before, ttr.params))
    assert all(torch.equal(a, e) for a, e in zip(before, ttr.ema_params))
    assert ttr.global_step == 0 and ttr._grid_updates == 0
