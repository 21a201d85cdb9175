"""The port's grid-free training path (`Trainer(use_grid=False)`, the CLIs'
`--no_grid`) against the JAX trainer's: one step with the JAX step's own
draws (the frame, the pixels, and `render_rays_uniform`'s
z jitter and importance-sampling uniforms from its key) handed to the
port's `train_step` as an explicit batch, on the same weights; and the
chunked eval render, which both packages take on this path.

A small golden-grid NGP (4 levels of 2^12 rows, hidden 16, f32) on 3
frames of the 24x24 blob scene, 128 rays of 16 + 16 samples.  Tolerances:
the loss 1e-5 relative; the gradient 3e-2 norm-relative against
`jax.jit(jax.grad)` of the step's loss (the table's and the first density
layer's gradients are sums of many terms of both signs, and the JAX
package's own jitted and eager gradients of this loss differ by 7.1e-3 and
1.4e-3 there; the color layers agree to 2e-4); the weights after the first Adam step,
which moves each entry by about lr * sign(gradient), within 2 * lr
everywhere and 1e-6 on 99% of the entries (an entry whose gradient is near
zero can step either way); the eval image 5e-5 and depth 1e-4 absolute
(the importance samples' inverse CDF carries the coarse weights' f32
rounding into the sample positions)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tngp.data import make_synthetic_dataset
from tngp.data.rays import sample_rays as jax_sample_rays
from tngp.models import NGPNetwork as JaxNGP
from tngp.render import FieldFns as JaxFieldFns
from tngp.render import RenderConfig as JaxRenderConfig
from tngp.render import render_rays_uniform as jax_render_rays_uniform
from tngp.train import Trainer as JaxTrainer
from tngp.utils.config import TrainConfig as JaxTrainConfig
from tngp_torch.convert import ngp_state_dict_from_flax
from tngp_torch.data import NeRFDataset, sample_rays
from tngp_torch.models import NGPNetwork
from tngp_torch.render import RenderConfig
from tngp_torch.train import Trainer
from tngp_torch.utils import TrainConfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

NET_KW = dict(encoding="hashgrid", num_levels=4, log2_hashmap_size=12, hidden_dim=16,
              hidden_dim_color=16)
CFG_KW = dict(bound=1.0, grid_size=16, max_steps=64, K=16, min_near=0.05, num_steps=16,
              upsample_steps=16)
N = 128
LR = 1e-2


def pair(tmp_path):
    """(JAX trainer, port trainer), both grid-free, on the same dataset and
    weights (tables N(0, 0.3))."""
    ds = make_synthetic_dataset(n_frames=3, H=24, W=24, seed=0, num_steps=64)
    kw = dict(name="ng", iters=100, num_rays=N, lr=LR, use_checkpoint="scratch", bf16=False)
    jtr = JaxTrainer(JaxNGP(bound=1.0, **NET_KW), ds, JaxRenderConfig(**CFG_KW),
                     JaxTrainConfig(workspace=str(tmp_path / "jax"), **kw), use_grid=False)
    params = jax.tree_util.tree_map(np.asarray, jtr.params)
    emb = params["params"]["encoder"]["embeddings"]
    params["params"]["encoder"]["embeddings"] = np.random.default_rng(0).normal(
        0, 0.3, emb.shape).astype(np.float32)
    jtr.params = jax.tree_util.tree_map(jnp.asarray, params)
    jtr.ema_params = jax.tree_util.tree_map(jnp.asarray, params)
    jtr.opt_state = jtr.tx.init(jtr.params)
    pds = NeRFDataset(poses=np.asarray(ds.poses), intrinsics=np.asarray(ds.intrinsics),
                      H=ds.H, W=ds.W, images=np.asarray(ds.images))
    net = NGPNetwork(bound=1.0, device="cpu", **NET_KW)
    net.load_state_dict(ngp_state_dict_from_flax(params))
    ttr = Trainer(net, pds, RenderConfig(**CFG_KW),
                  TrainConfig(workspace=str(tmp_path / "port"), **kw), device="cpu",
                  use_grid=False)
    return jtr, ttr, params


def test_grid_free_step_matches_the_jax_step(tmp_path):
    jtr, ttr, params = pair(tmp_path)
    assert ttr._dgrid is None and len(ttr._tier_M) == 1
    cfg = jtr.cfg
    key = jax.random.PRNGKey(3)
    k_idx, k_rays, k_perturb, k_bg = jax.random.split(key, 4)
    f = int(jax.random.randint(k_idx, (), 0, jtr.n_frames))
    r = jax_sample_rays(k_rays, jtr.poses[f], jtr.intrinsics, jtr.H, jtr.W, N)
    assert jtr.channels == 3  # RGB targets: no random background (bg 1.0)
    k, k1 = jax.random.split(k_perturb)  # render_rays_uniform's draws
    _, k2 = jax.random.split(k)
    perturb = jax.random.uniform(k1, (N, cfg.num_steps))
    u = jax.random.uniform(k2, (N, cfg.upsample_steps))

    copy = lambda t: jax.tree_util.tree_map(jnp.array, t)  # noqa: E731  (the step donates)
    out = jtr._train_step(copy(jtr.params), copy(jtr.opt_state), copy(jtr.ema_params), key,
                          jnp.zeros((1, 1)), jtr.grid.bitfield)
    jnew, jloss, jnpts = out[0], float(out[4]), int(out[5])

    gt_rgb = jtr.images[f].reshape(-1, 3)[r["inds"]]
    field = JaxFieldFns.from_model(jtr.model)

    def loss_fn(p):  # the step's grid-free loss (`tngp/train/trainer.py:272-287`)
        o = jax_render_rays_uniform(field, p, r["rays_o"], r["rays_d"], cfg,
                                    num_steps=cfg.num_steps, upsample_steps=cfg.upsample_steps,
                                    key=k_perturb)
        return jnp.mean(jnp.mean((o["image"] - gt_rgb) ** 2, axis=-1))

    vloss, jgrad = jax.jit(jax.value_and_grad(loss_fn))(jtr.params)
    assert abs(float(vloss) - jloss) <= 1e-6 * jloss

    rr = sample_rays(ttr.poses[f], ttr.intrinsics, ttr.H, ttr.W, N,
                     inds=torch.from_numpy(np.array(r["inds"])))
    batch = {"frame": f, "rays_o": rr["rays_o"], "rays_d": rr["rays_d"],
             "gt_rgb": torch.from_numpy(np.array(gt_rgb)), "bg": None,
             "perturb": torch.from_numpy(np.array(perturb)), "u": torch.from_numpy(np.array(u))}
    loss, npts, kept = ttr.train_step(batch)
    assert abs(float(loss) - jloss) <= 1e-5 * jloss, (float(loss), jloss)
    assert int(npts) == jnpts == N * 32 and int(kept) == N
    want = ngp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrad))
    new = ngp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jnew))
    for name, p in ttr.model.named_parameters():
        g, w = p.grad.numpy(), want[name].numpy()
        assert np.linalg.norm(g - w) <= 3e-2 * np.linalg.norm(w), name
        d = np.abs(p.detach().numpy() - new[name].numpy())
        assert d.max() <= 2 * LR and (d <= 1e-6).mean() >= 0.99, (name, d.max())
        assert np.abs(p.detach().numpy() - params["params"][name.split(".")[0]][
            name.split(".")[1]]).max() > 0.5 * LR, name
    assert ttr._grid_updates == 0


def test_grid_free_chunked_eval_matches_jax(tmp_path):
    """The EMA render of a full frame (24x24 in chunks of 256 rays, the
    last padded) and one at an overridden size."""
    jtr, ttr, _ = pair(tmp_path)
    pose = np.asarray(jtr.poses[1])
    jimg, jdep = jtr.render_image(pose, chunk=256)
    timg, tdep = ttr.render_image(pose, chunk=256)
    assert timg.shape == (24, 24, 3) and ttr.last_render_stats["chunks"] == 3
    np.testing.assert_allclose(timg, jimg, rtol=0, atol=5e-5)
    np.testing.assert_allclose(tdep, jdep, rtol=0, atol=1e-4)
    jimg, _ = jtr.render_image(pose, chunk=256, W=16, H=32)
    timg, _ = ttr.render_image(pose, chunk=256, W=16, H=32)
    assert timg.shape == (32, 16, 3)
    np.testing.assert_allclose(timg, jimg, rtol=0, atol=5e-5)
