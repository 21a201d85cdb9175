"""Shared set-up of the training-slice parity tests (`test_torch_train_step.py`,
`test_torch_trainer.py`): a small instant-NGP network (4 levels, hidden 16,
2^12 rows per level) in both packages with the same weights, the blob
scene's occupancy grid (32^3), 128 rays with explicit pixels, march noise
and targets from a numpy seed, and the ray-masked loss in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tngp.data.synthetic import make_blob_field as jax_blob_field
from tngp.data.synthetic import orbit_poses
from tngp.models import NGPNetwork as JaxNGP
from tngp.ops import packbits as jax_packbits
from tngp.render import FieldFns as JaxFieldFns
from tngp.render import dilated_chunk_grid as jax_dilated_chunk_grid
from tngp.render import render_rays_train as jax_render_rays_train
from tngp_torch.convert import ngp_state_dict_from_flax
from tngp_torch.data import sample_rays
from tngp_torch.models import NGPNetwork
from tngp_torch.render import FieldFns, render_rays_train
from tngp_torch.render.occupancy import cell_centers_cf
from tngp_torch.train.trainer import masked_mse

NET_KW = dict(num_levels=4, hidden_dim=16, hidden_dim_color=16, log2_hashmap_size=12)
CFG_KW = dict(bound=1.0, grid_size=32, max_steps=64, K=16, min_near=0.05,
              compact_fraction=0.25, density_thresh=1.0, march_dense=True)
N_RAYS = 128
H = W = 32
NAMES = ("encoder.embeddings", "sigma_net.dense_0", "sigma_net.dense_1",
         "color_net.dense_0", "color_net.dense_1", "color_net.dense_2")


def scene_inputs():
    """Rays of one camera with explicit pixels, march noise, targets and the
    blob occupancy bitfield, all as numpy."""
    rng = np.random.default_rng(0)
    pose = orbit_poses(4)[1]
    intr = np.array([0.9 * W, 0.9 * W, W / 2, H / 2], np.float32)
    inds = rng.integers(0, H * W, N_RAYS)
    r = sample_rays(torch.from_numpy(pose), torch.from_numpy(intr), H, W, N_RAYS,
                    inds=torch.from_numpy(inds))
    dens = jax_blob_field(0).density(None, jnp.asarray(cell_centers_cf(0, 1.0, 32, "cpu").numpy()))
    bitfield = np.array(jax_packbits(dens, 1.0))
    return dict(o=r["rays_o"].numpy().copy(), d=r["rays_d"].numpy().copy(),
                noise=rng.uniform(size=N_RAYS).astype(np.float32),
                gt=rng.uniform(size=(N_RAYS, 3)).astype(np.float32), bitfield=bitfield)


def nets(dtype_name):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[
        dtype_name]
    jnet = JaxNGP(encoding="hashgrid_window", compute_dtype=jdt, **NET_KW)
    params = jnet.init(jax.random.PRNGKey(3), jnp.zeros((8, 3)), jnp.ones((8, 3)) / np.sqrt(3))
    params = jax.tree_util.tree_map(np.asarray, params)
    emb = params["params"]["encoder"]["embeddings"]
    # a table scale that moves the density (the init is U(+-1e-4))
    params["params"]["encoder"]["embeddings"] = np.random.default_rng(1).normal(
        0, 0.3, emb.shape).astype(np.float32)
    tnet = NGPNetwork(compute_dtype=tdt, device="cpu", **NET_KW)
    tnet.load_state_dict(ngp_state_dict_from_flax(params))
    return jnet, params, tnet


def jax_loss_fn(jnet, scene, jcfg):
    field = JaxFieldFns.from_model(jnet)
    bf = jnp.asarray(scene["bitfield"])
    dgrid = jax_dilated_chunk_grid(bf, jcfg)
    noise = jnp.asarray(scene["noise"])

    def render(p):
        # the JAX render draws its noise from a key; hand it ours instead
        orig = jax.random.uniform
        try:
            jax.random.uniform = lambda key, shape=(), *a, **k: (
                noise if tuple(shape) == (N_RAYS,) else orig(key, shape, *a, **k))
            return jax_render_rays_train(field, p, jnp.asarray(scene["o"]),
                                         jnp.asarray(scene["d"]), bf, jcfg,
                                         key=jax.random.PRNGKey(0), dilated_grid=dgrid)
        finally:
            jax.random.uniform = orig

    def loss_fn(p):
        out = render(p)
        per_ray = jnp.mean((out["image"] - jnp.asarray(scene["gt"])) ** 2, axis=-1)
        rm = out["ray_mask"].astype(jnp.float32)
        return (per_ray * rm).sum() / jnp.maximum(rm.sum(), 1.0), out

    return loss_fn


def torch_loss(tnet, scene, tcfg):
    out = render_rays_train(FieldFns.from_model(tnet), None, torch.from_numpy(scene["o"]),
                            torch.from_numpy(scene["d"]), torch.from_numpy(scene["bitfield"]),
                            tcfg, noise=torch.from_numpy(scene["noise"]))
    loss, _ = masked_mse(out["image"], torch.from_numpy(scene["gt"]), out["ray_mask"])
    return loss, out


def rel_err(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


