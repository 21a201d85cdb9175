"""The error map of the port's `Trainer` against the JAX trainer's
(`tngp/train/trainer.py` `_build_train_step`): one step with the map on,
with the JAX step's own draws (the frame, the error-map-weighted pixels,
the march noise and the background from its key) handed to the port's
`train_step` as an explicit batch, on the same weights, occupancy grid and
map; and the map through a checkpoint both ways.

The step: a small golden-grid NGP (4 levels of 2^12 rows, hidden 16, f32)
on 3 frames of the 24x24 blob scene, 256 rays under a sample budget tight
enough that some rays are dropped.  Tolerances: the loss 1e-5 relative and
the written entries 1e-4 relative (the two packages' renders sum in other
orders); the kept-ray count, the untouched rows and entries, and the
entries of dropped rays exactly.  A pixel that several rays name gets one
of their values in either package (XLA's `.at[].set` and `index_put_`
leave the winner unspecified), so it is held to the set of candidates."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tngp.train.checkpoint as jckpt
from tngp.data import make_synthetic_dataset
from tngp.data.rays import sample_rays as jax_sample_rays
from tngp.models import NGPNetwork as JaxNGP
from tngp.render import RenderConfig as JaxRenderConfig
from tngp.train import Trainer as JaxTrainer
from tngp.utils.config import TrainConfig as JaxTrainConfig
from tngp_torch.convert import ngp_state_dict_from_flax, occupancy_grid_from_arrays
from tngp_torch.data import NeRFDataset, sample_rays
from tngp_torch.models import NGPNetwork
from tngp_torch.render import RenderConfig
from tngp_torch.train import Trainer
from tngp_torch.utils import TrainConfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

NET_KW = dict(encoding="hashgrid", num_levels=4, log2_hashmap_size=12, hidden_dim=16,
              hidden_dim_color=16)
CFG_KW = dict(bound=1.0, grid_size=16, max_steps=64, K=16, K_eval=16, min_near=0.05,
              compact_fraction=0.1, march_dense=True)
N = 256


def jax_pair(tmp_path, **tc_kw):
    """(JAX trainer, port trainer) on the same dataset, weights (tables
    N(0, 0.3)), grid (every cell occupied, so that rays outrun the sample
    budget) and error map (uniform in [0.2, 2])."""
    ds = make_synthetic_dataset(n_frames=3, H=24, W=24, seed=0, num_steps=64)
    kw = dict(name="em", iters=100, num_rays=N, use_checkpoint="scratch", error_map=True,
              bf16=False, **tc_kw)
    jtr = JaxTrainer(JaxNGP(bound=1.0, **NET_KW), ds, JaxRenderConfig(**CFG_KW),
                     JaxTrainConfig(workspace=str(tmp_path / "jax"), **kw))
    params = jax.tree_util.tree_map(np.asarray, jtr.params)
    emb = params["params"]["encoder"]["embeddings"]
    rng = np.random.default_rng(0)
    params["params"]["encoder"]["embeddings"] = rng.normal(0, 0.3, emb.shape).astype(np.float32)
    jtr.params = jax.tree_util.tree_map(jnp.asarray, params)
    jtr.ema_params = jax.tree_util.tree_map(jnp.asarray, params)
    jtr.opt_state = jtr.tx.init(jtr.params)
    jtr.grid = jtr.grid.replace(bitfield=jnp.full_like(jtr.grid.bitfield, 255))
    jtr._dgrid = jtr._dgrid_fn(jtr.grid.bitfield)
    em = rng.uniform(0.2, 2.0, (3, 128 * 128)).astype(np.float32)
    jtr.error_map = jnp.asarray(em)

    pds = NeRFDataset(poses=np.asarray(ds.poses), intrinsics=np.asarray(ds.intrinsics),
                      H=ds.H, W=ds.W, images=np.asarray(ds.images))
    net = NGPNetwork(bound=1.0, device="cpu", **NET_KW)
    net.load_state_dict(ngp_state_dict_from_flax(params))
    ttr = Trainer(net, pds, RenderConfig(**CFG_KW),
                  TrainConfig(workspace=str(tmp_path / "port"), **kw), device="cpu")
    g = jtr.grid
    ttr.set_grid(occupancy_grid_from_arrays(g.density_grid, g.bitfield, g.mean_density,
                                            g.iter_density, device="cpu"))
    ttr.error_map.copy_(torch.from_numpy(em))
    return jtr, ttr


def jax_draws(jtr, key):
    """The JAX step's frame, rays and noise from its key
    (`tngp/train/trainer.py:241-266`)."""
    k_idx, k_rays, k_perturb, k_bg = jax.random.split(key, 4)
    idx = int(jax.random.randint(k_idx, (), 0, jtr.n_frames))
    r = jax_sample_rays(k_rays, jtr.poses[idx], jtr.intrinsics, jtr.H, jtr.W, N,
                        error_map=jtr.error_map[idx])
    return dict(frame=idx, inds=np.asarray(r["inds"]), inds_coarse=np.asarray(r["inds_coarse"]),
                k_perturb=k_perturb, k_bg=k_bg)


def port_batch(ttr, d, noise, bg):
    """The port's batch for the JAX draws `d`."""
    r = sample_rays(ttr.poses[d["frame"]], ttr.intrinsics, ttr.H, ttr.W, N,
                    inds=torch.from_numpy(d["inds"].copy()))
    gt = ttr.images[d["frame"]].reshape(-1, ttr.channels)[r["inds"]]
    bg_t = torch.from_numpy(np.array(bg)) if bg is not None else None
    gt_rgb = gt[:, :3] * gt[:, 3:] + bg_t * (1.0 - gt[:, 3:]) if bg is not None else gt[:, :3]
    return {"frame": d["frame"], "rays_o": r["rays_o"], "rays_d": r["rays_d"], "gt_rgb": gt_rgb,
            "bg": bg_t, "noise": torch.from_numpy(np.array(noise)),
            "inds_coarse": torch.from_numpy(d["inds_coarse"].copy())}


def test_error_map_step_matches_the_jax_step(tmp_path):
    jtr, ttr = jax_pair(tmp_path)
    em0 = np.asarray(jtr.error_map).copy()
    key = jax.random.PRNGKey(7)
    d = jax_draws(jtr, key)
    copy = lambda t: jax.tree_util.tree_map(jnp.array, t)  # noqa: E731  (the step donates)
    out = jtr._train_step(copy(jtr.params), copy(jtr.opt_state), copy(jtr.ema_params), key,
                          jnp.array(em0), jtr.grid.bitfield, jtr._dgrid)
    jem, jloss, jkept = np.asarray(out[3]), float(out[4]), int(out[6])
    noise = jax.random.uniform(d["k_perturb"], (N,))
    bg = jax.random.uniform(d["k_bg"], (N, 3)) if ttr.channels == 4 else None
    batch = port_batch(ttr, d, noise, bg)
    loss, _, kept = ttr.train_step(batch)
    tem = ttr.error_map.numpy()
    assert abs(float(loss) - jloss) <= 1e-5 * abs(jloss), (float(loss), jloss)
    assert int(kept) == jkept and 0 < jkept < N  # some rays were dropped

    f = d["frame"]
    others = np.arange(3) != f
    np.testing.assert_array_equal(tem[others], em0[others])
    np.testing.assert_array_equal(jem[others], em0[others])
    ic = d["inds_coarse"]
    untouched = np.ones(128 * 128, bool)
    untouched[ic] = False
    np.testing.assert_array_equal(tem[f][untouched], em0[f][untouched])
    np.testing.assert_array_equal(jem[f][untouched], em0[f][untouched])

    per_ray = batch["per_ray"].numpy()
    rm = batch["ray_mask"].numpy() > 0
    assert rm.sum() == jkept
    new = np.where(rm, np.float32(0.1) * em0[f][ic] + np.float32(0.9) * per_ray, em0[f][ic])
    n_shared = 0
    for c in np.unique(ic):
        cands = new[ic == c]
        if len(cands) > 1:
            n_shared += 1
        assert np.isclose(cands, tem[f][c], rtol=0, atol=0).any(), c
        assert np.isclose(cands, jem[f][c], rtol=1e-4, atol=0).any(), c
        if not rm[ic == c].any():  # only dropped rays: the old entry, exactly
            assert tem[f][c] == em0[f][c] and jem[f][c] == em0[f][c]
    assert n_shared > 0 and (tem[f] != em0[f]).any()


def test_error_map_goes_through_checkpoints_both_ways(tmp_path):
    """A port checkpoint's map loads into the JAX trainer exactly, and a
    JAX checkpoint's into the port; a port without the map saves an empty
    one, as the JAX trainer does."""
    jtr, ttr = jax_pair(tmp_path)
    ttr.error_map.mul_(torch.linspace(0.5, 1.5, 128 * 128))
    path = ttr.save_checkpoint()
    payload, _ = jckpt.load_checkpoint(path, jtr._payload(), strict=True)
    np.testing.assert_array_equal(np.asarray(payload["error_map"]), ttr.error_map.numpy())

    jtr.error_map = jtr.error_map * 3.0
    jtr.epoch = 5
    jtr.save_checkpoint()
    fresh = jax_pair(tmp_path / "fresh")[1]
    fresh.load_checkpoint(str(tmp_path / "jax" / "checkpoints" / "em_ep0005.npz"))
    np.testing.assert_array_equal(fresh.error_map.numpy(), np.asarray(jtr.error_map))

    plain = Trainer(fresh.model, NeRFDataset(poses=fresh.poses.numpy(),
                                             intrinsics=fresh.intrinsics.numpy(), H=24, W=24,
                                             images=fresh.images.numpy()),
                    fresh.cfg, dataclasses.replace(fresh.tc, error_map=False), device="cpu")
    assert plain.error_map is None and plain._payload()["error_map"].shape == (0,)
    with pytest.raises(AttributeError):
        plain.error_map.shape  # noqa: B018
