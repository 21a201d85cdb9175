"""Shared set-up of the training-slice parity tests (`test_torch_train_step.py`,
`test_torch_trainer.py`, and the D-NeRF files): a small instant-NGP network
(4 levels, hidden 16, 2^12 rows per level) and a small D-NeRF in both
packages with the same weights, the blob scene's occupancy grid (32^3), 128
rays with explicit pixels, march noise and targets from a numpy seed, and
the ray-masked loss in both packages."""

import contextlib
import functools

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
    blob occupancy bitfield, all as numpy (made once per process; no test
    writes to them)."""
    return dict(_scene_inputs())


@functools.lru_cache(maxsize=1)
def _scene_inputs():
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
    tnet = NGPNetwork(encoding="hashgrid_window", compute_dtype=tdt, device="cpu", **NET_KW)
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



# ---- D-NeRF (`test_torch_dnerf.py`, `test_torch_dnerf_trainer.py`) ----------
# A small D-NeRF: hidden widths 16, a 3-layer deform net, and a 2-level
# window encoder (level 0 dense, level 1 hashed, 2^12 rows) with block 64.
# The JAX module sizes its encoder with get_encoder's defaults; the tests
# narrow it through `small_jax_dnerf_encoder`.
DNERF_KW = dict(hidden_dim=16, hidden_dim_color=16, hidden_dim_deform=16,
                num_layers_deform=3)
DNERF_ENC_KW = dict(num_levels=2, log2_hashmap_size=12)
DNERF_BLOCK = 64
DNERF_NAMES = tuple(f"deform_net.dense_{i}" for i in range(3)) + NAMES[:3] + tuple(
    f"color_net.dense_{i}" for i in range(3))


@functools.partial(jax.jit, static_argnums=(2, 3))
def _jax_binned_jit(x01_cf, table_win, spec, block):
    """The JAX encoder's interpret-mode binned path with `input_grads`, as
    `WindowGridEncoder.cf` calls it under TNGP_WIN_FORCE_BINNED, compiled
    once per shape: for the encoder alone jit and op by op agree (forward
    and table gradient bit for bit, position gradient to its sum order;
    `test_torch_window_encoder_dx.py` runs it so), and the jit boundary keeps
    XLA from fusing it with the op-by-op MLPs around it."""
    from tngp.kernels.window_encoder import window_encode_binned

    return window_encode_binned(x01_cf, table_win, spec, block, False, True, True, True)


@contextlib.contextmanager
def small_jax_dnerf_encoder():
    """Inside this scope `tngp.models.dnerf.DNeRFNetwork` builds its window
    encoder with DNERF_ENC_KW and block DNERF_BLOCK, its `cf` through
    `_jax_binned_jit`."""
    import tngp.models.dnerf as jdnerf
    from tngp.encoders.modules import WindowGridEncoder

    class JitWindowEncoder(WindowGridEncoder):
        def cf(self, x_cf, bound=1.0):
            x01 = (x_cf + bound) / (2.0 * bound)
            return _jax_binned_jit(x01, self.embeddings, self.spec, self.block)

    orig = jdnerf.get_encoder

    def small(encoding, **kw):
        if encoding != "hashgrid_window":
            return orig(encoding, **kw)
        enc, dim = orig(encoding, **{**kw, **DNERF_ENC_KW})
        assert not enc.mxu_f32 and enc.swap_select and enc.input_grads
        return JitWindowEncoder(spec=enc.spec, block=DNERF_BLOCK, input_grads=True), dim

    jdnerf.get_encoder = small
    try:
        yield
    finally:
        jdnerf.get_encoder = orig


def dnerf_nets(dtype_name, table_std=0.3):
    """(JAX module, its params, the port's module): the port's initial
    weights (the JAX package's init distributions) with an N(0, table_std)
    table that moves the density, handed to the JAX module through
    `flax_params_from_ngp_state_dict` (JAX applies them inside
    `small_jax_dnerf_encoder()`, which also checks every shape)."""
    from tngp.models import DNeRFNetwork as JaxDNeRF
    from tngp_torch.convert import flax_params_from_ngp_state_dict
    from tngp_torch.models import DNeRFNetwork

    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[
        dtype_name]
    jnet = JaxDNeRF(encoding="hashgrid_window", compute_dtype=jdt, **DNERF_KW)
    tnet = DNeRFNetwork(encoding="hashgrid_window", compute_dtype=tdt, device="cpu", seed=4,
                        **DNERF_KW, **DNERF_ENC_KW)
    tnet.encoder.block = DNERF_BLOCK
    emb = tnet.encoder.embeddings
    with torch.no_grad():
        emb.copy_(torch.from_numpy(np.random.default_rng(2).normal(
            0, table_std, tuple(emb.shape)).astype(np.float32)))
    return jnet, flax_params_from_ngp_state_dict(tnet.state_dict()), tnet


def _jax_step_cfg():
    from tngp.render import RenderConfig as JaxRenderConfig

    cfg = JaxRenderConfig(**CFG_KW)
    geo = dict(bound=cfg.bound, cascades=cfg.cascades, grid_size=cfg.grid_size,
               dt_gamma=cfg.dt_gamma, max_steps=cfg.max_steps)
    return cfg, geo


@jax.jit
def _jax_march(o, d, bitfield, noise):
    """The chunked march of `render_rays_train` (integer selection)."""
    from tngp.ops.march import march_rays_chunked
    from tngp.ops.rays import near_far_from_aabb

    cfg, geo = _jax_step_cfg()
    N = o.shape[0]
    M_budget = min(N * cfg.max_steps,
                   max(128, -(-int(N * cfg.K * cfg.compact_fraction) // 128) * 128))
    nears, fars = near_far_from_aabb(o, d, cfg.aabb, cfg.min_near)
    return march_rays_chunked(o, d, nears, fars, bitfield, M_budget=M_budget,
                              G=cfg.march_chunk, noise=noise, **geo)


@jax.jit
def _jax_finish(sig, rgb, deform_abs, dt_c, ray_id, sel_valid, t_rel, ray_mask, num_points, gt,
                deform_reg):
    """Composite, background 1, ray-masked MSE and deform_reg * mean|dx|."""
    from tngp.ops.composite import composite_stream

    cfg, _ = _jax_step_cfg()
    N = gt.shape[0]
    ws, _, image = composite_stream(sig.astype(jnp.float32) * cfg.density_scale, rgb, dt_c,
                                    None, ray_id, sel_valid, N, cfg.T_thresh, t_cum=t_rel)
    image = image + (1.0 - ws)[:, None] * jnp.ones((), jnp.float32)
    per_ray = jnp.mean((image - gt) ** 2, axis=-1)
    rm = ray_mask.astype(jnp.float32)
    loss = (per_ray * rm).sum() / jnp.maximum(rm.sum(), 1.0)
    aux = (deform_abs.reshape(-1) * sel_valid.astype(jnp.float32)).sum() / jnp.maximum(
        num_points.astype(jnp.float32), 1.0)
    return loss + deform_reg * aux, image


def jax_dnerf_step(jnet, params, scene, t, deform_reg=1e-3):
    """The JAX package's D-NeRF step loss (`tngp/train/dnerf_trainer.py`
    `_build_train_step`: the chunked `march_dense` branch of
    `render_rays_train`, `tngp/render/renderer.py:214-288`, with the aux
    |dx| mean, the ray-masked MSE and `deform_reg`) and its gradient, on the
    scene's rays, noise, targets and bitfield at time `t`.  The march (integer
    selection, no gradient) and the compositor run jitted; the sample
    positions and the field run op by op, because under jit XLA fuses
    arithmetic into other roundings, and a position or an encoder weight an
    f32 ulp away flips bf16 roundings of derivative weights (measured on
    this network: 1.1e-3 on the deform net's gradient with everything
    jitted, where op by op and the port agree to 4e-5).  Returns ((loss,
    (image, num_points, ray_mask, sigma, rgb, deform)), grads)."""
    from tngp.ops.march import ladder_samples

    _, geo = _jax_step_cfg()
    o, d = jnp.asarray(scene["o"]), jnp.asarray(scene["d"])
    cm = _jax_march(o, d, jnp.asarray(scene["bitfield"]), jnp.asarray(scene["noise"]))
    ray_id, x_c, d_c, dt_c, t_rel = ladder_samples(cm.sel, o, d, cm.t0, **geo)

    def loss_fn(p):
        sig, rgb, deform = jnet.apply(p, x_c, d_c, jnp.float32(t),
                                      method=type(jnet).sigma_rgb_cf)
        loss, image = _jax_finish(sig, rgb, jnp.abs(deform).mean(axis=0), dt_c, ray_id,
                                  cm.sel_valid, t_rel, cm.ray_mask, cm.num_points,
                                  jnp.asarray(scene["gt"]), deform_reg)
        return loss, (image, cm.num_points, cm.ray_mask, sig, rgb, deform)

    with small_jax_dnerf_encoder():
        return jax.value_and_grad(loss_fn, has_aux=True)(params)


def port_dnerf_step(tnet, scene, t, time_size=4):
    """The port's step through `DNeRFTrainer.loss_on_batch`, on the CPU, with
    the scene's rays, noise, targets and bitfield as the slice of time `t`
    (the other slices empty).  Returns (trainer, batch, loss, num_points,
    kept) after `backward()`."""
    from tngp_torch.data import NeRFDataset
    from tngp_torch.render import RenderConfig, TimeOccupancyGrid, time_slice_index
    from tngp_torch.train import DNeRFTrainer
    from tngp_torch.utils import TrainConfig

    ds = NeRFDataset(poses=np.stack([np.eye(4, dtype=np.float32)] * 2),
                     intrinsics=np.array([0.9 * W, 0.9 * W, W / 2, H / 2], np.float32), H=H,
                     W=W, images=np.zeros((2, H, W, 3), np.float32),
                     times=np.array([0.0, t], np.float32))
    tr = DNeRFTrainer(tnet, ds, RenderConfig(**CFG_KW), TrainConfig(num_rays=N_RAYS, iters=1000),
                      time_size=time_size, device="cpu")
    s = time_slice_index(t, time_size)
    bf = np.zeros((time_size, scene["bitfield"].size), np.uint8)
    bf[s] = scene["bitfield"]
    z = torch.zeros(())
    tr.set_grid(TimeOccupancyGrid(density_grid=torch.zeros(time_size, 1, bf.shape[1] * 8),
                                  bitfield=torch.from_numpy(bf), mean_density=z,
                                  iter_density=z.long()))
    batch = {"frame": 1, "time": tr.times[1], "slice": s, "rays_o": torch.from_numpy(scene["o"]),
             "rays_d": torch.from_numpy(scene["d"]), "gt_rgb": torch.from_numpy(scene["gt"]),
             "noise": torch.from_numpy(scene["noise"]), "bg": None}
    loss, npts, kept = tr.loss_on_batch(batch)
    loss.backward()
    return tr, batch, loss, npts, kept
