"""Port parity for the frame renderer (`tngp_torch/render/frame_eval.py`)
against the JAX package's `FrameRenderer` on the CPU, on the same weights
(carried by `tngp_torch.convert`), bitfield and rays; and the march and the
occupancy update at the CLI's defaults, 2 cascades and dt_gamma 1/128."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tngp.models import NGPNetwork as JaxNGP
from tngp.ops import march as jm
from tngp.ops import packbits as jax_packbits
from tngp.ops.rays import near_far_from_aabb as jax_near_far
from tngp.render import FieldFns as JaxFieldFns
from tngp.render import RenderConfig as JaxRenderConfig
from tngp.render import dilated_chunk_grid as jax_dilated_chunk_grid
from tngp.render import occupancy as jocc
from tngp.render.frame_eval import FrameRenderer as JaxFrameRenderer
from tngp_torch.convert import ngp_state_dict_from_flax, occupancy_grid_from_arrays
from tngp_torch.data.rays import full_image_rays
from tngp_torch.data.synthetic import make_blob_field, orbit_poses
from tngp_torch.models import NGPNetwork
from tngp_torch.ops import march as tm
from tngp_torch.render import FieldFns, RenderConfig, dilated_chunk_grid
from tngp_torch.render import occupancy as tocc
from tngp_torch.render.frame_eval import FrameRenderer
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

NET_KW = dict(num_levels=4, log2_hashmap_size=15, base_resolution=16)
GRID = 16
# a starved first pass (eval_budget 0.05) leaves most rays to the rounds;
# tiers 16 and 64 make the frame visit both
CFG_KW = dict(bound=1.0, grid_size=GRID, max_steps=256, K=32, K_eval=8, min_near=0.05,
              march_chunk=8, eval_budget=0.05, eval_tiers=(16, 64))
FRAME_H, FRAME_W, CHUNK = 23, 24, 64  # 552 rays: 9 chunks, the last one 24 padding rays


@pytest.fixture(scope="module")
def scene():
    jnet = JaxNGP(encoding="hashgrid_window", compute_dtype=jnp.bfloat16, **NET_KW)
    params = jnet.init(jax.random.PRNGKey(3), jnp.zeros((8, 3)), jnp.ones((8, 3)) / np.sqrt(3))
    params = jax.tree_util.tree_map(np.asarray, params)
    # a table scale that moves the density (the init is U(+-1e-4))
    emb = params["params"]["encoder"]["embeddings"]
    params["params"]["encoder"]["embeddings"] = np.random.default_rng(0).normal(
        0, 0.1, emb.shape).astype(np.float32)
    tnet = NGPNetwork(encoding="hashgrid_window", compute_dtype=torch.bfloat16, device="cpu", **NET_KW)
    tnet.load_state_dict(ngp_state_dict_from_flax(params))
    ax = (np.arange(GRID) + 0.5) / GRID * 2.0 - 1.0
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    occ = ((gx**2 + gy**2 + gz**2) < 0.45**2).astype(np.float32).reshape(-1)
    bf = np.array(jax_packbits(jnp.asarray(occ), 0.5))
    # explicit pixel rays of one orbit pose, the same arrays for both packages;
    # the focal length makes the object fill the middle rows only, so the
    # first and last chunks miss the occupied cells' box
    pose = orbit_poses(1, radius=2.5, elevation=0.3)[0]
    intr = np.array([1.2 * FRAME_W, 1.2 * FRAME_W, FRAME_W / 2, FRAME_H / 2], np.float32)
    o, d = full_image_rays(pose, intr, FRAME_H, FRAME_W, device="cpu")
    jcfg, tcfg = JaxRenderConfig(**CFG_KW), RenderConfig(**CFG_KW)
    jfr = JaxFrameRenderer(JaxFieldFns.from_model(jnet), jcfg, chunk=CHUNK)
    tfr = FrameRenderer(FieldFns.from_model(tnet), tcfg, chunk=CHUNK)
    return dict(params=params, bf=bf, o=o.numpy(), d=d.numpy(), jfr=jfr, tfr=tfr,
                jcfg=jcfg, tcfg=tcfg)


def _render_both(sc, bg_color=None, max_rounds=64):
    bf = sc["bf"]
    jimg, jdep = sc["jfr"].render(sc["params"], jnp.asarray(sc["o"]), jnp.asarray(sc["d"]),
                                  jnp.asarray(bf),
                                  jax_dilated_chunk_grid(jnp.asarray(bf), sc["jcfg"]),
                                  bg_color=None if bg_color is None else jnp.asarray(bg_color),
                                  max_rounds=max_rounds)
    tbf = torch.from_numpy(bf.copy())
    timg, tdep = sc["tfr"].render(None, torch.from_numpy(sc["o"]), torch.from_numpy(sc["d"]),
                                  tbf, dilated_chunk_grid(tbf, sc["tcfg"]),
                                  bg_color=None if bg_color is None else torch.tensor(bg_color),
                                  max_rounds=max_rounds)
    return np.asarray(jimg), np.asarray(jdep), timg.numpy(), tdep.numpy()


def test_frame_renderer_host_reads(scene):
    """One read for the hit bitmap, one for the marched chunks' sample
    counts, one for the alive count after the first pass, and one per
    round plus one per tier exit on the alive count: `3 + rounds + exits`,
    within `1 + first-pass chunks + rounds` for this frame."""
    tfr = scene["tfr"]
    _render_both(scene)
    st = tfr.last_stats
    exits = len(tfr.last_tiers)  # each tier loop ended on the alive count
    assert tfr.host_reads == st["host_reads"] == 3 + tfr.last_rounds + exits
    assert tfr.host_reads <= 1 + st["chunks_marched"] + tfr.last_rounds
    # a cut at max_rounds costs no read for the alive count after it
    _render_both(scene, max_rounds=2)
    assert tfr.host_reads == 3 + 2


def test_trainer_render_image_goes_through_the_frame_renderer(scene):
    """`Trainer.render_image` takes the frame renderer under the stream eval
    and the chunked march, one per (chunk, cfg), and agrees with
    `render_image_chunked` (the per-chunk `render_rays_eval` loop) to the
    same tolerances."""
    from tngp_torch.data import NeRFDataset
    from tngp_torch.train import Trainer
    from tngp_torch.utils import TrainConfig

    tnet = NGPNetwork(encoding="hashgrid_window", compute_dtype=torch.bfloat16, device="cpu", **NET_KW)
    tnet.load_state_dict(ngp_state_dict_from_flax(scene["params"]))
    pose = orbit_poses(1, radius=2.5, elevation=0.3)
    intr = np.array([1.2 * FRAME_W, 1.2 * FRAME_W, FRAME_W / 2, FRAME_H / 2], np.float32)
    ds = NeRFDataset(poses=pose, intrinsics=intr, H=FRAME_H, W=FRAME_W,
                     images=np.zeros((1, FRAME_H, FRAME_W, 3), np.float32))
    cfg = RenderConfig(**CFG_KW, compact_fraction=0.5, march_dense=True)
    tr = Trainer(tnet, ds, cfg, TrainConfig(num_rays=64), device="cpu")
    tbf = torch.from_numpy(scene["bf"].copy())
    tr.set_grid(dataclasses.replace(tr.grid, bitfield=tbf))
    img, dep = tr.render_image(pose[0], use_ema=False, chunk=CHUNK)
    assert set(tr._frame_renderers) == {(CHUNK, cfg)}
    assert tr.last_render_stats["rounds"] > 0
    img_c, dep_c = tr.render_image_chunked(pose[0], use_ema=False, chunk=CHUNK)
    assert img.shape == (FRAME_H, FRAME_W, 3)
    np.testing.assert_allclose(img, img_c, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dep, dep_c, rtol=1e-3, atol=1e-3)


def test_two_cascade_march_and_grid_update_exact():
    """The CLI's defaults (bound 2: 2 cascades; dt_gamma 1/128) on the
    march's exact-prefix contract (sel, sel_valid, m_eff, ray_mask and
    num_points equal) and on a full occupancy update of both cascades from
    the same draws (densities to the blob field's f32 rounding, 1e-5
    relative; the bitfield exact away from cells on the threshold)."""
    H, bound, cas = 32, 2.0, 2
    rng = np.random.default_rng(8)
    o = (np.array([0.0, 0.0, -3.5]) + rng.normal(0, 0.1, (96, 3))).astype(np.float32)
    d = rng.uniform(-0.8, 0.8, (96, 3)) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    ax = (np.arange(H) + 0.5) / H * 2.0 - 1.0
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    occ0 = ((gx**2 + gy**2 + gz**2) < 0.5**2) | (rng.uniform(size=gx.shape) < 0.02)
    # the outer cascade's shell lies outside the inner cascade's box
    occ1 = ((gx**2 + gy**2 + gz**2) > 0.55**2) & ((gx**2 + gy**2 + gz**2) < 0.8**2)
    occ = np.concatenate([occ0.reshape(-1), occ1.reshape(-1)]).astype(np.float32)
    bf = np.asarray(jax_packbits(jnp.asarray(occ), 0.5))
    aabb = (-bound,) * 3 + (bound,) * 3
    nears, fars = (np.asarray(a) for a in jax_near_far(jnp.asarray(o), jnp.asarray(d),
                                                       jnp.asarray(aabb), 0.2))
    noise = rng.uniform(size=96).astype(np.float32)
    kw = dict(bound=bound, cascades=cas, grid_size=H, dt_gamma=1 / 128, max_steps=512,
              M_budget=4096, G=8, chunk_budget=1024)
    cj = jm.march_rays_chunked(jnp.asarray(o), jnp.asarray(d), jnp.asarray(nears),
                               jnp.asarray(fars), jnp.asarray(bf), noise=jnp.asarray(noise), **kw)
    ct = tm.march_rays_chunked(torch.from_numpy(o), torch.from_numpy(d),
                               torch.from_numpy(nears.copy()), torch.from_numpy(fars.copy()),
                               torch.from_numpy(bf.copy()), noise=torch.from_numpy(noise), **kw)
    for name in ("sel", "sel_valid", "m_eff", "ray_mask", "num_points"):
        np.testing.assert_array_equal(getattr(ct, name).numpy(), np.asarray(getattr(cj, name)),
                                      err_msg=name)
    assert int(ct.m_eff) > 500 and not bool(ct.ray_mask.all())
    # samples in the outer cascade were selected
    lk = dict(bound=bound, cascades=cas, grid_size=H, dt_gamma=1 / 128, max_steps=512)
    _, x_c, _, _, _ = tm.ladder_samples(ct.sel, torch.from_numpy(o), torch.from_numpy(d),
                                        ct.t0, **lk)
    assert bool((x_c[:, ct.sel_valid].abs().amax(0) > 1.0).any())

    # a full update of both cascades from the same jitter draws
    key = jax.random.PRNGKey(4)
    kwu = dict(bound=bound, grid_size=H, density_thresh=1.0)
    jfield, tfield = _blob_fields()
    jstate = jocc.create(cas, H)
    jnew = jocc.update_density_grid(jstate, None, key, density_fn=jfield.density, full=True,
                                    **kwu)
    draws = _full_draws(key, cas, H)
    told = occupancy_grid_from_arrays(*(np.asarray(a) for a in (
        jstate.density_grid, jstate.bitfield, jstate.mean_density, jstate.iter_density)),
        device="cpu")
    tnew = tocc.update_density_grid_from_draws(told, None, draws, density_fn=tfield.density,
                                               full=True, **kwu)
    tg, jg = tnew.density_grid.numpy(), np.asarray(jnew.density_grid)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-6)
    thresh = min(float(jnew.mean_density), kwu["density_thresh"])
    near = (np.abs(jg - thresh) <= 1e-5 * max(thresh, 1.0)).ravel()
    tb = np.unpackbits(tnew.bitfield.numpy(), bitorder="little")
    jb = np.unpackbits(np.asarray(jnew.bitfield), bitorder="little")
    np.testing.assert_array_equal(tb[~near], jb[~near])
    assert jb[: H**3].mean() > 0.01 and jb[H**3:].mean() > 0.001  # both cascades occupied


def _blob_fields():
    from tngp.data.synthetic import make_blob_field as jax_blob_field

    return jax_blob_field(0), make_blob_field(0, device="cpu")


def _full_draws(key, cascades, H):
    """The jitter draws a full `update_density_grid` makes from `key`, per
    cascade, as the JAX function splits its key."""
    draws = []
    for _ in range(cascades):
        key, jk = jax.random.split(key)
        draws.append(tocc.GridDraws(torch.from_numpy(np.array(
            jax.random.uniform(jk, (H**3, 3), minval=-1.0, maxval=1.0).T))))
    return draws
