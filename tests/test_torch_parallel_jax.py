"""The port's trainer on two gloo ranks (`Trainer(mesh=make_mesh())`,
`tests/torch_dist_worker.py`'s `replay`) against the JAX package's data
parallelism, on the same weights, grid, error map and global batches (the
JAX draws: frame, pixels and march noise), with budget tiers and the error
map on and the grid updates off in both packages:

- against `tngp.train.Trainer(mesh=make_mesh(2, 1))` over three steps on a
  sparse grid, where demand moves the tier down twice through the
  all-reduced tier read (the second time on a step whose two halves lie on
  either side of the threshold, so that only the global read agrees) and
  no ray is dropped;
- with a budget that drops rays, against the JAX package's per-chip budget
  semantics (`tngp.parallel.data_parallel_value_and_grad`, each shard's
  `render_rays_train` under its own M_local, mesh.py:89-93), the loss
  divided by the kept rays of both shards; the JAX trainer under a mesh
  keeps one global budget instead (ROADMAP section 3), so it is not the
  reference there.

Each step's tier, demand and kept rays are held exactly, the ranks' losses,
gradients, error maps and weights bitwise equal to each other.
Tolerances (the packages' f32 renders sum in other orders, the ranks'
gradients as two partial sums): every step's loss 1e-5 relative (measured
<= 1.4e-7), the first step's gradients 1e-3 norm-relative (measured <=
6.0e-5); an error-map entry equal to one of the port's candidate values
and the JAX entry within 1e-4 relative of one, since a pixel named by
several rays has an unspecified winner in both packages; entries no ray
wrote, and those only dropped rays named, exactly."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tngp.data import make_synthetic_dataset
from tngp.data.rays import sample_rays as jax_sample_rays
from tngp.models import NGPNetwork as JaxNGP
from tngp.parallel import data_parallel_value_and_grad as jax_dpvg
from tngp.parallel import make_mesh as jax_make_mesh
from tngp.parallel import shard_params as jax_shard_params
from tngp.render import RenderConfig as JaxRenderConfig
from tngp.render import render_rays_train as jax_render_rays_train
from tngp.render.occupancy import update_density_grid as jax_update_density_grid
from tngp.train import Trainer as JaxTrainer
from tngp.utils.config import TrainConfig as JaxTrainConfig
from tngp_torch.convert import ngp_state_dict_from_flax
from tngp_torch.data import sample_rays
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

WORKER = Path(__file__).parent / "torch_dist_worker.py"
NET_KW = dict(encoding="hashgrid", num_levels=4, log2_hashmap_size=12, hidden_dim=16,
              hidden_dim_color=16)
CFG_KW = dict(bound=1.0, grid_size=16, max_steps=64, K=16, K_eval=16, min_near=0.05,
              march_dense=True)
N = 256


def _rel(a, b):
    a, b = torch.as_tensor(np.asarray(a)).double(), torch.as_tensor(np.asarray(b)).double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def jax_setup(tmp_path, compact_fraction, mesh=None, ball=None, **tc_kw):
    """A JAX trainer (under `mesh` when given) of the small golden-grid NGP
    on 3 views of the 24x24 blob scene, its tables N(0, 0.3), its grid
    every cell (or, with `ball`, the cells within that radius), its error
    map uniform in [0.2, 2]; and the port's set-up of the same."""
    ds = make_synthetic_dataset(n_frames=3, H=24, W=24, seed=0, num_steps=64)
    tc_kw = dict(name="dpj", iters=100, num_rays=N, error_map=True, bf16=False,
                 adaptive_budget=True, **tc_kw)
    cfg_kw = dict(compact_fraction=compact_fraction, **CFG_KW)
    jtr = JaxTrainer(JaxNGP(bound=1.0, **NET_KW), ds, JaxRenderConfig(**cfg_kw),
                     JaxTrainConfig(workspace=str(tmp_path / "jax"), use_checkpoint="scratch",
                                    **tc_kw), mesh=mesh)
    params = jax.tree_util.tree_map(np.asarray, jtr.params)
    emb = params["params"]["encoder"]["embeddings"]
    rng = np.random.default_rng(0)
    params["params"]["encoder"]["embeddings"] = rng.normal(0, 0.3, emb.shape).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    if mesh is not None:
        jparams = jax_shard_params(jparams, mesh, False)
    jtr.params = jparams
    jtr.ema_params = jax.tree_util.tree_map(jnp.array, jparams)
    jtr.opt_state = jtr.tx.init(jtr.params)
    if ball is None:
        jtr.grid = jtr.grid.replace(bitfield=jnp.full_like(jtr.grid.bitfield, 255))
    else:
        jtr.grid = jax_update_density_grid(
            jtr.grid, None, jax.random.PRNGKey(3),
            density_fn=lambda p, x: 100.0 * (jnp.sqrt((x ** 2).sum(0)) < ball), bound=1.0,
            grid_size=16, density_thresh=10.0, full=True)
    jtr._dgrid = jtr._dgrid_fn(jtr.grid.bitfield)
    jtr.error_map = jnp.asarray(rng.uniform(0.2, 2.0, (3, 128 * 128)).astype(np.float32))
    jtr.maybe_update_grid = lambda: None
    g = jtr.grid
    setup = {
        "dataset": {"poses": torch.from_numpy(np.asarray(ds.poses)),
                    "intrinsics": torch.from_numpy(np.asarray(ds.intrinsics)),
                    "H": ds.H, "W": ds.W, "images": torch.from_numpy(np.asarray(ds.images))},
        "net_kw": NET_KW, "cfg_kw": cfg_kw, "tc_kw": tc_kw,
        "state_dict": {k: torch.as_tensor(np.array(v))
                       for k, v in ngp_state_dict_from_flax(params).items()},
        "grid": [torch.from_numpy(np.array(a)) for a in
                 (g.density_grid, g.bitfield, g.mean_density, g.iter_density)],
        "error_map": torch.from_numpy(np.array(jtr.error_map)),
    }
    return jtr, setup


def draws(jtr, key, error_map):
    """The JAX step's frame, pixels and perturbation key from its key
    (`tngp/train/trainer.py:241-266`), drawn by `error_map`'s row."""
    k_idx, k_rays, k_perturb, _ = jax.random.split(key, 4)
    idx = int(jax.random.randint(k_idx, (), 0, jtr.n_frames))
    r = jax_sample_rays(k_rays, jtr.poses[idx], jtr.intrinsics, jtr.H, jtr.W, N,
                        error_map=jnp.asarray(error_map[idx]))
    return idx, np.asarray(r["inds"]), np.asarray(r["inds_coarse"]), k_perturb


def port_batch(jtr, frame, inds, inds_coarse, noise):
    """The port trainer's global batch for those draws (RGB targets)."""
    r = sample_rays(torch.from_numpy(np.asarray(jtr.poses[frame])),
                    torch.from_numpy(np.asarray(jtr.intrinsics)), jtr.H, jtr.W, N,
                    inds=torch.from_numpy(inds.copy()))
    gt = torch.from_numpy(np.asarray(jtr.images[frame])).reshape(-1, 3)[r["inds"]]
    return {"frame": frame, "rays_o": r["rays_o"], "rays_d": r["rays_d"], "gt_rgb": gt,
            "bg": None, "noise": torch.from_numpy(np.array(noise)),
            "inds_coarse": torch.from_numpy(inds_coarse.copy())}


def run_ranks(tmp_path, setup):
    """Both gloo ranks' `replay` of `setup`; returns their records."""
    path = tmp_path / "setup.pt"
    torch.save(setup, path)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "TNGP_COORDINATOR": f"localhost:{port}", "TNGP_NUM_PROCESSES": "2",
           "TNGP_PLATFORM": "cpu", "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(tmp_path / f"r{r}.pt"),
                               str(path)], env={**env, "TNGP_PROCESS_ID": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    r0, r1 = (torch.load(tmp_path / f"r{r}.pt") for r in range(2))
    for key in ("losses", "pts", "kepts"):
        assert r0[key].shape == r1[key].shape
    assert torch.equal(r0["losses"], r1["losses"]) and r0["tiers"] == r1["tiers"]
    for a, b in zip(r0["params"], r1["params"]):
        assert torch.equal(a, b)
    for g0, g1 in zip(r0["grads"], r1["grads"]):
        assert all(torch.equal(g0[n], g1[n]) for n in g0)
    for m0, m1 in zip(r0["maps"], r1["maps"]):
        assert torch.equal(m0, m1)
    return r0, r1


def jax_loss_parts(field, bitfield, dgrid, cfg):
    """(sum of the kept rays' errors, kept rays, per-ray error, ray mask,
    demand) of one `render_rays_train` call, as the JAX step's loss_fn."""

    def parts(p, o, d, gt, key):
        out = jax_render_rays_train(field, p, o, d, bitfield, cfg, key=key, dilated_grid=dgrid)
        rm = out["ray_mask"].astype(jnp.float32)
        per_ray = jnp.mean((out["image"] - gt) ** 2, axis=-1)
        return (per_ray * rm).sum(), rm.sum(), per_ray, rm, out["num_points"]

    return parts


def check_error_map(port_map, jax_map, port_old, jax_old, frame, ic, per_ray, rm, rtol):
    """Each package's error map after a step against its map before it:
    other rows and unnamed entries unchanged; each named entry one of the
    port's candidates, the JAX entry within `rtol` of one; entries only
    dropped rays named unchanged."""
    named = np.zeros(port_old.shape[1], bool)
    named[ic] = True
    for new_map, old in ((port_map, port_old), (jax_map, jax_old)):
        others = np.arange(old.shape[0]) != frame
        np.testing.assert_array_equal(new_map[others], old[others])
        np.testing.assert_array_equal(new_map[frame][~named], old[frame][~named])
    new = np.where(rm > 0, np.float32(0.1) * port_old[frame][ic] + np.float32(0.9) * per_ray,
                   port_old[frame][ic])
    for c in np.unique(ic):
        cands = new[ic == c]
        assert (cands == port_map[frame][c]).any(), c
        assert np.isclose(cands, jax_map[frame][c], rtol=rtol, atol=0).any(), c
        if not (rm[ic == c] > 0).any():
            assert port_map[frame][c] == port_old[frame][c], c
            assert jax_map[frame][c] == jax_old[frame][c], c


def test_two_ranks_follow_the_jax_mesh_trainer(tmp_path):
    """Three steps, a tier read before each (demand moves the tier from f =
    0.5 to 0.25 to 0.125), no ray dropped.  (A fourth step, at tier 0,
    counts 249 samples where the JAX trainer counts 251: the chunked march
    counts the rungs of the chunks it considers, which a rank's M_local of
    256 bounds and the global 512 does not; the per-rank budgets of
    ROADMAP section 3.)"""
    jmesh = jax_make_mesh(2, 1, devices=jax.devices()[:2])
    jtr, setup = jax_setup(tmp_path, 0.5, mesh=jmesh, ball=0.45, update_extra_interval=1)
    rec = []

    def recorded(step, frac):
        def run(*args):
            em = np.array(args[4])  # the step donates it
            out = step(*args)
            rec.append(dict(frac=frac, key=args[3], em_in=em, em_out=np.array(out[3]),
                            loss=float(out[4]), npts=int(out[5]), kept=int(out[6])))
            return out
        return run

    build = jtr._build_train_step
    jtr._build_train_step = lambda cfg=None: recorded(build(cfg), cfg.compact_fraction)
    jtr._train_step = jtr._tier_steps[2] = recorded(jtr._train_step, 0.5)
    p0 = jax.tree_util.tree_map(np.array, jtr.params)
    jtr.train_one_epoch(3)
    assert [r["frac"] for r in rec] == [0.5, 0.25, 0.125]
    assert all(r["kept"] == N for r in rec)

    batches, per_step = [], []
    for r in rec:
        frame, inds, ic, k_perturb = draws(jtr, r["key"], r["em_in"])
        batches.append(port_batch(jtr, frame, inds, ic, jax.random.uniform(k_perturb, (N,))))
        per_step.append((frame, ic, k_perturb))
    setup["batches"] = batches
    r0, r1 = run_ranks(tmp_path, setup)

    fracs = jtr._tier_fracs
    assert [fracs[t] for t in r0["tiers"]] == [r["frac"] for r in rec]
    # the read before step 2: one rank's own demand would keep tier 1
    # (M_local 256 at tier 0), the other's would not
    own = sorted([int(r0["pts"][1]), int(r1["pts"][1])])
    assert own[0] * 1.6 < 256 <= own[1] * 1.6
    assert (r0["pts"] + r1["pts"]).tolist() == [r["npts"] for r in rec]
    assert (r0["kepts"] + r1["kepts"]).tolist() == [N] * len(rec)
    for i, r in enumerate(rec):
        assert abs(float(r0["losses"][i]) - r["loss"]) <= 1e-5 * abs(r["loss"]), (i, r)

    # the first step's gradients: the JAX step's loss at the starting weights
    b0, (frame, ic, k_perturb) = batches[0], per_step[0]
    parts = jax_loss_parts(jtr.field, jtr.grid.bitfield, jtr._dgrid,
                           JaxRenderConfig(**setup["cfg_kw"]))

    def loss_fn(p):
        s, k, *_ = parts(p, jnp.asarray(b0["rays_o"].numpy()), jnp.asarray(b0["rays_d"].numpy()),
                         jnp.asarray(b0["gt_rgb"].numpy()), k_perturb)
        return s / jnp.maximum(k, 1.0)

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(jax.tree_util.tree_map(jnp.asarray, p0))
    assert abs(float(jl) - rec[0]["loss"]) <= 1e-5 * abs(float(jl))
    jg = ngp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jg))
    for name, g in r0["grads"][0].items():
        assert _rel(g, jg[name]) <= 1e-3, name

    # the error map, step by step
    for i, r in enumerate(rec):
        frame, ic, _ = per_step[i]
        per_ray = torch.cat([r0["per_ray"][i], r1["per_ray"][i]]).numpy()
        rm = torch.cat([r0["ray_mask"][i], r1["ray_mask"][i]]).float().numpy()
        old = setup["error_map"].numpy() if i == 0 else r0["maps"][i - 1].numpy()
        check_error_map(r0["maps"][i].numpy(), r["em_out"], old, r["em_in"], frame, ic, per_ray,
                        rm, 1e-4)


def test_two_ranks_drop_rays_under_their_own_budgets(tmp_path):
    """Every cell occupied and f = 0.25: each rank keeps the rays that fit
    its M_local = 512 samples.  The first step against the JAX per-chip
    semantics; the second step's tier read all-reduces the drop and moves
    both ranks up a tier, as the JAX trainer's `_adapt_tier` does on the
    same demand and kept fraction."""
    jtr, setup = jax_setup(tmp_path, 0.25, update_extra_interval=1)
    cfg = JaxRenderConfig(**setup["cfg_kw"])
    em0 = np.array(jtr.error_map)
    p0 = jtr.params
    parts = jax.jit(jax_loss_parts(jtr.field, jtr.grid.bitfield, jtr._dgrid, cfg))
    batches, shards = [], []
    for step in range(2):
        frame, inds, ic, k_perturb = draws(jtr, jax.random.PRNGKey(11 + step), em0)
        keys = jax.random.split(k_perturb, 2)  # each shard's noise from its own key
        noise = jnp.concatenate([jax.random.uniform(k, (N // 2,)) for k in keys])
        b = port_batch(jtr, frame, inds, ic, noise)
        batches.append(b)
        shards.append((frame, ic, keys, b))
    setup["batches"] = batches
    r0, r1 = run_ranks(tmp_path, setup)

    frame, ic, keys, b = shards[0]
    o, d, gt = (jnp.asarray(b[k].numpy()) for k in ("rays_o", "rays_d", "gt_rgb"))
    halves = [parts(p0, o[s], d[s], gt[s], keys[i])
              for i, s in enumerate((slice(0, N // 2), slice(N // 2, N)))]
    kept = [int(h[1]) for h in halves]
    assert 0 < sum(kept) < N  # the budgets dropped rays
    assert [int(r0["kepts"][0]), int(r1["kepts"][0])] == kept
    assert [int(r0["pts"][0]), int(r1["pts"][0])] == [int(h[4]) for h in halves]
    inv_total = 1.0 / sum(kept)

    def shard_loss(p, o_s, d_s, gt_s, key_s, inv):
        s, *_ = jax_loss_parts(jtr.field, jtr.grid.bitfield, jtr._dgrid, cfg)(
            p, o_s, d_s, gt_s, key_s[0])
        return 2.0 * s * inv  # the mean over 'data' of these is the global masked mean

    jmesh = jax_make_mesh(2, 1, devices=jax.devices()[:2])
    jl, jg = jax.jit(jax_dpvg(shard_loss, jmesh, 4))(p0, o, d, gt, jnp.stack(keys),
                                                     jnp.float32(inv_total))
    assert abs(float(r0["losses"][0]) - float(jl)) <= 1e-5 * abs(float(jl))
    jg = ngp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jg))
    for name, g in r0["grads"][0].items():
        assert _rel(g, jg[name]) <= 1e-3, name

    # the error map the JAX step writes from both shards' rays
    per_ray_j = np.concatenate([np.asarray(h[2]) for h in halves])
    rm_j = np.concatenate([np.asarray(h[3]) for h in halves])
    jmap = em0.copy()
    row = jmap[frame]
    row[ic] = np.where(rm_j > 0, np.float32(0.1) * em0[frame][ic] + np.float32(0.9) * per_ray_j,
                       em0[frame][ic])
    per_ray = torch.cat([r0["per_ray"][0], r1["per_ray"][0]]).numpy()
    rm = torch.cat([r0["ray_mask"][0], r1["ray_mask"][0]]).float().numpy()
    np.testing.assert_array_equal(rm, rm_j)
    check_error_map(r0["maps"][0].numpy(), jmap, em0, em0, frame, ic, per_ray, rm, 1e-4)

    # the tier read after the drop: up one tier on both ranks, as JAX's
    demand = float(r0["pts"][0] + r1["pts"][0])
    jtr._adapt_tier(demand, sum(kept) / N)
    assert r0["tiers"] == [2, jtr._tier] and jtr._tier == 3
    assert torch.isfinite(r0["losses"]).all()
