"""The hard scene and its scripts in the port: `make_hard_field` against the
JAX package's at seeded points, `render_gt_images` of it at 16x16 with 64
steps against the JAX package's, and `tngp_torch.scripts.train_hard` (bf16
and `--mxu_f32`) and `bench_eval` at a small size on a cut of the tracked
`.cache/hard_256.npz`, and device parity's trained-table branch on the
checkpoint that run wrote.

Tolerances.  Colour 1e-6 absolute.  Density within 1e-5 of its 250-per-shape
scale: the shapes' superellipsoid distance `sum(d^p)^(1/p)` takes a
non-integer power, where XLA's and torch's `pow` differ by an ulp, and the
occupancy's sigmoid multiplies a distance error by sharpness / radius, up
to 1,000 (measured 5.5e-4 of density 500, 2.2e-6 of the scale).  Images
1e-5 (the quadrature of those densities)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tngp.data.synthetic import make_hard_field as jax_make_hard_field
from tngp.data.synthetic import orbit_poses
from tngp.data.synthetic import render_gt_images as jax_render_gt_images
from tngp_torch.data.synthetic import make_hard_field, render_gt_images
from tngp_torch.scripts import bench_eval, train_hard
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

MODEL_KW = dict(num_levels=4, log2_hashmap_size=12, hidden_dim=16, hidden_dim_color=16)
CFG_KW = dict(grid_size=32, max_steps=64, K=32)
CPU = torch.device("cpu")


def test_hard_field_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.8, 0.8, (3, 4096)).astype(np.float32)
    d = rng.normal(size=(3, 4096)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    jf, pf = jax_make_hard_field(0), make_hard_field(0, device="cpu")
    js, jc = jf.sigma_rgb(None, jnp.asarray(x), jnp.asarray(d))
    ps, pc = pf.sigma_rgb(None, torch.from_numpy(x), torch.from_numpy(d))
    assert float(np.asarray(js).max()) > 250.0  # the points reach into shapes
    assert np.abs(ps.numpy() - np.asarray(js)).max() <= 1e-5 * 250.0
    assert np.abs(pc.numpy() - np.asarray(jc)).max() <= 1e-6
    jd = np.asarray(jf.density(None, jnp.asarray(x)))
    assert np.abs(pf.density(None, torch.from_numpy(x)).numpy() - jd).max() <= 1e-5 * 250.0


def test_hard_scene_render_matches_jax():
    poses = orbit_poses(2)
    intr = np.array([0.9 * 16, 0.9 * 16, 8, 8], np.float32)
    want = jax_render_gt_images(jax_make_hard_field(0), poses, intr, 16, 16, 1.0, 64)
    got = render_gt_images(make_hard_field(0, device="cpu"), poses, intr, 16, 16, 1.0, 64,
                           device="cpu")
    assert got.shape == (2, 16, 16, 3) and float(want.max()) > 0.1
    assert np.abs(got - np.asarray(want)).max() <= 1e-5


@pytest.fixture
def hard_cut():
    """8 of the cache's views at 32x32 (every 8th pixel): 5 held out, 3 to
    train on."""
    z = np.load(train_hard.CACHE)
    return z["poses"][:8], z["intrinsics"] / 8, z["images"][:8, ::8, ::8]


def test_train_hard_and_bench_eval_run(hard_cut, tmp_path, monkeypatch, capsys):
    """Two epochs of two steps, bf16 and `--mxu_f32` (the f32 form through
    `TNGP_MXU_F32`, as the JAX script sets it; that run the first 4 steps
    of a 30,000-step schedule, `max_steps`): curve.json and the JSON line's
    keys, a checkpoint; then `bench_eval` renders two frames from the bf16
    run's checkpoint and its JSON line parses."""
    monkeypatch.setenv("TNGP_MXU_F32", "0")
    results = {}
    for flags in ([], ["--mxu_f32"]):
        ws = tmp_path / ("hard_f32" if flags else "hard_base")
        opt = train_hard.build_parser().parse_args(
            ["--iters", "30000" if flags else "4", "--workspace", str(ws), *flags])
        r = train_hard.train_hard(opt, data=hard_cut, device=CPU, model_kw=MODEL_KW,
                                  cfg_kw=CFG_KW, steps_per_epoch=2,
                                  max_steps=4 if flags else None)
        curve = json.loads((ws / "curve.json").read_text())
        assert curve == json.loads(json.dumps(r["curve"])) and curve[-1]["final"]
        assert curve[-1]["step"] == 4 and len(r["epoch_losses"]) == 2
        assert r["tag"] == "base" and np.isfinite(r["final_psnr"]) and r["ms_per_step"] > 0
        assert r["mxu_f32"] == bool(flags)
        assert list((ws / "checkpoints").glob("hard_base_ep0002.npz"))
        results[bool(flags)] = r
    assert results[True]["final_psnr"] != results[False]["final_psnr"]
    opt = bench_eval.build_parser().parse_args(
        ["--workspace", str(tmp_path / "hard_base"), "--res", "48", "--frames", "2",
         "--chunk", "1024"])
    monkeypatch.setenv("TNGP_MXU_F32", "0")
    line = bench_eval.bench_eval(opt, data=hard_cut, device=CPU, model_kw=MODEL_KW,
                                 cfg_kw=CFG_KW)
    out = json.loads(json.dumps(line))
    assert out["metric"] == "eval_rays_per_s" and out["value"] > 0 and out["res"] == 48
    assert len(out["rounds"]) == 2 and len(out["rays_cut"]) == 2
    assert "# frame:" in capsys.readouterr().err
    # device parity's trained-table branch reads the newest such checkpoint
    from tngp_torch.diagnostics import device_parity
    from tngp_torch.models import NGPNetwork

    spec = NGPNetwork(encoding="hashgrid_window", device="cpu", **MODEL_KW).encoder.spec
    assert device_parity.run_probes(spec, n=512, device="cpu",
                                    trained=str(tmp_path / "hard_*" / "checkpoints" / "*.npz"))
    assert "forward trained mxu_f32=True" in capsys.readouterr().out


def test_bench_eval_without_a_checkpoint_says_so(tmp_path, capsys):
    opt = bench_eval.build_parser().parse_args(["--workspace", str(tmp_path / "none")])
    z = np.load(train_hard.CACHE)
    data = z["poses"][:2], z["intrinsics"] / 8, z["images"][:2, ::8, ::8]
    assert bench_eval.bench_eval(opt, data=data, device=CPU, model_kw=MODEL_KW,
                                 cfg_kw=CFG_KW) is None
    assert "no checkpoint found" in capsys.readouterr().err
