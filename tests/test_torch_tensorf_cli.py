"""The TensoRF and CCNeRF entry points of the port in the process, on the
CPU, at small width: `main_tensorf` with an upsample inside the run (the
JAX CLI's `append` quirk: `--upsample_model_steps 8` adds a sixth milestone
to the five defaults) and a resume across it, `--cp`, and `main_ccnerf`
(train, finalize, the five `--rank_levels` files) then `--compose`.  The
models are narrowed (TensoRF: resolution 16 -> 24, ranks 2-4, hidden 16;
CCNeRF: `torch_tensorf_helpers.CC_SMALL`) and the occupancy grid to 32^3;
the synthetic scene is 4 frames of 16x16.  No JAX here, but the runs take
tens of seconds, so this file has three cases."""

import functools
import os

import numpy as np
import pytest
import torch

from torch_tensorf_helpers import CC_SMALL
from torch_threads import one_torch_thread  # noqa: F401  (autouse: the in-process runs)

FLAGS = ["--num_rays", "128", "--max_steps", "48", "--sample_budget", "16", "--bound", "1.0",
         "--dt_gamma", "0", "--min_near", "0.05", "--eval_interval", "100",
         "--density_thresh", "1.0"]


@pytest.fixture
def small(monkeypatch):
    import dataclasses

    import tngp_torch.models as models
    from tngp_torch.cli import common, main_ccnerf
    from tngp_torch.models.ccnerf import CCConfig

    monkeypatch.setenv("TNGP_PLATFORM", "cpu")
    monkeypatch.setenv("TNGP_SYNTH", "4,16,16")
    monkeypatch.setattr(models, "TensoRFNetwork", functools.partial(
        models.TensoRFNetwork, color_feat_dim=6, hidden_dim=16))
    monkeypatch.setattr(main_ccnerf, "cc_config",
                        lambda opt: CCConfig(bound=opt.bound, **CC_SMALL))
    build = common.build_configs

    def small_grid(opt):
        cfg, tc = build(opt)
        return dataclasses.replace(cfg, grid_size=32), tc

    monkeypatch.setattr(common, "build_configs", small_grid)


def test_main_tensorf_upsamples_and_resumes_across(small, tmp_path):
    from tngp_torch.cli import main_tensorf
    from tngp_torch.train import TensoRFTrainer

    ws = str(tmp_path / "tf")
    argv = ["synthetic", "-O", *FLAGS, "--workspace", ws, "--resolution0", "16",
            "--resolution1", "24", "--upsample_model_steps", "8"]
    tr = main_tensorf.main(argv + ["--iters", "16"])
    assert tr.upsample_model_steps == [2000, 3000, 4000, 5500, 7000, 8]
    assert [u["step"] for u in tr.upsamples] == [8]
    assert tr.upsamples[0]["new"] == tuple(tr.model.resolution) != (16, 16, 16)
    assert tr.global_step == 16 and np.isfinite(tr.stats["loss"]).all()
    res, aabb = tuple(tr.model.resolution), tr.model.aabb
    weights = [p.detach().clone() for p in tr.params]
    seen = {}
    real_train = TensoRFTrainer.train

    def train_seen(self, max_epochs):
        seen["at"] = (self.epoch, self.global_step, tuple(self.model.resolution), self.model.aabb)
        seen["same"] = all(torch.equal(a, b) for a, b in zip(self.params, weights))
        return real_train(self, max_epochs)

    TensoRFTrainer.train = train_seen
    try:
        tr2 = main_tensorf.main(argv + ["--iters", "20"])
    finally:
        TensoRFTrainer.train = real_train
    assert seen == {"at": (4, 16, res, aabb), "same": True}
    assert tr2.global_step == 20 and os.path.isdir(os.path.join(ws, "validation"))


def test_main_tensorf_cp(small, tmp_path):
    from tngp_torch.cli import main_tensorf

    tr = main_tensorf.main(["synthetic", "--cp", *FLAGS, "--workspace", str(tmp_path),
                            "--resolution0", "16", "--iters", "8"])
    assert tr.model.decomposition == "cp" and tr.model.sigma_rank == (96, 96, 96)
    assert tr.model.color_rank == (288, 288, 288) and not hasattr(tr.model, "sigma_mat_0")
    assert np.isfinite(tr.stats["loss"]).all()


def test_main_ccnerf_and_compose(small, tmp_path, capsys):
    from tngp_torch.cli import main_ccnerf

    ws = str(tmp_path / "cc")
    tr = main_ccnerf.main(["synthetic", *FLAGS, "--workspace", ws, "--iters", "8"])
    assert tr.global_step == 8 and np.isfinite(tr.stats["loss"]).all()
    files = sorted(os.listdir(os.path.join(ws, "cc_models")))
    assert files == ["full.pkl", "rank_16_2_16_2.pkl", "rank_32_4_32_16.pkl",
                     "rank_64_16_64_64.pkl", "rank_64_8_64_32.pkl", "rank_8_0_8_0.pkl"]
    assert capsys.readouterr().out.count("[compress] ranks=") == 5
    scene = main_ccnerf.main(["synthetic", *FLAGS, "--workspace", ws, "--compose"])
    assert len(scene.objects) == 6
    x = torch.rand((3, 64)) * 1.6 - 0.8
    d = torch.nn.functional.normalize(torch.randn((3, 64)), dim=0)
    with torch.no_grad():
        sig, rgb = scene.sigma_rgb_cf(x, d)
    assert torch.isfinite(sig).all() and rgb.shape == (3, 64) and torch.isfinite(rgb).all()
