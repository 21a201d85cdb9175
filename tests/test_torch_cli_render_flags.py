"""The render flags that select the other render paths, through the port's
entry points in the process, on the CPU, at small width
(`torch_cli_helpers.small_models`; port only, no JAX):

- `main_nerf --no_march_dense` (the grouped slab march and the global
  budget), `--march_chunk 0` (the stream march; the eval's stream first
  pass and slab rounds) and `--compact_fraction 1` (every slab slot): each
  trains 8 iterations with finite losses on the path its flag selects, with
  one sample budget on the slab paths, and evaluates to a finite PSNR;
  the `--no_march_dense` run resumes with `--ckpt latest` at its step with
  a first render bitwise equal to its last;
- `main_dnerf` and `main_tensorf` with each of the three flags: 4
  iterations each, finite losses, the configuration the flag selects.

The runs take seconds each on one torch thread: this file has four cases."""

import functools

import numpy as np
import pytest

from torch_cli_helpers import DNERF_FLAGS, FLAGS, small_models  # noqa: F401  (the fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RENDER_FLAGS = {
    "--no_march_dense": (["--no_march_dense"], dict(march_dense=False, march_group=8,
                                                    compact_fraction=0.25)),
    "--march_chunk 0": (["--march_chunk", "0"], dict(march_dense=True, march_chunk=0)),
    "--compact_fraction 1": (["--compact_fraction", "1"], dict(march_dense=False,
                                                               march_group=8,
                                                               compact_fraction=1.0)),
}


def _cfg_has(cfg, want):
    return {k: getattr(cfg, k) for k in want} == want


@pytest.mark.parametrize("flag", list(RENDER_FLAGS))
def test_main_nerf_trains_on_the_flags_path(small_models, tmp_path, flag):  # noqa: F811
    from tngp_torch.cli import main_nerf
    from tngp_torch.train import Trainer

    argv, want = RENDER_FLAGS[flag]
    ws = str(tmp_path / "ws")
    run = ["synthetic", *argv, *FLAGS[:-2], "--workspace", ws]
    tr = main_nerf.main(run + ["--iters", "8"])
    assert _cfg_has(tr.cfg, want), tr.cfg
    assert (len(tr._tier_M) > 1) == tr.cfg.march_dense
    assert (tr._dgrid is None) == (tr.cfg.march_chunk == 0)
    assert tr.global_step == 8 and np.isfinite(tr.stats["loss"]).all()
    assert np.isfinite(tr.evaluate(tr.dataset))
    if flag != "--no_march_dense":
        return
    img_last, _ = tr.render_image(tr.dataset.poses[0])
    seen = {}
    real_train = Trainer.train

    def train_seen(self, max_epochs):
        seen["at"] = (self.epoch, self.global_step)
        seen["img"] = self.render_image(self.dataset.poses[0])[0]
        return real_train(self, max_epochs)

    Trainer.train = train_seen
    try:
        tr2 = main_nerf.main(run + ["--iters", "12", "--ckpt", "latest"])
    finally:
        Trainer.train = real_train
    assert seen["at"] == (tr.epoch, 8) and np.array_equal(seen["img"], img_last)
    assert tr2.global_step == 12


def test_main_dnerf_and_main_tensorf_on_the_flags_paths(small_models, tmp_path,  # noqa: F811
                                                        monkeypatch):
    import tngp_torch.models as models
    from tngp_torch.cli import main_dnerf, main_tensorf

    monkeypatch.setattr(models, "TensoRFNetwork", functools.partial(
        models.TensoRFNetwork, color_feat_dim=6, hidden_dim=16))
    for i, (argv, want) in enumerate(RENDER_FLAGS.values()):
        tr = main_dnerf.main(["synthetic", *argv, *DNERF_FLAGS, "--workspace",
                              str(tmp_path / f"d{i}"), "--iters", "4"])
        assert _cfg_has(tr.cfg, want) and tr.global_step == 4, tr.cfg
        assert np.isfinite(tr.stats["loss"]).all()
        tr = main_tensorf.main(["synthetic", *argv, *FLAGS[:14], "--density_thresh", "1.0",
                                "--workspace", str(tmp_path / f"t{i}"), "--resolution0", "16",
                                "--iters", "4"])
        assert _cfg_has(tr.cfg, want) and tr.global_step == 4, tr.cfg
        assert np.isfinite(tr.stats["loss"]).all()
