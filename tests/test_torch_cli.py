"""The port's NGP entry point end to end on the CPU: `python -m
tngp_torch.cli.main_nerf synthetic` in a subprocess with
`TNGP_PLATFORM=cpu` and tests/test_cli.py:41-46's flags, a second run that
resumes from its checkpoint, and the options the port has not ported,
which raise."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FLAGS = ["--num_rays", "128", "--max_steps", "48", "--sample_budget", "16", "--bound", "1.0",
         "--dt_gamma", "0", "--min_near", "0.05", "--eval_interval", "100",
         "--skip_test_render", "--mesh_resolution", "24", "--workspace", "ws"]


def run_cli(args, cwd):
    env = dict(os.environ, TNGP_PLATFORM="cpu", TNGP_SYNTH="4,32,32", OMP_NUM_THREADS="2",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", "tngp_torch.cli.main_nerf", *args],
                          capture_output=True, text=True, timeout=600, cwd=str(cwd), env=env)


def test_main_nerf_synthetic_trains_checkpoints_and_resumes(tmp_path):
    """8 iterations (2 epochs of the 4 frames): rc 0, a checkpoint per
    epoch, an `[eval` line, a `[save_mesh]` line and validation PNGs; then
    `--ckpt latest` with 12 iterations loads epoch 2 at step 8 and trains
    epoch 3 from there."""
    r = run_cli(["synthetic", "--iters", "8", *FLAGS], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "[epoch 2]" in r.stdout and "[eval" in r.stdout and "[save_mesh]" in r.stdout
    ck = tmp_path / "ws" / "checkpoints"
    assert sorted(p.name for p in ck.glob("*.npz")) == ["ngp_ep0001.npz", "ngp_ep0002.npz"]
    assert len(list((tmp_path / "ws" / "validation").glob("*.png"))) == 4
    assert (tmp_path / "ws" / "log_ngp.txt").read_text().count("[epoch") == 2

    r2 = run_cli(["synthetic", "--iters", "12", "--ckpt", "latest", *FLAGS], tmp_path)
    assert r2.returncode == 0, r2.stderr[-3000:]
    assert "ngp_ep0002.npz (epoch 2, step 8)" in r2.stdout
    assert "[epoch 3]" in r2.stdout and "[epoch 1]" not in r2.stdout
    assert sorted(p.name for p in ck.glob("*.npz")) == ["ngp_ep0002.npz", "ngp_ep0003.npz"]


@pytest.mark.parametrize("flag", [["--gui"], ["--no_grid"], ["--error_map"],
                                  ["--rand_pose", "4", "--clip_text", "a chair"],
                                  ["--encoding", "hashgrid"], ["--bg_radius", "2"],
                                  ["--profile", "prof"]])
def test_unported_options_raise(monkeypatch, flag):
    """Each raises before anything is built, naming its ROADMAP item."""
    from tngp_torch.cli import main_nerf

    monkeypatch.setenv("TNGP_PLATFORM", "cpu")
    with pytest.raises(NotImplementedError, match="not ported to tngp_torch yet .*ROADMAP"):
        main_nerf.main(["synthetic", *flag])
