"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds, for the
benchmark's own tests: a few views of the hard scene at 24x24, narrow
fields and short marches.  The program runs its plain versions there."""

from __future__ import annotations

import copy
import hashlib
from pathlib import Path

import numpy as np
import torch

from benchmark import harness

SCENE = harness.ROOT / ".cache" / "hard_256.npz"


def tiny_scene(path: Path, n: int = 8, res: int = 24) -> str:
    """Write n views of the hard scene at res x res to `path`; returns its sha256."""
    with np.load(SCENE) as z:
        step = 256 // res
        np.savez(path, poses=z["poses"][:n], intrinsics=z["intrinsics"] * np.float32(res / 256),
                 images=z["images"][:n, ::step, ::step, :3].astype(np.float32))
    return hashlib.sha256(path.read_bytes()).hexdigest()


BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = sorted(w["name"] for w in BENCH["workloads"])


def tiny_spec(cell: str, tmp: Path) -> dict:
    """`harness.cell_spec(cell)` with its configuration and traffic cut down."""
    spec = copy.deepcopy(harness.cell_spec(cell))
    cfg, tf = spec["cfg"], spec["traffic"]
    scene = tmp / "scene.npz"
    cfg["scene"] = {"file": str(scene), "sha256": tiny_scene(scene), "n_val": 2}
    if cfg["arch"] == "ngp":
        cfg.update(num_levels=4, log2_hashmap_size=14, hidden_dim=16, hidden_dim_color=16)
    else:
        cfg.update(resolution0=16, resolution1=24, sigma_rank=[4, 4, 4], color_rank=[8, 8, 8],
                   color_feat_dim=6, hidden_dim=16, upsample_model_steps=[4, 6])
    cfg["render"].update(grid_size=16, density_thresh=0.01)  # the ladder stays the cell's
    if tf["driver"] == "train_loop":
        tf.update(num_rays=128, warmup_steps=8, chunk_steps=16, profile_steps=16)
    else:
        tf.update(setup_num_rays=256, setup_steps=200, width=20, height=16, chunk=128,
                  warmup_frames=1, profile_frames=1)
        # 200 steps of a narrow field on six 24x24 views read ~17 dB on a
        # held-out view, where the cell's field reads ~37 dB
        spec["limits"]["val_mse"] = 0.05
    return spec


def run_tiny(cell: str, tmp: Path, seed: int = 2**31 + 12345, trace: bool = False,
             faults=(), control: bool = False):
    """(Outcome, result line) of one tiny run of a cell on the CPU."""
    torch.set_num_threads(2)
    spec = tiny_spec(cell, tmp)
    out = harness.run_cell(spec, seed, 1.0, trace, torch.device("cpu"), 0.0, faults,
                           control=control)
    line = harness.result_line(spec, out, trace, {"platform": "cpu", "kind": "cpu", "count": 1})
    return out, line
