"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds, for the
benchmark's own tests: a few views of the hard scene at 24x24, narrow
fields and short marches.  The program runs its plain versions there.

Each configuration's program module (`benchmark/models/<arch>.py`) gives
its cut as `tiny(cfg)`, and each mix's driver module
(`benchmark/drivers/<driver>.py`) its own as `tiny(traffic, limits)`."""

from __future__ import annotations

import copy
import hashlib
import importlib
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


def driver(cell: str):
    """The driver module of the cell's traffic mix."""
    tf = harness.cell_spec(cell)["traffic"]
    return importlib.import_module(f"benchmark.drivers.{tf['driver']}")


def program(cell: str):
    """The program module of the cell's configuration."""
    arch = harness.cell_spec(cell)["cfg"]["arch"]
    return importlib.import_module(f"benchmark.models.{arch}")


def tiny_cut(module, *args) -> None:
    """`module.tiny(*args)`, refused where the module gives no tiny cut:
    a configuration of a new arch, or a mix of a new driver, brings its own."""
    cut = getattr(module, "tiny", None)
    if not callable(cut):
        raise LookupError(f"{module.__name__} gives no tiny cut (`tiny`)")
    cut(*args)


def tiny_spec(cell: str, tmp: Path) -> dict:
    """`harness.cell_spec(cell)` with its configuration and traffic cut down."""
    spec = copy.deepcopy(harness.cell_spec(cell))
    cfg, tf = spec["cfg"], spec["traffic"]
    scene = tmp / "scene.npz"
    cfg["scene"] = {"file": str(scene), "sha256": tiny_scene(scene), "n_val": 2}
    tiny_cut(program(cell), cfg)
    cfg["render"].update(grid_size=16, density_thresh=0.01)  # the ladder stays the cell's
    tiny_cut(driver(cell), tf, spec["limits"])
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
