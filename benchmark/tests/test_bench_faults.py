"""The comparison that decides `correct` catches a broken timed path: each
fault a cell can have, planted underneath a tiny run on the CPU, and the
control (the plain reference one precision down in the program's place)
read against the cell's limits."""

import pytest

from benchmark import harness
from benchmark.tests.tiny_cells import BENCH, CELLS, run_tiny

# each fault a cell can have: in a training cell's steps; in the eval
# cell's frames, and in the training that its set-up runs
FAULTS = {"train_loop": ["frozen_state", "half_batch", "altered_answer"],
          "frame_loop": ["frozen_state", "half_batch", "altered_answer"]}
TRAFFIC = {w["name"]: w["traffic"] for w in BENCH["workloads"]}
CASES = [(cell, f) for cell in CELLS
         for f in FAULTS[harness.load_json(harness.BENCH_DIR / "traffic"
                                           / f"{TRAFFIC[cell]}.json")["driver"]]]


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f}" for c, f in CASES])
def test_fault_is_not_correct(cell, fault, tmp_path):
    _, line = run_tiny(cell, tmp_path, faults=[fault])
    assert not line["correct"], (fault, line["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell, tmp_path):
    out, line = run_tiny(cell, tmp_path, control=True)
    assert line["correct"], line["checks"]
    failed = [n for n, c in line["checks"].items()
              if n in out.record["control"] and out.record["control"][n] > c["limit"]]
    assert failed, (out.record["control"], line["checks"])
