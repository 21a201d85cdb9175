"""The comparison that decides `correct` catches a broken timed path: each
fault a cell can have, planted underneath a tiny run on the CPU, and the
control (the plain reference one precision down in the program's place)
read against the cell's limits."""

import pytest

from benchmark.tests.tiny_cells import CELLS, driver, program, run_tiny

# each fault a cell can have, as its mix's driver module gives them (`faults`)
CASES = [(cell, f) for cell in CELLS for f in driver(cell).faults(program(cell))]


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
