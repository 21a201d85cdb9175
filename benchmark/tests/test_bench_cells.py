"""Each cell of BENCHMARK.json, cut to a tiny size, runs end to end on the
CPU through the port's plain versions, and the plain reference agrees with
it: every number compared is inside its limit, and the integer ones are
exact."""

import pytest

from benchmark import harness
from benchmark.tests.tiny_cells import BENCH, CELLS, run_tiny


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_is_correct(cell, tmp_path):
    out, line = run_tiny(cell, tmp_path)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    for name, c in line["checks"].items():
        if name.endswith("_off"):
            assert c["value"] == 0, name
    assert list(line)[-1] == "checks"
    e2e, _ = harness.cell_metrics(BENCH, cell)
    assert {m["name"] for m in e2e} <= set(out.e2e) | {"frame_ms_p90"}
    assert all(v > 0 for v in out.e2e.values())


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_traced_reads_counters(cell, tmp_path):
    """A traced run on the CPU has no device trace: the readers of device
    numbers return nothing, those of program counters and the host clock
    read."""
    out, line = run_tiny(cell, tmp_path, trace=True)
    assert line["correct"], line["checks"]
    _, per = harness.cell_metrics(BENCH, cell)
    for m in per:
        v = harness.metric_reader(m["name"])(out.record)
        if m["source"] == "device_trace":
            assert v is None, m["name"]
        else:
            assert v is not None and v > 0, m["name"]
    assert line["device"]["window_s"] > 0 and line["device"]["busy_s"] == 0
