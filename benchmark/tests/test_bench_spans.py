"""The program's spans in a profiled span, on synthetic events as
`test_bench_trace.py` builds them: device time by span through launches,
idle gaps by the innermost program span, host readings with the profiled
chunk left out; and a tiny run of each cell through `phases.py`."""

import pytest

from benchmark import phases, spans, trace
from benchmark.tests.tiny_cells import CELLS, run_tiny
from benchmark.trace import Event


def _events(us=1000):
    """One step of 1 ms in a profiled span: march, field and backward
    ranges, the backward's second launch made from another thread (by time
    inside the range), a scatter range inside the backward, and an idle
    stretch outside every program range; times in ns from microseconds."""
    return [
        Event(trace.SPAN, False, 0, 1000 * us, 0),
        Event("tngp.train.step", False, 10 * us, 800 * us, 0),
        Event("tngp.render.march", False, 20 * us, 80 * us, 0),
        Event("cudaLaunchKernel", False, 30 * us, 5 * us, 1),
        Event("tngp.render.field", False, 120 * us, 100 * us, 0),
        Event("cudaLaunchKernel", False, 130 * us, 5 * us, 2),
        Event("tngp.train.backward", False, 300 * us, 400 * us, 0),
        Event("cudaLaunchKernel", False, 310 * us, 5 * us, 3),
        Event("tngp.kernel.scatter_add_any", False, 500 * us, 100 * us, 0),
        Event("cuLaunchKernel", False, 510 * us, 5 * us, 4),
        Event("cudaLaunchKernel", False, 900 * us, 5 * us, 5),  # outside the program
        Event("march_kernel", True, 40 * us, 50 * us, 1),  # 40-90
        Event("mlp_kernel", True, 140 * us, 100 * us, 2),  # 140-240
        Event("bwd_kernel", True, 320 * us, 100 * us, 3),  # 320-420
        Event("scatter_kernel", True, 520 * us, 30 * us, 4),  # 520-550
        Event("tail_kernel", True, 910 * us, 10 * us, 5),  # 910-920
    ]


def test_device_time_by_span_follows_launches():
    red = spans.reduce(_events())
    by = red["by_span"]
    assert by["tngp.render.march"] == 50e-6 and by["tngp.render.field"] == 100e-6
    # the backward's launches and the scatter's inside it
    assert by["tngp.train.backward"] == 130e-6 and by["tngp.kernel.scatter_add_any"] == 30e-6
    assert by["tngp.train.step"] == 280e-6
    own = red["own"]
    assert own == {"tngp.render.march": 50e-6, "tngp.render.field": 100e-6,
                   "tngp.train.backward": 100e-6, "tngp.kernel.scatter_add_any": 30e-6,
                   spans.OUTSIDE: 10e-6}
    assert abs(sum(own.values()) - red["device_s"]) < 1e-12
    assert abs(red["covered"] - 280 / 290) < 1e-12
    assert red["ranges"]["tngp.train.step"] == 1


def test_idle_gaps_go_to_the_innermost_program_span():
    red = spans.reduce(_events())
    # 0-40 us (mid 20: the march, started at 20), 90-140 (mid 115: the step
    # alone), 240-320 (mid 280: the step), 420-520 (mid 470: the backward),
    # 550-910 (mid 730: the step, to 810), 920-1000 (mid 960: none)
    idle = red["idle"]
    assert idle == pytest.approx({"tngp.render.march": 40e-6, "tngp.train.step": 490e-6,
                                  "tngp.train.backward": 100e-6, spans.OUTSIDE: 80e-6})
    assert abs(red["idle_covered"] - 630 / 710) < 1e-12
    top = spans.idle_by_span(red)
    assert top[0] == ["tngp.train.step", pytest.approx(490e-6)] and len(top) <= trace.TOP
    assert all(isinstance(n, str) and isinstance(s, float) for n, s in top)
    assert spans.reduce([e for e in _events() if not e.name.startswith("tngp.")]) == {}


def test_host_readings_leave_out_the_profiled_chunk():
    totals = {"tngp.train.step": (48, 48 * 45_000_000), "tngp.train.sample": (48, 4_800_000)}
    profiled = {"tngp.train.step": (16, 16 * 90_000_000), "tngp.train.sample": (16, 1_600_000)}
    host = spans.host_window(totals, profiled)
    assert host == {"tngp.train.step": (32, 32 * 22_500_000),
                    "tngp.train.sample": (32, 3_200_000)}
    got = spans.readings("train", spans.reduce(_events()), 1, host)
    assert got["dispatch_ms_per_step.train"] == 22.5
    assert got["backward_ms_per_step.train"] == pytest.approx(0.13)
    frames = {"tngp.frame": (10, 10 * 330_000_000), "tngp.frame.read": (90, 10 * 60_000_000),
              "tngp.frame.to_host": (10, 10 * 5_000_000)}
    got = spans.readings("eval", {}, 0, spans.host_window(frames, {"tngp.frame": (0, 0)}))
    assert got == {"read_wait_ms_per_frame.eval": 65.0, "dispatch_ms_per_frame.eval": 265.0}
    assert spans.readings("eval", {}, 0, {}) == {}


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_through_phases_reads_the_spans(cell, tmp_path):
    """A traced tiny run with the hooks installed: every reading of the
    cell's kind is there (device readings 0 on the CPU), the idle list is in
    the breakdown, and the hooks are gone afterwards."""
    from benchmark import harness, util

    real = harness.result_line, util.profiled
    with phases.installed(True):
        out, line = run_tiny(cell, tmp_path, trace=True)
    assert (harness.result_line, util.profiled) == real
    kind = out.record["kind"]
    want = set(spans.DEVICE[kind]) | ({"dispatch_ms_per_step.train"} if kind == "train" else
                                      {"read_wait_ms_per_frame.eval",
                                       "dispatch_ms_per_frame.eval"})
    assert want <= set(line["metrics"]) and line["correct"]
    assert list(line)[-1] == "checks" and line["breakdown"]["idle_by_span"]
    assert line["spans"]["device_copies"] == 0
