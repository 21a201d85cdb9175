"""The program's spans in a profiled span, on synthetic events as
`test_bench_trace.py` builds them: device time and operations by span
through launches, idle gaps by the innermost program span, host readings
with the profiled chunk left out and the record a traced run keeps
(`record["spans"]`); and a tiny traced run of each cell through its driver,
which reads the spans and leaves them off."""

import pytest

from benchmark import spans, trace
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


def test_device_operations_by_span_follow_launches():
    ops = spans.reduce(_events())["ops"]
    # the step holds four launches; the one outside every program range counts for none
    assert ops == {"tngp.train.step": 4, "tngp.render.march": 1, "tngp.render.field": 1,
                   "tngp.train.backward": 2, "tngp.kernel.scatter_add_any": 1}


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


def test_host_totals_leave_out_the_profiled_chunk():
    totals = {"tngp.train.step": (48, 48 * 45_000_000), "tngp.train.sample": (48, 4_800_000)}
    profiled = {"tngp.train.step": (16, 16 * 90_000_000), "tngp.train.sample": (16, 1_600_000)}
    assert spans.host_window(totals, profiled) == {"tngp.train.step": (32, 32 * 22_500_000),
                                                   "tngp.train.sample": (32, 3_200_000)}
    assert spans.host_window({"tngp.frame": (4, 8)}, {"tngp.frame": (4, 8)}) == {}


def test_record_by_span_name():
    """Device numbers over the profiled span's steps, host numbers over the
    unprofiled steps' count of the step's span; a span seen by one side
    only has that side's numbers."""
    host = {"tngp.train.step": (32, 32 * 22_500_000), "tngp.train.sample": (32, 3_200_000),
            "tngp.train.tier_read": (2, 400_000)}
    got = spans.by_name(spans.reduce(_events()), 2, host, "tngp.train.step")
    assert got["tngp.train.backward"] == pytest.approx(
        {"device_ms": 0.065, "own_ms": 0.05, "idle_ms": 0.05, "device_ops": 1.0})
    assert got["tngp.train.step"] == pytest.approx(
        {"device_ms": 0.14, "own_ms": 0.0, "idle_ms": 0.245, "device_ops": 2.0,
         "host_ms": 22.5, "count": 1.0})
    assert got["tngp.train.tier_read"] == pytest.approx({"host_ms": 0.0125, "count": 1 / 16})
    assert spans.by_name({}, 0, {}, "tngp.frame") == {}
    rec = {"kind": "train", "spans": got}
    assert spans.value(rec, "train", "tngp.train.step", "host_ms") == 22.5
    assert spans.value(rec, "eval", "tngp.train.step", "host_ms") is None
    assert spans.value(rec, "train", "tngp.frame", "host_ms") is None
    # a device reading of zero is a run without a device trace: nothing read
    rec["spans"]["tngp.render.march"]["device_ms"] = 0.0
    assert spans.value(rec, "train", "tngp.render.march", "device_ms") is None


def test_span_readers_on_a_record():
    """The span readers' arithmetic: device ms of a span a step or frame,
    the step's host ms, a frame's waits (reads and the image's copy) and the
    rest of its host ms."""
    from benchmark import harness

    train = {"kind": "train", "spans": {
        "tngp.render.march": {"device_ms": 0.5}, "tngp.render.field": {"device_ms": 10.0},
        "tngp.render.composite": {"device_ms": 1.5}, "tngp.train.backward": {"device_ms": 11.0},
        "tngp.train.step": {"device_ms": 26.0, "host_ms": 40.0, "count": 1.0}}}
    want = {"march_ms_per_step.train": 0.5, "field_ms_per_step.train": 10.0,
            "composite_ms_per_step.train": 1.5, "backward_ms_per_step.train": 11.0,
            "dispatch_ms_per_step.train": 40.0}
    for name, v in want.items():
        assert harness.metric_reader(name)(train) == v, name
        assert harness.metric_reader(name)({"kind": "eval", "spans": train["spans"]}) is None
    frame = {"kind": "eval", "spans": {
        "tngp.render.march": {"device_ms": 3.0}, "tngp.render.field": {"device_ms": 20.0},
        "tngp.render.composite": {"device_ms": 40.0},
        "tngp.frame": {"host_ms": 110.0, "count": 1.0},
        "tngp.frame.read": {"host_ms": 33.0, "count": 9.5},
        "tngp.frame.to_host": {"host_ms": 10.5, "count": 1.0}}}
    want = {"march_ms_per_frame.eval": 3.0, "field_ms_per_frame.eval": 20.0,
            "composite_ms_per_frame.eval": 40.0, "read_wait_ms_per_frame.eval": 43.5,
            "dispatch_ms_per_frame.eval": 66.5}
    for name, v in want.items():
        assert harness.metric_reader(name)(frame) == pytest.approx(v), name
        assert harness.metric_reader(name)({"kind": "eval"}) is None


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_traced_run_records_the_spans(cell, tmp_path):
    """A traced tiny run through the cell's driver: `record["spans"]` holds
    the step's or frame's span with its host ms and a count of one, every
    span the run met with host numbers; afterwards the aggregate is off and
    the kernel entries the run captured are the program's again."""
    from tngp_torch.kernels import scatter
    from tngp_torch.kernels import window_encoder as kw
    from tngp_torch.ops import grid_sample
    from tngp_torch.utils import profiling

    entries = (kw.window_encode_fwd, kw.window_encode_bwd, scatter._launch_any,
               grid_sample.scatter_add)
    out, line = run_tiny(cell, tmp_path, trace=True)
    assert line["correct"], line["checks"]
    rec = out.record["spans"]
    unit = {"train": "tngp.train.step", "eval": "tngp.frame"}[out.record["kind"]]
    assert rec[unit]["count"] == 1.0 and rec[unit]["host_ms"] > 0
    assert all(n.startswith(spans.PREFIX) for n in rec)
    assert all(e.get("host_ms", 1.0) > 0 for e in rec.values())
    assert "tngp.render.march" in rec and "tngp.render.field" in rec
    assert profiling.span_totals() == {}
    assert (kw.window_encode_fwd, kw.window_encode_bwd, scatter._launch_any,
            grid_sample.scatter_add) == entries
