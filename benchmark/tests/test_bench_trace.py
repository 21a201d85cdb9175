"""The reduction of a profiled span, on synthetic events: the union of
overlapping device intervals, device time by launch, the idle gaps by the
innermost host operation, and the breakdown's form."""

from benchmark import trace
from benchmark.trace import Event


def _events(us=1000):
    """A span of 1 ms; times in ns, built from microseconds."""
    return [
        Event(trace.SPAN, False, 0, 1000 * us, 0),
        Event("step", False, 10 * us, 900 * us, 0),
        Event("aten::mm", False, 20 * us, 100 * us, 0),
        Event("cudaLaunchKernel", False, 30 * us, 5 * us, 7),
        Event("bench.optimizer_step", False, 400 * us, 200 * us, 0),
        Event("cudaLaunchKernel", False, 410 * us, 5 * us, 8),
        Event("aten::add", False, 700 * us, 150 * us, 0),
        Event("gemm", True, 100 * us, 200 * us, 7),  # 100-300
        Event("copy", True, 250 * us, 100 * us, 0),  # 250-350, overlaps gemm
        Event("adam", True, 500 * us, 50 * us, 8),  # 500-550
        Event("late", True, 1500 * us, 10 * us, 0),  # outside the span
    ]


def test_union_counts_overlaps_once():
    busy, merged = trace.union_ns([(100, 300), (250, 350), (500, 550), (520, 530)])
    assert busy == 300 and merged == [[100, 350], [500, 550]]


def test_reduce_span():
    red = trace.reduce_span(_events())
    assert red["window_s"] == 1e-3 and red["busy_s"] == 300e-6
    assert red["device_ops"] == 3
    assert red["kernel_s"] == {"gemm": 200e-6, "copy": 100e-6, "adam": 50e-6}
    ops = red["breakdown"]["device_ops"]
    assert [n for n, _ in ops] == ["gemm", "copy", "adam"]
    gaps = dict(red["breakdown"]["idle_gaps"])
    # 0-100 us under aten::mm (the innermost at 50), 350-500 under the optimizer's
    # range, 550-1000 under aten::add (at 775)
    assert gaps == {"aten::mm": 100e-6, "bench.optimizer_step": 150e-6, "aten::add": 450e-6}
    assert len(red["breakdown"]["idle_gaps"]) <= trace.TOP


def test_device_time_of_a_span_follows_its_launches():
    s, n = trace.span_device_s(_events(), "bench.optimizer_step")
    assert n == 1 and s == 50e-6


def test_kernel_seconds_by_name():
    assert trace.kernel_seconds({"void window_fwd_kernel<2>": 1.0, "other": 2.0},
                                "window_fwd_kernel") == 1.0
