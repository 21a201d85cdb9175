"""The profiler's trace of a run's profiled span, reduced in memory: device
operations, the union of their busy intervals, device time by kernel name,
device time of the operations launched inside the benchmark's own
`record_function` spans, and the breakdown of the result line.

Events are read from the profiler's kineto results as plain tuples
(building its `FunctionEvent` tree takes a minute for a few hundred
thousand events).  A device event is a kernel, copy or set; the ranges
that the profiler also lays on the device's timeline (user annotations)
are not work."""

from __future__ import annotations

import bisect
from dataclasses import dataclass

SPAN = "bench.span"  # the record_function around the whole profiled span
TOP = 10  # entries of each breakdown list
MIN_GAP_NS = 2000  # idle gaps shorter than this are not labelled


@dataclass(frozen=True)
class Event:
    name: str
    device: bool
    start: int  # ns
    dur: int  # ns
    corr: int  # correlation id: a launch and the device work it made share it


def read_events(prof) -> list:
    """The profiler's events as `Event`s, user annotations left out."""
    import torch

    cuda_t = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda_t and getattr(e, "is_user_annotation", lambda: False)():
            continue
        out.append(Event(e.name(), e.device_type() == cuda_t, e.start_ns(), e.duration_ns(),
                         e.correlation_id()))
    return out


def host_spans(events, name: str) -> list:
    """(start, end) of each host range called `name`."""
    return sorted((e.start, e.start + e.dur) for e in events if not e.device and e.name == name)


def _annotation(name: str) -> bool:
    return name.startswith(("bench.", "Optimizer.", "ProfilerStep"))


def device_work(events, lo: int, hi: int) -> list:
    """Device operations that start in [lo, hi) and took time."""
    return [e for e in events
            if e.device and e.dur > 0 and lo <= e.start < hi and not _annotation(e.name)]


def union_ns(intervals) -> tuple:
    """(busy ns of the union of `intervals` (start, end), merged intervals)."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def launched_in(events, spans) -> list:
    """Device operations launched by host calls inside `spans` (the launch's
    correlation id is the device operation's)."""
    starts = [a for a, _ in spans]
    corrs = set()
    for e in events:
        if e.device or e.corr == 0 or not e.name.startswith("cu"):
            continue
        i = bisect.bisect_right(starts, e.start) - 1
        if i >= 0 and e.start < spans[i][1]:
            corrs.add(e.corr)
    return [e for e in events if e.device and e.corr in corrs and not _annotation(e.name)]


def label_gaps(events, gaps) -> list:
    """(host operation running at each gap's midpoint, the innermost one,
    gap seconds) for each gap (start, end)."""
    host = sorted((e for e in events if not e.device), key=lambda e: e.start)
    starts = [e.start for e in host]
    out = []
    for a, b in gaps:
        mid = (a + b) // 2
        name = "(no host operation)"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - 4000), -1):
            if host[j].start + host[j].dur >= mid:
                name = host[j].name
                break
        out.append((name, (b - a) / 1e9))
    return out


def reduce_span(events) -> dict:
    """The profiled span's numbers: window_s (the span's wall), busy_s (the
    union of device work in it), device_ops (their count), kernel_s (device
    seconds by operation name) and breakdown (the longest device operations
    and the longest idle gaps by host operation, TOP each)."""
    spans = host_spans(events, SPAN)
    if not spans:
        return {}
    lo, hi = spans[0][0], spans[-1][1]
    work = device_work(events, lo, hi)
    busy, merged = union_ns((e.start, min(e.start + e.dur, hi)) for e in work)
    kernel_s: dict = {}
    for e in work:
        kernel_s[e.name] = kernel_s.get(e.name, 0.0) + e.dur / 1e9
    gaps = []
    prev = lo
    for a, b in merged:
        if a - prev >= MIN_GAP_NS:
            gaps.append((prev, a))
        prev = max(prev, b)
    if hi - prev >= MIN_GAP_NS:
        gaps.append((prev, hi))
    by_host: dict = {}
    for name, s in label_gaps(events, gaps):
        by_host[name] = by_host.get(name, 0.0) + s
    top_ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
    top_gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (hi - lo) / 1e9,
        "busy_s": busy / 1e9,
        "device_ops": len(work),
        "kernel_s": kernel_s,
        "breakdown": {"device_ops": [[n[:160], s] for n, s in top_ops],
                      "idle_gaps": [[n[:160], s] for n, s in top_gaps]},
    }


def span_device_s(events, name: str) -> tuple:
    """(device seconds of the operations launched inside the host ranges
    called `name`, number of such ranges)."""
    spans = host_spans(events, name)
    return sum(e.dur for e in launched_in(events, spans)) / 1e9, len(spans)


def kernel_seconds(kernel_s: dict, needle: str) -> float:
    """Device seconds of the operations whose name contains `needle`."""
    return sum(s for n, s in kernel_s.items() if needle in n)
