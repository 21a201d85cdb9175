"""The program's spans (`tngp_torch.utils.profiling.span`, ranges named
`tngp.*`) in a run, reduced: device time by span, the idle gaps of the
profiled span put down to the innermost program span, and host time by span
from the program's own aggregate over the window's unprofiled steps or
frames.

Device time follows launches, as `trace.span_device_s` does: an operation
counts for a span when the host call that launched it started inside one of
the span's ranges (`trace.launched_in`), so that the backward's kernels,
launched from autograd's device thread, count for `tngp.train.backward`.
No span name nests inside itself, which `launched_in` needs.  `by_span`
counts a span's launches whatever spans it holds; `own` gives each launch to
its innermost span alone, a partition of the device time.

`readings` turns them into the per-layer numbers of the two cells:

| reading | from |
|---|---|
| `march_ms_per_step.train`, `field_ms_per_step.train`, `composite_ms_per_step.train`, `backward_ms_per_step.train` | device ms of `tngp.render.march` / `.field` / `.composite`, `tngp.train.backward` a profiled step |
| `dispatch_ms_per_step.train` | host ms of `tngp.train.step` a step, aggregate |
| `march_ms_per_frame.eval`, `field_ms_per_frame.eval`, `composite_ms_per_frame.eval` | device ms of the same render spans a profiled frame |
| `read_wait_ms_per_frame.eval` | host ms of `tngp.frame.read` and `tngp.frame.to_host` a frame, aggregate |
| `dispatch_ms_per_frame.eval` | host ms of `tngp.frame` less those waits a frame, aggregate |
"""

from __future__ import annotations

import bisect

from . import trace

PREFIX = "tngp."
OUTSIDE = "(outside program spans)"
SCAN = 4000  # ranges looked back at for the one that holds a point
TOP_KERNELS = 40  # entries of `own_kernels`

DEVICE = {
    "train": {"march_ms_per_step.train": "tngp.render.march",
              "field_ms_per_step.train": "tngp.render.field",
              "composite_ms_per_step.train": "tngp.render.composite",
              "backward_ms_per_step.train": "tngp.train.backward"},
    "eval": {"march_ms_per_frame.eval": "tngp.render.march",
             "field_ms_per_frame.eval": "tngp.render.field",
             "composite_ms_per_frame.eval": "tngp.render.composite"},
}
WAITS = ("tngp.frame.read", "tngp.frame.to_host")


def program_ranges(events) -> list:
    """(start, end, name) of every host range of the program, by start."""
    return sorted((e.start, e.start + e.dur, e.name) for e in events
                  if not e.device and e.name.startswith(PREFIX))


def innermost(ranges, starts, t: int) -> str:
    """The name of the innermost range of `ranges` (`program_ranges`, its
    `starts`) that holds time `t`, or OUTSIDE: of the ranges that hold it,
    the one that started last."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - SCAN), -1):
        if ranges[j][1] >= t:
            return ranges[j][2]
    return OUTSIDE


def _is_launch(e) -> bool:
    """A host call that launched device work (`trace.launched_in`'s)."""
    return not e.device and e.corr != 0 and e.name.startswith("cu")


def reduce(events) -> dict:
    """The program's spans in the profiled span (`trace.SPAN`): `by_span`
    and `own` (device seconds by span name, module docstring), `own_kernels`
    (the largest [span, operation, seconds] of `own` by operation), `ranges`
    (ranges by name), `idle` (idle seconds by the innermost span at each
    gap's midpoint, OUTSIDE where none holds it), `device_s` (device seconds
    of the span's work), `covered` (the share of it launched inside some
    program span) and `idle_covered` (the share of the idle time inside
    one); {} where the events hold no profiled span or no program span."""
    spans = trace.host_spans(events, trace.SPAN)
    ranges = program_ranges(events)
    if not spans or not ranges:
        return {}
    lo, hi = spans[0][0], spans[-1][1]
    work = trace.device_work(events, lo, hi)
    device_s = sum(e.dur for e in work) / 1e9
    names = sorted({r[2] for r in ranges})
    sub = [e for e in events if e.device or _is_launch(e)]  # what launched_in reads
    by_span = {n: sum(e.dur for e in trace.launched_in(sub, [(a, b) for a, b, m in ranges
                                                             if m == n])) / 1e9
               for n in names}
    starts = [r[0] for r in ranges]
    owner = {e.corr: innermost(ranges, starts, e.start) for e in sub if not e.device}
    own: dict = {}
    kernels: dict = {}
    for e in work:
        n = owner.get(e.corr, OUTSIDE)
        own[n] = own.get(n, 0.0) + e.dur / 1e9
        kernels[n, e.name] = kernels.get((n, e.name), 0.0) + e.dur / 1e9
    _, merged = trace.union_ns((e.start, min(e.start + e.dur, hi)) for e in work)
    gaps, prev = [], lo
    for a, b in merged:  # the gaps of `trace.reduce_span`
        if a - prev >= trace.MIN_GAP_NS:
            gaps.append((prev, a))
        prev = max(prev, b)
    if hi - prev >= trace.MIN_GAP_NS:
        gaps.append((prev, hi))
    idle: dict = {}
    for a, b in gaps:
        n = innermost(ranges, starts, (a + b) // 2)
        idle[n] = idle.get(n, 0.0) + (b - a) / 1e9
    idle_s = sum(idle.values())
    _, top = trace.union_ns((a, b) for a, b, _ in ranges)
    covered = trace.launched_in(sub, [tuple(r) for r in top])
    top_kernels = sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]
    return {
        "by_span": by_span, "own": own, "idle": idle,
        "own_kernels": [[n, k[:120], s] for (n, k), s in top_kernels],
        "ranges": {n: sum(r[2] == n for r in ranges) for n in names},
        "device_s": device_s,
        "covered": sum(e.dur for e in covered) / 1e9 / device_s if device_s else 0.0,
        "idle_covered": 1.0 - idle.get(OUTSIDE, 0.0) / idle_s if idle_s else 1.0,
    }


def idle_by_span(red: dict) -> list:
    """The breakdown's third list: [span, idle seconds], the largest
    `trace.TOP`, in the form of `trace.reduce_span`'s lists."""
    top = sorted(red.get("idle", {}).items(), key=lambda kv: -kv[1])[:trace.TOP]
    return [[n[:160], s] for n, s in top]


def host_window(totals: dict, profiled: dict) -> dict:
    """The aggregate's totals (`span_totals()`: name -> (count, ns)) over
    the window less those of its profiled chunk."""
    out = {}
    for n, (c, ns) in totals.items():
        pc, pns = profiled.get(n, (0, 0))
        if c - pc > 0:
            out[n] = (c - pc, ns - pns)
    return out


def readings(kind: str, red: dict, units: int, host: dict) -> dict:
    """The per-layer readings of a cell of `kind` ("train" or "eval"):
    device ms a step or frame from `red` (`reduce`) over the profiled span's
    `units`, host ms from `host` (`host_window`) over its own count of steps
    or frames; a reading that has nothing to read is left out."""
    out = {}
    if red and units:
        for metric, name in DEVICE[kind].items():
            if red["ranges"].get(name):
                out[metric] = 1e3 * red["by_span"][name] / units
    if kind == "train" and host.get("tngp.train.step"):
        c, ns = host["tngp.train.step"]
        out["dispatch_ms_per_step.train"] = ns / c / 1e6
    if kind == "eval" and host.get("tngp.frame"):
        c, ns = host["tngp.frame"]
        wait = sum(host.get(n, (0, 0))[1] for n in WAITS)
        out["read_wait_ms_per_frame.eval"] = wait / c / 1e6
        out["dispatch_ms_per_frame.eval"] = (ns - wait) / c / 1e6
    return out
