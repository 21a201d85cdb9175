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

`by_name` puts both into the record of a traced run (`record["spans"]`): for
every program span, a step or a frame, its device ms, own device ms, idle ms
and device operations from the profiled span, and its host ms and count
from the aggregate.  The per-layer readers (`benchmark/metrics/`) read it by
span name (`value`).
"""

from __future__ import annotations

import bisect

from . import trace

PREFIX = "tngp."
OUTSIDE = "(outside program spans)"
SCAN = 4000  # ranges looked back at for the one that holds a point


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
    and `own` (device seconds by span name, module docstring), `ops` (the
    device operations counted in `by_span`, by span name), `ranges`
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
    by_span, ops = {}, {}
    for n in names:
        launched = trace.launched_in(sub, [(a, b) for a, b, m in ranges if m == n])
        by_span[n], ops[n] = sum(e.dur for e in launched) / 1e9, len(launched)
    starts = [r[0] for r in ranges]
    owner = {e.corr: innermost(ranges, starts, e.start) for e in sub if not e.device}
    own: dict = {}
    for e in work:
        n = owner.get(e.corr, OUTSIDE)
        own[n] = own.get(n, 0.0) + e.dur / 1e9
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
    return {
        "by_span": by_span, "ops": ops, "own": own, "idle": idle,
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


def by_name(red: dict, units: int, host: dict, unit: str) -> dict:
    """`record["spans"]`: for every program span of `red` (`reduce`) or
    `host` (`host_window`), a step or a frame: `device_ms`, `own_ms`,
    `idle_ms` and `device_ops` over the profiled span's `units`, where the
    span ran in it; `host_ms` and `count` over the aggregate's count of
    `unit` (the step's or the frame's span), where it ran outside it."""
    n_host = host.get(unit, (0, 0))[0]
    ran = red.get("ranges", {}) if units else {}
    out = {}
    for n in sorted(set(ran) | set(host)):
        e = out[n] = {}
        if n in ran:
            e.update(device_ms=1e3 * red["by_span"][n] / units,
                     own_ms=1e3 * red["own"].get(n, 0.0) / units,
                     idle_ms=1e3 * red["idle"].get(n, 0.0) / units,
                     device_ops=red["ops"][n] / units)
        if n_host and n in host:
            c, ns = host[n]
            e.update(host_ms=ns / 1e6 / n_host, count=c / n_host)
    return out


def value(rec: dict, kind: str, name: str, key: str):
    """`rec["spans"][name][key]` of a record of `kind` ("train" or "eval"),
    None where the run read nothing there: no such span, or no device time
    (a device reading of a run without a device trace)."""
    if rec.get("kind") != kind:
        return None
    v = rec.get("spans", {}).get(name, {}).get(key)
    return v if v else None
