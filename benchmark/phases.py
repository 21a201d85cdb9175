"""Run one cell of BENCHMARK.json as `run.py` does, with the program's spans
read (`benchmark/spans.py`):

    python3 benchmark/phases.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
        [--spans 0|1]
    python3 benchmark/phases.py --site-cost

With `--spans 1` (the default under `--trace 1`) the program's aggregate of
host time by span (`tngp_torch.utils.profiling.enable_spans`) is on from the
window's start to its end, and the host readings leave out the profiled
chunk; with `--trace 1` the profiled span's events are reduced by program
span as well.  The result line is the harness's, with the cell's span
readings (`spans.readings`) added to `metrics` under `--trace 1`, the idle
time by program span added to `breakdown` as `idle_by_span`, and `spans`
(the readings, device and host ms by span a step or frame, coverage, the
device-side copies of program ranges in the events) before `checks`.  The
ten largest idle spans go to standard error.

The hooks are the drivers' own functions, wrapped from here: the window's
start (`hooks.reseed` in training, `frame_loop._break` in frames), the
profiled chunk (`util.profiled`) and the window's end (each driver's
`_reduce_trace`, which still reads the events).  `--site-cost` prints the
host ns of one span site with both sinks off and with the aggregate on.
"""

import time

T_START = time.time()  # set-up is timed from here, before any import

import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness, spans, util  # noqa: E402
from benchmark.drivers import frame_loop, train_loop  # noqa: E402
from benchmark.models import hooks  # noqa: E402

UNITS = {"march_ms_per_step.train": "ms", "field_ms_per_step.train": "ms",
         "composite_ms_per_step.train": "ms", "backward_ms_per_step.train": "ms",
         "dispatch_ms_per_step.train": "ms", "march_ms_per_frame.eval": "ms",
         "field_ms_per_frame.eval": "ms", "composite_ms_per_frame.eval": "ms",
         "read_wait_ms_per_frame.eval": "ms", "dispatch_ms_per_frame.eval": "ms"}
UNIT_SPAN = {"train": "tngp.train.step", "eval": "tngp.frame"}  # a step, a frame


@contextlib.contextmanager
def installed(aggregate: bool):
    """Inside: the drivers' hooks wrapped (module docstring); `aggregate`
    turns the program's aggregate on over the window."""
    from tngp_torch.utils import profiling as prof

    state: dict = {"profiled": {}}

    def window_start():
        if aggregate:
            prof.enable_spans(True)
            prof.reset_spans()

    real_reseed, real_break = hooks.reseed, frame_loop._break

    def reseed(*a, **k):
        real_reseed(*a, **k)
        window_start()

    def brk(*a, **k):
        real_break(*a, **k)
        window_start()

    real_profiled = util.profiled

    @contextlib.contextmanager
    def profiled(device):
        before = prof.span_totals()
        with real_profiled(device) as out:
            yield out
        state["profiled"] = spans.host_window(prof.span_totals(), before)

    def window_end(real, kind, units_key):
        def reduce_trace(record, *a):
            host = spans.host_window(prof.span_totals(), state["profiled"])
            prof.enable_spans(False)
            events = record.get("span_events") or []
            red = spans.reduce(events)
            n = record.get(units_key, 0)
            red_out = real(record, *a)
            unit = host.get(UNIT_SPAN[kind], (0, 0))[0]
            got = {"readings": spans.readings(kind, red, n, host),
                   "host_ms": {k: ns / 1e6 / unit for k, (c, ns) in host.items()} if unit
                   else {},
                   "host_counts": {k: c for k, (c, ns) in host.items()},
                   "device_copies": sum(e.device and e.name.startswith(spans.PREFIX)
                                        for e in events),
                   # the benchmark's own ranges around the same work, device s
                   "bench_s": {k: record[k] for k in ("grid_update_s", "optimizer_s",
                                                      "scatter_any") if k in record}}
            if red:
                got.update(device_ms={k: 1e3 * s / n for k, s in red["by_span"].items()},
                           own_ms={k: 1e3 * s / n for k, s in red["own"].items()},
                           idle_ms={k: 1e3 * s / n for k, s in red["idle"].items()},
                           own_kernels=[[sp, k, 1e3 * s / n] for sp, k, s in red["own_kernels"]],
                           ranges=red["ranges"], covered=red["covered"],
                           idle_covered=red["idle_covered"],
                           device_ms_total=1e3 * red["device_s"] / n)
                idle = spans.idle_by_span(red)
                red_out.setdefault("breakdown", {})["idle_by_span"] = idle
                for name, s in idle:
                    util.note(f"idle {1e3 * s:10.3f} ms under {name}")
            record["phases"] = got
            util.note(f"spans: {json.dumps(got)}")
            return red_out
        return reduce_trace

    real_line = harness.result_line

    def result_line(spec, out, traced, info):
        line = real_line(spec, out, traced, info)
        got = out.record.get("phases", {})
        if traced:
            for k, v in got.get("readings", {}).items():
                line["metrics"][k] = {"value": float(v), "unit": UNITS[k]}
        checks = line.pop("checks")
        line["spans"] = got
        line["checks"] = checks
        return line

    saved = (hooks.reseed, frame_loop._break, util.profiled, train_loop._reduce_trace,
             frame_loop._reduce_trace)
    hooks.reseed, frame_loop._break, util.profiled = reseed, brk, profiled
    train_loop._reduce_trace = window_end(saved[3], "train", "span_steps")
    frame_loop._reduce_trace = window_end(saved[4], "eval", "span_frames")
    harness.result_line = result_line
    try:
        yield
    finally:
        (hooks.reseed, frame_loop._break, util.profiled, train_loop._reduce_trace,
         frame_loop._reduce_trace) = saved
        harness.result_line = real_line
        prof.enable_spans(False)


def site_cost(n: int = 1_000_000) -> dict:
    """Host ns of one `with span(...)` site, both sinks off and with the
    aggregate on, less an empty loop's ns a turn (best of three)."""
    from tngp_torch.utils.profiling import enable_spans, span

    def loop_empty():
        for _ in range(n):
            pass

    def loop_span():
        for _ in range(n):
            with span("tngp.cost"):
                pass

    def best(fn):
        out = []
        for _ in range(3):
            t = time.perf_counter_ns()
            fn()
            out.append(time.perf_counter_ns() - t)
        return min(out) / n

    base = best(loop_empty)
    off = best(loop_span) - base
    enable_spans(True)
    on = best(loop_span) - base
    enable_spans(False)
    return {"site_ns_off": off, "site_ns_aggregate": on, "turns": n}


def main(argv) -> int:
    if argv == ["--site-cost"]:
        print(json.dumps(site_cost()), flush=True)
        return 0
    agg = None
    if "--spans" in argv:
        i = argv.index("--spans")
        agg = bool(int(argv[i + 1]))
        argv = argv[:i] + argv[i + 2:]
    traced = "--trace" in argv and argv[argv.index("--trace") + 1] == "1"
    with installed(traced if agg is None else agg):
        return harness.main(argv, T_START)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
