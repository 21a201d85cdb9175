"""Each cell of BENCHMARK.json, cut to a tiny size, runs end to end on the
CPU through the port's plain versions, and the plain reference agrees with
it: every number compared is inside its limit, and the integer ones are
exact.  A traced run reads every per-layer metric the cell lists (on a
device trace made up from the CPU's), an untraced one hooks nothing, and
every configuration's arch and every mix's driver give their own tiny cut."""

import copy
import importlib
import re
import types

import pytest

from benchmark import harness, trace, util
from benchmark.tests import tiny_cells
from benchmark.tests.tiny_cells import BENCH, CELLS, run_tiny
from benchmark.trace import Event


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


# host ranges that stand in for kernels the CPU has not (the plain versions
# run inside them), named as the kernels' device operations are
STANDINS = {"window_encode_fwd": "window_fwd_kernel", "window_encode_bwd": "window_bwd_kernel"}


def _fake_device(read_events):
    """`trace.read_events` with a device trace made up from the CPU's
    events: each operator (`aten::*`) and kernel stand-in launches one
    device operation of its name over its own interval."""
    def read(prof):
        events = read_events(prof)
        out, corr = list(events), 1 << 40
        for e in events:
            if e.device or not (e.name.startswith("aten::") or e.name in STANDINS.values()):
                continue
            corr += 1
            out += [Event("cudaLaunchKernel", False, e.start, 1, corr),
                    Event(e.name, True, e.start + 1, max(e.dur - 1, 1), corr)]
        return out
    return read


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_traced_run_reads_every_listed_metric(cell, tmp_path, monkeypatch):
    """On a made-up device trace, a traced tiny run reads each per-layer
    metric that the cell lists: none is left out of the result line."""
    from torch.autograd.profiler import record_function
    from tngp_torch.kernels import window_encoder as kw

    for fn, kernel in STANDINS.items():
        real = getattr(kw, fn)

        def standin(*a, _real=real, _name=kernel, **k):
            with record_function(_name):
                return _real(*a, **k)

        monkeypatch.setattr(kw, fn, standin)
    monkeypatch.setattr(trace, "read_events", _fake_device(trace.read_events))
    out, line = run_tiny(cell, tmp_path, trace=True)
    assert line["correct"], line["checks"]
    _, per = harness.cell_metrics(BENCH, cell)
    missing = [m["name"] for m in per if m["name"] not in line["metrics"]]
    assert not missing, missing
    assert all(line["metrics"][m["name"]]["value"] > 0 for m in per)
    assert line["device"]["busy_s"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run_hooks_nothing(cell, tmp_path, monkeypatch):
    """`--trace 0`: no profiler, no capture, no benchmark range, and the
    program's spans stay off (their aggregate never turned on)."""
    from tngp_torch.utils import profiling

    def refused(*a, **k):
        raise AssertionError("a hook in an untraced run")

    for name in ("profiled", "spans_around", "encoder_calls",
                 "encoder_bwd_calls", "scatter_any_calls", "any_kernel_calls"):
        monkeypatch.setattr(util, name, refused)
    host_spans = util.HostSpans
    monkeypatch.setattr(util, "HostSpans", lambda on: refused() if on else host_spans(on))
    monkeypatch.setattr(profiling, "enable_spans", lambda on=True: refused() if on else None)
    _, line = run_tiny(cell, tmp_path)
    assert line["correct"], line["checks"]
    assert profiling.span_totals() == {}


def test_every_arch_and_driver_gives_its_tiny_cut():
    """Each configuration's program module and each mix's driver module cut
    their own part; a module without a cut (a stand-in here) is refused, so
    that a new arch or driver cannot run at another's cut."""
    for c in BENCH["configs"]:
        cfg = copy.deepcopy(harness.load_json(harness.ROOT / c["file"]))
        tiny_cells.tiny_cut(importlib.import_module(f"benchmark.models.{cfg['arch']}"), cfg)
    for w in BENCH["workloads"]:
        spec = copy.deepcopy(harness.cell_spec(w["name"]))
        tiny_cells.tiny_cut(tiny_cells.driver(w["name"]), spec["traffic"], spec["limits"])
    standin = types.ModuleType("benchmark.models.standin")
    with pytest.raises(LookupError, match="gives no tiny cut"):
        tiny_cells.tiny_cut(standin, {})
    standin.tiny = lambda cfg: cfg.update(cut=True)
    cfg = {}
    tiny_cells.tiny_cut(standin, cfg)
    assert cfg == {"cut": True}


def test_tiny_cells_and_fault_cases_name_no_arch_or_driver():
    names = {p.stem for d in ("models", "drivers") for p in (harness.BENCH_DIR / d).glob("*.py")
             if not p.stem.startswith("_")} - {"hooks"}
    assert len(names) >= 4
    for f in ("tests/tiny_cells.py", "tests/test_bench_faults.py"):
        text = (harness.BENCH_DIR / f).read_text()
        assert not [n for n in names if re.search(rf"\b{n}\b", text)], f
