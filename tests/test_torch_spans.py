"""The program's spans (`tngp_torch/utils/profiling.py`): off by default, a
profiler range each under a profiler, in the tree the layers give, and an
in-memory aggregate of host time, on the smallest trainer of the trainer
tests (2 frames of 16x16, 128 rays, grid 32)."""

import pytest
import torch

from tngp_torch.data import make_synthetic_dataset
from tngp_torch.models import NGPNetwork
from tngp_torch.render import RenderConfig
from tngp_torch.train import Trainer
from tngp_torch.utils import TrainConfig
from tngp_torch.utils import profiling
from tngp_torch.utils.profiling import enable_spans, reset_spans, span, span_totals
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

NET_KW = dict(num_levels=4, hidden_dim=16, hidden_dim_color=16, log2_hashmap_size=12)
CFG_KW = dict(bound=1.0, grid_size=32, max_steps=64, K=16, min_near=0.05,
              compact_fraction=0.25, density_thresh=1.0, march_dense=True)
SIDE = 16  # the frame's width and height

STEP = ["tngp.train.sample", "tngp.render.march", "tngp.render.march", "tngp.render.field",
        "tngp.render.composite", "tngp.train.loss", "tngp.train.optimizer",
        "tngp.train.backward", "tngp.train.optimizer", "tngp.train.ema"]


def _trainer():
    ds = make_synthetic_dataset(n_frames=2, H=SIDE, W=SIDE, seed=0, num_steps=32, device="cpu")
    model = NGPNetwork(encoding="hashgrid_window", compute_dtype=torch.float32, device="cpu",
                       **NET_KW)
    tc = TrainConfig(num_rays=128, iters=1000, update_extra_interval=2)
    return Trainer(model, ds, RenderConfig(**CFG_KW), tc, device="cpu"), ds


def _frame(tr, ds):
    return tr.render_image(ds.poses[0], W=SIDE, H=SIDE, chunk=SIDE * SIDE)


@pytest.fixture(scope="module")
def profiled():
    """Two `run_steps` across grid updates (steps 0 and 2, a tier read
    before the second) and one frame under a CPU profiler: (the program's
    ranges as (name, start, end) by start, the frame's host reads)."""
    from torch.profiler import ProfilerActivity, profile

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tr, ds = _trainer()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tr.run_steps(1)
            tr.run_steps(2)
            _frame(tr, ds)
    finally:
        torch.set_num_threads(n)
    ev = sorted((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                for e in prof.profiler.kineto_results.events() if e.name().startswith("tngp."))
    return sorted(ev, key=lambda e: e[1]), tr.last_render_stats["host_reads"]


def _inside(ev, outer):
    return [e for e in ev if outer[1] <= e[1] and e[2] <= outer[2] and e is not outer]


def _top(ev):
    """The ranges that no other range holds, in order."""
    return [e for e in ev if not any(o is not e and o[1] <= e[1] and e[2] <= o[2] for o in ev)]


def test_spans_off_enter_no_profiler_range(monkeypatch):
    """With no profiler and the aggregate off a span is the shared null
    context: a train step across a grid update and a frame enter no
    `record_function` of the program's (patched to raise; torch's optimizer
    enters its own, whatever the program does)."""
    def boom(*a, **k):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(profiling, "record_function", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert span("tngp.train.step") is span("tngp.frame") is profiling._NULL
    tr, ds = _trainer()
    tr.run_steps(1)
    img, _ = _frame(tr, ds)
    assert img.shape == (SIDE, SIDE, 3) and tr.last_render_stats["host_reads"] > 0


def test_profiled_steps_emit_the_tree_in_order(profiled):
    """Under a profiler the steps give, at the top, the grid updates, the
    tier read and the steps in the order they ran, each step holding its
    phases in order, and the frame after them."""
    ev, _ = profiled
    assert [e[0] for e in _top(ev)] == [
        "tngp.train.grid_update", "tngp.train.step", "tngp.train.step",
        "tngp.train.tier_read", "tngp.train.grid_update", "tngp.train.step", "tngp.frame"]
    for step in (e for e in _top(ev) if e[0] == "tngp.train.step"):
        assert [e[0] for e in _inside(ev, step)] == STEP
    for upd in (e for e in _top(ev) if e[0] == "tngp.train.grid_update"):
        assert _inside(ev, upd) == []  # the field's density query is no render span


def test_profiled_frame_emits_its_phases_and_a_read_range_per_host_read(profiled):
    """The frame holds the first pass, its rounds, the finalisation and the
    copies to the host, in order; the renderer's spans sit inside the first
    pass and the rounds, and there is one `tngp.frame.read` range per read
    the frame renderer counts."""
    ev, reads = profiled
    frame = _top(ev)[-1]
    inner = _inside(ev, frame)
    phases = [e[0] for e in _top(inner)]
    assert phases[0] == "tngp.frame.first_pass" and phases[-2:] == [
        "tngp.frame.finalize", "tngp.frame.to_host"]
    assert set(phases[1:-2]) <= {"tngp.frame.round"}
    first = _top(inner)[0]
    assert {e[0] for e in _inside(ev, first)} == {
        "tngp.frame.read", "tngp.render.march", "tngp.render.field", "tngp.render.composite"}
    assert sum(e[0] == "tngp.frame.read" for e in inner) == reads >= 3


def test_no_span_name_nests_inside_itself(profiled):
    """Ranges of one name never overlap, so that a reader can take the
    device work launched inside each name's ranges by their starts."""
    ev, _ = profiled
    for name in {e[0] for e in ev}:
        spans = [e for e in ev if e[0] == name]
        assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:])), name


def test_span_totals_count_and_reset(monkeypatch):
    """The aggregate counts each span and its host ns by name, without
    entering a profiler range; `reset_spans` clears it and turning it off
    drops it."""
    def boom(*a, **k):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(profiling, "record_function", boom)
    assert span_totals() == {}
    enable_spans(True)
    try:
        for _ in range(3):
            with span("tngp.a"):
                with span("tngp.b"):
                    pass
        tot = span_totals()
        assert set(tot) == {"tngp.a", "tngp.b"}
        assert tot["tngp.a"][0] == tot["tngp.b"][0] == 3
        assert tot["tngp.a"][1] >= tot["tngp.b"][1] > 0
        reset_spans()
        assert span_totals() == {}
        with span("tngp.a"):
            pass
        assert span_totals()["tngp.a"][0] == 1
    finally:
        enable_spans(False)
    assert span_totals() == {} and span("tngp.a") is profiling._NULL
