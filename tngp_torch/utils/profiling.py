"""Profiler integration and the program's spans — the port of
`tngp/utils/profiling.py`, with the spans added.

    with profile_trace("ws/profile"):   # a no-op when the dir is falsy
        train_steps()

`profile_trace` runs `torch.profiler` over the CPU and, where there is a
card, CUDA activity, and writes a Chrome trace (`trace_<time>.json`,
viewable in Perfetto or chrome://tracing) into the directory.  `Trainer`
profiles its first epoch under `TrainConfig.profile_dir` (the CLIs'
`--profile`).

`span(name)` marks a phase of the program where the work happens:

    with span("tngp.train.step"):
        ...

It has two sinks, both off by default:

- under an active profiler it enters `record_function(name)`: a host range
  on the device trace's clock, which the profiler also lays over the device
  work launched inside it on the device timeline.  A phase belongs to the
  step or frame whose range holds it (torch keeps no argument of such a
  range that its trace shows, so the ranges carry no ids);
- with the aggregate on (`enable_spans(True)`) it adds the span's count and
  host nanoseconds (`time.perf_counter_ns`) to in-memory totals by name,
  which `span_totals()` reads and `reset_spans()` clears.

With both off it returns one shared null context: no range, no clock read,
no allocation.  The spans, each named after the layer it marks (parents by
nesting; no name nests inside itself):

- `tngp.train.step` in `Trainer.train_step`, holding
  `tngp.train.sample`, `tngp.render.march` (the march, its compaction and
  `ladder_samples`), `tngp.render.field` (each field query of the
  renderer), `tngp.render.composite` (the compositors and the results),
  `tngp.train.loss`, `tngp.train.backward`, `tngp.train.optimizer`
  (`zero_grad`; `step` and the schedule) and `tngp.train.ema` (the EMA and
  the error map's update);
- in `Trainer.run_steps`, beside the step: `tngp.train.grid_update`,
  `tngp.train.tier_read` (the host read of the tier) and
  `tngp.train.upsample` (TensoRF's shrink and upsample, when it acts);
- `tngp.frame` in `Trainer.render_image`, the copies to the host
  included, holding the frame renderer's `tngp.frame.first_pass`,
  `tngp.frame.round` and `tngp.frame.finalize`, the
  renderer's spans inside them, `tngp.frame.read` (each device-to-host read
  the frame renderer counts in `host_reads`) and `tngp.frame.to_host`;
- `tngp.encoder.hash_grid` / `tngp.encoder.hash_grid.backward` (the plain
  hash grid) and `tngp.kernel.scatter_add_any` (the general scatter-add
  on the card).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch
from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """A torch.profiler trace of the block into `trace_dir`; a falsy dir
    makes it a no-op."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{int(time.time() * 1e3)}.json"))


def _no_exit(exc_type, exc, tb):
    return None


class _Null:
    """The context of every span while both sinks are off.  Its methods are
    static, so that a `with` binds no method object: `__enter__` is the C
    builtin `tuple` (it returns the empty tuple), and `__exit__` returns
    None, so that an exception goes on."""

    __slots__ = ()
    __enter__ = staticmethod(tuple)
    __exit__ = staticmethod(_no_exit)


_NULL = _Null()
_totals: Optional[dict] = None  # name -> [count, host ns] while the aggregate is on


class _Span:
    """One span's profiler range and clock reading (`span`)."""

    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str):
        self.name, self.rf, self.t0 = name, None, 0

    def __enter__(self):
        if _profiler_enabled():
            self.rf = record_function(self.name)
            self.rf.__enter__()
        if _totals is not None:
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.t0 and _totals is not None:
            tot = _totals.setdefault(self.name, [0, 0])
            tot[0] += 1
            tot[1] += time.perf_counter_ns() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context for the program phase `name` (module docstring): the shared
    null context while no profiler runs and the aggregate is off."""
    if _totals is None and not _profiler_enabled():
        return _NULL
    return _Span(name)


def enable_spans(on: bool = True) -> None:
    """Turn the spans' aggregate on (totals it holds stay) or off (its
    totals dropped)."""
    global _totals
    if not on:
        _totals = None
    elif _totals is None:
        _totals = {}


def reset_spans() -> None:
    """Clear the aggregate's totals (it stays on or off)."""
    if _totals is not None:
        _totals.clear()


def span_totals() -> dict:
    """The aggregate's totals: name -> (count, host ns); empty when off."""
    return {k: (c, ns) for k, (c, ns) in (_totals or {}).items()}
