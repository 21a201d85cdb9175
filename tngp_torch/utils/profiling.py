"""Profiler integration — the port of `tngp/utils/profiling.py`.

    with profile_trace("ws/profile"):   # a no-op when the dir is falsy
        train_steps()

`profile_trace` runs `torch.profiler` over the CPU and, where there is a
card, CUDA activity, and writes a Chrome trace (`trace_<time>.json`,
viewable in Perfetto or chrome://tracing) into the directory.  `Trainer`
profiles its first epoch under `TrainConfig.profile_dir` (the CLIs'
`--profile`).  `StepTimer` times stages with CUDA events on the card and
the host clock on the CPU.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


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


class StepTimer:
    """Stage timing: on the card a CUDA event pair around each timed block
    (`stop` waits for its end event), on the CPU the host clock."""

    def __init__(self, device="cuda"):
        self.cuda = torch.device(device).type == "cuda"
        self.times_ms: list[float] = []
        self._t0: float | None = None
        self._ev0 = None

    def start(self):
        if self.cuda:
            self._ev0 = torch.cuda.Event(enable_timing=True)
            self._ev0.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record()
            ev1.synchronize()
            dt = self._ev0.elapsed_time(ev1)
        else:
            dt = (time.perf_counter() - self._t0) * 1e3
        self.times_ms.append(dt)
        return dt

    @property
    def mean_ms(self) -> float:
        return sum(self.times_ms) / max(len(self.times_ms), 1)
