"""Helpers the drivers share: the scene, the device's clock and memory, and
what a traced run reads besides the device trace: the program's host time
by span over the window, and the kernel calls of the profiled span."""

from __future__ import annotations

import contextlib
import hashlib
import sys
import time

import numpy as np
import torch

from . import spans, trace
from .harness import ROOT


def load_scene(cfg: dict):
    """(poses [B, 4, 4], intrinsics [4], images [B, H, W, 3]) of the
    configuration's scene file, refused where its sha256 differs from the
    one the configuration names."""
    path = ROOT / cfg["scene"]["file"]
    raw = path.read_bytes()
    if hashlib.sha256(raw).hexdigest() != cfg["scene"]["sha256"]:
        raise SystemExit(f"{path}: not the scene the configuration names (sha256 differs)")
    with np.load(path) as z:
        return (z["poses"].astype(np.float32), z["intrinsics"].astype(np.float32),
                z["images"].astype(np.float32))


def note(msg: str) -> None:
    """A progress line on standard error."""
    print(f"# {msg}", file=sys.stderr, flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def clock(device) -> float:
    """Host seconds after the device's queue has drained."""
    sync(device)
    return time.perf_counter()


def peak_memory(device) -> int:
    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0


def free(device) -> None:
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


@contextlib.contextmanager
def profiled(device):
    """A profiler session around a `trace.SPAN` range that ends once the
    device is done; yields a dict that holds the span's events (`trace.Event`
    list) once the block has left."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out: dict = {}
    sync(device)
    with profile(activities=acts) as prof:
        with record_function(trace.SPAN):
            yield out
            sync(device)
    out["events"] = trace.read_events(prof)


class HostSpans:
    """The program's aggregate of host time by span
    (`tngp_torch.utils.profiling`) over a traced run's window: entered at
    the window's start and left at its end (or on an error), it turns the
    spans on and off again, and leaves in `totals` what they read over the
    window less the profiled chunk (`left_out`).  With `on` false (an
    untraced run) it touches nothing and `totals` stays empty."""

    def __init__(self, on: bool):
        self.on, self.profiled, self.totals = bool(on), {}, {}

    def __enter__(self):
        if self.on:
            from tngp_torch.utils import profiling

            self.prof = profiling
            profiling.enable_spans(True)
            profiling.reset_spans()
        return self

    def __exit__(self, *exc) -> bool:
        if self.on:
            self.totals = spans.host_window(self.prof.span_totals(), self.profiled)
            self.prof.enable_spans(False)
        return False

    @contextlib.contextmanager
    def left_out(self):
        """Inside: the totals that `totals` leaves out."""
        before = self.prof.span_totals()
        yield
        self.profiled = spans.host_window(self.prof.span_totals(), before)


@contextlib.contextmanager
def spans_around(obj, attr: str, name: str):
    """Inside: calls of `obj.<attr>` run inside a `record_function(name)`
    range, calling through unchanged."""
    from torch.autograd.profiler import record_function

    own = attr in vars(obj)
    real = getattr(obj, attr)

    def wrapped(*a, **k):
        with record_function(name):
            return real(*a, **k)

    setattr(obj, attr, wrapped)
    try:
        yield
    finally:
        if own:
            setattr(obj, attr, real)
        else:
            delattr(obj, attr)  # the class's method shows through again


@contextlib.contextmanager
def encoder_calls(limit: int):
    """Inside: the inputs (xyz4, wob) of the first `limit` window-encoder
    forward launches are appended to the yielded dict's `fwd`, each of
    those calls inside a `record_function("bench.encoder_fwd")` range, so
    that their kernels' time is read beside them (the inputs are kept, so
    a few calls); the calls go through unchanged."""
    from torch.autograd.profiler import record_function
    from tngp_torch.kernels import window_encoder as kw

    seen: dict = {"fwd": [], "block": kw.DEFAULT_BLOCK}
    real = kw.window_encode_fwd

    def call(xyz4, wob, *a, **k):
        if len(seen["fwd"]) >= limit:
            return real(xyz4, wob, *a, **k)
        seen["fwd"].append((xyz4, wob))
        with record_function("bench.encoder_fwd"):
            return real(xyz4, wob, *a, **k)

    kw.window_encode_fwd = call
    try:
        yield seen
    finally:
        kw.window_encode_fwd = real


@contextlib.contextmanager
def scatter_any_calls():
    """Inside: each general scatter-add that the grid samples' backward
    launches runs in a `record_function("bench.scatter_any")` range and its
    shape (m, c, rows) is appended to the yielded list; the calls go
    through unchanged."""
    from torch.autograd.profiler import record_function
    from tngp_torch.ops import grid_sample

    seen: list = []
    real = grid_sample.scatter_add

    def call(idx, vals, num_rows, *a, **k):
        if k.get("indices", "any") != "any":
            return real(idx, vals, num_rows, *a, **k)
        seen.append((int(vals.shape[0]), int(vals.shape[1]), int(num_rows)))
        with record_function("bench.scatter_any"):
            return real(idx, vals, num_rows, *a, **k)

    grid_sample.scatter_add = call
    try:
        yield seen
    finally:
        grid_sample.scatter_add = real


@contextlib.contextmanager
def encoder_bwd_calls():
    """Inside: the sizes (M_pad, wob entries) of each window-encoder table
    gradient call (`window_encode_bwd`: the zeroing and table-gradient
    kernels) are appended to the yielded list, for `roofline.
    encoder_bwd_bytes`; the calls go through unchanged."""
    from tngp_torch.kernels import window_encoder as kw

    seen: list = []
    real = kw.window_encode_bwd

    def call(xyz4, wob, *a, **k):
        seen.append((int(xyz4.shape[0]), int(wob.numel())))
        return real(xyz4, wob, *a, **k)

    kw.window_encode_bwd = call
    try:
        yield seen
    finally:
        kw.window_encode_bwd = real


@contextlib.contextmanager
def any_kernel_calls():
    """Inside: the shape (m, c, rows) of each launch of the general
    scatter-add's kernel (`tngp_torch.kernels.scatter`'s any form, at its
    launch, so every caller's) is appended to the yielded list, for
    `roofline.add_bytes`; the launches go through unchanged.  CPU tensors
    take the plain version and launch nothing."""
    from tngp_torch.kernels import scatter

    seen: list = []
    real = scatter._launch_any

    def launch(idx, vals, num_rows, *a, **k):
        seen.append((int(vals.shape[0]), int(vals.shape[1]), int(num_rows)))
        return real(idx, vals, num_rows, *a, **k)

    scatter._launch_any = launch
    try:
        yield seen
    finally:
        scatter._launch_any = real
