"""Helpers the drivers share: the scene, the device's clock and memory, and
the profiled span of a traced run."""

from __future__ import annotations

import contextlib
import hashlib
import sys
import time

import numpy as np
import torch

from . import trace
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
def encoder_calls():
    """Inside: the inputs (xyz4, wob) of each window-encoder forward launch
    are appended to the yielded dict's `fwd`; the calls go through
    unchanged."""
    from tngp_torch.kernels import window_encoder as kw

    seen: dict = {"fwd": [], "block": kw.DEFAULT_BLOCK}
    real = kw.window_encode_fwd

    def call(xyz4, wob, *a, **k):
        seen["fwd"].append((xyz4, wob))
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

