"""Build, load and launch the port's hand-written CUDA kernels.

Each source in `tngp_torch/csrc/` compiles with `nvcc` into a shared library
with a plain C interface, loaded through `ctypes`.  The first call builds
every library that is missing, one `nvcc` per source, all started together,
into `tngp_torch/_build/` (git-ignored), named by a hash of the source and
the flags so that an edited source rebuilds.  Nothing is built or imported
when this module is imported: the CPU tests import every module.

Dispatch rule for every wrapper: a CPU tensor goes to the kernel's plain
PyTorch version; a CUDA tensor launches the kernel or raises.  The one
exception is `plain_versions()`, a scope in which CUDA tensors also take the
plain versions — it exists so that `chip_smoke.py` can hold a whole render
chunk or train step against the plain path on the card; the main path never
enters it.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass, field
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_c = ctypes
# C signatures of the exported launchers: (name, restype, argtypes)
_SIGNATURES = {
    "scatter.cu": [
        *[(f"tngp_scatter_add_{form}_f32", _c.c_int,
           [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int64, _c.c_int,
            _c.c_int64, _c.c_void_p])
          for form in ("unique", "sorted")],
        ("tngp_scatter_add_any_f32", _c.c_int,
         [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int64, _c.c_int,
          _c.c_int64, _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_void_p]),
        ("tngp_scatter_set_f32", _c.c_int,
         [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int,
          _c.c_int64, _c.c_float, _c.c_void_p]),
    ],
    "bin_rank.cu": [
        ("tngp_bin_dest", _c.c_int,
         [_c.c_void_p, _c.c_int64, _c.c_int64, _c.c_int64, _c.c_int, _c.c_int,
          *[_c.c_void_p] * 6, _c.c_void_p]),
    ],
    "window_encoder.cu": [
        *[(f"tngp_window_encode_{d}{form}", _c.c_int,
           [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
            _c.c_void_p, _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,
            _c.c_float, _c.c_int, _c.c_void_p])
          for d in ("fwd", "bwd") for form in ("", "_f32")],
        *[(f"tngp_window_encode_dx{form}", _c.c_int,
           [*[_c.c_void_p] * 8, _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,
            _c.c_int, _c.c_float, _c.c_int, _c.c_void_p])
          for form in ("", "_f32")],
    ],
    "march.cu": [
        ("tngp_march_chunked", _c.c_int, [_c.c_void_p] * 17),  # 16 pointers, the stream
    ],
    "int_mul_probe.cu": [
        ("tngp_int_mul_probe", _c.c_int,
         [_c.c_void_p, _c.c_void_p, _c.c_int64, _c.c_void_p]),
    ],
}
SOURCES = tuple(_SIGNATURES)


@dataclass
class KernelInfo:
    """One hand-written kernel: where it lives, what it replaces, its
    exported launcher, and how many times its wrapper launched it (a plain
    integer, reset by callers that want to show a path went through it);
    a kernel of several designs also counts its launches by design under
    `forms`."""

    name: str
    source: str  # repo-relative path of the CUDA source
    replaces: str  # file:line of the TPU kernel it replaces
    symbol: str  # the exported C launcher
    launches: int = 0
    forms: dict = field(default_factory=dict)
    fn: object = field(default=None, repr=False)  # the ctypes function, bound at load


KERNELS: dict[str, KernelInfo] = {}


def register(name: str, source: str, replaces: str, symbol: str) -> KernelInfo:
    info = KernelInfo(name, f"tngp_torch/csrc/{source}", replaces, symbol)
    KERNELS[name] = info
    return info


def reset_launch_counts() -> None:
    for info in KERNELS.values():
        info.launches = 0
        info.forms.clear()


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

_PLAIN = contextvars.ContextVar("tngp_torch_plain_versions", default=False)


@contextlib.contextmanager
def plain_versions():
    """Scope in which CUDA tensors take the kernels' plain versions.  Only
    for holding the kernel path against the plain path on the card."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def use_plain(t: torch.Tensor) -> bool:
    """True for a CPU tensor (or inside `plain_versions()`), False for a
    CUDA tensor, which must then launch the kernel."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return _PLAIN.get()


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and `shape`
    (None in `shape` matches any extent)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
        s is not None and s != n for s, n in zip(shape, t.shape)
    ):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def launch(info: KernelInfo, device: torch.device, *args) -> None:
    """Call the kernel's launcher on the current stream of `device`; raise
    if it reports a CUDA error, else count the launch.  The launcher is
    bound once, when its library loads; the stream is read without a
    device switch when `device` is the current one."""
    fn = info.fn
    if fn is None:
        library(info.source.rsplit("/", 1)[-1])
        fn = info.fn
    index = device.index
    if index == torch._C._cuda_getDevice():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{info.name}: CUDA error {rc} at launch")
    info.launches += 1


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(source: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / source).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all(sources=SOURCES) -> list[Path]:
    """Compile every listed source whose library is missing, one nvcc
    process per source, all started together.  Returns the library paths."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = [_lib_path(s) for s in sources]
    jobs = []
    try:
        for src, out in zip(sources, paths):
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / src)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            jobs.append((src, proc, tmp, out))
        errors = []
        for src, proc, tmp, out in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src}: nvcc exit {proc.returncode}\n{log}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    finally:
        for _, proc, tmp, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    return paths


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source (built on first use)."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            (path,) = build_all((source,))
            lib = ctypes.CDLL(str(path))
            for name, restype, argtypes in _SIGNATURES[source]:
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            for info in KERNELS.values():
                if info.source.rsplit("/", 1)[-1] == source:
                    info.fn = getattr(lib, info.symbol)
            _LIBS[source] = lib
        return lib


def load_all() -> None:
    """Build every kernel in parallel, then load each library."""
    build_all()
    for source in SOURCES:
        library(source)
