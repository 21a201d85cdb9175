"""Mesh export on the host: isosurface extraction by marching tetrahedra and
PLY / OBJ writers — the port of `tngp/native/__init__.py`
(`marching_tetrahedra`, `save_ply`, `save_obj`).

`src/meshops.cpp` is the port's own copy of the JAX package's C++ source,
byte for byte, so both packages extract the same mesh.  It is compiled with
`g++` at first use into the git-ignored `tngp_torch/_build/` (named by a
hash of the source and the flags, so an edited source rebuilds) and loaded
through ctypes; nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = "tngp_torch/native/src/meshops.cpp"  # repo-relative, as the CUDA kernels register
COPY_OF = "tngp/native/src/meshops.cpp"  # the JAX package's source it copies
_SRC = Path(__file__).resolve().parent / "src" / "meshops.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-fopenmp")

_lib: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def _lib_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD_DIR / f"meshops-{h.hexdigest()[:16]}.so"


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        out = _lib_path()
        if not out.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            res = subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"building {SOURCE} failed:\n{res.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.mt_extract.restype = ctypes.c_void_p
        lib.mt_extract.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_float,
        ]
        lib.mt_num_verts.restype = ctypes.c_int64
        lib.mt_num_verts.argtypes = [ctypes.c_void_p]
        lib.mt_num_faces.restype = ctypes.c_int64
        lib.mt_num_faces.argtypes = [ctypes.c_void_p]
        lib.mt_get.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
        ]
        lib.mt_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def marching_tetrahedra(field: np.ndarray, iso: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """The iso surface of a [X, Y, Z] scalar field, in grid coordinates.
    Returns (vertices [V, 3] float32, faces [F, 3] int32)."""
    f = np.ascontiguousarray(field, np.float32)
    X, Y, Z = f.shape
    lib = get_lib()
    h = lib.mt_extract(f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), X, Y, Z, iso)
    nv, nf = lib.mt_num_verts(h), lib.mt_num_faces(h)
    verts = np.empty((nv, 3), np.float32)
    faces = np.empty((nf, 3), np.int32)
    if nv:
        lib.mt_get(h, verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                   faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    lib.mt_free(h)
    return verts, faces


def save_obj(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as fh:
        for v in vertices:
            fh.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for f in faces:
            fh.write(f"f {f[0]+1} {f[1]+1} {f[2]+1}\n")


def save_ply(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """ASCII PLY, as the JAX package writes it."""
    with open(path, "w") as fh:
        fh.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(vertices)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        for v in vertices:
            fh.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for f in faces:
            fh.write(f"3 {f[0]} {f[1]} {f[2]}\n")
