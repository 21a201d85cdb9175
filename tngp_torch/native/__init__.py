"""Mesh operations on the host — the port of `tngp/native/__init__.py`:
signed distance to a triangle mesh and area-weighted surface sampling
(`MeshSDF`, the SDF dataset's labels), isosurface extraction by marching
tetrahedra, the OBJ reader and the PLY / OBJ writers.

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
        lib.sdf_build.restype = ctypes.c_void_p
        lib.sdf_build.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int64,
        ]
        lib.sdf_free.argtypes = [ctypes.c_void_p]
        lib.sdf_query.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.sdf_sample_surface.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_float),
        ]
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


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


class MeshSDF:
    """Signed distance to a triangle mesh, positive inside (a BVH for the
    closest point, ray parity for the sign), and area-weighted sampling of
    its surface.  The C++ state is freed with the object."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray):
        self.vertices = np.ascontiguousarray(vertices, np.float32)
        self.faces = np.ascontiguousarray(faces, np.int32)
        self._h = get_lib().sdf_build(_fptr(self.vertices), len(self.vertices),
                                      _iptr(self.faces), len(self.faces))

    def __call__(self, points: np.ndarray) -> np.ndarray:
        """points [N, 3] -> signed distances [N] float32."""
        pts = np.ascontiguousarray(points, np.float32)
        out = np.empty(len(pts), np.float32)
        get_lib().sdf_query(self._h, _fptr(pts), len(pts), _fptr(out))
        return out

    def sample_surface(self, n: int, seed: int = 0) -> np.ndarray:
        """n points [n, 3] float32 on the surface, drawn from `seed`."""
        out = np.empty((n, 3), np.float32)
        get_lib().sdf_sample_surface(self._h, n, seed, _fptr(out))
        return out

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h and _lib is not None:
            _lib.sdf_free(h)


def marching_tetrahedra(field: np.ndarray, iso: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """The iso surface of a [X, Y, Z] scalar field, in grid coordinates.
    Returns (vertices [V, 3] float32, faces [F, 3] int32)."""
    f = np.ascontiguousarray(field, np.float32)
    X, Y, Z = f.shape
    lib = get_lib()
    h = lib.mt_extract(_fptr(f), X, Y, Z, iso)
    nv, nf = lib.mt_num_verts(h), lib.mt_num_faces(h)
    verts = np.empty((nv, 3), np.float32)
    faces = np.empty((nf, 3), np.int32)
    if nv:
        lib.mt_get(h, _fptr(verts), _iptr(faces))
    lib.mt_free(h)
    return verts, faces


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """The `v` and `f` records of an OBJ file (polygons fan-triangulated).
    Returns (vertices [V, 3] float32, faces [F, 3] int32)."""
    verts, faces = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                verts.append([float(t) for t in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(t.split("/")[0]) - 1 for t in line.split()[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


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
