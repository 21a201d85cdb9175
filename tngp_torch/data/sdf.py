"""SDF dataset — the port of `tngp/data/sdf.py`: the mesh normalised into
[-1, 1] (centred, its bounding-box diagonal scaled to 2 * 0.95), and each
step's batch drawn on the host from a seed: 7/8 of the points on the
surface (the second half of the whole batch perturbed by N(0, 0.01)) and
1/8 uniform in [-1, 1]^3.  Labels are 0 on the first half and minus the
mesh library's signed distance elsewhere (that distance is positive inside,
so a label is positive outside).

It is numpy and the port's copy of the mesh library, so a seed gives the
JAX package's points and labels bit for bit.  The batch stays on the host;
the trainer uploads it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..native import MeshSDF, load_obj


def normalize_mesh(vertices: np.ndarray) -> np.ndarray:
    vmin, vmax = vertices.min(0), vertices.max(0)
    center = (vmin + vmax) / 2
    scale = 2.0 / np.sqrt(np.sum((vmax - vmin) ** 2)) * 0.95
    return ((vertices - center) * scale).astype(np.float32)


class SDFDataset:
    def __init__(
        self,
        path: Optional[str] = None,
        size: int = 100,
        num_samples: int = 2**18,
        clip_sdf: Optional[float] = None,
        vertices: Optional[np.ndarray] = None,
        faces: Optional[np.ndarray] = None,
    ):
        if path is not None:
            vertices, faces = load_obj(path)
        if vertices is None or faces is None:
            raise ValueError("need either path or (vertices, faces)")
        self.vertices = normalize_mesh(np.asarray(vertices, np.float32))
        self.faces = np.asarray(faces, np.int32)
        self.sdf_fn = MeshSDF(self.vertices, self.faces)
        if num_samples % 8 != 0:
            raise ValueError(f"num_samples must be divisible by 8, got {num_samples}")
        self.num_samples = num_samples
        self.clip_sdf = clip_sdf
        self.size = size  # steps per epoch

    def sample(self, seed: int) -> Tuple[np.ndarray, np.ndarray]:
        """One training batch: (points [N, 3], sdfs [N, 1]) float32."""
        n = self.num_samples
        rng = np.random.default_rng(seed)
        surface = self.sdf_fn.sample_surface(n * 7 // 8, seed=seed)
        surface[n // 2:] += (0.01 * rng.standard_normal((n * 7 // 8 - n // 2, 3))).astype(
            np.float32)
        uniform = (rng.random((n // 8, 3), dtype=np.float32) * 2 - 1).astype(np.float32)
        points = np.concatenate([surface, uniform]).astype(np.float32)

        sdfs = np.zeros((n, 1), np.float32)
        sdfs[n // 2:, 0] = -self.sdf_fn(points[n // 2:])
        if self.clip_sdf is not None:
            sdfs = sdfs.clip(-self.clip_sdf, self.clip_sdf)
        return points, sdfs


def sphere_mesh(n: int = 64, r: float = 0.6) -> Tuple[np.ndarray, np.ndarray]:
    """The `sphere` mesh of the SDF entry point: the r-isosurface of the
    distance to the origin on an n^3 lattice over [-1, 1]^3, by marching
    tetrahedra.  Returns (vertices [V, 3] in [-1, 1], faces [F, 3])."""
    from ..native import marching_tetrahedra

    g = np.linspace(-1, 1, n, dtype=np.float32)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    verts, faces = marching_tetrahedra(r - np.sqrt(X**2 + Y**2 + Z**2), 0.0)
    return verts / (n - 1) * 2 - 1, faces
