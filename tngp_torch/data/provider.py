"""Dataset container — the `NeRFDataset` dataclass of
`tngp/data/provider.py` (the transforms.json loader comes with the CLI)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class NeRFDataset:
    """Host-side arrays of one posed-image set; the trainer puts them on
    its device once."""

    poses: np.ndarray  # [B, 4, 4] float32 camera-to-world, ngp convention
    intrinsics: np.ndarray  # [4] fx, fy, cx, cy
    H: int
    W: int
    images: Optional[np.ndarray] = None  # [B, H, W, 3|4] float32 in [0, 1]
    times: Optional[np.ndarray] = None  # [B] float32 in [0, 1]
    error_map: Optional[np.ndarray] = None  # [B, 128*128]

    @property
    def num_frames(self) -> int:
        return self.poses.shape[0]
