"""NeRF datasets: the `NeRFDataset` container and the instant-ngp
`transforms.json` loader — the port of `tngp/data/provider.py`
(`nerf_matrix_to_ngp`, `rand_poses`, `NeRFDataset.load` in its colmap and
blender modes).  Images are read with `utils/image_io.py` (8-bit PNGs),
which stands in for `cv2`."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..utils.image_io import downscale_area, read_png


def nerf_matrix_to_ngp(pose: np.ndarray, scale: float = 0.33, offset=(0, 0, 0)) -> np.ndarray:
    """OpenGL/NeRF camera-to-world -> the ngp convention: the axes cycled
    and flipped, the translation scaled and offset."""
    return np.array(
        [
            [pose[1, 0], -pose[1, 1], -pose[1, 2], pose[1, 3] * scale + offset[0]],
            [pose[2, 0], -pose[2, 1], -pose[2, 2], pose[2, 3] * scale + offset[1]],
            [pose[0, 0], -pose[0, 1], -pose[0, 2], pose[0, 3] * scale + offset[2]],
            [0, 0, 0, 1],
        ],
        dtype=np.float32,
    )


def rand_poses(
    rng: np.random.Generator,
    size: int,
    radius: float = 1.0,
    theta_range=(np.pi / 3, 2 * np.pi / 3),
    phi_range=(0, 2 * np.pi),
) -> np.ndarray:
    """Random orbit-camera poses looking at the origin, y up.  Returns
    [size, 4, 4] float32."""
    thetas = rng.uniform(*theta_range, size)
    phis = rng.uniform(*phi_range, size)
    centers = np.stack(
        [
            radius * np.sin(thetas) * np.sin(phis),
            radius * np.cos(thetas),
            radius * np.sin(thetas) * np.cos(phis),
        ],
        axis=-1,
    )
    forward = -centers / (np.linalg.norm(centers, axis=-1, keepdims=True) + 1e-10)
    up = np.tile(np.array([0.0, -1.0, 0.0]), (size, 1))
    right = np.cross(forward, up)
    right /= np.linalg.norm(right, axis=-1, keepdims=True) + 1e-10
    up = np.cross(right, forward)
    up /= np.linalg.norm(up, axis=-1, keepdims=True) + 1e-10
    poses = np.tile(np.eye(4, dtype=np.float32), (size, 1, 1))
    poses[:, :3, :3] = np.stack([right, up, forward], axis=-1)
    poses[:, :3, 3] = centers
    return poses.astype(np.float32)


def _load_image(path: str, downscale: int) -> np.ndarray:
    """An 8-bit PNG as float32 in [0, 1], [H, W] or [H, W, C] in RGB(A)
    order, shrunk by `downscale` as cv2's INTER_AREA does."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return downscale_area(read_png(path), downscale).astype(np.float32) / 255.0


@dataclass
class NeRFDataset:
    """Host-side arrays of one posed-image set; the trainer puts them on
    its device once."""

    poses: np.ndarray  # [B, 4, 4] float32 camera-to-world, ngp convention
    intrinsics: np.ndarray  # [4] fx, fy, cx, cy
    H: int
    W: int
    images: Optional[np.ndarray] = None  # [B, H, W, 3|4] float32 in [0, 1]; None for test
    times: Optional[np.ndarray] = None  # [B] float32 in [0, 1]
    error_map: Optional[np.ndarray] = None  # [B, 128*128]

    @property
    def num_frames(self) -> int:
        return self.poses.shape[0]

    @staticmethod
    def load(
        root_path: str,
        split: str = "train",
        downscale: int = 1,
        scale: float = 0.33,
        offset=(0, 0, 0),
        mode: Optional[str] = None,  # 'colmap' | 'blender' | None: detect
        use_error_map: bool = False,
        with_time: bool = False,
    ) -> "NeRFDataset":
        """A split of a transforms.json dataset.  colmap mode
        (`transforms.json`): frames sorted by file path, every 8th held out
        for val and test.  blender mode (`transforms_<split>.json`, val
        falling back to test).  Focal lengths from fl_x/fl_y or
        camera_angle_x/y; the principal point from cx/cy or the image
        centre.  Frames whose image is missing leave `images` None."""
        if mode is None:
            if os.path.exists(os.path.join(root_path, "transforms.json")):
                mode = "colmap"
            elif os.path.exists(os.path.join(root_path, f"transforms_{split}.json")):
                mode = "blender"
            else:
                raise FileNotFoundError(f"no transforms*.json under {root_path}")

        if mode == "colmap":
            with open(os.path.join(root_path, "transforms.json")) as f:
                transform = json.load(f)
            frames = sorted(transform["frames"], key=lambda d: d["file_path"])
            if split == "train":
                frames = [f for i, f in enumerate(frames) if i % 8 != 0]
            elif split in ("val", "test"):
                frames = [f for i, f in enumerate(frames) if i % 8 == 0]
        else:
            fname = os.path.join(root_path, f"transforms_{split}.json")
            if not os.path.exists(fname) and split == "val":
                fname = os.path.join(root_path, "transforms_test.json")
            with open(fname) as f:
                transform = json.load(f)
            frames = transform["frames"]

        H = W = None
        if "h" in transform:
            H = int(transform["h"]) // downscale
            W = int(transform["w"]) // downscale

        poses, images, times = [], [], []
        for fr in frames:
            fpath = os.path.join(root_path, fr["file_path"])
            if mode == "blender" and not os.path.splitext(fpath)[1]:
                fpath += ".png"
            pose = nerf_matrix_to_ngp(np.array(fr["transform_matrix"], np.float32), scale, offset)
            img = None
            if os.path.exists(fpath):
                img = _load_image(fpath, downscale)
                if H is None:
                    H, W = img.shape[:2]
            poses.append(pose)
            images.append(img)
            if with_time:
                times.append(float(fr.get("time", len(times) / max(1, len(frames) - 1))))

        poses = np.stack(poses)
        have_imgs = all(im is not None for im in images) and len(images) > 0
        images_np = np.stack(images) if have_imgs else None

        if "fl_x" in transform or "fl_y" in transform:
            fl_x = transform.get("fl_x", transform.get("fl_y")) / downscale
            fl_y = transform.get("fl_y", transform.get("fl_x")) / downscale
        elif "camera_angle_x" in transform or "camera_angle_y" in transform:
            if "camera_angle_x" in transform:
                fl_x = W / (2 * np.tan(transform["camera_angle_x"] / 2))
            else:
                fl_x = None
            if "camera_angle_y" in transform:
                fl_y = H / (2 * np.tan(transform["camera_angle_y"] / 2))
            else:
                fl_y = None
            fl_x = fl_x if fl_x is not None else fl_y
            fl_y = fl_y if fl_y is not None else fl_x
        else:
            raise ValueError("transforms has no focal length information")
        cx = transform.get("cx", W / 2) / (downscale if "cx" in transform else 1)
        cy = transform.get("cy", H / 2) / (downscale if "cy" in transform else 1)
        intrinsics = np.array([fl_x, fl_y, cx, cy], np.float32)

        error_map = (
            np.ones((poses.shape[0], 128 * 128), np.float32)
            if (use_error_map and split == "train")
            else None
        )
        return NeRFDataset(
            poses=poses,
            intrinsics=intrinsics,
            H=H,
            W=W,
            images=images_np,
            times=np.array(times, np.float32) if with_time else None,
            error_map=error_map,
        )
