"""Checkpoint save/load with rotation and best-tracking — the port of
`tngp/train/checkpoint.py`, reading and writing the same files: the
payload as flax's msgpack state dict (`utils/msgpack_codec.py`, the bytes
`flax.serialization.to_bytes` writes) and a JSON sidecar of scalars
(`<file>.json`: epoch, global_step, stats, geometry).

Payloads are nested dicts of numpy arrays (or torch tensors) under the JAX
package's names; `Trainer` maps its state to and from them through
`tngp_torch/convert.py`.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, Optional

from ..utils import msgpack_codec


def save_checkpoint(
    workspace: str,
    name: str,
    epoch: int,
    global_step: int,
    payload: Dict[str, Any],  # state dicts: params, opt_state, ema, grid, ...
    stats: Optional[Dict[str, Any]] = None,
    max_keep: int = 2,
    best: bool = False,
    geometry: Optional[Dict[str, Any]] = None,  # model shape info for rebuild-on-load
) -> str:
    """Write `<workspace>/checkpoints/<name>_ep<epoch>.npz` (or
    `<name>.pth.npz` for the best one) and its sidecar; keep the newest
    `max_keep` epoch checkpoints.  Returns the file's path."""
    ckpt_dir = os.path.join(workspace, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    fname = (
        os.path.join(ckpt_dir, f"{name}.pth.npz")
        if best
        else os.path.join(ckpt_dir, f"{name}_ep{epoch:04d}.npz")
    )
    blob = msgpack_codec.packb(payload)
    meta = {"epoch": epoch, "global_step": global_step, "stats": stats or {}}
    if geometry is not None:
        meta["geometry"] = geometry
    with open(fname, "wb") as f:
        f.write(blob)
    with open(fname + ".json", "w") as f:
        json.dump(meta, f, default=float)  # numpy scalars -> json numbers

    if not best and max_keep > 0:
        ckpts = sorted(glob.glob(os.path.join(ckpt_dir, f"{name}_ep*.npz")))
        for old in ckpts[:-max_keep]:
            os.remove(old)
            if os.path.exists(old + ".json"):
                os.remove(old + ".json")
    return fname


def latest_checkpoint(workspace: str, name: str) -> Optional[str]:
    ckpts = sorted(glob.glob(os.path.join(workspace, "checkpoints", f"{name}_ep*.npz")))
    return ckpts[-1] if ckpts else None


def load_meta(path: str) -> Dict[str, Any]:
    """The JSON sidecar alone ({} when there is none)."""
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            return json.load(f)
    return {}


def _merge_state(template, loaded, path: str, report: Dict[str, list]):
    """Overlay `loaded` onto `template`, tolerating missing, unexpected and
    shape-mismatched entries (the JAX package's non-strict load)."""
    if isinstance(template, dict):
        out = {}
        loaded = loaded if isinstance(loaded, dict) else {}
        for k, tv in template.items():
            if k in loaded:
                out[k] = _merge_state(tv, loaded[k], f"{path}/{k}", report)
            else:
                report["missing"].append(f"{path}/{k}")
                out[k] = tv
        for k in loaded:
            if k not in template:
                report["unexpected"].append(f"{path}/{k}")
        return out
    t_shape = getattr(template, "shape", None)
    l_shape = getattr(loaded, "shape", None)
    if t_shape is not None and l_shape is not None and tuple(t_shape) != tuple(l_shape):
        report["mismatched"].append(f"{path}: ckpt{tuple(l_shape)} != model{tuple(t_shape)}")
        return template
    return loaded


def load_checkpoint(path: str, template: Dict[str, Any], strict: bool = False):
    """Restore a `template`-shaped payload from `path`.  Returns (payload,
    meta).  Missing entries keep the template's values, unexpected ones are
    dropped, shape mismatches keep the template's; meta's `_load_report`
    lists all three.  `strict=True` raises on any of them instead."""
    with open(path, "rb") as f:
        raw = msgpack_codec.unpackb(f.read())
    report = {"missing": [], "unexpected": [], "mismatched": []}
    payload = _merge_state(template, raw, "", report)
    if strict and any(report.values()):
        raise ValueError(f"checkpoint {path} does not match the template: {report}")
    meta = load_meta(path)
    meta["_load_report"] = report
    return payload, meta
