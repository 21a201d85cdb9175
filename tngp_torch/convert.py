"""Carry weights across from the JAX package: a flax param tree, given as
nested dicts of numpy arrays (the caller applies `np.asarray` to each leaf),
to the port's `NGPNetwork` state_dict.  Nothing here imports JAX."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def ngp_state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """{'params': {'encoder': {'embeddings': [NW, C, 128, 64]},
    'sigma_net': {'dense_i': [in, out]}, 'color_net': {...}}} (the outer
    'params' level is optional) -> {'encoder.embeddings': ..., ...}."""
    tree = params.get("params", params)
    out = {
        "encoder.embeddings": torch.from_numpy(
            np.array(tree["encoder"]["embeddings"], dtype=np.float32)
        )
    }
    for net in ("sigma_net", "color_net"):
        for name, kernel in tree[net].items():
            out[f"{net}.{name}"] = torch.from_numpy(np.array(kernel, dtype=np.float32))
    return out
