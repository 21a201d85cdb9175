"""Carry weights and training state across between the JAX package and the
port.  Flax param trees, optax Adam moments and occupancy grids pass as
nested dicts of numpy arrays (the caller applies `np.asarray` to each leaf).
Nothing here imports JAX."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .render.occupancy import OccupancyGrid


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


def flax_params_from_ngp_state_dict(state_dict: Mapping) -> dict:
    """The inverse of `ngp_state_dict_from_flax`: {'params': {...}} with
    numpy leaves."""
    tree: dict = {}
    for key, value in state_dict.items():
        net, name = key.split(".")
        tree.setdefault(net, {})[name] = value.detach().cpu().numpy().copy()
    return {"params": tree}


def load_adam_state(optimizer: torch.optim.Adam, model: torch.nn.Module, count: int,
                    mu: Mapping, nu: Mapping) -> None:
    """Put an optax Adam state (`count`, and `mu` / `nu` as flax-shaped
    trees of numpy arrays) into `optimizer`, whose parameters are `model`'s."""
    by_param = {p: name for name, p in model.named_parameters()}
    mu_sd, nu_sd = ngp_state_dict_from_flax(mu), ngp_state_dict_from_flax(nu)
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = by_param[p]
            optimizer.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": mu_sd[name].to(p.device),
                "exp_avg_sq": nu_sd[name].to(p.device),
            }


def occupancy_grid_from_arrays(density_grid, bitfield, mean_density, iter_density,
                               device="cuda") -> OccupancyGrid:
    """An `OccupancyGrid` of the JAX package, given as numpy arrays, as the
    port's."""
    return OccupancyGrid(
        density_grid=torch.as_tensor(np.array(density_grid, np.float32), device=device),
        bitfield=torch.as_tensor(np.array(bitfield, np.uint8), device=device),
        mean_density=torch.as_tensor(np.array(mean_density, np.float32), device=device),
        iter_density=torch.as_tensor(np.array(iter_density, np.int64), device=device),
    )
