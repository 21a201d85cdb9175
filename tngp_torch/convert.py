"""Carry weights and training state across between the JAX package and the
port.  Flax param trees, optax Adam moments and occupancy grids pass as
nested dicts of numpy arrays (the caller applies `np.asarray` to each leaf).
Nothing here imports JAX."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .render.occupancy import OccupancyGrid, TimeOccupancyGrid


def ngp_state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """{'params': {'encoder': {'embeddings': [NW, C, 128, 64]},
    'sigma_net': {'dense_i': [in, out]}, 'color_net': {...}}} (the outer
    'params' level is optional) -> {'encoder.embeddings': ..., ...}.  Every
    MLP of the tree maps the same way, so D-NeRF's `deform_net` comes along
    (`DNeRFNetwork` has the NGP names plus `deform_net.dense_i`)."""
    tree = params.get("params", params)
    out = {}
    for net, leaves in tree.items():
        for name, value in leaves.items():
            out[f"{net}.{name}"] = torch.from_numpy(np.array(value, dtype=np.float32))
    return out


def flax_params_from_ngp_state_dict(state_dict: Mapping) -> dict:
    """The inverse of `ngp_state_dict_from_flax` (NGP and D-NeRF names):
    {'params': {...}} with numpy leaves."""
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


def time_occupancy_grid_from_arrays(density_grid, bitfield, mean_density, iter_density,
                                    device="cuda") -> TimeOccupancyGrid:
    """A `TimeOccupancyGrid` of the JAX package, given as numpy arrays, as
    the port's."""
    return TimeOccupancyGrid(**vars(occupancy_grid_from_arrays(
        density_grid, bitfield, mean_density, iter_density, device)))


def adam_state_to_flax(optimizer: torch.optim.Adam, model: torch.nn.Module):
    """The inverse of `load_adam_state`: (`count`, `mu`, `nu`), the moments
    as flax-shaped trees of numpy arrays ({'params': {...}}); zeros before
    the first step."""
    mu, nu, count = {}, {}, 0
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        st = optimizer.state.get(p, {})
        if st:
            count = int(st["step"])
            mu[name], nu[name] = st["exp_avg"], st["exp_avg_sq"]
        else:
            mu[name], nu[name] = torch.zeros_like(p), torch.zeros_like(p)
    return count, flax_params_from_ngp_state_dict(mu), flax_params_from_ngp_state_dict(nu)


def optax_adam_state_dict(optimizer: torch.optim.Adam, model: torch.nn.Module) -> dict:
    """The flax state dict of the JAX trainer's optimizer state, optax
    `adam` over `exponential_decay` (`tngp/train/trainer.py:51-59`): the
    chain's first state is scale_by_adam's (count, mu, nu), its second
    the schedule's count.  Counts are int32 0-d arrays."""
    count, mu, nu = adam_state_to_flax(optimizer, model)
    c = np.asarray(count, np.int32)
    return {"0": {"count": c, "mu": mu, "nu": nu}, "1": {"count": c.copy()}}


def load_optax_adam_state(optimizer: torch.optim.Adam, model: torch.nn.Module,
                          state: Mapping) -> int:
    """Put `optax_adam_state_dict`'s layout into `optimizer`.  Returns the
    step count."""
    count = int(np.asarray(state["0"]["count"]))
    load_adam_state(optimizer, model, count, state["0"]["mu"], state["0"]["nu"])
    return count


def occupancy_grid_state_dict(grid: OccupancyGrid) -> dict:
    """The flax state dict of the JAX package's `OccupancyGrid` (its field
    order and dtypes: iter_density int32)."""
    return {
        "density_grid": grid.density_grid.detach().cpu().numpy().copy(),
        "bitfield": grid.bitfield.detach().cpu().numpy().copy(),
        "mean_density": np.asarray(grid.mean_density.detach().cpu().numpy(), np.float32),
        "iter_density": np.asarray(grid.iter_density.detach().cpu().numpy(), np.int32),
    }
