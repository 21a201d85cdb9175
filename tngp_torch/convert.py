"""Carry weights and training state across between the JAX package and the
port.  Flax param trees, optax Adam moments and occupancy grids pass as
nested dicts of numpy arrays (the caller applies `np.asarray` to each leaf).
Nothing here imports JAX."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .render.occupancy import OccupancyGrid, TimeOccupancyGrid


def _flatten(tree: Mapping, prefix: str, out: dict) -> dict:
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            _flatten(value, name + ".", out)
        else:
            out[name] = torch.from_numpy(np.array(value, dtype=np.float32))
    return out


def ngp_state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """{'params': {'encoder': {'embeddings': [NW, C, 128, 64] or [T, C]},
    'sigma_net': {'dense_i': [in, out]}, 'color_net': {...}}} (the outer
    'params' level is optional) -> {'encoder.embeddings': ..., ...}: the
    tree's keys joined with '.', at any depth.  Every model's tree maps the
    same way: the window and the flat golden tables, the background's
    `encoder_bg` and `bg_net`, D-NeRF's `deform_net`, `basis_net` and
    `ambient_net`, `SDFNetwork`'s `encoder` and `backbone`, TensoRF's
    top-level factors (`sigma_mat_0`, `basis_mat`, ...) beside its
    `color_net`, and CCNeRF's factor lists in their state-dict form
    ({'vd_U_0': {'0': ..., '1': ..., '2': ...}} -> 'vd_U_0.0', ...)."""
    return _flatten(params.get("params", params), "", {})


def flax_params_from_ngp_state_dict(state_dict: Mapping, wrap: bool = True) -> dict:
    """The inverse of `ngp_state_dict_from_flax` (every model's names):
    {'params': {...}} with numpy leaves, or the bare tree with
    `wrap=False` (CCNeRF's parameters, a plain dict in the JAX package)."""
    tree: dict = {}
    for key, value in state_dict.items():
        *path, name = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[name] = value.detach().cpu().numpy().copy()
    return {"params": tree} if wrap else tree


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


def adam_state_to_flax(optimizer: torch.optim.Adam, model: torch.nn.Module,
                       wrap: bool = True):
    """The inverse of `load_adam_state`: (`count`, `mu`, `nu`), the moments
    as flax-shaped trees of numpy arrays ({'params': {...}}, or the bare
    tree with `wrap=False`); zeros before the first step."""
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
    return (count, flax_params_from_ngp_state_dict(mu, wrap),
            flax_params_from_ngp_state_dict(nu, wrap))


def optax_adam_state_dict(optimizer: torch.optim.Adam, model: torch.nn.Module) -> dict:
    """The flax state dict of the JAX trainers' optimizer state, optax
    `adam` over `exponential_decay` (`tngp/train/trainer.py:51-59`, and the
    SDF trainer's staircase schedule, `tngp/train/sdf_trainer.py:49-58`):
    the chain's first state is scale_by_adam's (count, mu, nu), its second
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


CC_GROUPS = ("U", "S")  # optax multi_transform labels of CCNeRF's Adam


def cc_group(name: str) -> str:
    """The label of a CCNeRF parameter (`tngp/train/cc_trainer.py:57-59`):
    "S" for the projections `{kind}_S_{g}`, "U" for the factors."""
    return "S" if "_S_" in name else "U"


def _masked(tree: Mapping, group: str) -> dict:
    """`tree` with the entries of the other group replaced by optax's
    `MaskedNode`, whose state dict is {} (a factor list: one {} a factor)."""
    out = {}
    for key, value in tree.items():
        if cc_group(key) == group:
            out[key] = value
        else:
            out[key] = {k: {} for k in value} if isinstance(value, Mapping) else {}
    return out


def optax_cc_adam_state_dict(optimizer: torch.optim.Adam, model: torch.nn.Module) -> dict:
    """The flax state dict of the CCNeRF trainer's optimizer state: optax
    `multi_transform` of two Adams ("U" the factors, "S" the projections,
    `tngp/train/cc_trainer.py:57-71`), each a chain of scale_by_adam (count,
    mu, nu over the whole tree, the other group's entries masked) and its
    schedule's count.  `optimizer` is one `torch.optim.Adam` with a group
    each; every count is the step count."""
    count, mu, nu = adam_state_to_flax(optimizer, model, wrap=False)
    inner = {}
    for g in CC_GROUPS:
        c = np.asarray(count, np.int32)
        inner[g] = {"inner_state": {"0": {"count": c, "mu": _masked(mu, g),
                                          "nu": _masked(nu, g)},
                                    "1": {"count": c.copy()}}}
    return {"inner_states": inner}


def load_optax_cc_adam_state(optimizer: torch.optim.Adam, model: torch.nn.Module,
                             state: Mapping) -> int:
    """Put `optax_cc_adam_state_dict`'s layout into `optimizer`: each
    parameter's moments from its own group.  Returns the step count."""
    mu, nu = {}, {}
    for g in CC_GROUPS:
        st = state["inner_states"][g]["inner_state"]["0"]
        for key in st["mu"]:
            if cc_group(key) == g:
                mu[key], nu[key] = st["mu"][key], st["nu"][key]
    count = int(np.asarray(state["inner_states"]["U"]["inner_state"]["0"]["count"]))
    load_adam_state(optimizer, model, count, mu, nu)
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
