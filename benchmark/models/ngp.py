"""The program under test for configurations of arch "ngp": the port's
`NGPNetwork` under its `Trainer`, built from the configuration file."""

from __future__ import annotations

import torch

from .hooks import copy_weights, render_config, train_config, train_dataset


def build_trainer(cfg: dict, data, num_rays: int, weights: dict, seed: int, device,
                  **render_over):
    """A `Trainer` of the configuration on `data` (poses, intrinsics,
    images; the first `n_val` views held out), its weights copied from
    `weights` (the benchmark's, drawn from the seed)."""
    from tngp_torch.models import NGPNetwork
    from tngp_torch.train import Trainer

    if cfg["desired_resolution"] != int(2048 * cfg["bound"]) or cfg["sh_degree"] != 4:
        raise ValueError("NGPNetwork fixes N_max at 2048 bound and SH degree 4")
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["precision"]["mlp"]]
    model = NGPNetwork(
        bound=cfg["bound"], encoding=cfg["encoding"], num_layers=cfg["num_layers"],
        hidden_dim=cfg["hidden_dim"], geo_feat_dim=cfg["geo_feat_dim"],
        num_layers_color=cfg["num_layers_color"], hidden_dim_color=cfg["hidden_dim_color"],
        log2_hashmap_size=cfg["log2_hashmap_size"], num_levels=cfg["num_levels"],
        level_dim=cfg["level_dim"], base_resolution=cfg["base_resolution"],
        compute_dtype=dtype, device=device)
    copy_weights(model, weights)
    return Trainer(model, train_dataset(cfg, data), render_config(cfg, **render_over),
                   train_config(cfg, num_rays, seed), device=device)


def tiny(cfg: dict) -> None:
    """Cut the configuration to a size the CPU runs in seconds, for the
    harness's tests: fewer levels, a smaller table, narrow MLPs."""
    cfg.update(num_levels=4, log2_hashmap_size=14, hidden_dim=16, hidden_dim_color=16)


# the faults of this arch's trainer that a training driver plants (`plant`)
FAULTS = ["lowest_tier"]


def plant(trainer, faults) -> None:
    """Break the trainer underneath, for the harness's own tests:
    `lowest_tier` pins its sample budget to the lowest tier from its next
    step on."""
    if "lowest_tier" in faults:
        trainer._tier = 0
        trainer._adapt_tier = lambda *a, **k: None
