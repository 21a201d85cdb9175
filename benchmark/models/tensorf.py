"""The program under test for configurations of arch "tensorf": the port's
`TensoRFNetwork` under its `TensoRFTrainer`, built from the configuration
file."""

from __future__ import annotations

import contextlib

import torch

from .hooks import copy_weights, leaves, render_config, train_config, train_dataset


def build_trainer(cfg: dict, data, num_rays: int, weights: dict, seed: int, device,
                  **render_over):
    """A `TensoRFTrainer` of the configuration on `data` (poses,
    intrinsics, images; the first `n_val` views held out) at resolution0,
    its weights copied from `weights` (the benchmark's, drawn from the
    seed), shrinking and upsampling at the configuration's milestones."""
    from tngp_torch.models import TensoRFNetwork
    from tngp_torch.train import TensoRFTrainer

    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["precision"]["mlp"]]
    model = TensoRFNetwork(
        resolution=(cfg["resolution0"],) * 3, sigma_rank=tuple(cfg["sigma_rank"]),
        color_rank=tuple(cfg["color_rank"]), color_feat_dim=cfg["color_feat_dim"],
        num_layers=cfg["num_layers"], hidden_dim=cfg["hidden_dim"], bound=cfg["bound"],
        decomposition=cfg["decomposition"], compute_dtype=dtype, device=device)
    copy_weights(model, weights)
    return TensoRFTrainer(model, train_dataset(cfg, data), render_config(cfg, **render_over),
                          train_config(cfg, num_rays, seed),
                          l1_reg_weight=cfg["l1_reg_weight"],
                          upsample_model_steps=tuple(cfg["upsample_model_steps"]),
                          resolution1=cfg["resolution1"], device=device)


def tiny(cfg: dict) -> None:
    """Cut the configuration to a size the CPU runs in seconds, for the
    harness's tests: low resolutions and ranks, a narrow MLP, the upsamples
    inside a tiny mix's set-up."""
    cfg.update(resolution0=16, resolution1=24, sigma_rank=[4, 4, 4], color_rank=[8, 8, 8],
               color_feat_dim=6, hidden_dim=16, upsample_model_steps=[4, 6])


def _geometry(trainer) -> dict:
    return {"weights": {k: p.detach().clone() for k, p in leaves(trainer).items()},
            "resolution": [int(r) for r in trainer.model.resolution],
            "aabb": [float(a) for a in trainer.model.aabb] or None}


@contextlib.contextmanager
def watch_stage(trainer):
    """Inside: the trainer's last upsample is recorded in the yielded dict:
    `before` (weights, resolution, box) and the density grid it shrinks
    by, `after` the same once it is done, and which milestone it was;
    `before_step` runs unchanged."""
    seen: dict = {}
    last = trainer.upsample_model_steps[-1]

    def before_step():
        if trainer.global_step != last:
            return type(trainer).before_step(trainer)
        seen.update(before=_geometry(trainer), density_grid=trainer.grid.density_grid[-1].clone(),
                    milestone=len(trainer.upsample_model_steps) - 1)
        type(trainer).before_step(trainer)
        seen["after"] = _geometry(trainer)

    trainer.before_step = before_step
    try:
        yield seen
    finally:
        del trainer.before_step
