"""CCNeRF trainer — the port of `tngp/train/cc_trainer.py` `CCTrainer`:
rank-residual training.  A step samples its rays, finds their near/far on
the box, marches the `[N, K]` slab (`ops/march.py` `march_rays`, K =
`cfg.K` slots), queries the field with `residual=True` (the `cc_cfg.K`
cumulative group prefixes: sigmas [Kc, N*K], colours [Kc, 3, N*K]),
composites each prefix against the background (random for RGBA targets,
else white) with `composite_rays_cf`, and takes the mean squared error over
the prefixes and rays.  Adam with two parameter groups (the factors U at
`lr1`, the projections S at `lr2`; betas (0.9, 0.99), eps 1e-15), each
decayed as `optax.exponential_decay(lr, iters, 0.1)` — with no end value,
so the decay goes on past `iters` — and the per-step EMA.  The step marches
the slab, which reads no dilated chunk grid; the eval renders the full
(non-residual) field through the frame renderer, which does.

Checkpoints are the JAX package's: the parameter dict without a 'params'
level, the optimizer state as optax's `multi_transform` (`convert.py`
`optax_cc_adam_state_dict`), and the ranks in the sidecar's geometry.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..convert import (
    cc_group,
    flax_params_from_ngp_state_dict,
    load_optax_cc_adam_state,
    optax_cc_adam_state_dict,
)
from ..data.provider import NeRFDataset
from ..models.ccnerf import CCConfig, CCNeRF
from ..ops.composite import composite_rays_cf
from ..ops.march import march_rays
from ..ops.rays import near_far_from_aabb
from ..render.renderer import RenderConfig
from ..utils.config import TrainConfig
from .trainer import Trainer


class CCTrainer(Trainer):
    adaptive_tiers = False  # the JAX CC step runs at one budget
    error_map_step = False  # and ignores the error map
    eval_tag = "ccnerf eval"

    def __init__(
        self,
        cc_cfg: CCConfig,
        dataset: NeRFDataset,
        cfg: RenderConfig,
        tc: TrainConfig,
        valid_dataset: Optional[NeRFDataset] = None,
        lr1: float = 2e-2,
        lr2: float = 1e-3,
        device="cuda",
        model: Optional[CCNeRF] = None,  # default: CCNeRF(cc_cfg) seeded with tc.seed
    ):
        self.cc_cfg = cc_cfg
        self.lr1, self.lr2 = lr1, lr2
        if model is None:
            model = CCNeRF(cc_cfg, device=device, seed=tc.seed)
        super().__init__(model, dataset, cfg, tc, valid_dataset=valid_dataset, device=device)

    def make_optimizer(self):
        named = list(self.model.named_parameters())
        groups = [{"params": [p for n, p in named if cc_group(n) == g], "lr": lr}
                  for g, lr in (("U", self.lr1), ("S", self.lr2))]
        opt = torch.optim.Adam(groups, betas=(0.9, 0.99), eps=1e-15)
        iters = self.tc.iters
        sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda step: 0.1 ** (step / iters))
        return opt, sched

    # ------------------------------------------------------------------ step
    def random_bg(self) -> bool:
        """RGBA targets always go over a random background here, as the JAX
        CC step draws one whatever `bg_radius` says."""
        return self.channels == 4

    def loss_on_batch(self, batch):
        """Mean over the cc_cfg.K prefixes of the rays' squared errors (each
        prefix's mean goes into the batch as `prefix_losses`).  Returns
        (loss, occupied rungs found, rays)."""
        cfg, Kc = self.cfg, self.cc_cfg.K
        o, d = batch["rays_o"], batch["rays_d"]
        N = o.shape[0]
        nears, fars = near_far_from_aabb(o, d, cfg.aabb, cfg.min_near)
        with torch.no_grad():  # integer selection: nothing to differentiate
            res = march_rays(o, d, nears, fars, self.grid.bitfield, bound=cfg.bound,
                             cascades=cfg.cascades, grid_size=cfg.grid_size,
                             dt_gamma=cfg.dt_gamma, max_steps=cfg.max_steps, K=cfg.K,
                             noise=batch["noise"])
        sig, rgb = self.model.sigma_rgb_cf(res.xyzs_cf.reshape(3, -1),
                                           res.dirs_cf.reshape(3, -1), residual=True)
        sig = sig.reshape(Kc, N, cfg.K) * cfg.density_scale
        rgb = rgb.reshape(Kc, 3, N, cfg.K)
        bg = batch["bg"]
        if bg is None:
            bg = torch.ones((), dtype=torch.float32, device=o.device)
        images = []
        for k in range(Kc):
            ws, _, image, _ = composite_rays_cf(sig[k], rgb[k], res.dts, res.gaps, res.mask,
                                                cfg.T_thresh)
            images.append(image + (1.0 - ws)[:, None] * bg)
        per_prefix = ((torch.stack(images) - batch["gt_rgb"][None]) ** 2).mean(dim=(1, 2))
        batch["prefix_losses"] = per_prefix.detach()
        loss = per_prefix.mean()
        return loss, res.counts.sum(), torch.full((), float(N), device=o.device)

    # ------------------------------------------------------------ checkpoints
    def _params_tree(self, tensors) -> dict:
        return flax_params_from_ngp_state_dict(self._named(tensors), wrap=False)

    def _opt_state_tree(self) -> dict:
        return optax_cc_adam_state_dict(self.optimizer, self.model)

    def _load_opt_state(self, tree) -> int:
        return load_optax_cc_adam_state(self.optimizer, self.model, tree)

    def _geometry(self):
        c = self.cc_cfg
        return {
            "resolution": [int(r) for r in c.resolution],
            "rank_vec_density": list(c.rank_vec_density),
            "rank_mat_density": list(c.rank_mat_density),
            "rank_vec": list(c.rank_vec),
            "rank_mat": list(c.rank_mat),
        }

    def _rebuild_to_geometry(self, geometry):
        """Rebuild the field (freshly initialised), its optimizer and EMA to
        the checkpoint's ranks before its arrays are read."""
        c = self.cc_cfg
        new_cfg = dataclasses.replace(
            c,
            resolution=tuple(int(r) for r in geometry.get("resolution", c.resolution)),
            rank_vec_density=tuple(geometry.get("rank_vec_density", c.rank_vec_density)),
            rank_mat_density=tuple(geometry.get("rank_mat_density", c.rank_mat_density)),
            rank_vec=tuple(geometry.get("rank_vec", c.rank_vec)),
            rank_mat=tuple(geometry.get("rank_mat", c.rank_mat)),
        )
        if new_cfg == c:
            return
        self.log(f"[ccnerf resume] rebuilding to the checkpoint's geometry {geometry}")
        self.cc_cfg = new_cfg
        self.set_model(CCNeRF(new_cfg, device=self.device, seed=self.tc.seed))
