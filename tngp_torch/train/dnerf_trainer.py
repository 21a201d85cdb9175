"""D-NeRF trainer — the port of `tngp/train/dnerf_trainer.py`
`DNeRFTrainer`, model-generic as the JAX trainer: `DNeRFNetwork` and the
`--basis` / `--hyper` variants (`DNeRFBasisNetwork`, `DNeRFHyperNetwork`).
Each step renders at its frame's time through that time's slice of the
time-extended occupancy grid; only the deformation-field model adds
`deform_reg * mean|dx|` to the loss (the variants return no deform), and a
model with a background model (`bg_radius > 0`) renders its background.

The frame, its time and its bitfield slice are picked on the host (the frame
index from the trainer's numpy generator), so a step makes no host sync.
The time grid is updated every `update_interval` steps, with every cell of
every slice queried while fewer than 16 updates have run (a host counter,
not a read of `iter_density`).  `create_time` replaces the base grid, so no
cell is marked untrained, as in the JAX package.

Where the JAX step rebuilds the dilated chunk grid of its slice inside every
step, this trainer builds the T slices' dilated grids at each grid update and
picks one per step: the same function of the same bitfield.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..data.provider import NeRFDataset
from ..models.dnerf import DNeRFNetwork
from ..render.occupancy import create_time, time_slice_index, update_time_density_grid
from ..render.renderer import FieldFns, RenderConfig, dilated_chunk_grid, render_rays_train
from ..utils.config import TrainConfig
from .trainer import Trainer, masked_mse


class DNeRFTrainer(Trainer):
    adaptive_tiers = False  # the JAX package runs subclass steps at one budget
    error_map_step = False  # the JAX D-NeRF step ignores the error map
    eval_tag = "dnerf eval"

    def __init__(
        self,
        model: torch.nn.Module,  # DNeRFNetwork, DNeRFBasisNetwork or DNeRFHyperNetwork
        dataset: NeRFDataset,
        cfg: RenderConfig,
        tc: TrainConfig,
        valid_dataset: Optional[NeRFDataset] = None,
        time_size: int = 64,
        deform_reg: float = 1e-3,
        update_interval: int = 100,
        device="cuda",
    ):
        if dataset.times is None:
            raise ValueError("D-NeRF needs per-frame times")
        self.time_size = time_size
        self.deform_reg = deform_reg
        self.times = [float(t) for t in dataset.times]  # host: a step reads no tensor
        super().__init__(model, dataset, cfg, tc, valid_dataset=valid_dataset,
                         field=self.field_at_time(model, 0.0), device=device)
        self.update_interval = update_interval

    @staticmethod
    def field_at_time(model, t: float, with_aux: bool = False) -> FieldFns:
        """The field at time `t`, with the model's background model when
        its `bg_radius` > 0.  `with_aux` adds the deformation-field model's
        per-sample mean |dx| as an auxiliary output (`render_rays_train`
        averages it); the variants have none."""
        with_aux = with_aux and isinstance(model, DNeRFNetwork)

        def sigma_rgb(p, x_cf, d_cf):
            sigma, rgb, deform = model.sigma_rgb_cf(x_cf, d_cf, t)
            if with_aux:
                return sigma, rgb, {"deform_abs": deform.abs().mean(dim=0)}
            return sigma, rgb

        bg = None
        if getattr(model, "bg_radius", -1.0) > 0 and hasattr(model, "background_cf"):
            bg = lambda p, sph_cf, d_cf: model.background_cf(sph_cf, d_cf)  # noqa: E731
        return FieldFns(sigma_rgb=sigma_rgb,
                        density=lambda p, x_cf: model.density_cf(x_cf, t)["sigma"],
                        background=bg)

    # ------------------------------------------------------------------ grid
    def make_grid(self):
        cfg = self.cfg
        return create_time(self.time_size, cfg.cascades, cfg.grid_size, device=self.device)

    def set_grid(self, grid):
        """Install a time grid and build each slice's dilated chunk grid (the
        only place they are built)."""
        self.grid = grid
        self._dgrids = [dilated_chunk_grid(grid.bitfield[s], self.cfg)
                        for s in range(grid.bitfield.shape[0])]

    def update_grid(self):
        cfg, model = self.cfg, self.model
        self.set_grid(update_time_density_grid(
            self.grid, None, self.gen, self.host_rng,
            density_fn=lambda p, x_cf, t: model.density_cf(x_cf, t)["sigma"],
            bound=cfg.bound, grid_size=cfg.grid_size, density_thresh=cfg.density_thresh,
            full=self._grid_updates < self.full_grid_updates,
        ))
        self._grid_updates += 1

    # ------------------------------------------------------------------ step
    def sample_batch(self):
        batch = super().sample_batch()
        t = self.times[batch["frame"]]
        batch["time"] = t
        batch["slice"] = time_slice_index(t, self.time_size)
        return batch

    def loss_on_batch(self, batch):
        """Render the batch at its time through its slice; ray-masked MSE,
        plus `deform_reg` times the mean |dx| over the selected samples for
        the deformation-field model."""
        s = batch["slice"]
        out = render_rays_train(
            self.field_at_time(self.model, batch["time"], with_aux=True), None,
            batch["rays_o"], batch["rays_d"], self.grid.bitfield[s],
            self._tier_cfgs[self._tier], noise=batch["noise"], bg_color=batch["bg"],
            dilated_grid=self._dgrids[s],
        )
        loss, kept = masked_mse(out["image"], batch["gt_rgb"], out["ray_mask"])
        if "aux" in out:
            loss = loss + self.deform_reg * out["aux"]["deform_abs"]
        return loss, out["num_points"], kept

    # ------------------------------------------------------------------ eval
    def render_image(self, pose, intrinsics=None, use_ema: bool = True,
                     chunk: int = 4096, bg_color=None, time: float = 0.0, W=None, H=None):
        """`Trainer.render_image` at `time`, through that time's slice."""
        s = time_slice_index(time, self.time_size)
        return self._render_frame(pose, intrinsics, use_ema, chunk, bg_color, W, H,
                                  self.field_at_time(self.model, float(time)),
                                  self.grid.bitfield[s], self._dgrids[s])

    def _render_view(self, dataset: NeRFDataset, i: int):
        """View i of `dataset` at its own time."""
        t = float(dataset.times[i]) if dataset.times is not None else 0.0
        return self.render_image(dataset.poses[i], time=t)
