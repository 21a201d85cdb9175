"""TensoRF trainer — the port of `tngp/train/tensorf_trainer.py`
`TensoRFTrainer`: the occupancy-grid training render (`render_rays_train`,
the `march_dense` branch with the dilated chunk grid) with the ray-masked
MSE plus `l1_reg_weight` times the mean |.| of the density factors, at one
sample budget (no tiers) and without error-map updates, as the JAX step.

At each of `upsample_model_steps` (checked before the grid update of that
step, `before_step`): the factors are cropped to the box of the coarsest
cascade's cells above min(density_thresh, mean density) (`shrink_params`),
the resolution for the next of the log-spaced `upsample_resolutions` is
taken from that box's voxel size, the factors are resized to it
(`upsample_params`), and the optimizer, its schedule, the EMA and the
frame renderers start afresh (`Trainer.set_model`).  The resolution and
box go into each checkpoint's sidecar, so that a resume across an upsample
rebuilds the module to the checkpoint's shape before reading its arrays.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..data.provider import NeRFDataset
from ..models.tensorf import (
    TensoRFNetwork,
    l1_density_loss,
    load_numpy_state,
    numpy_state,
    shrink_params,
    upsample_params,
)
from ..render.renderer import RenderConfig
from ..utils.config import TrainConfig
from ..utils.profiling import span
from .trainer import Trainer


def upsample_resolutions(res0: int, resolution1: int, n_steps: int) -> list[int]:
    """The resolutions of the upsamples: log-spaced from res0 to
    resolution1, rounded, res0 left out (`tngp/train/tensorf_trainer.py:
    53-58`)."""
    r = np.round(np.exp(np.linspace(np.log(res0), np.log(resolution1), n_steps + 1)))
    return r.astype(np.int32).tolist()[1:]


class TensoRFTrainer(Trainer):
    adaptive_tiers = False  # the JAX TensoRF step runs at one budget
    error_map_step = False  # and ignores the error map
    eval_tag = "tensorf eval"

    def __init__(
        self,
        model: TensoRFNetwork,
        dataset: NeRFDataset,
        cfg: RenderConfig,
        tc: TrainConfig,
        valid_dataset: Optional[NeRFDataset] = None,
        l1_reg_weight: float = 1e-4,
        upsample_model_steps: Sequence[int] = (2000, 3000, 4000, 5500, 7000),
        resolution1: int = 300,
        device="cuda",
    ):
        self.l1_reg_weight = l1_reg_weight
        self.upsample_model_steps = list(upsample_model_steps)
        self.upsample_resolutions = upsample_resolutions(
            model.resolution[0], resolution1, len(self.upsample_model_steps))
        self.upsamples: list[dict] = []  # one record per upsample done here
        super().__init__(model, dataset, cfg, tc, valid_dataset=valid_dataset, device=device)

    def loss_on_batch(self, batch):
        """The base step's ray-masked MSE plus the L1 density term."""
        loss, npts, kept = super().loss_on_batch(batch)
        with span("tngp.train.loss"):
            loss = loss + self.l1_reg_weight * l1_density_loss(self.model)
        return loss, npts, kept

    def before_step(self):
        """Shrink then upsample at the milestones (module docstring)."""
        if self.global_step not in self.upsample_model_steps:
            return
        with span("tngp.train.upsample"):
            self._upsample()

    def _upsample(self):
        """The shrink and upsample of the milestone at this step."""
        i = self.upsample_model_steps.index(self.global_step)
        old_res = tuple(self.model.resolution)
        thresh = min(self.cfg.density_thresh, float(self.grid.mean_density))
        self.host_reads += 1
        params, model = shrink_params(
            numpy_state(self.model), self.model,
            self.grid.density_grid[-1].cpu().numpy(), self.cfg.grid_size, thresh)
        shrunk_res = tuple(model.resolution)
        # the voxel size of the (possibly shrunk) box (utils.py:112-118)
        n_vox = self.upsample_resolutions[i] ** 3
        aabb = np.asarray(model.aabb or (-model.bound,) * 3 + (model.bound,) * 3)
        vox = np.cbrt(np.prod(aabb[3:] - aabb[:3]) / n_vox)
        new_res = tuple(int(v) for v in ((aabb[3:] - aabb[:3]) / vox).astype(np.int32))
        self.log(f"[tensorf] upsample at step {self.global_step}: {old_res} -> shrunk "
                 f"{shrunk_res} -> {new_res} (aabb {aabb.round(3).tolist()})")
        new_model = model.clone(resolution=new_res)
        load_numpy_state(new_model, upsample_params(params, new_res))
        self.set_model(new_model)
        self.upsamples.append(dict(step=self.global_step, old=old_res, shrunk=shrunk_res,
                                   new=new_res, aabb=aabb.tolist(), thresh=thresh))

    # ------------------------------------------------------ shape-aware resume
    def _geometry(self):
        return {
            "resolution": [int(r) for r in self.model.resolution],
            "aabb": [float(a) for a in self.model.aabb] if self.model.aabb else None,
        }

    def _rebuild_to_geometry(self, geometry):
        """Rebuild the module (freshly initialised), its optimizer and EMA to
        the checkpoint's resolution and box before its arrays are read."""
        res = tuple(int(r) for r in geometry.get("resolution", self.model.resolution))
        aabb = tuple(float(a) for a in geometry["aabb"]) if geometry.get("aabb") else ()
        if tuple(self.model.resolution) == res and tuple(self.model.aabb or ()) == aabb:
            return
        self.log(f"[tensorf resume] rebuilding to the checkpoint's geometry res={res} "
                 f"aabb={aabb}")
        self.set_model(self.model.clone(resolution=res, aabb=aabb))
