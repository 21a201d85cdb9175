"""Trainer — the port of `tngp/train/trainer.py` `Trainer`:
per-step Adam(0.9, 0.99, eps 1e-15) with the exponential lr decay to 0.1x
over `iters`, a per-step EMA, the density-grid update and the dilated-grid
rebuild every `update_extra_interval` steps, adaptive sample-budget tiers;
full-image eval through the frame renderer with PSNR, validation images,
test renders as PNG frames, mesh export, and checkpoints in the JAX
package's format with rotation, the best checkpoint and resume.

Images, poses and intrinsics live on the device and every step samples its
own rays there.  A step is eager PyTorch: sample -> march -> field ->
composite -> loss -> backward -> Adam -> EMA.  The sample budget of a tier is
static, so a step makes no host sync; the trainer reads demand from the
device once per grid-update interval (`host_reads` counts those reads), and
losses stay on the device until an epoch ends.  Every render path of the
config runs (`render_rays_train`): the budget tiers only on the
`march_dense` path with 0 < compact_fraction < 1, as the JAX package; the
other paths have one budget and no tier read.

With `use_grid=False` (the CLIs' `--no_grid`) a step renders through the
grid-free uniform + importance-sampled path (`render_rays_uniform`, every
ray kept, num_rays * (num_steps + upsample_steps) samples), with no grid
update and no tiers, and the eval renders that path in chunks.  With
`TrainConfig.error_map` a [frames, 128 * 128] map of per-pixel errors
weights each step's ray draw from its frame's row, and the step writes
0.1 * old + 0.9 * the ray's error back at the rays' coarse pixels, where
the ray kept all its samples (a budget-dropped ray keeps its old entry).
`profile_dir` profiles the first epoch (`utils/profiling.py`), and each
epoch's loss and it/s go to TensorBoard under `<workspace>/run/<name>`
where `tensorboardX` or `torch.utils.tensorboard` imports.

Subclasses (`DNeRFTrainer`, `TensoRFTrainer`, `CCTrainer`) override the
hooks `make_grid`, `set_grid`, `update_grid`, `sample_batch`,
`loss_on_batch`, `render_image`, `before_step` (called first in every step
of `run_steps`), `make_optimizer`, and the checkpoint's `_params_tree`,
`_opt_state_tree`, `_load_opt_state`, `_geometry` and
`_rebuild_to_geometry` (the sidecar's model shape, read before the arrays,
as `tngp/train/trainer.py:669-679,689-695`); `set_model` installs a module
of a new shape with a fresh optimizer, EMA and frame renderers.  They set
`update_interval`, and run without budget tiers (`adaptive_tiers = False`)
and without error-map updates (`error_map_step = False`), as the JAX
package gives tiers and the map's update to the base step only.

Data parallelism (`mesh=`, a `parallel.make_mesh()` over the process
group; the base trainer only, as the JAX package's subclasses pass none):
every rank draws the same global ray batch from the same seeded generators
and takes its 'data' slice (`ray_sharding`); the sample budgets are per
rank (M_local = tier fraction x N_local x K, `mesh.py`'s multi-chip
semantics); the masked mean divides by the all-reduced count of kept rays,
so that the loss is the global mean, and the gradients are summed over the
ranks in one flat all-reduce before Adam, so that the parameters stay
equal on every rank.  The tier read all-reduces demand and kept rays (every
rank picks the same tier), rank 0's grid is broadcast after each occupancy
update (a repeated set-scatter index has an unspecified winner), the error
map's update gathers every rank's errors and takes rank 0's row, and only
rank 0 writes checkpoints, logs and TensorBoard.  The table stays
replicated, `shard_table` or not (`parallel/mesh.py`).  Under NCCL a step
makes no host sync.  Without a mesh the trainer runs the same code on
`parallel.mesh.SINGLE`, one rank without collectives, and the step is the
one it was before data parallelism.

CLIP guidance (`clip_embedder=`, with `TrainConfig.rand_pose` > 0 and
`clip_text`): every `rand_pose`-th step (after that step's grid update)
is a CLIP step instead of a photometric one: a square render of a random
orbit pose, its image embedded, -cos(image, text) minimised with one Adam
step (no EMA, no grid update) and `train/clip_loss` logged
(`run_clip_step`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from ..convert import (
    flax_params_from_ngp_state_dict,
    load_optax_adam_state,
    ngp_state_dict_from_flax,
    occupancy_grid_from_arrays,
    occupancy_grid_state_dict,
    optax_adam_state_dict,
)
from ..data.provider import NeRFDataset, rand_poses
from ..data.rays import full_image_rays, sample_rays
from ..parallel.mesh import SINGLE, all_reduce_flat, ray_sharding, shard_params
from ..render.frame_eval import FrameRenderer
from ..render.occupancy import create as create_grid
from ..render.occupancy import mark_untrained_grid, update_density_grid
from ..render.renderer import (
    FieldFns,
    RenderConfig,
    dilated_chunk_grid,
    render_rays_eval,
    render_rays_train,
    render_rays_uniform,
    train_sample_budget,
)
from ..utils.colors import srgb_to_linear
from ..utils.config import TrainConfig
from ..utils.image_io import write_png
from ..utils.profiling import profile_trace, span
from . import checkpoint as ckpt_io
from .ema import ema_init, ema_update
from .metrics import PSNRMeter


def make_optimizer(params, tc: TrainConfig, constant_lr: bool = False):
    """Adam(0.9, 0.99, eps 1e-15) and its schedule: lr * 0.1 ** min(step /
    iters, 1), the step counted from 0.  Returns (optimizer, scheduler);
    `constant_lr=True` gives no scheduler (a fixed-lr benchmark loop)."""
    opt = torch.optim.Adam(list(params), lr=tc.lr, betas=(0.9, 0.99), eps=1e-15)
    if constant_lr:
        return opt, None
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: 0.1 ** min(step / tc.iters, 1.0))
    return opt, sched


def masked_mse(image: torch.Tensor, gt_rgb: torch.Tensor, ray_mask: torch.Tensor):
    """Mean over kept rays of the per-ray mean squared error.  Returns
    (loss, number of kept rays)."""
    return masked_mean(((image - gt_rgb) ** 2).mean(dim=-1), ray_mask)


def masked_mean(per_ray: torch.Tensor, ray_mask: torch.Tensor, mesh=SINGLE):
    """(mean of `per_ray` over the kept rays of every rank of `mesh`, this
    rank's number of kept rays).  Under a mesh each rank's term is its own
    rays' sum over the all-reduced count, so that the terms sum to the
    global mean."""
    rm = ray_mask.float()
    kept = rm.sum()
    kept_all = mesh.all_reduce(kept.detach().reshape(1).clone())[0] / mesh.n_model
    return (per_ray * rm).sum() / torch.clamp(kept_all, min=1.0), kept


@torch.no_grad()
def update_error_map(error_map: torch.Tensor, frame: int, inds_coarse: torch.Tensor,
                     per_ray: torch.Tensor, ray_mask: torch.Tensor) -> None:
    """The error map's update, in place: at each ray's coarse pixel of row
    `frame`, 0.1 * old + 0.9 * the ray's error where the ray kept all its
    samples, else the old entry.  A pixel named by several rays gets one of
    their values (which one is unspecified, as in XLA's scatter)."""
    row = error_map[frame]
    old = row[inds_coarse]
    row[inds_coarse] = torch.where(ray_mask > 0, 0.1 * old + 0.9 * per_ray, old)


def _summary_writer(logdir: str):
    """A TensorBoard writer into `logdir`, or None where neither
    `tensorboardX` nor `torch.utils.tensorboard` imports."""
    for mod in ("tensorboardX", "torch.utils.tensorboard"):
        try:
            return __import__(mod, fromlist=["SummaryWriter"]).SummaryWriter(logdir)
        except Exception:
            continue
    return None


class Trainer:
    """Occupancy-grid NeRF trainer over an `nn.Module` field."""

    adaptive_tiers = True  # budget tiers for this step (the base NGP step only)
    error_map_step = True  # the step samples by and updates the error map
    eval_tag = "eval"  # the tag of evaluate's log line

    def __init__(
        self,
        model: torch.nn.Module,
        dataset: NeRFDataset,
        cfg: RenderConfig,
        tc: TrainConfig,
        valid_dataset: Optional[NeRFDataset] = None,
        field: Optional[FieldFns] = None,
        device="cuda",
        constant_lr: bool = False,  # fixed lr, as a benchmark loop wants
        full_grid_updates: int = 16,  # the first updates query every cell
        use_grid: bool = True,  # False: the grid-free uniform path
        mesh=None,  # parallel.Mesh: data parallelism over the process group
        shard_table: bool = False,  # accepted; the table stays replicated
        clip_embedder=None,  # image / text embedder of the CLIP step
    ):
        # ray and pose arithmetic stays true f32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.use_grid = use_grid
        self.mesh = mesh = mesh if mesh is not None else SINGLE
        if tc.num_rays % mesh.n_data:
            raise ValueError(f"num_rays {tc.num_rays} does not split over {mesh.n_data} data "
                             "ranks")
        self.device = torch.device(device)
        self.cfg = cfg
        self.tc = tc
        self.constant_lr = constant_lr
        self.dataset = dataset
        self.valid_dataset = valid_dataset
        self.full_grid_updates = full_grid_updates
        self.gen = torch.Generator(device=self.device).manual_seed(tc.seed)
        self.host_rng = np.random.default_rng(tc.seed)  # frame choice

        # device-resident data
        images = dataset.images
        if tc.color_space == "linear":
            images = np.array(images, np.float32)
            images[..., :3] = srgb_to_linear(images[..., :3])
        self.images = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        self.poses = torch.as_tensor(dataset.poses, dtype=torch.float32, device=self.device)
        self.intrinsics = torch.as_tensor(dataset.intrinsics, dtype=torch.float32,
                                          device=self.device)
        self.H, self.W = dataset.H, dataset.W
        self.n_frames = dataset.num_frames
        self.channels = int(self.images.shape[-1])
        self.error_map = (
            torch.ones((self.n_frames, 128 * 128), dtype=torch.float32, device=self.device)
            if tc.error_map else None)

        # model / params / optimizer / ema / grid
        self.set_model(model, field)
        self._grid_updates = 0  # host copy of grid.iter_density
        self.update_interval = tc.update_extra_interval  # grid update cadence (steps)
        self.set_grid(self.make_grid())

        self.epoch = 0
        self.global_step = 0
        self.host_reads = 0  # device -> host reads the trainer made
        self.stats = {"loss": [], "results": [], "best_result": None}
        self.last_render_stats: dict = {}
        self.last_render_cut = None  # [H, W] rays the last render's round cap left alive
        # the log file, written once the workspace exists (the CLI makes it)
        self.log_path = os.path.join(tc.workspace, f"log_{tc.name}.txt")
        self.writer = None  # TensorBoard's, made at the first scalar (`log_scalars`)

        # adaptive sample-budget tiers: fractions of the configured one, an
        # overdrive tier above it, each with its static sample budget; only
        # the march_dense step with a global budget has them
        f = cfg.compact_fraction
        fracs = [f]
        if (tc.adaptive_budget and self.adaptive_tiers and use_grid and cfg.march_dense
                and 0.0 < f < 1.0):
            fracs = [f / 4.0, f / 2.0, f]
            f_over = min(2.0 * f, 0.9)
            if tc.adaptive_overdrive and f_over > f:
                fracs.append(f_over)
        self._tier_cfgs = [dataclasses.replace(cfg, compact_fraction=tf) for tf in fracs]
        self._tier_M = [train_sample_budget(self.n_rays_local, c) for c in self._tier_cfgs]
        self._tier = fracs.index(f)  # start at the configured fraction

        # the CLIP step's text embedding (tngp/train/trainer.py:192-201)
        self.clip_embedder = clip_embedder
        self._clip_text_feat = None
        if tc.rand_pose > 0 and clip_embedder is not None:
            if not tc.clip_text:
                raise ValueError("--rand_pose > 0 needs --clip_text")
            self._clip_text_feat = torch.as_tensor(
                np.asarray(clip_embedder.embed_text(tc.clip_text), np.float32),
                device=self.device)

        if tc.use_checkpoint == "latest":
            path = ckpt_io.latest_checkpoint(tc.workspace, tc.name)
            if path:
                self.load_checkpoint(path)

    @property
    def n_rays_local(self) -> int:
        """Rays of this rank's slice of a step's batch (all of them without
        a mesh)."""
        return self.tc.num_rays // self.mesh.n_data

    @property
    def primary(self) -> bool:
        """Whether this process writes logs, checkpoints and TensorBoard."""
        return self.mesh.rank == 0

    # ------------------------------------------------------------------ logging
    def log(self, msg: str):
        if not self.primary:
            return
        print(msg, flush=True)
        if os.path.isdir(self.tc.workspace):
            with open(self.log_path, "a") as f:
                f.write(msg + "\n")

    def log_scalars(self, **scalars):
        """TensorBoard scalars `train/<name>` at the current step, once the
        workspace exists (the writer is made at the first call there, and
        is False where neither library imports); rank 0's only."""
        if not self.primary:
            return
        if self.writer is None and os.path.isdir(self.tc.workspace):
            self.writer = _summary_writer(
                os.path.join(self.tc.workspace, "run", self.tc.name)) or False
        if self.writer:
            for name, value in scalars.items():
                self.writer.add_scalar(f"train/{name}", value, self.global_step)

    def make_optimizer(self):
        """(optimizer, scheduler) over `self.params`: `make_optimizer`'s Adam
        and schedule (a subclass with other groups or schedules overrides
        this)."""
        return make_optimizer(self.params, self.tc, self.constant_lr)

    def set_model(self, model: torch.nn.Module, field: Optional[FieldFns] = None):
        """Install `model` (at construction, and after a change of shape):
        its field (`FieldFns.from_model` unless given), the parameter list,
        a fresh optimizer and schedule, an EMA of copies of its weights, and
        no cached frame renderer (they hold the old field).  Under a mesh
        every rank takes rank 0's weights first."""
        self.model = model.to(self.device)
        self.field = field if field is not None else FieldFns.from_model(self.model)
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        shard_params(self.params, self.mesh)
        self.optimizer, self.scheduler = self.make_optimizer()
        self.ema_params = ema_init(self.params)
        self._frame_renderers: dict = {}  # (chunk, cfg) -> FrameRenderer

    def set_cfg(self, cfg: RenderConfig):
        """Replace the render config (the viewer's dt_gamma / max_steps
        controls): the tiers' configs and budgets and the dilated chunk
        grids are rebuilt from it; frame renderers are cached per cfg, so
        the next frame renders with it."""
        fracs = [c.compact_fraction for c in self._tier_cfgs]
        self.cfg = cfg
        self._tier_cfgs = [dataclasses.replace(cfg, compact_fraction=f) for f in fracs]
        self._tier_M = [train_sample_budget(self.n_rays_local, c) for c in self._tier_cfgs]
        self.set_grid(self.grid)

    @property
    def tier_M(self) -> int:
        """The sample budget of the current tier."""
        return self._tier_M[self._tier]

    # --------------------------------------------------------------- train step
    @property
    def uses_error_map(self) -> bool:
        return self.error_map is not None and self.error_map_step

    def sample_batch(self):
        """One step's rays, targets, march noise and background, drawn on the
        device (the frame index on the host, from a numpy generator: no
        tensor is read back).  Returns dict(frame, rays_o, rays_d, gt_rgb,
        noise, bg), `frame` the host index; with the error map the rays are
        drawn by the frame's row and `inds_coarse` holds their coarse
        pixels; on the grid-free path `perturb` [N, num_steps] and `u` [N,
        upsample_steps] replace `noise`."""
        N = self.tc.num_rays
        idx = int(self.host_rng.integers(self.n_frames))
        r = sample_rays(self.poses[idx], self.intrinsics, self.H, self.W, N,
                        generator=self.gen, patch_size=self.tc.patch_size,
                        error_map=self.error_map[idx] if self.uses_error_map else None)
        gt = self.images[idx].reshape(-1, self.channels)[r["inds"]]  # [N, C]
        extra = {}
        if self.use_grid:
            extra["noise"] = torch.rand((N,), generator=self.gen, device=self.device)
        else:
            for k, S in (("perturb", self.cfg.num_steps), ("u", self.cfg.upsample_steps)):
                extra[k] = torch.rand((N, S), generator=self.gen, device=self.device)
        if "inds_coarse" in r:
            extra["inds_coarse"] = r["inds_coarse"]
        if self.random_bg():
            bg = torch.rand((N, 3), generator=self.gen, device=self.device)
            gt_rgb = gt[:, :3] * gt[:, 3:] + bg * (1.0 - gt[:, 3:])
        else:
            bg = None  # -> 1.0 inside the render
            gt_rgb = gt[:, :3]
        return self._shard_batch({"frame": idx, "rays_o": r["rays_o"], "rays_d": r["rays_d"],
                                  "gt_rgb": gt_rgb, "bg": bg, **extra})

    def _shard_batch(self, batch: dict) -> dict:
        """This rank's slice of every per-ray entry of a global batch (all
        of it on one data rank); the error map's coarse pixels stay global."""
        shard, N = ray_sharding(self.mesh), self.tc.num_rays
        return {k: shard.local(v) if (torch.is_tensor(v) and v.dim() and v.shape[0] == N
                                      and k != "inds_coarse") else v
                for k, v in batch.items()}

    def random_bg(self) -> bool:
        """Whether RGBA targets go over a random background drawn each step
        (the render composites on it): when the field has no background
        model."""
        return self.channels == 4 and self.cfg.bg_radius <= 0

    def loss_on_batch(self, batch):
        """Render the batch at the current tier (or on the grid-free path)
        and return (loss, num_points, kept rays), all on the device, the loss
        with its graph.  With the error map the rays' errors and mask go
        into the batch (`per_ray`, `ray_mask`) for `train_step`'s update."""
        N = batch["rays_o"].shape[0]
        if self.use_grid:
            out = render_rays_train(
                self.field, None, batch["rays_o"], batch["rays_d"], self.grid.bitfield,
                self._tier_cfgs[self._tier], noise=batch["noise"], bg_color=batch["bg"],
                dilated_grid=self._dgrid,
            )
            ray_mask, npts = out["ray_mask"], out["num_points"]
        else:
            cfg = self.cfg
            out = render_rays_uniform(
                self.field, None, batch["rays_o"], batch["rays_d"], cfg,
                num_steps=cfg.num_steps, upsample_steps=cfg.upsample_steps,
                perturb=batch["perturb"], u=batch["u"], bg_color=batch["bg"],
            )
            ray_mask = torch.ones((N,), dtype=torch.bool, device=self.device)
            npts = torch.full((), N * (cfg.num_steps + cfg.upsample_steps),
                              dtype=torch.int32, device=self.device)
        with span("tngp.train.loss"):
            per_ray = ((out["image"] - batch["gt_rgb"]) ** 2).mean(dim=-1)
            loss, kept = masked_mean(per_ray, ray_mask, self.mesh)
        if self.uses_error_map:
            batch["per_ray"], batch["ray_mask"] = per_ray.detach(), ray_mask
        return loss, npts, kept

    def train_step(self, batch=None):
        """One optimiser step with the per-step EMA (and the error map's
        update) on `batch`, sampled here when None.  Returns (loss,
        num_points, kept rays) as device scalars; makes no host sync."""
        with span("tngp.train.step"):
            if batch is None:
                with span("tngp.train.sample"):
                    batch = self.sample_batch()
            loss, npts, kept = self.loss_on_batch(batch)
            with span("tngp.train.optimizer"):
                self.optimizer.zero_grad(set_to_none=True)
            loss = self.backward(loss)
            with span("tngp.train.optimizer"):
                self.optimizer.step()
                if self.scheduler is not None:
                    self.scheduler.step()
            with span("tngp.train.ema"):
                ema_update(self.ema_params, self.params, self.tc.ema_decay)
                if self.uses_error_map:
                    self._update_error_map(batch)
            self.global_step += 1
            return loss, npts, kept

    def backward(self, loss: torch.Tensor, mean: bool = False) -> torch.Tensor:
        """`loss.backward()`; under a mesh each gradient and the loss are then
        summed over the ranks in one flat all-reduce (over the model axis's
        copies of a data slice once; `mean` averages over every rank, for a
        loss that each rank computes whole).  Returns the loss, detached."""
        with span("tngp.train.backward"):
            loss.backward()
            if not self.mesh.group:
                return loss.detach()
            for p in self.params:  # every rank's bucket has every parameter
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            value = loss.detach().reshape(1).clone()
            scale = 1.0 / (self.mesh.world if mean else self.mesh.n_model)
            all_reduce_flat([value, *(p.grad for p in self.params)], self.mesh, scale)
            return value.reshape(())

    def _update_error_map(self, batch) -> None:
        """The error map's update from the step's rays; over several data
        ranks from every rank's rays (gathered with one all-reduce), then
        rank 0's row on every rank (a pixel named twice has an unspecified
        winner)."""
        per_ray, ray_mask = batch["per_ray"], batch["ray_mask"]
        if self.mesh.n_data > 1:
            N = self.tc.num_rays
            a, b = ray_sharding(self.mesh).bounds(N)
            buf = torch.zeros((N, 2), dtype=torch.float32, device=self.device)
            buf[a:b, 0] = per_ray
            buf[a:b, 1] = ray_mask.float()
            self.mesh.all_reduce(buf).div_(self.mesh.n_model)
            per_ray, ray_mask = buf[:, 0], buf[:, 1]
        update_error_map(self.error_map, batch["frame"], batch["inds_coarse"], per_ray, ray_mask)
        if self.mesh.world > 1:
            torch.distributed.broadcast(self.error_map[batch["frame"]], src=0)

    def clip_loss(self) -> torch.Tensor:
        """The CLIP step's loss with its graph (`tngp/train/trainer.py:309-350`):
        a square side x side render (side = max(16, int(sqrt(num_rays)) // 8
        * 8), focal 0.7 side) of the pose `rand_poses(default_rng(global_step),
        1, radius=1.5 bound)` through `render_rays_train` under `cfg`, no
        noise and the default background, its image embedded, and
        -mean(feats @ text_feat)."""
        pose = rand_poses(np.random.default_rng(self.global_step), 1,
                          radius=float(self.cfg.bound) * 1.5)[0]
        side = max(16, int(np.sqrt(self.tc.num_rays)) // 8 * 8)
        intr = torch.tensor([side * 0.7, side * 0.7, side / 2.0, side / 2.0],
                            dtype=torch.float32, device=self.device)
        o, d = full_image_rays(pose, intr, side, side, device=self.device)
        out = render_rays_train(self.field, None, o, d, self.grid.bitfield, self.cfg)
        feats = self.clip_embedder.embed_images(out["image"].reshape(1, side, side, 3))
        return -torch.mean(feats @ self._clip_text_feat)

    def run_clip_step(self) -> float:
        """One CLIP-guided step: `clip_loss`, then one Adam step (and the
        schedule's); the EMA and the grid are left alone.  Returns the loss
        (one host read)."""
        loss = self.clip_loss()
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.backward(loss, mean=True)
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        self.host_reads += 1
        return float(loss)

    def _adapt_tier(self, demand: float, kept_frac: float):
        """Move the budget tier: up as soon as rays get dropped, down when
        demand leaves more than 1.6x headroom below the next tier down."""
        t = self._tier
        if kept_frac < 0.98 and t < len(self._tier_M) - 1:
            t += 1
        elif t > 0 and demand * 1.6 < self._tier_M[t - 1]:
            t -= 1
        if t == self._tier:
            return
        self._tier = t
        self.log(f"[adaptive_budget] step {self.global_step}: tier -> "
                 f"M={self._tier_M[t]} (demand {int(demand)}, kept {kept_frac:.3f})")

    def make_grid(self):
        """The initial grid: cells no training camera sees marked untrained."""
        cfg = self.cfg
        return mark_untrained_grid(
            create_grid(cfg.cascades, cfg.grid_size, device=self.device),
            self.poses, self.intrinsics, bound=cfg.bound, grid_size=cfg.grid_size,
        )

    def set_grid(self, grid):
        """Install an occupancy grid.  The dilated chunk grid of the training
        march changes only with the bitfield: it is rebuilt here and nowhere
        else, never inside a step."""
        self.grid = grid
        self._dgrid = dilated_chunk_grid(grid.bitfield, self.cfg) if self.use_grid else None

    def update_grid(self):
        """One density-grid update from the live field (`run_steps` calls it
        every `update_extra_interval` steps); under a mesh every rank then
        takes rank 0's grid."""
        cfg = self.cfg
        grid = update_density_grid(
            self.grid, None, self.gen, density_fn=self.field.density, bound=cfg.bound,
            grid_size=cfg.grid_size, density_thresh=cfg.density_thresh,
            full=self._grid_updates < self.full_grid_updates,
            density_scale=cfg.density_scale,
        )
        if self.mesh.world > 1:
            for t in (grid.density_grid, grid.bitfield, grid.mean_density, grid.iter_density):
                torch.distributed.broadcast(t, src=0)
        self.set_grid(grid)
        self._grid_updates += 1

    def run_steps(self, steps: int):
        """`steps` train steps with the grid update and the tier read at
        every `update_interval`-th step (none on the grid-free path); with
        CLIP guidance every `rand_pose`-th step is a CLIP step instead.
        Returns (losses, num_points, kept) of the photometric steps as device
        tensors; the only host reads are the tier reads, one per interval
        (all-reduced to the ranks' mean under a mesh), and the CLIP steps'
        losses."""
        losses, pts, kepts = [], [], []
        for _ in range(steps):
            self.before_step()
            if self.use_grid and self.global_step % self.update_interval == 0:
                if len(self._tier_M) > 1 and pts:
                    # one host read per grid-update interval
                    with span("tngp.train.tier_read"):
                        vals = torch.stack([pts[-1].float(), kepts[-1]])
                        self.mesh.all_reduce(vals, mean_over="data")
                        demand, kept = vals.tolist()
                    self.host_reads += 1
                    self._adapt_tier(demand, kept / self.n_rays_local)
                with span("tngp.train.grid_update"):
                    self.update_grid()
            if self._clip_text_feat is not None and self.global_step % self.tc.rand_pose == 0:
                closs = self.run_clip_step()
                self.global_step += 1
                self.log_scalars(clip_loss=closs)
                continue
            loss, npts, kept = self.train_step()
            losses.append(loss)
            pts.append(npts)
            kepts.append(kept)
        if not losses:  # every step was a CLIP step
            empty = torch.zeros((0,), device=self.device)
            return empty, empty.long(), empty
        return torch.stack(losses), torch.stack(pts), torch.stack(kepts)

    def before_step(self):
        """Called first in each step of `run_steps`, before the grid update
        (TensoRF's shrink and upsample)."""

    def train_one_epoch(self, steps: int) -> float:
        """`steps` steps; the first epoch runs under the profiler when
        `profile_dir` is set.  Returns the epoch's mean loss."""
        if self.tc.profile_dir and self.epoch <= 1:
            with profile_trace(self.tc.profile_dir):
                avg = self._train_one_epoch(steps)
            self.log(f"profiler trace written to {self.tc.profile_dir}")
            return avg
        return self._train_one_epoch(steps)

    def _train_one_epoch(self, steps: int) -> float:
        t0 = time.time()
        losses, pts, _ = self.run_steps(steps)
        total_loss, total_pts = torch.stack([losses.sum(), pts.sum().float()]).tolist()
        self.host_reads += 1
        dt = time.time() - t0
        avg = total_loss / steps
        self.stats["loss"].append(avg)
        self.log_scalars(loss=avg, its_per_s=steps / dt)
        self.log(f"[epoch {self.epoch}] loss={avg:.6f} "
                 f"psnr~{-10 * np.log10(max(avg, 1e-12)):.2f} steps={steps} "
                 f"{steps / dt:.1f} it/s pts/step={int(total_pts) // steps}")
        return avg

    def train(self, max_epochs: int):
        """Epochs up to `max_epochs` (or `iters` steps): every
        `eval_interval`-th epoch evaluates the validation set and saves the
        best checkpoint on a new best PSNR; every epoch saves a checkpoint."""
        steps = self.tc.steps_per_epoch or self.n_frames
        for _ in range(self.epoch, max_epochs):
            self.epoch += 1
            self.train_one_epoch(steps)
            if self.epoch % self.tc.eval_interval == 0 and self.valid_dataset is not None:
                result = self.evaluate(self.valid_dataset)
                self.stats["results"].append(result)
                best = self.stats["best_result"]
                if best is None or result > best:
                    self.stats["best_result"] = result
                    self.save_checkpoint(best=True)
            self.save_checkpoint(best=False)
            if self.global_step >= self.tc.iters:
                break

    # ------------------------------------------------------------------- eval
    @contextlib.contextmanager
    def ema_weights(self):
        """The model evaluates with the EMA weights inside this scope."""
        live = [p.data for p in self.params]
        for p, e in zip(self.params, self.ema_params):
            p.data = e
        try:
            yield
        finally:
            for p, d in zip(self.params, live):
                p.data = d

    def _frame_rays(self, pose, intrinsics, W, H):
        """A full frame's rays; W/H override the dataset resolution and the
        intrinsics are rescaled to match.  Returns (rays_o, rays_d, W, H)."""
        intr = self.intrinsics if intrinsics is None else torch.as_tensor(
            intrinsics, dtype=torch.float32, device=self.device)
        if W is None or H is None:
            W, H = self.W, self.H
        elif (W, H) != (self.W, self.H):
            s = torch.tensor([W / self.W, H / self.H, W / self.W, H / self.H],
                             dtype=torch.float32, device=self.device)
            intr = intr * s
        o, d = full_image_rays(pose, intr, H, W, device=self.device)
        return o, d, W, H

    def render_image(self, pose, intrinsics=None, use_ema: bool = True,
                     chunk: int = 4096, bg_color=None, W=None, H=None):
        """Full-image eval render.  With the stream eval and the chunked
        march (the condition of the JAX package's `Trainer.render_image`) it
        goes through the frame renderer (`render/frame_eval.py`), one per
        (chunk, cfg); otherwise through `render_image_chunked`.  W/H override
        the dataset resolution; the intrinsics are rescaled to match.
        Returns (image [H, W, 3], depth [H, W]) as numpy; `last_render_stats`
        holds the frame renderer's `last_stats` and `last_render_cut` its
        `last_cut`."""
        cfg = self.cfg
        if not (self.use_grid and cfg.eval_stream and cfg.march_chunk > 0
                and cfg.max_steps % cfg.march_chunk == 0):
            return self.render_image_chunked(pose, intrinsics, use_ema, chunk, bg_color, W, H)
        with span("tngp.frame"):
            fr = self.frame_renderer(chunk)
            o, d, W, H = self._frame_rays(pose, intrinsics, W, H)
            with self.ema_weights() if use_ema else contextlib.nullcontext():
                img, dep = fr.render(None, o, d, self.grid.bitfield, self._dgrid, bg_color)
            self.last_render_stats = fr.last_stats
            self.last_render_cut = fr.last_cut.reshape(H, W)
            with span("tngp.frame.to_host"):
                return img.reshape(H, W, 3).cpu().numpy(), dep.reshape(H, W).cpu().numpy()

    def frame_renderer(self, chunk: int = 4096) -> FrameRenderer:
        """The frame renderer `render_image` uses for `chunk`-ray first-pass
        chunks under the current cfg (one per (chunk, cfg), made on first
        use)."""
        key = (chunk, self.cfg)
        if key not in self._frame_renderers:
            self._frame_renderers[key] = FrameRenderer(self.field, self.cfg, chunk=chunk)
        return self._frame_renderers[key]

    def render_image_chunked(self, pose, intrinsics=None, use_ema: bool = True,
                             chunk: int = 4096, bg_color=None, W=None, H=None):
        """Full-image eval render in `chunk`-ray pieces of `render_rays_eval`
        (zero-padded to whole chunks), each with its own residual rounds, or
        on the grid-free path of the deterministic `render_rays_uniform`
        under the current cfg.  Arguments and return as `render_image`;
        `last_render_stats` holds the samples queried, the valid ones, the
        residual rounds, the host reads and the chunk count,
        `last_render_cut` (a device tensor [H, W]) the rays a chunk's round
        cap left alive."""
        return self._render_frame(pose, intrinsics, use_ema, chunk, bg_color, W, H,
                                  self.field, self.grid.bitfield)

    def _render_frame(self, pose, intrinsics, use_ema, chunk, bg_color, W, H, field,
                      bitfield, dgrid=None):
        """`render_image_chunked` through `field` over `bitfield` (its dilated
        chunk grid `dgrid`, built here when None)."""
        o, d, W, H = self._frame_rays(pose, intrinsics, W, H)
        n = o.shape[0]
        pad = (-n) % chunk
        o = torch.nn.functional.pad(o, (0, 0, 0, pad))
        d = torch.nn.functional.pad(d, (0, 0, 0, pad))
        cfg = self.cfg
        if dgrid is None and self.use_grid:
            dgrid = dilated_chunk_grid(bitfield, cfg)
        imgs, deps, cuts = [], [], []
        stats = {"samples": 0, "valid_samples": 0, "rounds": 0, "host_reads": 0, "chunks": 0}
        with self.ema_weights() if use_ema else contextlib.nullcontext():
            for s in range(0, n + pad, chunk):
                if self.use_grid:
                    out = render_rays_eval(field, None, o[s:s + chunk], d[s:s + chunk],
                                           bitfield, cfg, bg_color=bg_color,
                                           dilated_grid=dgrid)
                else:
                    out = self._uniform_eval_chunk(field, o[s:s + chunk], d[s:s + chunk],
                                                   bg_color)
                imgs.append(out["image"])
                deps.append(out["depth"])
                cuts.append(out["cut"])
                for k in ("samples", "valid_samples", "rounds", "host_reads"):
                    stats[k] += out[k]
                stats["chunks"] += 1
        self.last_render_stats = stats
        self.last_render_cut = torch.cat(cuts)[:n].reshape(H, W)
        img = torch.cat(imgs)[:n].reshape(H, W, 3).cpu().numpy()
        dep = torch.cat(deps)[:n].reshape(H, W).cpu().numpy()
        return img, dep

    def _uniform_eval_chunk(self, field, o, d, bg_color) -> dict:
        """One chunk of the grid-free eval, with `render_rays_eval`'s keys."""
        cfg = self.cfg
        with torch.no_grad():
            out = render_rays_uniform(field, None, o, d, cfg, num_steps=cfg.num_steps,
                                      upsample_steps=cfg.upsample_steps, bg_color=bg_color)
        m = o.shape[0] * (cfg.num_steps + cfg.upsample_steps)
        return {**out, "cut": torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device),
                "samples": m, "valid_samples": m, "rounds": 0, "host_reads": 0}

    def evaluate(self, dataset: NeRFDataset, write_images: bool = False) -> float:
        """Mean PSNR of the EMA render over the dataset's frames (RGBA
        targets composited on white); `write_images` writes each render to
        `<workspace>/validation/` as a PNG."""
        meter = PSNRMeter()
        out_dir = os.path.join(self.tc.workspace, "validation")
        if write_images:
            os.makedirs(out_dir, exist_ok=True)
        for i in range(dataset.num_frames):
            img, _ = self._render_view(dataset, i)
            gt = dataset.images[i]
            if gt.shape[-1] == 4:
                gt = gt[..., :3] * gt[..., 3:] + 1.0 * (1.0 - gt[..., 3:])
            meter.update(img, gt)
            if write_images:
                write_png(os.path.join(out_dir, f"{self.tc.name}_{self.epoch:04d}_{i:04d}.png"),
                          (np.clip(img, 0, 1) * 255).astype(np.uint8))
        psnr = meter.measure()
        self.log(f"[{self.eval_tag} epoch {self.epoch}] {meter.report()}")
        return psnr

    def _render_view(self, dataset: NeRFDataset, i: int):
        """View i of `dataset` as `evaluate` renders it."""
        return self.render_image(dataset.poses[i])

    def test(self, poses, out_dir: Optional[str] = None, write_video: bool = True):
        """Render a pose path into `<workspace>/results/` as PNG frames (the
        port has no mp4 writer; the JAX package falls back to the same
        frames where it has none).  Returns the uint8 frames."""
        out_dir = out_dir or os.path.join(self.tc.workspace, "results")
        os.makedirs(out_dir, exist_ok=True)
        frames = []
        for pose in poses:
            img, _ = self.render_image(pose)
            frames.append((np.clip(img, 0, 1) * 255).astype(np.uint8))
        if write_video:
            self.log("[test] mp4 writer unavailable (the port writes PNG frames)")
        for i, fr in enumerate(frames):
            write_png(os.path.join(out_dir, f"{self.tc.name}_{i:04d}.png"), fr)
        return frames

    @torch.no_grad()
    def save_mesh(self, path: Optional[str] = None, resolution: int = 256,
                  threshold: float = 10.0, chunk: int = 2**17):
        """The density field (live weights) on a resolution^3 lattice over
        [-bound, bound]^3, queried on the device in `chunk`-point pieces,
        then its `threshold` isosurface by marching tetrahedra, written as
        PLY (or OBJ for a .obj path).  Returns the path."""
        from ..native import marching_tetrahedra, save_obj, save_ply

        path = path or os.path.join(self.tc.workspace, "meshes",
                                    f"{self.tc.name}_{self.epoch}.ply")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        b = self.cfg.bound
        g = torch.linspace(-b, b, resolution, dtype=torch.float32, device=self.device)
        X, Y, Z = torch.meshgrid(g, g, g, indexing="ij")
        pts = torch.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)])
        vals = [self.field.density(None, pts[:, s:s + chunk].contiguous()).float()
                for s in range(0, pts.shape[1], chunk)]
        field3d = torch.cat(vals).reshape((resolution,) * 3).cpu().numpy()
        verts, faces = marching_tetrahedra(field3d, threshold)
        verts = verts / (resolution - 1) * 2 * b - b
        (save_obj if path.endswith(".obj") else save_ply)(path, verts, faces)
        self.log(f"[save_mesh] {path}: {len(verts)} verts, {len(faces)} faces")
        return path

    # ------------------------------------------------------------- checkpoints
    def _named(self, tensors) -> dict:
        names = [n for n, p in self.model.named_parameters() if p.requires_grad]
        return dict(zip(names, tensors))

    def _params_tree(self, tensors) -> dict:
        """The flax tree of `tensors` (the parameters or the EMA)."""
        return flax_params_from_ngp_state_dict(self._named(tensors))

    def _opt_state_tree(self) -> dict:
        return optax_adam_state_dict(self.optimizer, self.model)

    def _load_opt_state(self, tree) -> int:
        """Load `_opt_state_tree`'s layout; returns the step count."""
        return load_optax_adam_state(self.optimizer, self.model, tree)

    def _geometry(self):
        """The model's shape, written to the checkpoint's sidecar so that a
        load can rebuild the model to it first (TensoRF's resolution and
        box, CCNeRF's ranks); None for a model of fixed shape."""
        return None

    def _rebuild_to_geometry(self, geometry) -> None:
        """Rebuild the model (and its optimizer, EMA and frame renderers) to
        a checkpoint's `geometry` before its arrays are read; nothing to do
        for a model of fixed shape."""

    def _payload(self) -> dict:
        """The checkpoint payload under the JAX package's names
        (`tngp/train/trainer.py:660-667`), as flax state dicts of numpy
        arrays."""
        return {
            "params": self._params_tree(self.params),
            "opt_state": self._opt_state_tree(),
            "ema": self._params_tree(self.ema_params),
            "grid": occupancy_grid_state_dict(self.grid),
            "error_map": (np.zeros(0, np.float32) if self.error_map is None
                          else self.error_map.cpu().numpy().copy()),
        }

    def save_checkpoint(self, best: bool = False):
        if not self.primary:
            return None
        payload = self._payload()
        if best:
            # the best checkpoint drops the density grid: cheap to rebuild,
            # and most of the file
            payload = {k: v for k, v in payload.items() if k != "grid"}
        return ckpt_io.save_checkpoint(
            self.tc.workspace, self.tc.name, self.epoch, self.global_step, payload,
            stats={"best_result": self.stats["best_result"]},
            max_keep=self.tc.max_keep_ckpt, best=best, geometry=self._geometry(),
        )

    def load_checkpoint(self, path: str):
        """Restore weights, Adam state, EMA, grid, epoch and step from a
        checkpoint of either package (non-strict: entries the file lacks
        keep their current values, each reported), the model first rebuilt
        to the sidecar's geometry where it records one.  Returns the
        report."""
        geometry = ckpt_io.load_meta(path).get("geometry")
        if geometry:
            self._rebuild_to_geometry(geometry)
        payload, meta = ckpt_io.load_checkpoint(path, self._payload())
        rep = meta.get("_load_report", {})
        for kind in ("missing", "unexpected", "mismatched"):
            for item in rep.get(kind, []):
                self.log(f"[load_checkpoint] {kind}: {item}")
        named = dict(self.model.named_parameters())
        for name, value in ngp_state_dict_from_flax(payload["params"]).items():
            named[name].data.copy_(value)
        ema = self._named(self.ema_params)
        for name, value in ngp_state_dict_from_flax(payload["ema"]).items():
            ema[name].copy_(value)
        count = self._load_opt_state(payload["opt_state"])
        if self.scheduler is not None:
            sched = self.scheduler
            lrs = [base * f(count) for base, f in zip(sched.base_lrs, sched.lr_lambdas)]
            sched.last_epoch = count
            sched._last_lr = lrs
            for group, lr in zip(self.optimizer.param_groups, lrs):
                group["lr"] = lr
        g = payload["grid"]
        self.set_grid(occupancy_grid_from_arrays(g["density_grid"], g["bitfield"],
                                                 g["mean_density"], g["iter_density"],
                                                 device=self.device))
        self._grid_updates = int(np.asarray(g["iter_density"]))
        if self.error_map is not None:
            self.error_map.copy_(torch.as_tensor(np.asarray(payload["error_map"], np.float32)))
        self.epoch = meta.get("epoch", 0)
        self.global_step = meta.get("global_step", 0)
        best = (meta.get("stats") or {}).get("best_result")
        if best is not None:
            self.stats["best_result"] = best
        self.log(f"[load_checkpoint] {path} (epoch {self.epoch}, step {self.global_step})")
        return rep
