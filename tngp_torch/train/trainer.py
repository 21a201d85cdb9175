"""Trainer — the port of the base NGP grid path of `tngp/train/trainer.py`:
per-step Adam(0.9, 0.99, eps 1e-15) with the exponential lr decay to 0.1x
over `iters`, a per-step EMA, the density-grid update and the dilated-grid
rebuild every `update_extra_interval` steps, adaptive sample-budget tiers,
and chunked full-image eval with PSNR.

Images, poses and intrinsics live on the device and every step samples its
own rays there.  A step is eager PyTorch: sample -> march -> field ->
composite -> loss -> backward -> Adam -> EMA.  The sample budget of a tier is
static, so a step makes no host sync; the trainer reads demand from the
device once per grid-update interval (`host_reads` counts those reads), and
losses stay on the device until an epoch ends.

Not ported yet: `mesh=` (data parallelism), `use_grid=False` (the uniform
training path), the error map, the CLIP step, checkpoints, TensorBoard, and
the frame-level eval renderer (`render_image` takes the per-chunk
`render_rays_eval` loop).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..data.provider import NeRFDataset
from ..data.rays import full_image_rays, sample_rays
from ..render.occupancy import create as create_grid
from ..render.occupancy import mark_untrained_grid, update_density_grid
from ..render.renderer import (
    FieldFns,
    RenderConfig,
    dilated_chunk_grid,
    render_rays_eval,
    render_rays_train,
    train_sample_budget,
)
from ..utils.config import TrainConfig
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
    per_ray = ((image - gt_rgb) ** 2).mean(dim=-1)
    rm = ray_mask.float()
    kept = rm.sum()
    return (per_ray * rm).sum() / torch.clamp(kept, min=1.0), kept


class Trainer:
    """Occupancy-grid NeRF trainer over an `nn.Module` field."""

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
    ):
        # ray and pose arithmetic stays true f32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if not (cfg.march_dense and 0.0 < cfg.compact_fraction < 1.0):
            raise NotImplementedError(
                "the trainer runs the march_dense path with compact_fraction in (0, 1)")
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.tc = tc
        self.dataset = dataset
        self.valid_dataset = valid_dataset
        self.field = field if field is not None else FieldFns.from_model(model)
        self.full_grid_updates = full_grid_updates
        self.gen = torch.Generator(device=self.device).manual_seed(tc.seed)
        self.host_rng = np.random.default_rng(tc.seed)  # frame choice

        # device-resident data
        self.images = torch.as_tensor(dataset.images, dtype=torch.float32, device=self.device)
        self.poses = torch.as_tensor(dataset.poses, dtype=torch.float32, device=self.device)
        self.intrinsics = torch.as_tensor(dataset.intrinsics, dtype=torch.float32,
                                          device=self.device)
        self.H, self.W = dataset.H, dataset.W
        self.n_frames = dataset.num_frames
        self.channels = int(self.images.shape[-1])

        # params / optimizer / ema / grid
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer, self.scheduler = make_optimizer(self.params, tc, constant_lr)
        self.ema_params = ema_init(self.params)
        self._grid_updates = 0  # host copy of grid.iter_density
        self.set_grid(mark_untrained_grid(
            create_grid(cfg.cascades, cfg.grid_size, device=self.device),
            self.poses, self.intrinsics, bound=cfg.bound, grid_size=cfg.grid_size,
        ))

        self.epoch = 0
        self.global_step = 0
        self.host_reads = 0  # device -> host reads the trainer made
        self.stats = {"loss": [], "results": [], "best_result": None}
        self.last_render_stats: dict = {}

        # adaptive sample-budget tiers: fractions of the configured one, an
        # overdrive tier above it, each with its static sample budget
        f = cfg.compact_fraction
        fracs = [f]
        if tc.adaptive_budget:
            fracs = [f / 4.0, f / 2.0, f]
            f_over = min(2.0 * f, 0.9)
            if tc.adaptive_overdrive and f_over > f:
                fracs.append(f_over)
        self._tier_cfgs = [dataclasses.replace(cfg, compact_fraction=tf) for tf in fracs]
        self._tier_M = [train_sample_budget(tc.num_rays, c) for c in self._tier_cfgs]
        self._tier = fracs.index(f)  # start at the configured fraction

    # ------------------------------------------------------------------ logging
    def log(self, msg: str):
        print(msg, flush=True)

    @property
    def tier_M(self) -> int:
        """The sample budget of the current tier."""
        return self._tier_M[self._tier]

    # --------------------------------------------------------------- train step
    def sample_batch(self):
        """One step's rays, targets, march noise and background, drawn on the
        device (the frame index on the host, from a numpy generator: no
        tensor is read back).  Returns dict(rays_o, rays_d, gt_rgb, noise, bg)."""
        N = self.tc.num_rays
        idx = int(self.host_rng.integers(self.n_frames))
        r = sample_rays(self.poses[idx], self.intrinsics, self.H, self.W, N,
                        generator=self.gen)
        gt = self.images[idx].reshape(-1, self.channels)[r["inds"]]  # [N, C]
        noise = torch.rand((N,), generator=self.gen, device=self.device)
        if self.channels == 4 and self.cfg.bg_radius <= 0:
            bg = torch.rand((N, 3), generator=self.gen, device=self.device)
            gt_rgb = gt[:, :3] * gt[:, 3:] + bg * (1.0 - gt[:, 3:])
        else:
            bg = None  # -> 1.0 inside the render
            gt_rgb = gt[:, :3]
        return {"rays_o": r["rays_o"], "rays_d": r["rays_d"], "gt_rgb": gt_rgb,
                "noise": noise, "bg": bg}

    def loss_on_batch(self, batch):
        """Render the batch at the current tier and return (loss, num_points,
        kept rays), all on the device, the loss with its graph."""
        out = render_rays_train(
            self.field, None, batch["rays_o"], batch["rays_d"], self.grid.bitfield,
            self._tier_cfgs[self._tier], noise=batch["noise"], bg_color=batch["bg"],
            dilated_grid=self._dgrid,
        )
        loss, kept = masked_mse(out["image"], batch["gt_rgb"], out["ray_mask"])
        return loss, out["num_points"], kept

    def train_step(self):
        """One optimiser step with the per-step EMA.  Returns (loss,
        num_points, kept rays) as device scalars; makes no host sync."""
        loss, npts, kept = self.loss_on_batch(self.sample_batch())
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        ema_update(self.ema_params, self.params, self.tc.ema_decay)
        self.global_step += 1
        return loss.detach(), npts, kept

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

    def set_grid(self, grid):
        """Install an occupancy grid.  The dilated chunk grid of the training
        march changes only with the bitfield: it is rebuilt here and nowhere
        else, never inside a step."""
        self.grid = grid
        self._dgrid = dilated_chunk_grid(grid.bitfield, self.cfg)

    def update_grid(self):
        """One density-grid update from the live field (`run_steps` calls it
        every `update_extra_interval` steps)."""
        cfg = self.cfg
        self.set_grid(update_density_grid(
            self.grid, None, self.gen, density_fn=self.field.density, bound=cfg.bound,
            grid_size=cfg.grid_size, density_thresh=cfg.density_thresh,
            full=self._grid_updates < self.full_grid_updates,
            density_scale=cfg.density_scale,
        ))
        self._grid_updates += 1

    def run_steps(self, steps: int):
        """`steps` train steps with the grid update and the tier read at
        every `update_extra_interval`-th step.  Returns (losses, num_points,
        kept) as device tensors [steps]; the only host reads are the tier
        reads, one per interval."""
        losses, pts, kepts = [], [], []
        for _ in range(steps):
            if self.global_step % self.tc.update_extra_interval == 0:
                if len(self._tier_M) > 1 and pts:
                    # one host read per grid-update interval
                    demand, kept = torch.stack([pts[-1].float(), kepts[-1]]).tolist()
                    self.host_reads += 1
                    self._adapt_tier(demand, kept / self.tc.num_rays)
                self.update_grid()
            loss, npts, kept = self.train_step()
            losses.append(loss)
            pts.append(npts)
            kepts.append(kept)
        return torch.stack(losses), torch.stack(pts), torch.stack(kepts)

    def train_one_epoch(self, steps: int) -> float:
        t0 = time.time()
        losses, pts, _ = self.run_steps(steps)
        total_loss, total_pts = torch.stack([losses.sum(), pts.sum().float()]).tolist()
        self.host_reads += 1
        dt = time.time() - t0
        avg = total_loss / steps
        self.stats["loss"].append(avg)
        self.log(f"[epoch {self.epoch}] loss={avg:.6f} "
                 f"psnr~{-10 * np.log10(max(avg, 1e-12)):.2f} steps={steps} "
                 f"{steps / dt:.1f} it/s pts/step={int(total_pts) // steps}")
        return avg

    def train(self, max_epochs: int):
        steps = self.tc.steps_per_epoch or self.n_frames
        for _ in range(self.epoch, max_epochs):
            self.epoch += 1
            self.train_one_epoch(steps)
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

    def render_image(self, pose, intrinsics=None, use_ema: bool = True,
                     chunk: int = 4096, bg_color=None, W=None, H=None):
        """Full-image eval render in `chunk`-ray pieces of `render_rays_eval`
        (zero-padded to whole chunks).  W/H override the dataset resolution;
        the intrinsics are rescaled to match.  Returns (image [H, W, 3],
        depth [H, W]) as numpy; `last_render_stats` holds the samples
        queried, the valid ones, the residual rounds and the chunk count."""
        intr = self.intrinsics if intrinsics is None else torch.as_tensor(
            intrinsics, dtype=torch.float32, device=self.device)
        if W is None or H is None:
            W, H = self.W, self.H
        elif (W, H) != (self.W, self.H):
            s = torch.tensor([W / self.W, H / self.H, W / self.W, H / self.H],
                             dtype=torch.float32, device=self.device)
            intr = intr * s
        o, d = full_image_rays(pose, intr, H, W, device=self.device)
        n = o.shape[0]
        pad = (-n) % chunk
        o = torch.nn.functional.pad(o, (0, 0, 0, pad))
        d = torch.nn.functional.pad(d, (0, 0, 0, pad))
        dgrid = dilated_chunk_grid(self.grid.bitfield, self.cfg)
        imgs, deps = [], []
        stats = {"samples": 0, "valid_samples": 0, "rounds": 0, "chunks": 0}
        with self.ema_weights() if use_ema else contextlib.nullcontext():
            for s in range(0, n + pad, chunk):
                out = render_rays_eval(self.field, None, o[s:s + chunk], d[s:s + chunk],
                                       self.grid.bitfield, self.cfg, bg_color=bg_color,
                                       dilated_grid=dgrid)
                imgs.append(out["image"])
                deps.append(out["depth"])
                for k in ("samples", "valid_samples", "rounds"):
                    stats[k] += out[k]
                stats["chunks"] += 1
        self.last_render_stats = stats
        img = torch.cat(imgs)[:n].reshape(H, W, 3).cpu().numpy()
        dep = torch.cat(deps)[:n].reshape(H, W).cpu().numpy()
        return img, dep

    def evaluate(self, dataset: NeRFDataset) -> float:
        """Mean PSNR of the EMA render over the dataset's frames (RGBA
        targets composited on white)."""
        meter = PSNRMeter()
        for i in range(dataset.num_frames):
            img, _ = self.render_image(dataset.poses[i])
            gt = dataset.images[i]
            if gt.shape[-1] == 4:
                gt = gt[..., :3] * gt[..., 3:] + 1.0 * (1.0 - gt[..., 3:])
            meter.update(img, gt)
        psnr = meter.measure()
        self.log(f"[eval epoch {self.epoch}] {meter.report()}")
        return psnr
