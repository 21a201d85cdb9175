"""Trainer — the port of the base NGP grid path of `tngp/train/trainer.py`:
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
losses stay on the device until an epoch ends.

Subclasses (`DNeRFTrainer`) override the hooks `make_grid`, `set_grid`,
`update_grid`, `sample_batch`, `loss_on_batch` and `render_image`, set
`update_interval`, and run without budget tiers (`adaptive_tiers = False`),
as the JAX package enables tiers for the base step only.

Not ported yet: `mesh=` (data parallelism), `use_grid=False` (the uniform
training path), the error map, the CLIP step, TensorBoard and the profiler
(`TrainConfig` raises on their options).
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
from ..data.provider import NeRFDataset
from ..data.rays import full_image_rays, sample_rays
from ..render.frame_eval import FrameRenderer
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
from ..utils.colors import srgb_to_linear
from ..utils.config import TrainConfig
from ..utils.image_io import write_png
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
    per_ray = ((image - gt_rgb) ** 2).mean(dim=-1)
    rm = ray_mask.float()
    kept = rm.sum()
    return (per_ray * rm).sum() / torch.clamp(kept, min=1.0), kept


class Trainer:
    """Occupancy-grid NeRF trainer over an `nn.Module` field."""

    adaptive_tiers = True  # budget tiers for this step (the base NGP step only)

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

        # params / optimizer / ema / grid
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer, self.scheduler = make_optimizer(self.params, tc, constant_lr)
        self.ema_params = ema_init(self.params)
        self._grid_updates = 0  # host copy of grid.iter_density
        self.update_interval = tc.update_extra_interval  # grid update cadence (steps)
        self.set_grid(self.make_grid())

        self.epoch = 0
        self.global_step = 0
        self.host_reads = 0  # device -> host reads the trainer made
        self.stats = {"loss": [], "results": [], "best_result": None}
        self.last_render_stats: dict = {}
        self.last_render_cut = None  # [H, W] rays the last render's round cap left alive
        self._frame_renderers: dict = {}  # (chunk, cfg) -> FrameRenderer
        # the log file, written once the workspace exists (the CLI makes it)
        self.log_path = os.path.join(tc.workspace, f"log_{tc.name}.txt")

        # adaptive sample-budget tiers: fractions of the configured one, an
        # overdrive tier above it, each with its static sample budget
        f = cfg.compact_fraction
        fracs = [f]
        if tc.adaptive_budget and self.adaptive_tiers:
            fracs = [f / 4.0, f / 2.0, f]
            f_over = min(2.0 * f, 0.9)
            if tc.adaptive_overdrive and f_over > f:
                fracs.append(f_over)
        self._tier_cfgs = [dataclasses.replace(cfg, compact_fraction=tf) for tf in fracs]
        self._tier_M = [train_sample_budget(tc.num_rays, c) for c in self._tier_cfgs]
        self._tier = fracs.index(f)  # start at the configured fraction

        if tc.use_checkpoint == "latest":
            path = ckpt_io.latest_checkpoint(tc.workspace, tc.name)
            if path:
                self.load_checkpoint(path)

    # ------------------------------------------------------------------ logging
    def log(self, msg: str):
        print(msg, flush=True)
        if os.path.isdir(self.tc.workspace):
            with open(self.log_path, "a") as f:
                f.write(msg + "\n")

    @property
    def tier_M(self) -> int:
        """The sample budget of the current tier."""
        return self._tier_M[self._tier]

    # --------------------------------------------------------------- train step
    def sample_batch(self):
        """One step's rays, targets, march noise and background, drawn on the
        device (the frame index on the host, from a numpy generator: no
        tensor is read back).  Returns dict(frame, rays_o, rays_d, gt_rgb,
        noise, bg), `frame` the host index."""
        N = self.tc.num_rays
        idx = int(self.host_rng.integers(self.n_frames))
        r = sample_rays(self.poses[idx], self.intrinsics, self.H, self.W, N,
                        generator=self.gen, patch_size=self.tc.patch_size)
        gt = self.images[idx].reshape(-1, self.channels)[r["inds"]]  # [N, C]
        noise = torch.rand((N,), generator=self.gen, device=self.device)
        if self.channels == 4 and self.cfg.bg_radius <= 0:
            bg = torch.rand((N, 3), generator=self.gen, device=self.device)
            gt_rgb = gt[:, :3] * gt[:, 3:] + bg * (1.0 - gt[:, 3:])
        else:
            bg = None  # -> 1.0 inside the render
            gt_rgb = gt[:, :3]
        return {"frame": idx, "rays_o": r["rays_o"], "rays_d": r["rays_d"],
                "gt_rgb": gt_rgb, "noise": noise, "bg": bg}

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
        every `update_interval`-th step.  Returns (losses, num_points, kept)
        as device tensors [steps]; the only host reads are the tier reads,
        one per interval."""
        losses, pts, kepts = [], [], []
        for _ in range(steps):
            if self.global_step % self.update_interval == 0:
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
        if not (cfg.eval_stream and cfg.march_chunk > 0
                and cfg.max_steps % cfg.march_chunk == 0):
            return self.render_image_chunked(pose, intrinsics, use_ema, chunk, bg_color, W, H)
        fr = self.frame_renderer(chunk)
        o, d, W, H = self._frame_rays(pose, intrinsics, W, H)
        with self.ema_weights() if use_ema else contextlib.nullcontext():
            img, dep = fr.render(None, o, d, self.grid.bitfield, self._dgrid, bg_color)
        self.last_render_stats = fr.last_stats
        self.last_render_cut = fr.last_cut.reshape(H, W)
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
        (zero-padded to whole chunks), each with its own residual rounds.
        Arguments and return as `render_image`; `last_render_stats` holds
        the samples queried, the valid ones, the residual rounds, the host
        reads and the chunk count, `last_render_cut` (a device tensor
        [H, W]) the rays a chunk's round cap left alive."""
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
        if dgrid is None:
            dgrid = dilated_chunk_grid(bitfield, self.cfg)
        imgs, deps, cuts = [], [], []
        stats = {"samples": 0, "valid_samples": 0, "rounds": 0, "host_reads": 0, "chunks": 0}
        with self.ema_weights() if use_ema else contextlib.nullcontext():
            for s in range(0, n + pad, chunk):
                out = render_rays_eval(field, None, o[s:s + chunk], d[s:s + chunk],
                                       bitfield, self.cfg, bg_color=bg_color,
                                       dilated_grid=dgrid)
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

    def evaluate(self, dataset: NeRFDataset, write_images: bool = False) -> float:
        """Mean PSNR of the EMA render over the dataset's frames (RGBA
        targets composited on white); `write_images` writes each render to
        `<workspace>/validation/` as a PNG."""
        meter = PSNRMeter()
        out_dir = os.path.join(self.tc.workspace, "validation")
        if write_images:
            os.makedirs(out_dir, exist_ok=True)
        for i in range(dataset.num_frames):
            img, _ = self.render_image(dataset.poses[i])
            gt = dataset.images[i]
            if gt.shape[-1] == 4:
                gt = gt[..., :3] * gt[..., 3:] + 1.0 * (1.0 - gt[..., 3:])
            meter.update(img, gt)
            if write_images:
                write_png(os.path.join(out_dir, f"{self.tc.name}_{self.epoch:04d}_{i:04d}.png"),
                          (np.clip(img, 0, 1) * 255).astype(np.uint8))
        psnr = meter.measure()
        self.log(f"[eval epoch {self.epoch}] {meter.report()}")
        return psnr

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

    def _payload(self) -> dict:
        """The checkpoint payload under the JAX package's names
        (`tngp/train/trainer.py:660-667`), as flax state dicts of numpy
        arrays."""
        return {
            "params": flax_params_from_ngp_state_dict(self._named(self.params)),
            "opt_state": optax_adam_state_dict(self.optimizer, self.model),
            "ema": flax_params_from_ngp_state_dict(self._named(self.ema_params)),
            "grid": occupancy_grid_state_dict(self.grid),
            "error_map": np.zeros(0, np.float32),
        }

    def save_checkpoint(self, best: bool = False):
        payload = self._payload()
        if best:
            # the best checkpoint drops the density grid: cheap to rebuild,
            # and most of the file
            payload = {k: v for k, v in payload.items() if k != "grid"}
        return ckpt_io.save_checkpoint(
            self.tc.workspace, self.tc.name, self.epoch, self.global_step, payload,
            stats={"best_result": self.stats["best_result"]},
            max_keep=self.tc.max_keep_ckpt, best=best,
        )

    def load_checkpoint(self, path: str):
        """Restore weights, Adam state, EMA, grid, epoch and step from a
        checkpoint of either package (non-strict: entries the file lacks
        keep their current values, each reported).  Returns the report."""
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
        count = load_optax_adam_state(self.optimizer, self.model, payload["opt_state"])
        if self.scheduler is not None:
            lr = self.tc.lr * 0.1 ** min(count / self.tc.iters, 1.0)
            self.scheduler.last_epoch = count
            self.scheduler._last_lr = [lr] * len(self.optimizer.param_groups)
            for group in self.optimizer.param_groups:
                group["lr"] = lr
        g = payload["grid"]
        self.set_grid(occupancy_grid_from_arrays(g["density_grid"], g["bitfield"],
                                                 g["mean_density"], g["iter_density"],
                                                 device=self.device))
        self._grid_updates = int(np.asarray(g["iter_density"]))
        self.epoch = meta.get("epoch", 0)
        self.global_step = meta.get("global_step", 0)
        best = (meta.get("stats") or {}).get("best_result")
        if best is not None:
            self.stats["best_result"] = best
        self.log(f"[load_checkpoint] {path} (epoch {self.epoch}, step {self.global_step})")
        return rep
