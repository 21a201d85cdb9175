"""SDF trainer — the port of `tngp/train/sdf_trainer.py` `SDFTrainer`.

A step draws its batch on the host (`SDFDataset.sample(global_step)`),
uploads it (pinned, asynchronous on the card), and runs mape(pred, label)
-> backward -> Adam(0.9, 0.99, eps 1e-15) -> the per-step EMA.  The lr is
optax's staircase `exponential_decay` as the JAX trainer reads it, at the
step count before the update: lr * 0.1 ** floor(step / (10 * steps per
epoch)), set on the host from `global_step`, so a step reads nothing back
from the card.  The losses stay on the card until the epoch ends.
`save_mesh` queries the EMA field on the card one X-slice of the lattice
at a time and extracts the zero level set on the host.  Checkpoints are
the JAX package's files (`params`, `opt_state`, `ema`), with resume.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch

from ..convert import (
    flax_params_from_ngp_state_dict,
    load_optax_adam_state,
    ngp_state_dict_from_flax,
    optax_adam_state_dict,
)
from ..data.sdf import SDFDataset
from ..ops.losses import mape_loss
from ..utils.config import TrainConfig
from . import checkpoint as ckpt_io
from .ema import ema_init, ema_update


def staircase_lr(lr: float, step: int, steps_per_epoch: int) -> float:
    """StepLR(10 epochs, 0.1) as optax's staircase exponential decay gives
    it at update count `step`."""
    return lr * 0.1 ** (step // (10 * steps_per_epoch))


class SDFTrainer:
    def __init__(
        self,
        model: torch.nn.Module,  # SDFNetwork
        dataset: SDFDataset,
        tc: TrainConfig,
        valid_dataset: Optional[SDFDataset] = None,
        lr: float = 1e-4,
        device="cuda",
    ):
        # the MLP products stay true f32, as in the JAX package
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.dataset = dataset
        self.valid_dataset = valid_dataset
        self.tc = tc
        self.lr = lr
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.99), eps=1e-15)
        self.ema_params = ema_init(self.params)

        self.epoch = 0
        self.global_step = 0
        self.stats = {"loss": [], "valid_loss": []}
        os.makedirs(tc.workspace, exist_ok=True)
        self.log_path = os.path.join(tc.workspace, f"log_{tc.name}.txt")

        if tc.use_checkpoint == "latest":
            path = ckpt_io.latest_checkpoint(tc.workspace, tc.name)
            if path:
                self.load_checkpoint(path)

    def log(self, msg: str):
        print(msg, flush=True)
        with open(self.log_path, "a") as f:
            f.write(msg + "\n")

    # --------------------------------------------------------------- train step
    def upload(self, points: np.ndarray, sdfs: np.ndarray):
        """A host batch on the device: (points_cf [3, N], sdfs [N]); pinned and
        asynchronous on the card."""
        x = torch.from_numpy(np.ascontiguousarray(points.T))
        y = torch.from_numpy(np.ascontiguousarray(sdfs[:, 0]))
        if self.device.type == "cuda":
            x, y = x.pin_memory(), y.pin_memory()
        return (x.to(self.device, non_blocking=True), y.to(self.device, non_blocking=True))

    def train_step(self, points_cf: torch.Tensor, sdfs: torch.Tensor) -> torch.Tensor:
        """One optimiser step and the EMA on an uploaded batch.  Returns the
        loss as a device scalar; reads nothing back."""
        pred = self.model.cf(points_cf)  # [1, N]
        loss = mape_loss(pred[0], sdfs)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        lr = staircase_lr(self.lr, self.global_step, self.dataset.size)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        ema_update(self.ema_params, self.params, self.tc.ema_decay)
        self.global_step += 1
        return loss.detach()

    def train_one_epoch(self) -> float:
        t0 = time.time()
        losses = []
        for _ in range(self.dataset.size):
            pts, sdfs = self.dataset.sample(self.global_step)
            losses.append(self.train_step(*self.upload(pts, sdfs)))
        avg = torch.stack(losses).mean().item() if losses else 0.0  # one read an epoch
        self.stats["loss"].append(avg)
        self.log(f"[sdf epoch {self.epoch}] loss={avg:.6f} "
                 f"{self.dataset.size / (time.time() - t0):.1f} it/s")
        return avg

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

    @torch.no_grad()
    def evaluate(self) -> float:
        ds = self.valid_dataset or self.dataset
        pts, sdfs = ds.sample(10_000_000 + self.epoch)
        x, y = self.upload(pts, sdfs)
        with self.ema_weights():
            loss = mape_loss(self.model.cf(x)[0], y).item()
        self.stats["valid_loss"].append(loss)
        self.log(f"[sdf eval epoch {self.epoch}] mape={loss:.6f}")
        return loss

    def train(self, max_epochs: int):
        for _ in range(self.epoch, max_epochs):
            self.epoch += 1
            self.train_one_epoch()
            if self.epoch % self.tc.eval_interval == 0:
                self.evaluate()
            self.save_checkpoint()

    # ------------------------------------------------------------------- mesh
    @torch.no_grad()
    def sdf_field(self, resolution: int, chunk: int = 2**18) -> np.ndarray:
        """The EMA field on the resolution^3 lattice over [-1, 1]^3 (numpy's
        f32 linspace, `meshgrid(..., indexing="ij")` order), queried on the
        device one X-slice at a time in `chunk`-point pieces.  Returns
        [res, res, res] float32 on the host."""
        g = torch.from_numpy(np.linspace(-1, 1, resolution, dtype=np.float32)).to(self.device)
        Y, Z = torch.meshgrid(g, g, indexing="ij")
        yz = torch.stack([Y.reshape(-1), Z.reshape(-1)])  # [2, res^2]
        field = torch.empty((resolution, resolution * resolution), dtype=torch.float32,
                            device=self.device)
        with self.ema_weights():
            for i in range(resolution):
                pts = torch.cat([g[i].expand(1, yz.shape[1]), yz])
                for s in range(0, pts.shape[1], chunk):
                    field[i, s:s + chunk] = self.model.cf(pts[:, s:s + chunk].contiguous())[0]
        return field.reshape((resolution,) * 3).cpu().numpy()

    def save_mesh(self, path: Optional[str] = None, resolution: int = 512,
                  chunk: int = 2**18) -> str:
        """The zero level set of the EMA field (negated: the network is
        positive outside), by marching tetrahedra on the host, its vertices
        mapped to [-1, 1], written as PLY (or OBJ for a .obj path)."""
        from ..native import marching_tetrahedra, save_obj, save_ply

        path = path or os.path.join(self.tc.workspace, "results", "mesh.ply")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        field = self.sdf_field(resolution, chunk)
        verts, faces = marching_tetrahedra(-field, 0.0)
        verts = verts / (resolution - 1) * 2 - 1
        (save_obj if path.endswith(".obj") else save_ply)(path, verts, faces)
        self.log(f"[save_mesh] {path}: {len(verts)} verts, {len(faces)} faces")
        return path

    # ------------------------------------------------------------- checkpoints
    def _named(self, tensors) -> dict:
        names = [n for n, p in self.model.named_parameters() if p.requires_grad]
        return dict(zip(names, tensors))

    def _payload(self) -> dict:
        """The JAX SDF trainer's payload (`params`, `opt_state`, `ema`) as flax
        state dicts of numpy arrays; its optax state, adam over a schedule,
        has the layout of `optax_adam_state_dict`."""
        return {
            "params": flax_params_from_ngp_state_dict(self._named(self.params)),
            "opt_state": optax_adam_state_dict(self.optimizer, self.model),
            "ema": flax_params_from_ngp_state_dict(self._named(self.ema_params)),
        }

    def save_checkpoint(self, best: bool = False) -> str:
        return ckpt_io.save_checkpoint(
            self.tc.workspace, self.tc.name, self.epoch, self.global_step, self._payload(),
            max_keep=self.tc.max_keep_ckpt, best=best,
        )

    def load_checkpoint(self, path: str):
        """Restore weights, Adam state, EMA, epoch and step from a checkpoint
        of either package.  Returns the load report."""
        payload, meta = ckpt_io.load_checkpoint(path, self._payload())
        named = dict(self.model.named_parameters())
        for name, value in ngp_state_dict_from_flax(payload["params"]).items():
            named[name].data.copy_(value)
        ema = self._named(self.ema_params)
        for name, value in ngp_state_dict_from_flax(payload["ema"]).items():
            ema[name].copy_(value)
        load_optax_adam_state(self.optimizer, self.model, payload["opt_state"])
        self.epoch = meta.get("epoch", 0)
        self.global_step = meta.get("global_step", 0)
        self.log(f"[load_checkpoint] {path}")
        return meta.get("_load_report", {})
