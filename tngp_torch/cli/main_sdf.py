"""SDF entry point — the port of `tngp/cli/main_sdf.py`.

    python -m tngp_torch.cli.main_sdf <mesh.obj | sphere> [flags]

Fits the signed distance of a mesh (`sphere`: the radius-0.6 sphere that
marching tetrahedra extracts on a 64^3 lattice) on the card (the CPU with
`TNGP_PLATFORM=cpu`) for `--epochs` epochs of `--epoch_size` steps, with
a checkpoint per epoch and resume (`--ckpt latest`), then writes the zero
level set to `<workspace>/results/mesh.ply`; `--test` writes the mesh of
the latest checkpoint.  The flags and defaults are the JAX CLI's.
"""

from __future__ import annotations

import argparse
import os

import torch


def main(argv=None):
    from .common import select_device

    p = argparse.ArgumentParser()
    p.add_argument("path", type=str, help="mesh .obj path (or 'sphere')")
    p.add_argument("--test", action="store_true")
    p.add_argument("--workspace", type=str, default="workspace")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--fp16", action="store_true", help="bf16 MLP")
    p.add_argument("--tcnn", action="store_true", help="(parity flag; single backend here)")
    p.add_argument("--ff", action="store_true", help="(parity flag; single backend here)")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--num_samples", type=int, default=2**18)
    p.add_argument("--epoch_size", type=int, default=100, help="steps per epoch")
    p.add_argument("--mesh_resolution", type=int, default=512)
    p.add_argument("--ckpt", type=str, default="latest")
    opt = p.parse_args(argv)
    dev = select_device()

    from ..data.sdf import SDFDataset, sphere_mesh
    from ..models import SDFNetwork
    from ..train.sdf_trainer import SDFTrainer
    from ..utils.config import TrainConfig

    if opt.path == "sphere":
        verts, faces = sphere_mesh(64, 0.6)
        ds = SDFDataset(vertices=verts, faces=faces, num_samples=opt.num_samples,
                        size=opt.epoch_size)
    else:
        ds = SDFDataset(opt.path, num_samples=opt.num_samples, size=opt.epoch_size)

    model = SDFNetwork(compute_dtype=torch.bfloat16 if opt.fp16 else torch.float32,
                       device=dev, seed=opt.seed)
    tc = TrainConfig(name="ngp", workspace=opt.workspace, seed=opt.seed, eval_interval=1,
                     use_checkpoint=opt.ckpt)
    os.makedirs(tc.workspace, exist_ok=True)
    trainer = SDFTrainer(model, ds, tc, lr=opt.lr, device=dev)
    if not opt.test:
        trainer.train(opt.epochs)
    trainer.save_mesh(resolution=opt.mesh_resolution)
    return trainer


if __name__ == "__main__":
    main()
