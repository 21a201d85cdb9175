"""Data-parallel ranks of the flagship NGP trainer on the card.

    TNGP_COORDINATOR=localhost:PORT TNGP_NUM_PROCESSES=2 TNGP_PROCESS_ID=r \\
        python -m tngp_torch.diagnostics.dp_ranks OUT_DIR [--steps 8] [--backend gloo]

On the card (the CPU with `TNGP_PLATFORM=cpu`).  Each rank joins the
process group (`parallel.init_distributed`; gloo lets two ranks share one
card, where NCCL needs a card each) and builds
`Trainer(mesh=make_mesh())` over the flagship window-encoder NGP with
bf16 MLPs on 12 views of 128x128 of the blob scene, bench.py's render
config at compact_fraction 0.9 (a budget that drops no ray on this grid)
and the blob's own occupancy grid (`dp_trainer`).  It writes
OUT_DIR/rank<r>.pt: the loss, kept rays and all-reduced gradients of the
first batch (`first_batch_grads`, no step taken), then the losses, weights
and EMA after `--steps` training steps.  The caller holds the gradients to
one process's over the whole batch and the ranks' weights to each other.
"""

from __future__ import annotations

import argparse
import os

import torch

N_RAYS = 4096


def dp_trainer(mesh, device, seed: int = 0):
    """The trainer each rank (and the one-process reference, `mesh=None`)
    builds: the same weights, data, grid and seeded draws."""
    from ..data import make_blob_field, make_synthetic_dataset
    from ..models import NGPNetwork
    from ..ops.grid_utils import packbits
    from ..render import OccupancyGrid, RenderConfig, cell_centers_cf
    from ..train import Trainer
    from ..utils import TrainConfig

    ds = make_synthetic_dataset(n_frames=12, H=128, W=128, seed=0, device=device)
    cfg = RenderConfig(bound=1.0, grid_size=128, max_steps=512, K=128, min_near=0.05,
                       compact_fraction=0.9, density_thresh=1.0, march_dense=True,
                       march_group=16)
    tc = TrainConfig(num_rays=N_RAYS, lr=1e-2, seed=seed, adaptive_budget=False,
                     use_checkpoint="scratch")
    model = NGPNetwork(encoding="hashgrid_window", bound=1.0, compute_dtype=torch.bfloat16,
                       device=device, seed=seed)
    tr = Trainer(model, ds, cfg, tc, device=device, constant_lr=True, full_grid_updates=2,
                 mesh=mesh)
    density = make_blob_field(0, device=device).density(
        None, cell_centers_cf(0, cfg.bound, cfg.grid_size, device=device))[None]
    tr.set_grid(OccupancyGrid(
        density_grid=density, bitfield=packbits(density, cfg.density_thresh).reshape(-1),
        mean_density=density.mean(), iter_density=torch.zeros((), dtype=torch.int64,
                                                              device=device)))
    return tr


def first_batch_grads(tr):
    """(loss, kept rays, gradients) of the trainer's next batch, the
    gradients summed over the ranks under a mesh; no step is taken."""
    batch = tr.sample_batch()
    loss, _, kept = tr.loss_on_batch(batch)
    tr.optimizer.zero_grad(set_to_none=True)
    loss = tr.backward(loss)
    return loss, kept, [p.grad.clone() for p in tr.params]


def main(argv=None) -> int:
    from ..parallel import init_distributed, make_mesh

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--backend", default=None, help="gloo | nccl (default: nccl on the card)")
    args = ap.parse_args(argv)
    if not init_distributed(backend=args.backend):
        raise SystemExit("dp_ranks: set TNGP_COORDINATOR, TNGP_NUM_PROCESSES, TNGP_PROCESS_ID")
    from ..cli.common import select_device

    mesh = make_mesh()
    dev = select_device()
    tr = dp_trainer(mesh, dev)
    loss, kept, grads = first_batch_grads(tr)
    losses, _, _ = tr.run_steps(args.steps)
    cpu = lambda ts: [t.detach().cpu() for t in ts]  # noqa: E731
    torch.save({"rank": mesh.rank, "world": mesh.world, "loss": float(loss),
                "kept": float(kept), "grads": cpu(grads), "losses": losses.cpu(),
                "params": cpu(tr.params), "ema": cpu(tr.ema_params)},
               os.path.join(args.out_dir, f"rank{mesh.rank}.pt"))
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
