"""One rank of the port's two-process data-parallel tests on the CPU
(`tests/test_torch_parallel.py` starts two with the TNGP_COORDINATOR /
TNGP_NUM_PROCESSES / TNGP_PROCESS_ID contract and gloo).

    python tests/torch_dist_worker.py OUT.pt [SETUP.pt]

Writes OUT.pt: `data_parallel_value_and_grad`'s loss and gradients on a
small seeded regression, one `Trainer(mesh=make_mesh())` step's loss and
gradients on its first batch with a budget that drops no ray, and the
parameters and losses after three training steps.  Given SETUP.pt
(`tests/test_torch_parallel_jax.py` writes it from the JAX package's
trainer), `replay` runs `Trainer(mesh=make_mesh())` from its weights, grid,
error map and configs on its global batches instead, and writes each step's
tier, loss, demand, kept rays, gradients, rays' errors and error map."""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tngp_torch.convert import occupancy_grid_from_arrays  # noqa: E402
from tngp_torch.data import NeRFDataset, make_synthetic_dataset  # noqa: E402
from tngp_torch.models import NGPNetwork  # noqa: E402
from tngp_torch.parallel import data_parallel_value_and_grad, init_distributed, make_mesh  # noqa: E402
from tngp_torch.render import RenderConfig  # noqa: E402
from tngp_torch.train import Trainer  # noqa: E402
from tngp_torch.utils import TrainConfig  # noqa: E402

NET_KW = dict(encoding="hashgrid_window", num_levels=4, log2_hashmap_size=12, hidden_dim=16,
              hidden_dim_color=16)
CFG_KW = dict(bound=1.0, grid_size=16, max_steps=64, K=16, K_eval=16, min_near=0.05,
              march_dense=True)
N = 256


def regression(n=64, seed=0):
    """Parameters (w [3, 4], b [4]) and a batch (x [n, 3], y [n, 4])."""
    rng = np.random.default_rng(seed)
    return ([rng.normal(size=(3, 4)).astype(np.float32), rng.normal(size=4).astype(np.float32)],
            rng.normal(size=(n, 3)).astype(np.float32), rng.normal(size=(n, 4)).astype(np.float32))


def regression_loss(params, x, y):
    w, b = params
    pred = (x[:, :, None] * w[None]).sum(dim=1) + b
    return ((pred - y) ** 2).mean()


def make_trainer(mesh, workspace, compact_fraction, net_seed=0):
    """A small window-encoder NGP's trainer on 3 views of the 24x24 blob
    scene, 256 rays a step; `net_seed` draws its initial weights."""
    ds = make_synthetic_dataset(n_frames=3, H=24, W=24, seed=0, num_steps=64, device="cpu")
    net = NGPNetwork(bound=1.0, device="cpu", seed=net_seed, **NET_KW)
    tc = TrainConfig(name="dp", workspace=workspace, num_rays=N, use_checkpoint="scratch",
                     bf16=False, adaptive_budget=False)
    return Trainer(net, ds, RenderConfig(compact_fraction=compact_fraction, **CFG_KW), tc,
                   device="cpu", mesh=mesh)


def first_batch_grads(tr):
    """Loss and gradients of the trainer's first batch, without a step."""
    batch = tr.sample_batch()
    loss, _, kept = tr.loss_on_batch(batch)
    tr.optimizer.zero_grad(set_to_none=True)
    loss = tr.backward(loss)
    return loss, kept, [p.grad.clone() for p in tr.params]


def main(out):
    torch.set_num_threads(1)
    assert init_distributed() and init_distributed()  # the second call is a no-op
    mesh = make_mesh()
    params, x, y = regression()
    params = [torch.from_numpy(p).requires_grad_(True) for p in params]
    dp_loss, dp_grads = data_parallel_value_and_grad(regression_loss, mesh, 2)(
        params, torch.from_numpy(x), torch.from_numpy(y))

    ws = os.path.join(os.path.dirname(out), f"ws{mesh.rank}")
    tr = make_trainer(mesh, ws, compact_fraction=0.9)
    one_loss, one_kept, one_grads = first_batch_grads(tr)

    # each rank draws other initial weights: rank 0's must reach every rank
    tr = make_trainer(mesh, ws, compact_fraction=0.25, net_seed=mesh.rank)
    losses, _, _ = tr.run_steps(3)
    torch.save({"rank": mesh.rank, "world": mesh.world, "dp_loss": dp_loss, "dp_grads": dp_grads,
                "one_loss": one_loss, "one_kept": one_kept, "one_grads": one_grads,
                "losses": losses, "params": [p.detach() for p in tr.params],
                "ema": [e.clone() for e in tr.ema_params], "grid": tr.grid.density_grid.clone()},
               out)


def replay(out, setup_path):
    """`Trainer(mesh=make_mesh())` on SETUP.pt's global batches: its grid
    stays the given one (the JAX trainer's updates are switched off the same
    way), so that each step's tier read, budget, loss, gradient all-reduce
    and error-map gather are held to the JAX package's."""
    torch.set_num_threads(1)
    assert init_distributed()
    mesh = make_mesh()
    setup = torch.load(setup_path)
    ds = NeRFDataset(**{k: v.numpy() if torch.is_tensor(v) else v
                        for k, v in setup["dataset"].items()})
    net = NGPNetwork(bound=1.0, device="cpu", **setup["net_kw"])
    net.load_state_dict(setup["state_dict"])
    tc = TrainConfig(workspace=os.path.join(os.path.dirname(out), f"ws{mesh.rank}"),
                     use_checkpoint="scratch", **setup["tc_kw"])
    tr = Trainer(net, ds, RenderConfig(**setup["cfg_kw"]), tc, device="cpu", mesh=mesh)
    tr.set_grid(occupancy_grid_from_arrays(*setup["grid"], device="cpu"))
    tr.error_map.copy_(setup["error_map"])
    tr.update_grid = lambda: None
    names = [n for n, p in tr.model.named_parameters() if p.requires_grad]
    batches = iter(setup["batches"])
    rec = {"tiers": [], "grads": [], "per_ray": [], "ray_mask": [], "maps": []}

    def sample_batch():
        rec["tiers"].append(tr._tier)
        return tr._shard_batch(dict(next(batches)))

    def backward(loss, mean=False, _orig=tr.backward):
        value = _orig(loss, mean)
        rec["grads"].append({n: p.grad.clone() for n, p in zip(names, tr.params)})
        return value

    def update_error_map(batch, _orig=tr._update_error_map):
        rec["per_ray"].append(batch["per_ray"].clone())
        rec["ray_mask"].append(batch["ray_mask"].clone())
        _orig(batch)
        rec["maps"].append(tr.error_map.clone())

    tr.sample_batch, tr.backward, tr._update_error_map = sample_batch, backward, update_error_map
    losses, pts, kepts = tr.run_steps(len(setup["batches"]))
    torch.save({"rank": mesh.rank, "losses": losses, "pts": pts, "kepts": kepts,
                "params": [p.detach() for p in tr.params], **rec}, out)


if __name__ == "__main__":
    if len(sys.argv) > 2:
        replay(sys.argv[1], sys.argv[2])
    else:
        main(sys.argv[1])
