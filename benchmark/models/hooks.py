"""Hooks into the port's `Trainer`, shared by the configurations: how the
benchmark watches the steps it checks and reads the trainer's state.  Each
wrapper calls through to the program unchanged."""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def leaves(trainer) -> dict:
    """The trainer's parameters by name."""
    return dict(trainer.model.named_parameters())


def copy_weights(model, weights: dict) -> None:
    """Load the benchmark's weights (drawn from the seed) into the model."""
    named = dict(model.named_parameters())
    if sorted(named) != sorted(weights):
        raise ValueError(f"leaves {sorted(named)} != {sorted(weights)}")
    with torch.no_grad():
        for k, v in weights.items():
            named[k].copy_(v)


def train_config(cfg: dict, num_rays: int, seed: int):
    from tngp_torch.utils.config import TrainConfig

    tr = cfg["train"]
    return TrainConfig(name="bench", workspace="bench_workspace_unused", seed=int(seed),
                       iters=tr["iters"], lr=tr["lr"], num_rays=num_rays,
                       ema_decay=tr["ema_decay"], update_extra_interval=tr["update_interval"],
                       use_checkpoint="scratch")


def render_config(cfg: dict, **over):
    from tngp_torch.render import RenderConfig

    return RenderConfig(bound=cfg["bound"], **{**cfg["render"], **over})


def train_dataset(cfg: dict, data):
    """The training views of `data` (poses, intrinsics, images): all but the
    first `n_val`."""
    from tngp_torch.data.provider import NeRFDataset

    poses, intr, images = data
    n_val = cfg["scene"]["n_val"]
    H, W = images.shape[1:3]
    return NeRFDataset(poses=poses[n_val:], intrinsics=intr, H=H, W=W, images=images[n_val:])


def reseed(trainer, seed: int) -> None:
    """Start the trainer's draws (rays, march noise, grid jitter on the
    device; frames on the host) afresh from `seed`."""
    trainer.gen.manual_seed(int(seed))
    trainer.host_rng = np.random.default_rng(int(seed))


def snapshot(trainer) -> dict:
    """The trainer's state that its next steps start from, copied: the
    weights, Adam's moments and their step count, the field's box
    (TensoRF's `aabb`, None for the cube) and the samples its steps query
    (`tier_M`, its budget tier's), which the reference judges."""
    out = {"weights": {k: p.detach().clone() for k, p in leaves(trainer).items()},
           "adam": {}, "adam_step": 0, "aabb": list(getattr(trainer.model, "aabb", ()) or ())
           or None, "budget": int(trainer.tier_M)}
    for k, p in leaves(trainer).items():
        st = trainer.optimizer.state.get(p, {})
        if "exp_avg" in st:
            out["adam"][k] = (st["exp_avg"].clone(), st["exp_avg_sq"].clone())
            out["adam_step"] = int(st["step"])
    return out


def first_moments(trainer) -> dict:
    """Adam's first moment of each leaf, copied (zeros before any step)."""
    out = {}
    for k, p in leaves(trainer).items():
        m = trainer.optimizer.state.get(p, {}).get("exp_avg")
        out[k] = m.clone() if m is not None else torch.zeros_like(p)
    return out


@contextlib.contextmanager
def watch_steps(trainer):
    """Inside: each training step's batch, march and grid are appended to
    the yielded lists (the batch as `sample_batch` returned it; the march's
    selection, count and kept rays, and the colours rendered from it; the
    occupancy grid's bitfield and density grid the step marched through),
    the program's calls unchanged."""
    from tngp_torch.render import renderer
    from tngp_torch.train import trainer as trainer_mod

    batches, marches, grids = [], [], []
    real_march = renderer.march_rays_chunked
    real_render = trainer_mod.render_rays_train
    real_sample = trainer.sample_batch

    def march(*a, **k):
        cm = real_march(*a, **k)
        marches.append({"sel": cm.sel, "m_eff": cm.m_eff, "ray_mask": cm.ray_mask})
        return cm

    def render(*a, **k):
        out = real_render(*a, **k)
        marches[-1]["image"] = out["image"].detach()
        return out

    def sample():
        b = real_sample()
        batches.append(b)
        grids.append(grid_state(trainer))
        return b

    renderer.march_rays_chunked = march
    trainer_mod.render_rays_train = render
    trainer.sample_batch = sample
    try:
        yield batches, marches, grids
    finally:
        renderer.march_rays_chunked = real_march
        trainer_mod.render_rays_train = real_render
        del trainer.sample_batch


def watched_steps(trainer, n: int) -> dict:
    """`n` of the trainer's steps (`run_steps`) under `watch_steps`, and
    what the reference needs to follow them: the state they start from
    (`snapshot`), their batches, marches and grids, each step's loss, the
    first step's gradient as Adam got it (from its first moment before and
    after that step, m1 = beta1 m0 + (1 - beta1) g), and each leaf's change
    over the n steps."""
    start = snapshot(trainer)
    b1 = trainer.optimizer.param_groups[0]["betas"][0]
    m0 = first_moments(trainer)
    with watch_steps(trainer) as (batches, marches, grids):
        out1 = trainer.run_steps(1)
        m1 = first_moments(trainer)
        out2 = trainer.run_steps(n - 1)
    now = leaves(trainer)
    return {"start": start, "batches": batches, "marches": marches, "grids": grids,
            "losses": torch.cat([out1[0], out2[0]]).tolist(),
            "grads": {k: (m1[k] - b1 * m0[k]) / (1.0 - b1) for k in m1},
            "change_norms": {k: float((now[k].detach() - start["weights"][k]).norm())
                             for k in now}}


def ema_step(trainer) -> dict:
    """One training step, and what its EMA update is checked by: the EMA
    before and after it and the weights after it, copied, and the decay."""
    before = [e.detach().clone() for e in trainer.ema_params]
    trainer.run_steps(1)
    return {"before": before, "after": [e.detach().clone() for e in trainer.ema_params],
            "weights": [p.detach().clone() for p in trainer.params],
            "decay": trainer.tc.ema_decay}


def state_for_reference(trainer) -> dict:
    """What a frame's reference needs of the trained program: the weights
    the frames render with (the EMA) and the occupancy grid, copied."""
    names = [k for k, p in trainer.model.named_parameters() if p.requires_grad]
    return {"weights": {k: e.detach().clone() for k, e in zip(names, trainer.ema_params)},
            "bitfield": trainer.grid.bitfield.clone()}


def grid_state(trainer) -> dict:
    g = trainer.grid
    return {"density_grid": g.density_grid.clone(), "bitfield": g.bitfield.clone()}


def train_views(cfg: dict, data, device):
    """(images, poses) of the training views on `device`, indexed as a
    batch's `frame` counts them, for the reference's batch check."""
    poses, _, images = data
    n_val = cfg["scene"]["n_val"]
    return (torch.as_tensor(np.asarray(images[n_val:]), device=device),
            torch.as_tensor(np.asarray(poses[n_val:]), device=device))
