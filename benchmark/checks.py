"""The comparison of training steps that the drivers share: the plain
reference follows steps that the program took (`hooks.watched_steps`) from
the state they started from, on their batches and grids, and the numbers
that `correct` compares are worked out from both sides."""

from __future__ import annotations

import torch

from .reference import volume
from .reference.volume import bf16, same

# the numbers of a run of watched steps, each compared under its limit
STEP_NUMBERS = ("color_rmse", "loss_gap", "grad_gap", "update_gap")


def follow(ref, cfg: dict, watched: dict, precision: str = "f32") -> dict:
    """The reference's run of the watched steps (`ref.train_steps`)."""
    return ref.train_steps(watched["start"], watched["batches"],
                           [g["bitfield"] for g in watched["grids"]], cfg, precision=precision)


def exact_offs(watched: dict, got: dict, cfg: dict, views, intr) -> dict:
    """The integer numbers, each 0 where the program is right: rays that are
    not their pixel's camera ray and colour (`feed_rays_off`), occupancy
    bits that are not the density grid's (`grid_bits_off`), and samples,
    sample counts and kept rays of each march that are not the reference's,
    and steps at a budget the reference does not allow there (`march_off`)."""
    march_off = got["budget_off"]
    for pm, rm in zip(watched["marches"], got["marches"]):
        m = int(pm["m_eff"])
        march_off += abs(m - rm["m_eff"])
        k = min(m, rm["m_eff"])
        march_off += int((pm["sel"][:k] != rm["sel"][:k]).sum())
        march_off += int((pm["ray_mask"] != rm["kept"]).sum())
    return {"feed_rays_off": sum(volume.check_batch(b, *views, intr)
                                 for b in watched["batches"]),
            "grid_bits_off": sum(volume.grid_bits_off(g["density_grid"], g["bitfield"], cfg)
                                 for g in watched["grids"]),
            "march_off": march_off}


def leaves_compared(got: dict) -> list:
    """Leaves whose first gradient in the reference is at least a thousandth
    of the median leaf's: one that is nought to rounding moves under Adam
    by round-off alone, so it is not compared."""
    med = float(torch.tensor(list(got["grad_norms"].values())).median())
    return [k for k, g in got["grad_norms"].items() if g >= 1e-3 * med]


def _gap(side: dict, ref: dict, leaves) -> float:
    """Worst leaf's |side's norm - reference's| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = float(torch.tensor(list(ref.values())).median())
    return max(abs(side[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves)


def _rmse(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.sqrt(((a.float() - b.float()) ** 2).mean()))


def numbers(side: dict, ref: dict, leaves) -> dict:
    """The numbers compared, of one side (the program, or the control in its
    place) against the reference: the first step's colours (root mean
    square gap) and loss (relative gap), the first gradient's and the
    steps' change's worst leaf (`_gap`); and, for the record, each step's
    colour and loss gaps.  The later steps' colours and losses follow
    weights that Adam moved by lr wherever a gradient was nonzero, its sign
    set by rounding where the gradient is nought to rounding, so only the
    first step's are compared."""
    colors = [_rmse(a, b["image"]) for a, b in zip(side["images"], ref["marches"])]
    losses = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(side["losses"], ref["losses"])]
    return {"color_rmse": colors[0], "loss_gap": losses[0],
            "grad_gap": _gap(side["grad_norms"], ref["grad_norms"], leaves),
            "update_gap": _gap(side["change_norms"], ref["change_norms"], leaves),
            "color_rmse_steps": colors, "loss_gap_steps": losses}


def program_side(watched: dict) -> dict:
    return {"losses": watched["losses"], "images": [m["image"] for m in watched["marches"]],
            "grad_norms": {k: float(g.norm()) for k, g in watched["grads"].items()},
            "change_norms": watched["change_norms"]}


def control_side(low: dict) -> dict:
    return {"losses": low["losses"], "images": [m["image"] for m in low["marches"]],
            "grad_norms": low["grad_norms"], "change_norms": low["change_norms"]}


def sign_flips(prog: dict, ref: dict) -> dict:
    """By leaf: the share of the entries with a nonzero reference gradient
    whose program gradient has the other sign, and the largest such entry's
    |gradient| over the leaf's largest."""
    out = {}
    for k, g in ref.items():
        nz = g != 0
        flip = nz & (torch.sign(prog[k]) != torch.sign(g))
        top = float(g.abs().max())
        out[k] = (round(float(flip.sum()) / max(int(nz.sum()), 1), 6),
                  round(float(g[flip].abs().max()) / top if bool(flip.any()) and top > 0
                        else 0.0, 6))
    return out


def ema_gap(ema: dict, low: bool = False) -> float:
    """The worst leaf's largest gap between the EMA after a step and decay *
    the EMA before + (1 - decay) * the weights after (`hooks.ema_step`),
    over that leaf's largest |value|; `low`: the control, that update in
    bfloat16, in the program's place."""
    d, q = ema["decay"], bf16 if low else same
    gap = 0.0
    for e0, e1, p in zip(ema["before"], ema["after"], ema["weights"]):
        want = d * e0.float() + (1.0 - d) * p.float()
        side = q(d * q(e0.float()) + (1.0 - d) * q(p.float())) if low else e1.float()
        gap = max(gap, float((side - want).abs().max()) / max(float(want.abs().max()), 1e-30))
    return gap
