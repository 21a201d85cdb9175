"""How far the hard scene's first epochs move with the seed alone:
`train_hard`'s first `--steps` steps under its default 30,000-step
schedule, once per seed (the network's initial weights and the trainer's
draws both from it), each run's epoch losses, validation PSNR and ms/step
on one JSON line.

    python -m tngp_torch.diagnostics.hard_seeds [--seeds 0 1 2] [--steps 1000]

On the card (the CPU with `TNGP_PLATFORM=cpu`); workspaces under <tmp>.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile

from ..scripts import train_hard


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--steps", type=int, default=1000)
    args = ap.parse_args(argv)
    root = tempfile.mkdtemp(prefix="tngp_hard_seeds_")
    out = []
    try:
        for seed in args.seeds:
            ws = os.path.join(root, f"s{seed}")
            opt = train_hard.build_parser().parse_args(["--workspace", ws, "--tag", f"s{seed}"])
            r = train_hard.train_hard(opt, model_kw={"seed": seed}, tc_kw={"seed": seed},
                                      max_steps=args.steps)
            row = {"seed": seed, "steps": args.steps, "epoch_losses": r["epoch_losses"],
                   "final_psnr": r["final_psnr"], "ms_per_step": r["ms_per_step"]}
            print(json.dumps(row), flush=True)
            out.append(row)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


if __name__ == "__main__":
    main()
