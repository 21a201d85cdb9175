"""Every call of the general scatter-add (`scatter_add(..., indices="any")`)
on the port's paths, on the card: what each call is given and what it
costs, and its inputs saved for `kernel_times.py --any-inputs`.

    python3 -m tngp_torch.diagnostics.any_calls [--seed 0] [--steps 2]
        [--save FILE] [--out FILE]

The paths (`path_trainers`), each a trainer of `chip_smoke.py`'s phases at
full width on the blob scene (12 views of 128x128, bench.py's render
config, 4096 rays a step): D-NeRF at its defaults (the tiled grid, 16
levels, phase 6d) and its hyper variant (5-D grid); NGP on the tiled grid
with the background model (bg_radius 2: 16 + 4 levels, phase 6c run 4);
SDF (16 hashed levels, 2^18 samples a step, phase 6f); TensoRF VM at
resolution 128 and past its upsamples at ~300 (12 factor gradients,
phase 6g), CP at 128 (6); CCNeRF at its defaults (30, phase 6h).  TensoRF
and CCNeRF come from `tensor_steps`' builders, which phase 6h's device
times also use; the others restate their phases' configurations.  Each
trainer takes its warm-up steps, then `--steps` steps; every call of the
form in the last is recorded (`Recorder`): n, C and rows, the most and the
mean adds a row (indices in range), the share of vals rows that are all
zero, the design `any_form` gives it, and its device ms (`device_ms` of
the dispatch on the last step's inputs).  A path's calls a step are its
launches a step.

`--save FILE` writes the inputs of each distinct (path, n, C, rows) of the
last recorded step, and the device-parity probe's per-ray rows (393,216
ascending ray ids into 4,096 rows, C = 5: `chip_smoke.py`'s inputs, no
path's), as {label: (idx, vals, rows)}: `kernel_times.py --any-inputs FILE`
times them through whichever package it imports, so a parent checkout
(`--root DIR`) and this one are timed on the same tensors in one call.
Prints the card's name and power limit, one line per call, and one JSON
line; `--out` writes the JSON there too.  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

N_RAYS = 4096


class Recorder:
    """Wraps the `scatter_add` that a caller module imported: each "any"
    call's inputs are kept while `on`."""

    def __init__(self, modules):
        self.on = False
        self.calls: list = []
        self.real = {m: m.scatter_add for m in modules}
        for m in modules:
            m.scatter_add = self._wrap(self.real[m])

    def _wrap(self, real):
        def scatter_add(idx, vals, num_rows, *, indices="any"):
            if not self.on or indices != "any":
                return real(idx, vals, num_rows, indices=indices)
            self.calls.append((idx.detach(), vals.detach(), num_rows))
            return real(idx, vals, num_rows, indices=indices)
        return scatter_add

    def close(self):
        for m, f in self.real.items():
            m.scatter_add = f

    def take(self) -> list:
        """(idx, vals, rows) of the recorded calls, emptied."""
        out, self.calls = self.calls, []
        return out


def call_stats(idx, vals, rows: int) -> dict:
    """n, C, rows, adds a row (most, mean over all rows) of the indices in
    range, and the share of vals rows that are all zero."""
    from tngp_torch.kernels import scatter as ks

    n, C = vals.shape
    ok = (idx >= 0) & (idx < rows)
    counts = torch.bincount(idx[ok], minlength=rows)
    return dict(n=n, C=C, rows=rows, max_adds=int(counts.max()) if rows else 0,
                mean_adds=float(ok.sum()) / max(rows, 1),
                zero_rows=float((vals == 0).all(1).float().mean()) if n else 0.0,
                form=ks.any_form(n, C, rows).form)


def path_trainers(dev, seed: int):
    """label -> (callable building the trainer, its warm-up steps)."""
    import dataclasses

    from tngp_torch.data import make_synthetic_dataset, make_synthetic_dynamic_dataset
    from tngp_torch.diagnostics import tensor_steps as ts
    from tngp_torch.render import RenderConfig
    from tngp_torch.utils import TrainConfig

    ds = make_synthetic_dataset(n_frames=12, H=128, W=128, seed=0, device=dev)
    cfg = ts.render_config()

    def dnerf(cls_name):
        def build():
            from tngp_torch import models
            from tngp_torch.train import DNeRFTrainer

            dds = make_synthetic_dynamic_dataset(n_frames=12, H=128, W=128, seed=0, device=dev)
            cfg_d = RenderConfig(bound=1.0, grid_size=128, max_steps=512, K=128, min_near=0.05,
                                 compact_fraction=0.25, density_thresh=1.0, march_dense=True)
            model = getattr(models, cls_name)(bound=1.0, compute_dtype=torch.bfloat16,
                                              device=dev, seed=seed)
            tc = TrainConfig(num_rays=N_RAYS, iters=100_000, adaptive_budget=False, seed=seed,
                             use_checkpoint="scratch")
            return DNeRFTrainer(model, dds, cfg_d, tc, time_size=16, update_interval=16,
                                device=dev)
        return build

    def ngp_bg():
        from tngp_torch.models import NGPNetwork
        from tngp_torch.train import Trainer

        model = NGPNetwork(encoding="tiledgrid", bg_radius=2.0, bound=1.0,
                           compute_dtype=torch.bfloat16, device=dev, seed=seed)
        return Trainer(model, ds, dataclasses.replace(cfg, bg_radius=2.0), TrainConfig(num_rays=N_RAYS, lr=1e-2, seed=seed,
                                   use_checkpoint="scratch"), device=dev)

    class SDFSteps:
        """`run_steps` over `SDFTrainer`'s upload and step."""

        def __init__(self):
            from tngp_torch.data.sdf import SDFDataset, sphere_mesh
            from tngp_torch.models import SDFNetwork
            from tngp_torch.train.sdf_trainer import SDFTrainer

            verts, faces = sphere_mesh(64, 0.6)
            self.ds = SDFDataset(vertices=verts, faces=faces, num_samples=2**18, size=100)
            tc = TrainConfig(name="sdf", seed=seed, use_checkpoint="scratch")
            self.tr = SDFTrainer(SDFNetwork(device=dev, seed=seed), self.ds, tc, lr=1e-4,
                                 device=dev)
            self.k = 0

        def run_steps(self, steps):
            for _ in range(steps):
                self.tr.train_step(*self.tr.upload(*self.ds.sample(self.k)))
                self.k += 1

    def tensorf_cp():
        from tngp_torch.models import TensoRFNetwork
        from tngp_torch.train import TensoRFTrainer

        vm = ts.tensorf_trainer(ds, cfg, seed, dev)
        cp = TensoRFNetwork(bound=1.0, decomposition="cp", sigma_rank=(96,) * 3,
                            color_rank=(288,) * 3, compute_dtype=torch.bfloat16, device=dev,
                            seed=seed)
        return TensoRFTrainer(cp, ds, vm.cfg, vm.tc, upsample_model_steps=(), device=dev)

    return {
        "dnerf_tiledgrid": (dnerf("DNeRFNetwork"), 8),
        "dnerf_hyper": (dnerf("DNeRFHyperNetwork"), 8),
        "ngp_tiledgrid_bg": (ngp_bg, 8),
        "sdf": (SDFSteps, 4),
        "tensorf_vm_128": (lambda: ts.tensorf_trainer(ds, cfg, seed, dev), ts.TF_WARM),
        "tensorf_vm_last": (lambda: ts.tensorf_trainer(ds, cfg, seed, dev), ts.TF_STEPS),
        "tensorf_cp_128": (tensorf_cp, 1),
        "ccnerf": (lambda: ts.ccnerf_trainer(ds, cfg, seed, dev), 1 + ts.CC_WARM),
    }


def main(seed: int = 0, steps: int = 2, save_path: str | None = None,
         out_path: str | None = None) -> int:
    if not torch.cuda.is_available():
        print("any_calls: no CUDA card visible; this run needs one", file=sys.stderr)
        return 2
    from tngp_torch.diagnostics.kernel_times import card, device_ms
    from tngp_torch.kernels import load_all
    from tngp_torch.kernels import scatter as ks
    from tngp_torch.ops import grid_sample, hashgrid

    t0 = time.time()
    load_all()
    dev = torch.device("cuda")
    print(f"card: {card()}", flush=True)
    rec = Recorder([hashgrid, grid_sample])
    table, saved = {}, {}
    try:
        for label, (build, warm) in path_trainers(dev, seed).items():
            tr = build()
            tr.run_steps(warm)
            torch.cuda.synchronize()
            rec.on = True
            for _ in range(steps):
                tr.run_steps(1)
                last = rec.take()
            rec.on = False
            rows_out = []
            for i, v, r in last:
                st = call_stats(i, v, r)
                st["device_ms"] = device_ms(lambda: ks.scatter_add(i, v, r, indices="any"))[0]
                rows_out.append(st)
            table[label] = dict(calls_a_step=len(last), calls=rows_out,
                                device_ms_a_step=sum(c["device_ms"] for c in rows_out))
            print(f"# {time.time() - t0:7.1f} s {label}: {len(last)} calls a step, "
                  f"{table[label]['device_ms_a_step']:.4f} ms a step in the form", flush=True)
            for k, st in enumerate(rows_out):
                print(f"  {label} call {k:2d}: [{st['n']:,}, {st['C']}] -> [{st['rows']:,}] "
                      f"adds a row max {st['max_adds']:,} mean {st['mean_adds']:.1f}, zero rows "
                      f"{st['zero_rows']:.3f}, {st['form']}, {st['device_ms']:.4f} ms", flush=True)
            if save_path:
                seen = set()
                for k, (i, v, r) in enumerate(last):
                    if (tuple(v.shape), r) not in seen:
                        seen.add((tuple(v.shape), r))
                        saved[f"{label} call {k}"] = (i.cpu(), v.cpu(), r)
            del tr, last
            torch.cuda.empty_cache()
    finally:
        rec.close()
    if save_path:
        # the device-parity probe's per-ray rows (row 4d; no path calls the
        # form there): chip_smoke.py's inputs, ascending ray ids
        gen = torch.Generator(device="cpu").manual_seed(seed)
        rid = torch.sort(torch.randint(0, N_RAYS, (393_216,), generator=gen)).values
        saved["per_ray_parity"] = (rid, torch.rand((393_216, 5), generator=gen), N_RAYS)
        torch.save(saved, save_path)
        print(f"# {time.time() - t0:7.1f} s saved {len(saved)} calls' inputs to {save_path}",
              flush=True)
    line = json.dumps({"card": card(), "steps": steps, "paths": table})
    print(line)
    if out_path:
        with open(out_path, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--save", default=None,
                    help="write the inputs of each distinct call here, for kernel_times.py "
                         "--any-inputs")
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, here)
    sys.exit(main(args.seed, args.steps, args.save, args.out))
