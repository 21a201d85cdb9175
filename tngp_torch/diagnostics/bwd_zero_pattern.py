"""Where the table-gradient kernel's zeros differ from its plain version's
on real training steps, and why.

    python3 tngp_torch/diagnostics/bwd_zero_pattern.py [--steps 100]
        [--seeds 0 1 ...] [--march-group 16] [--out FILE]

For each seed, trains bench.py's loop (`kernel_times.bench_trainer`, with
`chip_smoke.py`'s `march_group`) for `kernel_times.TRAIN_STEPS` steps, then
takes `--steps` further steps and gives each step's table-gradient inputs
to the kernel and to the plain version on the card.  It counts the
subnormal cotangents and results, and the entries of at most two terms
where the two differ (values below 2^-126 taken as 0).  Where their zeros
differ, the plain version on the CPU (index order, no flush of subnormals)
joins them, and for each entry where exactly one result is zero it prints
the three values, the entry's number of terms `n`, the exact (f64) sum of
its terms, its smallest and largest nonzero |term| and how many terms are
subnormal (below 2^-126): an order-dependent cancellation (n >= 3) tells
itself apart from a subnormal that an f32 atomic add flushes to zero.  The
inputs of the first step with such an entry (~24 MB) are saved to `--out`.
It prints one JSON summary line last and needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

F32_MIN_NORMAL = 2.0**-126


def entry_terms(xyz4, wob, g_sorted, spec, block, entries):
    """entry -> list of its f32 terms bf16(w * g) in sample order, for the
    flat table indices `entries` (channel included)."""
    from tngp_torch.kernels import window_encoder as kw
    from tngp_torch.ops.window_table import WIN_ROWS

    L, C = spec.num_levels, spec.level_dim
    g = g_sorted.float().reshape(g_sorted.shape[0], L, C)
    want = entries.to(xyz4.device)
    found_e, found_t, found_m = [], [], []
    for l in range(L):
        addr, ws = kw.sorted_corner_addresses(xyz4, wob, spec, block, l)
        for c in range(C):
            flat = addr + c * WIN_ROWS
            hit = torch.isin(flat, want)
            if bool(hit.any()):
                terms = kw._bf16_round(ws * g[:, l, c])
                m = torch.arange(flat.shape[1], device=flat.device).expand_as(flat)
                found_e.append(flat[hit]), found_t.append(terms[hit]), found_m.append(m[hit])
    out = {int(e): [] for e in entries.tolist()}
    if found_e:
        e = torch.cat(found_e).cpu()
        t = torch.cat(found_t).cpu()
        m = torch.cat(found_m).cpu()
        order = torch.argsort(m, stable=True)
        for ei, ti in zip(e[order].tolist(), t[order].tolist()):
            out[ei].append(ti)
    return out


def describe(got, plain_dev, plain_cpu, terms):
    nz = [abs(t) for t in terms if t != 0.0]
    return {
        "kernel": got, "plain_card": plain_dev, "plain_cpu": plain_cpu, "n": len(terms),
        "nonzero_terms": len(nz), "exact_sum": float(sum(float(t) for t in terms)),
        "min_abs_term": min(nz) if nz else 0.0, "max_abs_term": max(nz) if nz else 0.0,
        "subnormal_terms": sum(1 for a in nz if a < F32_MIN_NORMAL),
    }


def subnormals(t) -> int:
    return int(((t != 0) & (t.abs() < F32_MIN_NORMAL)).sum())


def term_counts(xyz4, wob, spec, block):
    """[NW * C * 8192] the live samples' corners at each table entry (the
    terms it sums), counted at channel 0's addresses for every channel."""
    from tngp_torch.kernels import window_encoder as kw
    from tngp_torch.ops.window_table import WIN_ROWS

    L, C = spec.num_levels, spec.level_dim
    live = (xyz4[:, 3] > 0).float().expand(8, -1).reshape(-1)
    n = torch.zeros(spec.n_windows * C * WIN_ROWS, device=xyz4.device)
    for l in range(L):
        addr = kw.sorted_corner_addresses(xyz4, wob, spec, block, l)[0]
        n.index_add_(0, addr.reshape(-1), live)
    return n.reshape(spec.n_windows, C, -1)[:, :1].expand(-1, C, -1).reshape(-1)


def flushed(t):
    return torch.where(t.abs() < F32_MIN_NORMAL, torch.zeros_like(t), t)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=100, help="steps checked per seed")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--march-group", type=int, default=16,
                    help="RenderConfig.march_group (chip_smoke.py's training phase: 16)")
    ap.add_argument("--out", default=None, help="save the first differing step's inputs here")
    ap.add_argument("--show", type=int, default=12, help="entries printed per step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bwd_zero_pattern: no CUDA card visible; this run needs one", file=sys.stderr)
        return 2
    from tngp_torch.diagnostics import kernel_times
    from tngp_torch.kernels import window_encoder as kw

    steps_differing, kinds, saved, per_seed = 0, {}, None, {}
    for seed in args.seeds:
        tr = kernel_times.bench_trainer(seed, march_group=args.march_group)
        tr.run_steps(kernel_times.TRAIN_STEPS)
        spec, block = tr.model.encoder.spec, kw.DEFAULT_BLOCK
        sub = {"steps_with_subnormal_g": 0, "max_subnormal_g": 0, "steps_with_subnormal_out": 0,
               "steps_differing": 0, "few_term_entries_differing": 0}
        for step in range(args.steps):
            xyz4, wob, g_sorted = kernel_times.captured_bwd_inputs(tr)
            got = kw.window_encode_bwd(xyz4, wob, g_sorted, spec, block).reshape(-1)
            plain = kw.window_encode_bwd_plain(xyz4, wob, g_sorted, spec, block).reshape(-1)
            n_sub_g = subnormals(g_sorted)
            sub["steps_with_subnormal_g"] += n_sub_g > 0
            sub["max_subnormal_g"] = max(sub["max_subnormal_g"], n_sub_g)
            sub["steps_with_subnormal_out"] += (subnormals(got) + subnormals(plain)) > 0
            # chip_smoke.py's rule: an entry of at most two terms equals plain
            few = term_counts(xyz4, wob, spec, block) <= 2
            sub["few_term_entries_differing"] += int((flushed(got)[few]
                                                      != flushed(plain)[few]).sum())
            diff = (got == 0) != (plain == 0)
            if not bool(diff.any()):
                continue
            # only now the CPU's plain version (index order, subnormals kept)
            plain_cpu = kw.window_encode_bwd_plain(xyz4.cpu(), wob.cpu(), g_sorted.cpu(), spec,
                                                   block).reshape(-1)
            counts = {"kernel_vs_plain_card": int(diff.sum()),
                      "kernel_vs_plain_cpu": int(((got.cpu() == 0) != (plain_cpu == 0)).sum()),
                      "plain_card_vs_plain_cpu": int(((plain.cpu() == 0)
                                                      != (plain_cpu == 0)).sum())}
            steps_differing += 1
            sub["steps_differing"] += 1
            entries = torch.nonzero(diff).reshape(-1)[:args.show].cpu()
            terms = entry_terms(xyz4, wob, g_sorted, spec, block, entries)
            rows = [describe(float(got[e]), float(plain[e]), float(plain_cpu[e]), terms[e])
                    for e in entries.tolist()]
            for r in rows:
                kind = ("subnormal" if r["subnormal_terms"]
                        or 0 < abs(r["exact_sum"]) < F32_MIN_NORMAL
                        else "n>=3 cancellation" if r["n"] >= 3 else "other")
                kinds[kind] = kinds.get(kind, 0) + 1
            print(json.dumps({"seed": seed, "step": step, "subnormal_g": n_sub_g,
                              "differing": counts, "entries": rows}), flush=True)
            if args.out and saved is None:
                torch.save({"xyz4": xyz4.cpu(), "wob": wob.cpu(), "g_sorted": g_sorted.cpu()},
                           args.out)
                saved = args.out
        per_seed[seed] = sub
        print(json.dumps({"seed": seed, **sub}), flush=True)
    print(json.dumps({"seeds": args.seeds, "steps_per_seed": args.steps,
                      "steps_differing": steps_differing, "entries_by_kind": kinds,
                      "per_seed": per_seed, "saved": saved}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
