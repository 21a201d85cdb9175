"""Device parity of the window encoder's kernels and the scatter-add — the
port of `scripts/check_device_parity.py`.

    python -m tngp_torch.diagnostics.device_parity [--seed 0]

Runs on the card (the CPU only with `main(device="cpu")`, where every
wrapper takes its plain version) and holds each kernel against an
independent plain computation on the flagship window spec (16 levels, 2^19
rows, desired resolution 2048) with 65,536 uniform samples plus 1,024 that
straddle a tile boundary:

  int-mul    the hash-product kernel on arange(8192) as [8, 1024]: exact;
  forward    the encoder-forward kernel (through `window_encode_binned`) on
             an N(0, 1e-2) table against `window_encode_ref(emulate_bf16)`,
             in both forms (the default bf16 one and `mxu_f32`'s f32 one,
             against `emulate_bf16=False`), and the same on the EMA table of
             the newest checkpoint of `tngp_torch.scripts.train_hard`'s
             workspaces (<tmp>/hard_*/checkpoints/*.npz) where one exists;
  row map    the same on a value-coded table (channel 0 holds the lane,
             channel 1 the hi row of every window), so a wrong row shows as
             a wrong code;
  bwd grad   the table-gradient kernel against `window_table_grad_ref`;
  input grad the input-gradient kernel against its plain version;
  scatter    each scatter-add form on indices that hold its statement
             (unique C = 4, sorted C = 5, any C = 6; as many rows of values
             as samples) against the exact f64 sum.

Each tolerance is the f32 reordering bound of the sum it checks: two sums of
the same n terms in two orders differ by at most 2 (n - 1) 2^-24 sum|term|
(n = 8 corners for the forward; the terms of each table entry for the
table gradient; the L*C (level, channel) terms of each sample and dimension
for the input gradient, which the kernel adds in order and the plain
version in torch's order); against an exact sum, one order is within
(n - 1) 2^-24 sum|term|, which asks a unique scatter to be exact.  A probe
that fails makes `main` return 1; an error raises.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import tempfile

import numpy as np
import torch

from ..kernels import _lib
from ..kernels import window_encoder as kw
from ..kernels.int_mul import int_mul_hash, int_mul_hash_plain
from ..kernels.scatter import scatter_add
from ..ops import window_table as wt

U = 2.0**-24  # f32 unit roundoff


def _report(tag: str, err: torch.Tensor, tol: torch.Tensor) -> bool:
    bad = int((err > tol).sum())
    print(f"[{tag}] max|err| {float(err.max()):.3e}, worst err/bound "
          f"{float((err / tol.clamp(min=1e-30)).max()):.3f}, over the bound {bad}/{err.numel()}",
          flush=True)
    return bad == 0


def int_mul_probe(device) -> bool:
    x = torch.arange(1 << 13, dtype=torch.int32, device=device).reshape(8, -1)
    got, want = int_mul_hash(x), int_mul_hash_plain(x)
    bad = int((got != want).sum())
    print(f"[int-mul probe] mismatches: {bad}/{x.numel()}", flush=True)
    return bad == 0


def forward_probe(spec, table_win, x01, tag="forward", mxu_f32: bool = False) -> bool:
    """Kernel forward vs the canonical plain encoder of the same form: each
    output is a sum of the same 8 corner products (bf16-exact in the
    default form, rounded alike in the f32 form), so two orders are within
    14 2^-24 of the sum of their magnitudes (the encode of |table|: weights
    are >= 0)."""
    canon = wt.window_unview(table_win, spec)
    got = kw.window_encode_binned(x01, table_win, spec, mxu_f32=mxu_f32)
    want = wt.window_encode_ref(x01, canon, spec, emulate_bf16=not mxu_f32)
    sabs = wt.window_encode_ref(x01, canon.abs(), spec, emulate_bf16=not mxu_f32)
    return _report(f"{tag} mxu_f32={mxu_f32}", (got - want).abs(), 14 * U * sabs)


def trained_table(spec, device, pattern=None):
    """The EMA window table of the newest `train_hard` checkpoint
    (`<tmp>/hard_*/checkpoints/*.npz` unless `pattern` says otherwise), or
    None (said on stdout) when there is none or it is not this spec's
    window layout (a golden-grid run's)."""
    from ..utils import msgpack_codec

    pattern = pattern or os.path.join(tempfile.gettempdir(), "hard_*", "checkpoints", "*.npz")
    cands = sorted(glob.glob(pattern), key=os.path.getmtime)
    if not cands:
        print(f"# trained table: no checkpoint matches {pattern}", flush=True)
        return None
    print(f"# trained table: {cands[-1]}", flush=True)
    with open(cands[-1], "rb") as f:
        raw = msgpack_codec.unpackb(f.read())
    try:
        tab = np.asarray(raw["ema"]["params"]["encoder"]["embeddings"], np.float32)
    except (KeyError, TypeError) as e:
        print(f"# trained table unavailable ({type(e).__name__}: {e})", flush=True)
        return None
    want = (spec.n_windows, spec.level_dim, 128, 64)
    if tab.shape != want:
        print(f"# trained table skipped: shape {tab.shape} != window layout {want}", flush=True)
        return None
    return torch.from_numpy(tab.copy()).to(device)


def row_mapping_probe(spec, x01) -> bool:
    """Value-coded windows: channel 0 of row (lo, hi) holds lo, channel 1
    holds hi (both exact in bf16), in every window."""
    lane = torch.arange(128, dtype=torch.float32, device=x01.device)[:, None].expand(128, 64)
    hi = torch.arange(64, dtype=torch.float32, device=x01.device)[None, :].expand(128, 64)
    code = torch.stack([lane, hi])  # [2, 128, 64]
    tab = code[None].expand(spec.n_windows, 2, 128, 64).contiguous()
    return forward_probe(spec, tab, x01, "row map")


def _term_counts(x01, spec) -> torch.Tensor:
    """Number of corner contributions to each table entry (window layout)."""
    n = torch.zeros(spec.total_rows, device=x01.device)
    tile = wt.sample_tiles(x01)
    for level in range(spec.num_levels):
        rows, _ = wt._corner_rows(spec, level, x01)
        twin = torch.as_tensor(spec.tile_window(level), device=x01.device).long()
        w_id = spec.win_offsets[level] + twin[tile]
        n.index_add_(0, (w_id[None] * wt.WIN_ROWS + rows).reshape(-1),
                     torch.ones(rows.numel(), device=x01.device))
    return wt.window_view(n[:, None].expand(-1, spec.level_dim), spec)


def _cotangent(spec, M, mod, device):
    c = torch.arange(M * spec.output_dim, dtype=torch.float32, device=device)
    return (c.reshape(spec.output_dim, M) % mod) - (mod // 2)


def bwd_probe(spec, table_win, x01) -> bool:
    """Table gradient through the kernel vs the canonical plain gradient:
    the same bf16-rounded terms per entry in another order."""
    g = _cotangent(spec, x01.shape[1], 7, x01.device)
    tab = table_win.clone().requires_grad_(True)
    (kw.window_encode_binned(x01, tab, spec) * g).sum().backward()
    want = wt.window_view(wt.window_table_grad_ref(x01, g, spec, emulate_bf16=True), spec)
    sabs = wt.window_view(wt.window_table_grad_ref(x01, g.abs(), spec, emulate_bf16=True), spec)
    n = _term_counts(x01, spec)
    return _report("bwd grad", (tab.grad - want).abs(),
                   2 * (n - 1).clamp(min=0) * U * sabs)


def input_grad_probe(spec, table_win, x01, block: int = kw.DEFAULT_BLOCK) -> bool:
    """Input gradient through the kernel vs its plain version on the same
    sorted inputs: per sample and dimension the same L*C f32 products
    g * d, summed in two orders."""
    g = _cotangent(spec, x01.shape[1], 5, x01.device)
    x = x01.clone().requires_grad_(True)
    (kw.window_encode_binned(x, table_win, spec, block, input_grads=True) * g).sum().backward()
    dest, tob = kw.bin_dest(x01, block)
    M, M_pad = x01.shape[1], kw.padded_size(x01.shape[1], block)
    xyz4 = kw.scatter_add(dest, torch.cat([x01, torch.ones_like(x01[:1])]).T.contiguous(),
                          M_pad, indices="unique")
    wob = kw._wob_local(spec, tob)
    g_sorted = kw.scatter_add(dest, g.T.contiguous(), M_pad, indices="unique")
    with _lib.plain_versions():
        want = kw.window_encode_dx_plain(xyz4, wob, table_win, g_sorted, spec, block)
        d = kw.dx_features(xyz4, wob, table_win, spec, block)
    sabs = (g_sorted.T[None].abs() * d.abs()).sum(1)
    tol = 2 * spec.output_dim * U * sabs
    return _report("input grad", (x.grad - want[:, dest]).abs(), tol[:, dest])


def scatter_probe(n: int, seed: int, device) -> bool:
    """Each scatter-add form against the exact (f64) sum of its rows: within
    (n_row - 1) 2^-24 sum|v|, so exact where a row has one entry."""
    gen = torch.Generator().manual_seed(seed)
    rows = max(n // 16, 1)
    cases = {"unique": (torch.randperm(4 * n, generator=gen)[:n], 4 * n, 4),
             "sorted": (torch.sort(torch.randint(0, rows, (n,), generator=gen)).values, rows, 5),
             "any": (torch.randint(0, rows, (n,), generator=gen), rows, 6)}
    ok = True
    for indices, (idx, num_rows, C) in cases.items():
        vals = torch.randn((n, C), generator=gen).to(device)
        idx = idx.to(device)
        got = scatter_add(idx, vals, num_rows, indices=indices)

        def exact(v):
            z = torch.zeros((num_rows, C), dtype=torch.float64, device=device)
            return z.index_add_(0, idx, v.double())

        count = torch.bincount(idx, minlength=num_rows).double()[:, None]
        tol = (count - 1).clamp(min=0) * U * exact(vals.abs())
        ok &= _report(f"scatter {indices}", (got.double() - exact(vals)).abs(), tol)
    return ok


def probe_inputs(spec, n: int, seed: int, device):
    """N(0, 1e-2) table in the window layout and n uniform samples plus n/64
    that straddle the tile boundary x = 1/4, from `seed`."""
    gen = torch.Generator().manual_seed(seed)
    table = torch.randn((spec.n_windows, spec.level_dim, 128, 64), generator=gen) * 1e-2
    x01 = torch.rand((3, n), generator=gen)
    xb = torch.linspace(0.249999, 0.250001, max(n // 64, 2))
    x01 = torch.cat([x01, torch.stack([xb, torch.full_like(xb, 0.6),
                                       torch.full_like(xb, 0.3)])], dim=1)
    return table.to(device), x01.to(device)


# the kernels `run_probes` launches (a caller checks that each ran)
KERNELS = ("int_mul_probe", "bin_dest", "scatter_add_unique", "scatter_add_sorted",
           "scatter_add_any", "window_encode_fwd", "window_encode_bwd", "window_encode_dx",
           "window_encode_fwd_f32")


def run_probes(spec, n: int = 65536, seed: int = 0, device="cuda", trained=None) -> bool:
    """Every probe; `trained` is a glob of checkpoints for the trained
    table (`trained_table`'s default when None)."""
    table, x01 = probe_inputs(spec, n, seed, device)
    tabs = {"forward": table}
    tab = trained_table(spec, device, trained)
    if tab is not None:
        tabs["forward trained"] = tab
    ok = [int_mul_probe(device)]
    ok += [forward_probe(spec, t, x01, tag, f32) for tag, t in tabs.items()
           for f32 in (False, True)]
    ok += [row_mapping_probe(spec, x01), bwd_probe(spec, table, x01),
           input_grad_probe(spec, table, x01), scatter_probe(n, seed, device)]
    return all(ok)


def main(device="cuda", seed: int = 0) -> int:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device parity needs a CUDA card")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"# device: {name}", flush=True)
    spec = wt.WindowSpec.create(desired_resolution=2048)  # the flagship encoder
    ok = run_probes(spec, seed=seed, device=device)
    print(f"# PARITY {'OK' if ok else 'FAIL'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    sys.exit(main(seed=ap.parse_args().seed))
