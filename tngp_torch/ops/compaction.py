"""Global valid-sample compaction — the port of `tngp/ops/compaction.py`,
the analogue of the reference's `mean_count` point budget: the first
`M_budget` valid samples across ALL rays (ray-major order) go into a tight
buffer and the rest are dropped; a ray that lost samples to the budget is
out of the loss (`ray_in_budget_from_counts`, `Compaction.in_budget`).

Every shape is static: the selection is padded to `M_budget` and masked
(`sel_valid`), so no call reads the device.  `jnp.nonzero(size=,
fill_value=)` is `nonzero_static`.  Indices are int64 (int32 in the JAX
package); the values are equal.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .march import nonzero_static


class Compaction(NamedTuple):
    sel: torch.Tensor  # [M_budget] flat slab index of each compacted sample
    sel_valid: torch.Tensor  # [M_budget] bool: the slot holds a real sample
    rank: torch.Tensor  # [N, K] rank of each slab slot among the valid (clipped)
    in_budget: torch.Tensor  # [N, K] bool: slot valid AND within the budget


class StreamCompaction(NamedTuple):
    """Prefix compaction without the [N, K] rank maps: the first `m_eff`
    valid samples in flat order, m_eff = min(M_budget, the valid samples
    inside the selected chunk prefix) (`compact_mask_hier`)."""

    sel: torch.Tensor  # [M_budget] flat slab index, ascending
    sel_valid: torch.Tensor  # [M_budget] bool: the slot holds a real sample
    m_eff: torch.Tensor  # [] number of real samples selected


def ray_in_budget_from_counts(counts: torch.Tensor, m_eff) -> torch.Tensor:
    """[N] bool: the ray kept ALL of its valid samples.  The selection is a
    prefix of flat ray-major order, so that holds iff the inclusive cumsum of
    the per-ray valid counts is <= m_eff."""
    return torch.cumsum(counts.long(), 0) <= m_eff


def compact_mask(mask: torch.Tensor, M_budget: int) -> Compaction:
    """mask [N, K] bool -> the first M_budget valid samples (ray-major);
    padding slots point at the last slab slot."""
    N, K = mask.shape
    flat = mask.reshape(-1)
    rank_incl = torch.cumsum(flat.long(), 0)  # [N*K] inclusive
    sel = nonzero_static(flat, M_budget, N * K - 1)
    want = torch.arange(1, M_budget + 1, device=mask.device)
    rank = rank_incl.reshape(N, K) - 1
    return Compaction(sel=sel, sel_valid=want <= rank_incl[-1],
                      rank=torch.clamp(rank, 0, M_budget - 1),
                      in_budget=mask & (rank < M_budget))


def compact_mask_hier(mask: torch.Tensor, M_budget: int, G: int = 8,
                      chunk_budget: int | None = None) -> StreamCompaction:
    """Two-level prefix compaction: the first live G-slot chunks in flat
    order (`chunk_budget`, default ceil(3 M_budget / G), rounded up to 128),
    then the first M_budget valid slots inside them.  All valid samples lie
    in live chunks, so the selection is exactly the first m_eff valid
    samples in flat order, m_eff = min(M_budget, the valid samples of the
    selected chunks)."""
    N, K = mask.shape
    M = N * K
    dev = mask.device
    flat = mask.reshape(-1)
    pad = (-M) % G
    if pad:
        flat = torch.cat([flat, torch.zeros((pad,), dtype=torch.bool, device=dev)])
    NC = (M + pad) // G
    flags = flat.reshape(NC, G)
    chunk_any = flags.any(dim=1)
    if chunk_budget is None:
        chunk_budget = -(-3 * M_budget // G)
    CB = min(NC, -(-chunk_budget // 128) * 128)
    csel = nonzero_static(chunk_any, CB, NC - 1)
    # fill slots alias chunk NC - 1: zero their flags so that a real chunk
    # is never counted twice
    cand = flags[csel] & (torch.arange(CB, device=dev)[:, None] < chunk_any.sum())
    m_eff = torch.clamp(cand.sum(), max=M_budget)
    s2 = nonzero_static(cand.reshape(-1), M_budget, 0)
    sel = torch.clamp(csel[s2 // G] * G + s2 % G, max=M - 1)
    want = torch.arange(1, M_budget + 1, device=dev)
    return StreamCompaction(sel=sel, sel_valid=want <= m_eff, m_eff=m_eff)


def gather_cf(x_cf: torch.Tensor, comp: Compaction) -> torch.Tensor:
    """[C, N*K] channels-first samples -> [C, M_budget] compacted."""
    return x_cf[:, comp.sel]


def expand_to_slab(values: torch.Tensor, comp: Compaction, N: int, K: int) -> torch.Tensor:
    """[M_budget] (or [C, M_budget]) compacted values -> [N, K] (or [C, N,
    K]), zero outside the budget."""
    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    if values.dim() == 1:
        return torch.where(comp.in_budget, values[comp.rank.reshape(-1)].reshape(N, K), zero)
    out = values[:, comp.rank.reshape(-1)].reshape(values.shape[0], N, K)
    return torch.where(comp.in_budget[None], out, zero)
