"""Volume renderer — the port of `tngp/render/renderer.py`
(`RenderConfig`, `FieldFns`, `dilated_chunk_grid`, `_resolve_bg`,
`render_rays_train`, `render_rays_uniform`, `_eval_stream_pass`,
`_bucketed_stream_query`, the slab round `eval_round` as `_eval_round`, and
`render_rays_eval`).

`render_rays_train` is the single-march budgeted training render, with all
three of the JAX package's paths: `march_dense` (the chunked march, or the
stream march and `compact_mask_hier` when the chunked march is off), the
slab march with a global budget (`compact_mask`, the stream compositor on
the gaps), and the slab march without one (`composite_rays_cf` over every
slot).  The sample budget is static per call, the selection is padded to it
and masked, so the step needs no host sync.  `render_rays_uniform` is the
grid-free path that renders the synthetic ground truth.

`render_rays_eval` takes the stream path (one budgeted first pass: the
chunked or the stream march -> field query of the selected sample prefix ->
stream composite, then alive-compacted residual rounds, chunked or slab) or,
with `eval_stream=False`, the reference-style full-width slab round loop.
The JAX package's `lax.cond` bucket ladder and `lax.while_loop`s become host
control here: one `.item()` per query for the number of selected samples
and one per round for "any ray alive".  The selected prefix is exact, so
every bucket at or above that number gives the same result.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from ..kernels.scatter import scatter_add
from ..ops.compaction import (
    compact_mask,
    compact_mask_hier,
    gather_cf,
    ray_in_budget_from_counts,
)
from ..ops.composite import composite_rays_cf, composite_stream, composite_weights
from ..ops.march import (
    ChunkedMarch,
    _binary_search,
    _ladder_consts,
    _t_ladder,
    build_dilated_cell_grid,
    chunk_dilate,
    ladder_samples,
    march_rays,
    march_rays_chunked,
    march_rays_stream,
    nonzero_static,
)
from ..ops.rays import near_far_from_aabb, sph_from_ray
from ..ops.sampling import sample_pdf
from ..utils.profiling import span


@dataclass(frozen=True)
class RenderConfig:
    """Same fields and defaults as the JAX package's RenderConfig.  Every
    path reads bound, cascades, grid_size, min_near, density_scale,
    dt_gamma, max_steps, T_thresh and bg_radius.  The train path adds
    march_dense, compact_fraction and K, then march_chunk (`march_dense`:
    the chunked march when it is > 0 and divides max_steps, else the stream
    march) or march_group (otherwise: the slab march's group size, 0 for
    the flat march).  The eval adds K_eval, eval_stream, eval_budget,
    march_chunk (the first pass's and the residual rounds' march, as in
    training), eval_cb_mult and eval_ray_chunk_cap (the chunked first pass)
    and march_group (the slab rounds, when K_eval is a multiple of it); the
    frame renderer adds the eval_tiers, eval_round_budget,
    eval_march_chunk and eval_round_ladder; the uniform path num_steps and
    upsample_steps; the grid update density_thresh."""

    bound: float = 1.0
    cascades: int = 1
    grid_size: int = 128
    min_near: float = 0.2
    density_scale: float = 1.0
    dt_gamma: float = 0.0
    max_steps: int = 1024
    K: int = 128
    K_eval: int = 64
    T_thresh: float = 1e-4
    bg_radius: float = -1.0
    density_thresh: float = 10.0
    num_steps: int = 128
    upsample_steps: int = 128
    march_group: int = 0
    compact_fraction: float = 1.0
    march_dense: bool = False
    eval_stream: bool = True
    eval_budget: float = 0.75
    march_chunk: int = 8
    eval_tiers: tuple = (1024, 4096, 16384, 32768, 65536)
    eval_round_budget: int = 1 << 19
    eval_march_chunk: int = 16
    eval_round_ladder: int = 256
    eval_cb_mult: float = 6.0
    eval_ray_chunk_cap: int = 8

    @staticmethod
    def from_bound(bound: float, **kw) -> "RenderConfig":
        cascades = 1 + max(0, math.ceil(math.log2(bound))) if bound > 1 else 1
        return RenderConfig(bound=bound, cascades=cascades, **kw)

    @property
    def aabb(self):
        b = self.bound
        return (-b, -b, -b, b, b, b)


class FieldFns(NamedTuple):
    """Functional field interface, channels-first:
    sigma_rgb: (params, x_cf[3,B], d_cf[3,B]) -> (sigma[B], rgb_cf[3,B])
    density:   (params, x_cf[3,B]) -> sigma[B]
    background:(params, sph_cf[2,B], d_cf[3,B]) -> rgb_cf[3,B], or None
    `params` is passed through for analytic fields; an nn.Module field
    holds its own weights and ignores it."""

    sigma_rgb: Callable
    density: Callable
    background: Optional[Callable] = None

    @staticmethod
    def from_model(model) -> "FieldFns":
        """Wrap an nn.Module exposing sigma_rgb_cf / density_cf, and
        background_cf when its `bg_radius` > 0."""
        bg = None
        if getattr(model, "bg_radius", -1.0) > 0:
            bg = lambda p, sph_cf, d_cf: model.background_cf(sph_cf, d_cf)  # noqa: E731
        return FieldFns(
            sigma_rgb=lambda p, x_cf, d_cf: model.sigma_rgb_cf(x_cf, d_cf),
            density=lambda p, x_cf: model.density_cf(x_cf)["sigma"],
            background=bg,
        )


def _use_chunk(cfg: RenderConfig) -> bool:
    return cfg.march_chunk > 0 and cfg.max_steps % cfg.march_chunk == 0


def dilated_chunk_grid(bitfield: torch.Tensor, cfg: RenderConfig):
    """The chunked march's dilated occupancy grid for `cfg` (None when the
    chunked path is off).  Callers rendering many chunks of one frame build
    it once."""
    if not _use_chunk(cfg):
        return None
    return build_dilated_cell_grid(
        bitfield, bound=cfg.bound, cascades=cfg.cascades, grid_size=cfg.grid_size,
        dilate=chunk_dilate(cfg.march_chunk, cfg.max_steps, cfg.grid_size, cfg.bound),
    )


def _resolve_bg(field: FieldFns, params, rays_o, rays_d, cfg: RenderConfig, bg_color):
    """The background behind each ray: the field's background model at the
    rays' background-sphere coordinates ([N, 3]) when cfg.bg_radius > 0 and
    the field has one, else `bg_color` (None -> 1.0)."""
    if cfg.bg_radius > 0 and field.background is not None:
        sph = sph_from_ray(rays_o, rays_d, cfg.bg_radius)
        return field.background(params, sph.T, rays_d.T).T  # [N, 3]
    if bg_color is None:
        return torch.ones((), dtype=torch.float32, device=rays_o.device)
    return torch.as_tensor(bg_color, dtype=torch.float32, device=rays_o.device)


def train_sample_budget(n_rays: int, cfg: RenderConfig) -> int:
    """The static sample budget M of one `render_rays_train` call."""
    return min(
        n_rays * cfg.max_steps,
        max(128, -(-int(n_rays * cfg.K * cfg.compact_fraction) // 128) * 128),
    )


def render_rays_train(
    field: FieldFns,
    params,
    rays_o: torch.Tensor,  # [N, 3]
    rays_d: torch.Tensor,  # [N, 3]
    bitfield: torch.Tensor,
    cfg: RenderConfig,
    noise: torch.Tensor | None = None,  # [N] in [0, 1): None -> no perturb
    bg_color=None,  # None -> 1.0, or [N, 3] / [3]
    dilated_grid=None,  # dilated_chunk_grid(bitfield, cfg), hoisted by trainers
):
    """Single-march budgeted training render.  Returns dict(image [N, 3],
    depth [N], weights_sum [N], num_points [], ray_mask [N]), and the
    march's `counts` [N] on the slab paths; gradients flow to the field's
    weights.  The paths (`tngp/render/renderer.py:191-385`):

    - `march_dense` (needs compact_fraction < 1): the chunked march
      (`march_rays_chunked`) when march_chunk > 0 divides max_steps, else
      the stream march (`march_rays_stream`) and `compact_mask_hier`; then
      `ladder_samples` and `composite_stream` on the telescoped depth;
    - otherwise the slab march `march_rays(K, group=march_group)`, then,
      with compact_fraction < 1, `compact_mask` to the global budget and
      `composite_stream` on the gaps, a ray kept where all its valid slots
      are in the budget; with compact_fraction >= 1, every slab slot
      through `composite_rays_cf`, every ray kept.

    A field whose `sigma_rgb` returns a third entry, a dict of per-sample
    values, adds dict `aux` of their sums over the queried samples divided
    by max(demand, 1): the march's valid rungs on the `march_dense` paths,
    the slab's valid slots on the others (as the JAX package).  Where the
    JAX function takes a key, this one takes the per-ray `noise` itself."""
    N = rays_o.shape[0]
    with span("tngp.render.march"):
        nears, fars = near_far_from_aabb(rays_o, rays_d, cfg.aabb, cfg.min_near)
    bg = _resolve_bg(field, params, rays_o, rays_d, cfg, bg_color)
    geo = dict(bound=cfg.bound, cascades=cfg.cascades, grid_size=cfg.grid_size,
               dt_gamma=cfg.dt_gamma, max_steps=cfg.max_steps)
    results = {}
    if cfg.march_dense:
        if cfg.compact_fraction >= 1.0:
            raise ValueError("march_dense requires compact_fraction < 1")
        M_budget = train_sample_budget(N, cfg)
        # the march is integer selection: nothing to differentiate
        with span("tngp.render.march"), torch.no_grad():
            if _use_chunk(cfg):
                cm = march_rays_chunked(
                    rays_o, rays_d, nears, fars, bitfield, **geo, M_budget=M_budget,
                    G=cfg.march_chunk, noise=noise, dilated_grid=dilated_grid,
                )
                sel, sel_valid, t0 = cm.sel, cm.sel_valid, cm.t0
                ray_mask, num_points = cm.ray_mask, cm.num_points
            else:
                res = march_rays_stream(rays_o, rays_d, nears, fars, bitfield, **geo,
                                        noise=noise)
                comp = compact_mask_hier(res.mask, M_budget)
                sel, sel_valid, t0 = comp.sel, comp.sel_valid, res.t0
                # a ray that lost samples to the global budget leaves the loss
                ray_mask = ray_in_budget_from_counts(res.counts, comp.m_eff)
                num_points = res.counts.sum()
            ray_id, x_c, d_c, dt_c, t_rel = ladder_samples(sel, rays_o, rays_d, t0, **geo)
            ray_id = _ascending_ids(ray_id, sel_valid, N)
            gap_c = None
        demand = num_points
    else:
        with span("tngp.render.march"), torch.no_grad():
            res = march_rays(rays_o, rays_d, nears, fars, bitfield, **geo, K=cfg.K,
                             noise=noise, group=cfg.march_group)
        K_eff = res.mask.shape[-1]
        num_points = res.counts.sum()
        demand = res.mask.sum()
        results["counts"] = res.counts
        if cfg.compact_fraction >= 1.0:
            # no global budget: every slab slot, composited slab-wise
            with span("tngp.render.field"):
                out = field.sigma_rgb(params, res.xyzs_cf.reshape(3, -1),
                                      res.dirs_cf.reshape(3, -1))
            with span("tngp.render.composite"):
                sigmas = out[0].reshape(N, K_eff).float() * cfg.density_scale
                ws, depth_raw, image, _ = composite_rays_cf(
                    sigmas, out[1].reshape(3, N, K_eff), res.dts, res.gaps, res.mask,
                    cfg.T_thresh)
                valid_f = res.mask.reshape(-1).float()
                ray_mask = torch.ones((N,), dtype=torch.bool, device=rays_o.device)
                return _train_results(out, valid_f, demand, image, depth_raw, ws, bg, nears,
                                      fars, num_points, ray_mask, results)
        # the first M valid slots across all rays, composited on the stream
        M_budget = min(N * K_eff,
                       max(128, -(-int(N * cfg.K * cfg.compact_fraction) // 128) * 128))
        with span("tngp.render.march"), torch.no_grad():
            comp = compact_mask(res.mask, M_budget)
            sel_valid = comp.sel_valid
            ray_id = comp.sel // K_eff  # nondecreasing
            x_c = gather_cf(res.xyzs_cf.reshape(3, -1), comp)
            d_c = rays_d.T.float()[:, ray_id]
            dt_c = res.dts.reshape(-1)[comp.sel]
            gap_c = res.gaps.reshape(-1)[comp.sel]
            t_rel = None
            ray_mask = (comp.in_budget == res.mask).all(dim=-1)
            ray_id = _ascending_ids(ray_id, sel_valid, N)
    with span("tngp.render.field"):
        out = field.sigma_rgb(params, x_c, d_c)
    with span("tngp.render.composite"):
        ws, depth_raw, image = composite_stream(
            out[0].float() * cfg.density_scale, out[1], dt_c, gap_c, ray_id, sel_valid, N,
            cfg.T_thresh, t_cum=t_rel,
        )
        return _train_results(out, sel_valid.float(), demand, image, depth_raw, ws, bg, nears,
                              fars, num_points, ray_mask, results)


def _train_results(out, valid_f, demand, image, depth_raw, ws, bg, nears, fars, num_points,
                   ray_mask, results):
    """`render_rays_train`'s dict: the background behind the rays, the
    normalised depth, and `aux` (the field's third output, per-sample
    values summed over `valid_f` and divided by max(demand, 1))."""
    results.update(
        image=image + (1.0 - ws)[:, None] * bg,
        depth=torch.clamp(depth_raw - nears, min=0.0) / torch.clamp(fars - nears, min=1e-6),
        weights_sum=ws,
        num_points=num_points,
        ray_mask=ray_mask,
    )
    if len(out) == 3:  # per-sample auxiliary outputs (D-NeRF's |deform|)
        denom = torch.clamp(demand.float(), min=1.0)
        results["aux"] = {k: (a.reshape(-1) * valid_f).sum() / denom
                          for k, a in out[2].items()}
    return results


def _alpha_weights(deltas: torch.Tensor, sigmas: torch.Tensor) -> torch.Tensor:
    """alpha_i * prod_{j<i} (1 - alpha_j + 1e-15) over [N, S]."""
    alphas = 1.0 - torch.exp(-deltas * sigmas)
    shifted = torch.cat([torch.ones_like(alphas[:, :1]), 1.0 - alphas + 1e-15], dim=-1)
    return alphas * torch.cumprod(shifted, dim=-1)[:, :-1]


def render_rays_uniform(
    field: FieldFns,
    params,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    cfg: RenderConfig,
    num_steps: int = 128,
    upsample_steps: int = 128,
    perturb: torch.Tensor | None = None,  # [N, num_steps] in [0, 1): z jitter
    u: torch.Tensor | None = None,  # [N, upsample_steps] in [0, 1): pdf draws
    bg_color=None,
):
    """Grid-free path: uniform sampling in [near, far] plus one round of
    inverse-CDF importance upsampling.  With `perturb` and `u` both None it
    is deterministic (the JAX function with `key=None`); where the JAX
    function takes a key, this one takes the two sets of uniforms."""
    N = rays_o.shape[0]
    nears, fars = near_far_from_aabb(rays_o, rays_d, cfg.aabb, cfg.min_near)
    nears = torch.where(nears > 1e30, torch.full_like(nears, 0.05), nears)  # missed rays
    fars = torch.where(fars > 1e30, torch.full_like(fars, 0.06), fars)
    bg = _resolve_bg(field, params, rays_o, rays_d, cfg, bg_color)

    z = torch.linspace(0.0, 1.0, num_steps, dtype=torch.float32, device=rays_o.device)
    z_vals = nears[:, None] + (fars - nears)[:, None] * z[None, :]  # [N, S]
    sample_dist = (fars - nears) / num_steps
    if perturb is not None:
        z_vals = z_vals + (perturb - 0.5) * sample_dist[:, None]

    def points_cf(zv):
        comps = [
            torch.clamp(rays_o[:, c:c + 1] + rays_d[:, c:c + 1] * zv, -cfg.bound, cfg.bound)
            for c in range(3)
        ]
        return torch.stack([c.reshape(-1) for c in comps], dim=0)

    def deltas_of(zv):
        return torch.cat([zv[:, 1:] - zv[:, :-1], sample_dist[:, None]], dim=-1)

    if upsample_steps > 0:
        with torch.no_grad():
            with span("tngp.render.field"):
                sigmas = field.density(params, points_cf(z_vals)).reshape(z_vals.shape)
            weights = _alpha_weights(cfg.density_scale * deltas_of(z_vals), sigmas.float())
            z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
            new_z = sample_pdf(z_mid, weights[:, 1:-1], upsample_steps, det=(u is None), u=u)
            z_vals = torch.sort(torch.cat([z_vals, new_z], dim=-1), dim=-1).values

    S = z_vals.shape[-1]
    dirs_cf = rays_d.T[:, :, None].expand(3, N, S).reshape(3, -1)
    with span("tngp.render.field"):
        sigmas, rgbs_cf = field.sigma_rgb(params, points_cf(z_vals), dirs_cf)
    sigmas = sigmas.reshape(N, S).float() * cfg.density_scale
    rgbs_cf = rgbs_cf.reshape(3, N, S).float()
    weights = _alpha_weights(deltas_of(z_vals), sigmas)  # [N, S]
    ws = weights.sum(dim=-1)
    depth_raw = (weights * z_vals).sum(dim=-1)
    image = (weights[None] * rgbs_cf).sum(dim=-1).T
    image = image + (1.0 - ws)[:, None] * bg
    depth = torch.clamp(depth_raw - nears, min=0.0) / torch.clamp(fars - nears, min=1e-6)
    return {"image": image, "depth": depth, "weights_sum": ws}


def _ascending_ids(ray_id: torch.Tensor, sel_valid: torch.Tensor, n_rays: int) -> torch.Tensor:
    """The march's padding slots (after the selected prefix) repeat its first
    sample, so their ray ids fall back below the prefix's; give them n_rays
    instead, which keeps the ids ascending for the compositor's sorted
    reduction and drops the padding from it (its weights are 0)."""
    return torch.where(sel_valid, ray_id, n_rays)


def _bucket_ladder(M_total: int) -> list[int]:
    """Power-of-two query widths down to M/16, floored at 4096 samples."""
    ladder: list[int] = []
    for div in (16, 8, 4, 2):
        mq = max(128, (M_total // div // 128) * 128)
        if mq >= M_total or (M_total // div) < 4096:
            continue
        if not ladder or mq > ladder[-1]:
            ladder.append(mq)
    return ladder


def _bucketed_stream_query(field, params, sel, sel_valid, rays_o, rays_d, t0,
                           n_rays, cfg, stats=None, m_eff=None):
    """Field-query + stream-composite the selected sample prefix at the
    smallest bucketed width that holds it.  Returns (ws, depth_raw, image)
    over n_rays; an empty selection skips the field entirely.  `m_eff`, the
    number of selected samples, is read from the device here (one host
    read) unless the caller already read it.  `stats`, if given,
    accumulates the query width ('samples'), the number of real samples
    ('valid_samples') and the reads made here ('host_reads')."""
    if m_eff is None:
        m_eff = int(sel_valid.sum().item())
        if stats is not None:
            stats["host_reads"] += 1
    M_total = sel.shape[0]
    Mq = next((mq for mq in _bucket_ladder(M_total) if m_eff <= mq), M_total)
    if stats is not None:
        stats["samples"] += Mq if m_eff else 0
        stats["valid_samples"] += m_eff
    if m_eff == 0:
        z = torch.zeros((n_rays,), dtype=torch.float32, device=sel.device)
        return z, z.clone(), torch.zeros((n_rays, 3), dtype=torch.float32, device=sel.device)
    with span("tngp.render.march"):
        ray_id, x_c, d_c, dt_c, t_rel = ladder_samples(
            sel[:Mq], rays_o, rays_d, t0,
            bound=cfg.bound, cascades=cfg.cascades, grid_size=cfg.grid_size,
            dt_gamma=cfg.dt_gamma, max_steps=cfg.max_steps,
        )
        ray_id = _ascending_ids(ray_id, sel_valid[:Mq], n_rays)
    with span("tngp.render.field"):
        sig_c, rgb_c = field.sigma_rgb(params, x_c, d_c)[:2]
    with span("tngp.render.composite"):
        return composite_stream(
            sig_c.float() * cfg.density_scale, rgb_c, dt_c, None, ray_id,
            sel_valid[:Mq], n_rays, cfg.T_thresh, t_cum=t_rel,
        )


def _eval_stream_march(rays_o, rays_d, nears, fars, bitfield, cfg, dgrid=None, G=None):
    """The first eval pass's march: the first M valid samples (ray-major) of
    the chunked march, or, with the chunked march off, of the stream march
    and `compact_mask_hier`.  Returns a `ChunkedMarch` (its `resume_t` the
    t where each ray goes on: its first dropped rung, else the ladder's
    end)."""
    with span("tngp.render.march"):
        N = rays_o.shape[0]
        S = cfg.max_steps
        M = min(N * S, max(128, -(-int(N * cfg.K * cfg.eval_budget) // 128) * 128))
        G = cfg.march_chunk if G is None else G
        geo = dict(bound=cfg.bound, cascades=cfg.cascades, grid_size=cfg.grid_size,
                   dt_gamma=cfg.dt_gamma, max_steps=cfg.max_steps)
        if cfg.march_chunk > 0 and S % G == 0:
            return march_rays_chunked(
                rays_o, rays_d, nears, fars, bitfield, **geo, M_budget=M, G=G,
                dilated_grid=dgrid, chunk_budget=-(-int(cfg.eval_cb_mult * M) // G),
                ray_chunk_cap=cfg.eval_ray_chunk_cap or None,
            )
        res = march_rays_stream(rays_o, rays_d, nears, fars, bitfield, **geo)
        comp = compact_mask_hier(res.mask, M)
        # the selection is a flat prefix, so ray n got taken = clip(m_eff -
        # base_n, 0, counts_n) of its valid rungs; the first dropped one is its
        # (taken + 1)-th, found by a binary search over the row's valid ranks
        counts = res.counts
        base = torch.cumsum(counts, 0) - counts  # exclusive
        taken = torch.minimum(torch.clamp(comp.m_eff - base, min=0), counts)
        rank_row = torch.cumsum(res.mask.long(), dim=-1)  # [N, S]
        want = taken + 1
        nq = torch.arange(N, device=rays_o.device)
        found = torch.clamp(_binary_search(
            N, S, lambda mid: rank_row[nq, torch.clamp(mid, max=S - 1)] < want, rays_o.device),
            max=S - 1)
        dt_min, dt_max = _ladder_consts(cfg.max_steps, cfg.cascades, cfg.grid_size)
        t_res = _t_ladder(res.t0, found[:, None], cfg.dt_gamma, dt_min, dt_max)[:, 0]
        return ChunkedMarch(
            sel=comp.sel, sel_valid=comp.sel_valid, m_eff=comp.m_eff,
            ray_mask=ray_in_budget_from_counts(counts, comp.m_eff), num_points=counts.sum(),
            t0=res.t0, resume_t=torch.where(taken < counts, t_res, res.next_t),
        )


def _eval_stream_query(field, params, cm, rays_o, rays_d, nears, cfg, stats=None,
                       m_eff=None):
    """The first eval pass's field query and stream composite over the
    march `cm`.  Returns (rays_t, ws, depth_raw, image); rays with dropped
    samples resume at rays_t."""
    ws, depth_raw, image = _bucketed_stream_query(
        field, params, cm.sel, cm.sel_valid, rays_o, rays_d, cm.t0, rays_o.shape[0], cfg,
        stats, m_eff=m_eff,
    )
    # t_cum is relative to the ray start; the eval accumulators are absolute
    depth_raw = depth_raw + nears.float() * ws
    return cm.resume_t, ws, depth_raw, image


def _eval_stream_pass(field, params, rays_o, rays_d, nears, fars, bitfield, cfg,
                      dgrid=None, G=None, stats=None):
    """First eval pass: `_eval_stream_march`, then `_eval_stream_query`.
    Returns (rays_t, ws, depth_raw, image)."""
    cm = _eval_stream_march(rays_o, rays_d, nears, fars, bitfield, cfg, dgrid, G)
    return _eval_stream_query(field, params, cm, rays_o, rays_d, nears, cfg, stats)


def _eval_round(field, params, o_r, d_r, t_r, far_r, ws_in, K_round, bitfield, cfg, stats):
    """One marched-slab round over a ray batch, continuing from the
    accumulated weights `ws_in` (`tngp/render/renderer.py:544-580`): the
    grouped march when K_round is a multiple of march_group, every slab
    slot queried, the weights scaled by the carried transmittance and
    stopped on the running global one.  Returns (next_t, d_ws, d_depth,
    d_image) and the round's valid slots (a device scalar)."""
    Nr = o_r.shape[0]
    with span("tngp.render.march"):
        res = march_rays(
            o_r, d_r, t_r, far_r, bitfield, bound=cfg.bound, cascades=cfg.cascades,
            grid_size=cfg.grid_size, dt_gamma=cfg.dt_gamma, max_steps=cfg.max_steps,
            K=K_round, group=cfg.march_group if K_round % max(cfg.march_group, 1) == 0 else 0,
        )
    with span("tngp.render.field"):
        out = field.sigma_rgb(params, res.xyzs_cf.reshape(3, -1), res.dirs_cf.reshape(3, -1))
    stats["samples"] += Nr * K_round
    with span("tngp.render.composite"):
        sigmas = out[0].reshape(Nr, K_round).float() * cfg.density_scale
        rgbs_cf = out[1].reshape(3, Nr, K_round).float()
        # continue from the accumulated weight sum (raymarching.cu:884)
        T_in = torch.clamp(1.0 - ws_in, min=0.0)[:, None]
        w = T_in * composite_weights(sigmas, res.dts, res.mask, 0.0)
        # early stop on the global running transmittance (the first stopper stays)
        tau = sigmas * res.dts * res.mask.float()
        stop = (T_in * torch.exp(-torch.cumsum(tau, dim=-1)) < cfg.T_thresh).float()
        w = w * ((torch.cumsum(stop, dim=-1) - stop) < 0.5).float()
        t_cum = t_r[:, None] + torch.cumsum(res.gaps, dim=-1)
        return (res.next_t, w.sum(dim=-1), (w * t_cum).sum(dim=-1),
                torch.einsum("nk,cnk->nc", w, rgbs_cf)), res.mask.sum()


@torch.no_grad()
def render_rays_eval(
    field: FieldFns,
    params,
    rays_o: torch.Tensor,  # [N, 3]
    rays_d: torch.Tensor,  # [N, 3]
    bitfield: torch.Tensor,
    cfg: RenderConfig,
    bg_color=None,
    dilated_grid=None,
):
    """Full-quality render (`tngp/render/renderer.py:525-713`).  With
    `eval_stream`: the single-pass stream eval (`_eval_stream_pass`), then
    alive-compacted residual rounds over the first max(min(256, N), N / 4)
    alive rays, at most ceil(max_steps / K_eval) + 2 of them: the chunked
    march and the stream compositor when the chunked march is on, else the
    slab round `_eval_round`.  Without it: the reference-style round loop,
    `_eval_round` over all N rays, at most ceil(max_steps / K_eval) rounds.
    Each round's update is a scatter-add that sums duplicate rows: unused
    slots repeat ray N-1 with zero deltas.  Returns dict(image [N, 3],
    depth [N], weights_sum [N], cut [N], rounds, samples, valid_samples,
    host_reads): `cut` marks the rays still alive when the round cap ended
    the loop (a device tensor); the last four are host integers: the rounds
    run, the field-query width summed over passes and rounds, the real
    samples among them, and the device-to-host reads."""
    N = rays_o.shape[0]
    K = cfg.K_eval
    nears, fars = near_far_from_aabb(rays_o, rays_d, cfg.aabb, cfg.min_near)
    bg = _resolve_bg(field, params, rays_o, rays_d, cfg, bg_color)
    stats = {"samples": 0, "valid_samples": 0, "host_reads": 0}
    slab_valid = []  # the slab rounds' valid slots, read once at the end
    max_rounds = max(1, -(-cfg.max_steps // K))

    def alive_of(rays_t, ws):
        return (rays_t < fars) & (1.0 - ws >= cfg.T_thresh)

    if cfg.eval_stream:
        use_chunk = _use_chunk(cfg)
        dgrid = dilated_grid
        if use_chunk and dgrid is None:
            dgrid = dilated_chunk_grid(bitfield, cfg)
        rays_t, ws, depth, image = _eval_stream_pass(
            field, params, rays_o, rays_d, nears, fars, bitfield, cfg, dgrid, stats=stats)
        # residual rounds over ALIVE-COMPACTED rays (nerf/renderer.py:376-420)
        Na = max(min(256, N), N // 4)
        round_cap = max_rounds + 2
        M_res = max(128, -(-Na * K // 128) * 128)
    else:
        rays_t = nears.float()
        ws = torch.zeros((N,), dtype=torch.float32, device=rays_o.device)
        depth = torch.zeros_like(ws)
        image = torch.zeros((N, 3), dtype=torch.float32, device=rays_o.device)
        round_cap = max_rounds
    rnd = 0
    while rnd < round_cap:
        alive = alive_of(rays_t, ws)
        stats["host_reads"] += 1
        if not bool(alive.any().item()):
            break
        rnd += 1
        if not cfg.eval_stream:  # every ray, every round
            (rays_t, dws, ddep, dimg), nv = _eval_round(
                field, params, rays_o, rays_d, rays_t, fars, ws, K, bitfield, cfg, stats)
            ws, depth, image = ws + dws, depth + ddep, image + dimg
            slab_valid.append(nv)
            continue
        sel = nonzero_static(alive, Na, N - 1)
        slot_ok = torch.arange(Na, device=alive.device) < alive.sum()
        okf = slot_ok.float()
        o_a, d_a, f_a, ws_a = rays_o[sel], rays_d[sel], fars[sel], ws[sel]
        t_a = rays_t[sel]
        if use_chunk:
            with span("tngp.render.march"):
                t_a = torch.where(slot_ok, t_a, f_a)  # dead slots march nothing
                cm = march_rays_chunked(
                    o_a, d_a, t_a, f_a, bitfield,
                    bound=cfg.bound, cascades=cfg.cascades, grid_size=cfg.grid_size,
                    dt_gamma=cfg.dt_gamma, max_steps=cfg.max_steps, M_budget=M_res,
                    G=cfg.march_chunk, dilated_grid=dgrid,
                )
            ws_c, dep_c, img_c = _bucketed_stream_query(
                field, params, cm.sel, cm.sel_valid, o_a, d_a, cm.t0, Na, cfg, stats
            )
            # the round's weights scale by the carried transmittance; its
            # round-relative depth is made absolute by the round's start t
            T_in = torch.clamp(1.0 - ws_a, min=0.0) * okf
            next_t, dws, ddep, dimg = (cm.resume_t, T_in * ws_c, T_in * (dep_c + t_a * ws_c),
                                       T_in[:, None] * img_c)
        else:
            (next_t, dws, ddep, dimg), nv = _eval_round(
                field, params, o_a, d_a, t_a, f_a, ws_a, K, bitfield, cfg, stats)
            slab_valid.append(nv)
            dws, ddep, dimg = dws * okf, ddep * okf, dimg * okf[:, None]
        delta = torch.cat([((next_t - t_a) * okf)[:, None], dws[:, None], ddep[:, None], dimg],
                          dim=1)  # [Na, 6]
        # unused slots repeat ray N - 1 with zero deltas: the sorted form sums them
        upd = scatter_add(sel, delta.contiguous(), N, indices="sorted")
        rays_t = rays_t + upd[:, 0]
        ws = ws + upd[:, 1]
        depth = depth + upd[:, 2]
        image = image + upd[:, 3:6]

    if slab_valid:
        stats["valid_samples"] += int(torch.stack(slab_valid).sum().item())
        stats["host_reads"] += 1
    cut = alive_of(rays_t, ws)  # alive when the round cap ended the loop
    image = image + (1.0 - ws)[:, None] * bg
    depth = torch.clamp(depth - nears, min=0.0) / torch.clamp(fars - nears, min=1e-6)
    return {"image": image, "depth": depth, "weights_sum": ws, "cut": cut, "rounds": rnd,
            **stats}
