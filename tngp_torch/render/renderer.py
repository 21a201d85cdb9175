"""Volume renderer, eval path — the port of `tngp/render/renderer.py`
(`RenderConfig`, `FieldFns`, `dilated_chunk_grid`, `_resolve_bg`,
`_eval_stream_pass`, `_bucketed_stream_query`, `render_rays_eval`).

`render_rays_eval` takes the chunked stream path: one budgeted first pass
(chunked march -> field query of the selected sample prefix -> stream
composite), then alive-compacted residual rounds.  The JAX package's
`lax.cond` bucket ladder and `lax.while_loop` become host control here: one
`.item()` per query for the number of selected samples and one per round
for "any ray alive".  The selected prefix is exact, so every bucket at or
above that number gives the same result.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from ..kernels.scatter import scatter_add
from ..ops.composite import composite_stream
from ..ops.march import (
    build_dilated_cell_grid,
    chunk_dilate,
    ladder_samples,
    march_rays_chunked,
    nonzero_static,
)
from ..ops.rays import near_far_from_aabb


@dataclass(frozen=True)
class RenderConfig:
    """Same fields and defaults as the JAX package's RenderConfig; the eval
    path reads bound, cascades, grid_size, min_near, density_scale,
    dt_gamma, max_steps, K, K_eval, T_thresh, bg_radius, eval_stream,
    eval_budget, march_chunk, eval_cb_mult and eval_ray_chunk_cap."""

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
    `params` is passed through for analytic fields; an nn.Module field
    holds its own weights and ignores it."""

    sigma_rgb: Callable
    density: Callable
    background: Optional[Callable] = None

    @staticmethod
    def from_model(model) -> "FieldFns":
        """Wrap an nn.Module exposing sigma_rgb_cf / density_cf."""
        if getattr(model, "bg_radius", -1.0) > 0:
            raise NotImplementedError("the background model is not ported yet")
        return FieldFns(
            sigma_rgb=lambda p, x_cf, d_cf: model.sigma_rgb_cf(x_cf, d_cf),
            density=lambda p, x_cf: model.density_cf(x_cf)["sigma"],
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
    """Constant background only (the bg model is not ported yet)."""
    if cfg.bg_radius > 0 and field.background is not None:
        raise NotImplementedError("the background model is not ported yet")
    if bg_color is None:
        return torch.ones((), dtype=torch.float32, device=rays_o.device)
    return torch.as_tensor(bg_color, dtype=torch.float32, device=rays_o.device)


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
                           n_rays, cfg, stats=None):
    """Field-query + stream-composite the selected sample prefix at the
    smallest bucketed width that holds it.  Returns (ws, depth_raw, image)
    over n_rays; an empty selection skips the field entirely.  `stats`, if
    given, accumulates the query width ('samples') and the number of real
    samples ('valid_samples')."""
    m_eff = int(sel_valid.sum().item())
    M_total = sel.shape[0]
    Mq = next((mq for mq in _bucket_ladder(M_total) if m_eff <= mq), M_total)
    if stats is not None:
        stats["samples"] += Mq if m_eff else 0
        stats["valid_samples"] += m_eff
    if m_eff == 0:
        z = torch.zeros((n_rays,), dtype=torch.float32, device=sel.device)
        return z, z.clone(), torch.zeros((n_rays, 3), dtype=torch.float32, device=sel.device)
    ray_id, x_c, d_c, dt_c, t_rel = ladder_samples(
        sel[:Mq], rays_o, rays_d, t0,
        bound=cfg.bound, cascades=cfg.cascades, grid_size=cfg.grid_size,
        dt_gamma=cfg.dt_gamma, max_steps=cfg.max_steps,
    )
    sig_c, rgb_c = field.sigma_rgb(params, x_c, d_c)[:2]
    return composite_stream(
        sig_c.float() * cfg.density_scale, rgb_c, dt_c, None, ray_id,
        sel_valid[:Mq], n_rays, cfg.T_thresh, t_cum=t_rel,
    )


def _eval_stream_pass(field, params, rays_o, rays_d, nears, fars, bitfield, cfg,
                      dgrid=None, G=None, stats=None):
    """First eval pass: chunked march once, field-query the first M valid
    samples (ray-major), stream-composite.  Returns (rays_t, ws, depth_raw,
    image); rays with dropped samples resume at rays_t."""
    N = rays_o.shape[0]
    S = cfg.max_steps
    M = min(N * S, max(128, -(-int(N * cfg.K * cfg.eval_budget) // 128) * 128))
    G = cfg.march_chunk if G is None else G
    if not (cfg.march_chunk > 0 and S % G == 0):
        raise NotImplementedError("only the chunked eval march is ported (march_chunk > 0)")
    cb = -(-int(cfg.eval_cb_mult * M) // G)
    cm = march_rays_chunked(
        rays_o, rays_d, nears, fars, bitfield,
        bound=cfg.bound, cascades=cfg.cascades, grid_size=cfg.grid_size,
        dt_gamma=cfg.dt_gamma, max_steps=cfg.max_steps,
        M_budget=M, G=G, dilated_grid=dgrid, chunk_budget=cb,
        ray_chunk_cap=cfg.eval_ray_chunk_cap or None,
    )
    ws, depth_raw, image = _bucketed_stream_query(
        field, params, cm.sel, cm.sel_valid, rays_o, rays_d, cm.t0, N, cfg, stats
    )
    # t_cum is relative to the ray start; the eval accumulators are absolute
    depth_raw = depth_raw + nears.float() * ws
    return cm.resume_t, ws, depth_raw, image


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
    """Full-quality render: single-pass stream eval plus alive-compacted
    residual rounds.  Returns dict(image [N, 3], depth [N], weights_sum [N],
    rounds, samples, valid_samples) — the last three are host integers: the
    residual rounds run, the field-query width summed over passes, and the
    real samples among them."""
    if not (cfg.eval_stream and _use_chunk(cfg)):
        raise NotImplementedError("only the chunked stream eval is ported")
    N = rays_o.shape[0]
    K = cfg.K_eval
    nears, fars = near_far_from_aabb(rays_o, rays_d, cfg.aabb, cfg.min_near)
    bg = _resolve_bg(field, params, rays_o, rays_d, cfg, bg_color)
    stats = {"samples": 0, "valid_samples": 0}

    dgrid = dilated_grid if dilated_grid is not None else dilated_chunk_grid(bitfield, cfg)
    rays_t, ws, depth, image = _eval_stream_pass(
        field, params, rays_o, rays_d, nears, fars, bitfield, cfg, dgrid, stats=stats
    )
    # residual rounds over ALIVE-COMPACTED rays (nerf/renderer.py:376-420)
    Na = max(min(256, N), N // 4)
    max_res_rounds = max(1, -(-cfg.max_steps // K)) + 2
    M_res = max(128, -(-Na * K // 128) * 128)
    rnd = 0
    while rnd < max_res_rounds:
        alive = (rays_t < fars) & (1.0 - ws >= cfg.T_thresh)
        if not bool(alive.any().item()):
            break
        sel = nonzero_static(alive, Na, N - 1)
        slot_ok = torch.arange(Na, device=alive.device) < alive.sum()
        o_a, d_a = rays_o[sel], rays_d[sel]
        f_a = fars[sel]
        t_a = torch.where(slot_ok, rays_t[sel], f_a)  # dead slots march nothing
        ws_a = ws[sel]
        cm = march_rays_chunked(
            o_a, d_a, t_a, f_a, bitfield,
            bound=cfg.bound, cascades=cfg.cascades, grid_size=cfg.grid_size,
            dt_gamma=cfg.dt_gamma, max_steps=cfg.max_steps, M_budget=M_res,
            G=cfg.march_chunk, dilated_grid=dgrid,
        )
        ws_c, dep_c, img_c = _bucketed_stream_query(
            field, params, cm.sel, cm.sel_valid, o_a, d_a, cm.t0, Na, cfg, stats
        )
        # continue from the accumulated transmittance (raymarching.cu:884);
        # fill slots carry zero deltas, so one scatter-add applies the round
        okf = slot_ok.float()
        T_in = torch.clamp(1.0 - ws_a, min=0.0) * okf
        delta = torch.cat([
            ((cm.resume_t - t_a) * okf)[:, None],
            (T_in * ws_c)[:, None],
            (T_in * (dep_c + t_a * ws_c))[:, None],
            T_in[:, None] * img_c,
        ], dim=1)  # [Na, 6]
        upd = scatter_add(sel, delta.contiguous(), N)
        rays_t = rays_t + upd[:, 0]
        ws = ws + upd[:, 1]
        depth = depth + upd[:, 2]
        image = image + upd[:, 3:6]
        rnd += 1

    image = image + (1.0 - ws)[:, None] * bg
    depth = torch.clamp(depth - nears, min=0.0) / torch.clamp(fars - nears, min=1e-6)
    return {"image": image, "depth": depth, "weights_sum": ws, "rounds": rnd, **stats}
