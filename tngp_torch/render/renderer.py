"""Volume renderer — the port of `tngp/render/renderer.py`
(`RenderConfig`, `FieldFns`, `dilated_chunk_grid`, `_resolve_bg`,
`render_rays_train`, `render_rays_uniform`, `_eval_stream_pass`,
`_bucketed_stream_query`, `render_rays_eval`).

`render_rays_train` is the single-march budgeted training render (the
`march_dense` chunked branch): the sample budget is static per call, the
selection is padded to it and masked, so the step needs no host sync.
`render_rays_uniform` is the grid-free path that renders the synthetic
ground truth.

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
from ..ops.rays import near_far_from_aabb, sph_from_ray
from ..ops.sampling import sample_pdf


@dataclass(frozen=True)
class RenderConfig:
    """Same fields and defaults as the JAX package's RenderConfig.  The eval
    path reads bound, cascades, grid_size, min_near, density_scale,
    dt_gamma, max_steps, K, K_eval, T_thresh, bg_radius, eval_stream,
    eval_budget, march_chunk, eval_cb_mult and eval_ray_chunk_cap; the
    train path adds march_dense and compact_fraction, the uniform path
    num_steps and upsample_steps, the grid update density_thresh."""

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
    depth [N], weights_sum [N], num_points [], ray_mask [N]); gradients flow
    to the field's weights.  A field whose `sigma_rgb` returns a third entry,
    a dict of per-sample values, adds dict `aux` of their sums over the
    selected samples divided by max(num_points, 1), where num_points is the
    march's demand, not the selected count (as the JAX package).  Where the
    JAX function takes a key, this one takes the per-ray `noise` itself."""
    N = rays_o.shape[0]
    if not cfg.march_dense:
        raise NotImplementedError("only the march_dense training render is ported")
    if cfg.compact_fraction >= 1.0:
        raise ValueError("march_dense requires compact_fraction < 1")
    if not _use_chunk(cfg):
        raise NotImplementedError(
            "only the chunked training march is ported (march_chunk > 0 dividing max_steps)")
    nears, fars = near_far_from_aabb(rays_o, rays_d, cfg.aabb, cfg.min_near)
    bg = _resolve_bg(field, params, rays_o, rays_d, cfg, bg_color)
    with torch.no_grad():  # the march is integer selection: nothing to differentiate
        cm = march_rays_chunked(
            rays_o, rays_d, nears, fars, bitfield,
            bound=cfg.bound, cascades=cfg.cascades, grid_size=cfg.grid_size,
            dt_gamma=cfg.dt_gamma, max_steps=cfg.max_steps,
            M_budget=train_sample_budget(N, cfg), G=cfg.march_chunk, noise=noise,
            dilated_grid=dilated_grid,
        )
        ray_id, x_c, d_c, dt_c, t_rel = ladder_samples(
            cm.sel, rays_o, rays_d, cm.t0,
            bound=cfg.bound, cascades=cfg.cascades, grid_size=cfg.grid_size,
            dt_gamma=cfg.dt_gamma, max_steps=cfg.max_steps,
        )
        ray_id = _ascending_ids(ray_id, cm.sel_valid, N)
    out = field.sigma_rgb(params, x_c, d_c)
    aux = None
    if len(out) == 3:
        # per-sample auxiliary outputs (D-NeRF's |deform|): the mean over the
        # selected samples, divided by the march's demand as in the JAX package
        sig_c, rgb_c, aux_c = out
        valid_f = cm.sel_valid.float()
        denom = torch.clamp(cm.num_points.float(), min=1.0)
        aux = {k: (a.reshape(-1) * valid_f).sum() / denom for k, a in aux_c.items()}
    else:
        sig_c, rgb_c = out
    ws, depth_raw, image = composite_stream(
        sig_c.float() * cfg.density_scale, rgb_c, dt_c, None, ray_id, cm.sel_valid,
        N, cfg.T_thresh, t_cum=t_rel,
    )
    image = image + (1.0 - ws)[:, None] * bg
    depth = torch.clamp(depth_raw - nears, min=0.0) / torch.clamp(fars - nears, min=1e-6)
    results = {
        "image": image,
        "depth": depth,
        "weights_sum": ws,
        "num_points": cm.num_points,
        "ray_mask": cm.ray_mask,
    }
    if aux is not None:
        results["aux"] = aux
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
            sigmas = field.density(params, points_cf(z_vals)).reshape(z_vals.shape)
            weights = _alpha_weights(cfg.density_scale * deltas_of(z_vals), sigmas.float())
            z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
            new_z = sample_pdf(z_mid, weights[:, 1:-1], upsample_steps, det=(u is None), u=u)
            z_vals = torch.sort(torch.cat([z_vals, new_z], dim=-1), dim=-1).values

    S = z_vals.shape[-1]
    dirs_cf = rays_d.T[:, :, None].expand(3, N, S).reshape(3, -1)
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
    ray_id, x_c, d_c, dt_c, t_rel = ladder_samples(
        sel[:Mq], rays_o, rays_d, t0,
        bound=cfg.bound, cascades=cfg.cascades, grid_size=cfg.grid_size,
        dt_gamma=cfg.dt_gamma, max_steps=cfg.max_steps,
    )
    ray_id = _ascending_ids(ray_id, sel_valid[:Mq], n_rays)
    sig_c, rgb_c = field.sigma_rgb(params, x_c, d_c)[:2]
    return composite_stream(
        sig_c.float() * cfg.density_scale, rgb_c, dt_c, None, ray_id,
        sel_valid[:Mq], n_rays, cfg.T_thresh, t_cum=t_rel,
    )


def _eval_stream_march(rays_o, rays_d, nears, fars, bitfield, cfg, dgrid=None, G=None):
    """The first eval pass's march: the chunked march once, its sample
    budget M the first M valid samples (ray-major).  Returns the
    `ChunkedMarch`."""
    N = rays_o.shape[0]
    S = cfg.max_steps
    M = min(N * S, max(128, -(-int(N * cfg.K * cfg.eval_budget) // 128) * 128))
    G = cfg.march_chunk if G is None else G
    if not (cfg.march_chunk > 0 and S % G == 0):
        raise NotImplementedError("only the chunked eval march is ported (march_chunk > 0)")
    cb = -(-int(cfg.eval_cb_mult * M) // G)
    return march_rays_chunked(
        rays_o, rays_d, nears, fars, bitfield,
        bound=cfg.bound, cascades=cfg.cascades, grid_size=cfg.grid_size,
        dt_gamma=cfg.dt_gamma, max_steps=cfg.max_steps,
        M_budget=M, G=G, dilated_grid=dgrid, chunk_budget=cb,
        ray_chunk_cap=cfg.eval_ray_chunk_cap or None,
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
    residual rounds, at most ceil(max_steps / K_eval) + 2 of them.  Returns
    dict(image [N, 3], depth [N], weights_sum [N], cut [N], rounds,
    samples, valid_samples, host_reads): `cut` marks the rays still alive
    when the round cap ended the loop (a device tensor); the last four are
    host integers: the residual rounds run, the field-query width summed
    over passes, the real samples among them, and the device-to-host
    reads."""
    if not (cfg.eval_stream and _use_chunk(cfg)):
        raise NotImplementedError("only the chunked stream eval is ported")
    N = rays_o.shape[0]
    K = cfg.K_eval
    nears, fars = near_far_from_aabb(rays_o, rays_d, cfg.aabb, cfg.min_near)
    bg = _resolve_bg(field, params, rays_o, rays_d, cfg, bg_color)
    stats = {"samples": 0, "valid_samples": 0, "host_reads": 0}

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
        stats["host_reads"] += 1
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
        upd = scatter_add(sel, delta.contiguous(), N, indices="sorted")  # ascends, fill N-1
        rays_t = rays_t + upd[:, 0]
        ws = ws + upd[:, 1]
        depth = depth + upd[:, 2]
        image = image + upd[:, 3:6]
        rnd += 1

    cut = (rays_t < fars) & (1.0 - ws >= cfg.T_thresh)  # alive when the round cap ended it
    image = image + (1.0 - ws)[:, None] * bg
    depth = torch.clamp(depth - nears, min=0.0) / torch.clamp(fars - nears, min=1e-6)
    return {"image": image, "depth": depth, "weights_sum": ws, "cut": cut, "rounds": rnd,
            **stats}
