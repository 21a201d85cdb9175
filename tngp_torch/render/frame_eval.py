"""Frame-level eval with a persistent alive set — the port of
`tngp/render/frame_eval.py` `FrameRenderer`.

A frame renders in two stages, as in the JAX package:

1. the first pass per chunk of rays: one chunked march and one bucketed
   field query each (`renderer._eval_stream_march` / `_eval_stream_query`),
   with chunks whose rays all miss the occupied cells' bounding box skipped
   (their state is analytic: dead at `far`, no radiance);
2. frame-global residual rounds: the alive rays of the whole frame are
   compacted into one buffer whose width comes from the tier ladder
   `cfg.eval_tiers`, marched with a budget sized to that tier, queried, and
   their state updated, until every ray is dead or `max_rounds` is reached.

The JAX package runs each tier's rounds in a `lax.while_loop` on the device
and picks query widths with `lax.cond`.  Here the same decisions are host
control, taken in the same order, so `last_rounds` and the tier sequence
equal the JAX package's.  They cost device-to-host reads, counted in
`host_reads`:

- one read of the per-chunk hit bitmap;
- one read of every marched chunk's selected-sample count, after all
  first-pass marches are queued (the bucket choice of each chunk's query);
- one read of the alive count after the first pass (none when no chunk was
  marched: every ray is then dead);
- one read per residual round.  A round's march is queued before the host
  knows whether the round runs: the read brings back the alive count after
  the previous round together with this march's sample count.  When the
  count says that the tier's loop ends, that march is dropped; so each
  tier exit on the alive count costs one read more.

So a frame makes `3 + rounds + tier exits` reads (`1` when no chunk is
marched), at most `1 + first-pass chunks + rounds` once a frame has
`2 + tiers` marched chunks, as an 800x800 frame has.

The round update adds each round's zero-masked deltas into the frame state
with `scatter_add(..., indices="unique")`: the compaction fills its unused
slots with the frame's last ray (`nonzero_static(alive, na, n - 1)`) for the
gathers, and the update gives them distinct rows past the frame (`n + slot`),
which the scatter drops, so every index is distinct and each alive ray's
row is stored once.  The JAX package points unused slots at ray 0 and adds
with XLA's scatter; every entry of an unused slot is zero, so the state is
the same.  The sorted form would hold too, but it searches the index list
once per frame row, and a round updates at most `na` of the frame's rows.
"""

from __future__ import annotations

import torch

from ..kernels.scatter import scatter_add
from ..ops.march import build_dilated_cell_grid, chunk_dilate, march_rays_chunked, nonzero_static
from ..ops.rays import near_far_from_aabb
from .renderer import (
    FieldFns,
    RenderConfig,
    _bucketed_stream_query,
    _eval_stream_march,
    _eval_stream_query,
    _resolve_bg,
)


class FrameRenderer:
    """First pass, residual tier rounds and finalisation for one (field,
    cfg) pair.  Trainers hold one instance per eval configuration.  After a
    `render`, `last_rounds` holds the residual rounds it ran, `last_tiers`
    the tier width of each tier loop it entered, in order, `host_reads` the
    device-to-host reads it made, `last_stats` all of these with the sample
    counts and the chunks marched, and `last_cut` (a device tensor [N]) the
    rays that `max_rounds` left alive."""

    def __init__(self, field: FieldFns, cfg: RenderConfig, chunk: int = 8192):
        self.field = field
        self.cfg = cfg
        self.chunk = chunk
        self.tiers = tuple(cfg.eval_tiers)
        # the eval march's probe granularity and the rounds' ladder window
        self.G_eval = cfg.eval_march_chunk or cfg.march_chunk
        if cfg.max_steps % self.G_eval:
            self.G_eval = cfg.march_chunk
        rl = cfg.eval_round_ladder or cfg.max_steps
        self.round_ladder = rl if rl % self.G_eval == 0 else cfg.max_steps
        self.last_rounds = 0
        self.last_tiers: list[int] = []
        self.host_reads = 0
        self.last_stats: dict = {}
        self.last_cut = None

    # ---------------------------------------------------------------- stages
    def _dg(self, bitfield):
        """The dilated grid at the eval march's granularity."""
        cfg = self.cfg
        return build_dilated_cell_grid(
            bitfield, bound=cfg.bound, cascades=cfg.cascades, grid_size=cfg.grid_size,
            dilate=chunk_dilate(self.G_eval, cfg.max_steps, cfg.grid_size, cfg.bound),
        )

    def _occ_bbox(self, bitfield: torch.Tensor) -> torch.Tensor:
        """World-space box of all occupied cells with a one-cell margin, the
        union over cascades, [6] float32; an empty bitfield gives the scene's
        box."""
        cfg = self.cfg
        H = cfg.grid_size
        dev = bitfield.device
        shifts = torch.arange(8, dtype=torch.uint8, device=dev)
        bits = ((bitfield[:, None] >> shifts) & 1).reshape(cfg.cascades, H, H, H) > 0
        lo = torch.full((3,), float("inf"), dtype=torch.float32, device=dev)
        hi = torch.full((3,), -float("inf"), dtype=torch.float32, device=dev)
        idx = torch.arange(H, dtype=torch.float32, device=dev)
        for cas in range(cfg.cascades):
            b_c = min(2.0 ** cas, float(cfg.bound))
            cell = 2.0 * b_c / H
            m = bits[cas]
            any_ax = [m.any(dim=tuple(a for a in range(3) if a != d)) for d in range(3)]
            lo_i = torch.stack([torch.where(a, idx, float(H)).min() for a in any_ax])
            hi_i = torch.stack([torch.where(a, idx, -1.0).max() for a in any_ax])
            has = any_ax[0].any() | any_ax[1].any() | any_ax[2].any()
            lo_c = torch.where(has, (lo_i - 1.0) * cell - b_c, float("inf"))
            hi_c = torch.where(has, (hi_i + 2.0) * cell - b_c, -float("inf"))
            lo = torch.minimum(lo, lo_c)
            hi = torch.maximum(hi, hi_c)
        b = float(cfg.bound)
        empty = ~torch.isfinite(lo[0])
        lo = torch.where(empty, -b, torch.clamp(lo, -b, b))
        hi = torch.where(empty, b, torch.clamp(hi, -b, b))
        return torch.cat([lo, hi])

    def _alive(self, rays_t, ws, fars):
        return (rays_t < fars) & (1.0 - ws >= self.cfg.T_thresh)

    def _compact_alive(self, na: int, rays_t, ws, fars):
        """The first `na` alive ray indices, ascending, unused slots filled
        with the last ray, and each slot's validity."""
        alive = self._alive(rays_t, ws, fars)
        n = alive.shape[0]
        idx = nonzero_static(alive, na, n - 1)
        ok = torch.arange(na, device=alive.device) < alive.sum()
        return idx, ok

    def _round_march(self, na: int, bitfield, dgrid, o_f, d_f, rays_t, ws, fars_f):
        """Compaction and march of one residual round at tier width `na`.
        Returns the round's gathered inputs and its march; nothing of the
        frame state changes."""
        cfg = self.cfg
        idx, ok = self._compact_alive(na, rays_t, ws, fars_f)
        o_a, d_a = o_f[idx], d_f[idx]
        f_a = fars_f[idx]
        t_a = torch.where(ok, rays_t[idx], f_a)  # unused slots march nothing
        ws_a = ws[idx]
        # per-ray samples of a round: K_eval, fewer at wide tiers
        k_tier = max(8, min(cfg.K_eval, int(cfg.eval_round_budget) // na))
        m_res = max(128, -(-na * k_tier // 128) * 128)
        cm = march_rays_chunked(
            o_a, d_a, t_a, f_a, bitfield,
            bound=cfg.bound, cascades=cfg.cascades, grid_size=cfg.grid_size,
            dt_gamma=cfg.dt_gamma, max_steps=cfg.max_steps,
            M_budget=m_res, G=self.G_eval, dilated_grid=dgrid,
            ladder_steps=self.round_ladder,
            ray_chunk_cap=cfg.eval_ray_chunk_cap or None,
        )
        return (idx, ok, o_a, d_a, t_a, ws_a), cm

    def _round_update(self, na: int, params, state, gathered, cm, m_eff: int, stats):
        """Query the round's march and add its zero-masked deltas into the
        frame state (rays_t, ws, depth, image); continues from the
        accumulated transmittance (raymarching.cu:884)."""
        rays_t, ws, depth, image = state
        idx, ok, o_a, d_a, t_a, ws_a = gathered
        ws_c, dep_c, img_c = _bucketed_stream_query(
            self.field, params, cm.sel, cm.sel_valid, o_a, d_a, cm.t0, na, self.cfg,
            stats, m_eff=m_eff,
        )
        okf = ok.float()
        T_in = torch.clamp(1.0 - ws_a, min=0.0) * okf
        delta = torch.cat([
            ((cm.resume_t - t_a) * okf)[:, None],
            (T_in * ws_c)[:, None],
            (T_in * (dep_c + t_a * ws_c))[:, None],
            T_in[:, None] * img_c,
        ], dim=1)
        n = rays_t.shape[0]
        # unused slots: distinct rows past the frame, which the scatter drops
        sid = torch.where(ok, idx, n + torch.arange(na, device=idx.device))
        upd = scatter_add(sid, delta.contiguous(), n, indices="unique")
        return (rays_t + upd[:, 0], ws + upd[:, 1], depth + upd[:, 2], image + upd[:, 3:6])

    def _finalize(self, params, o, d, ws, depth, image, nears, fars, bg_color):
        cfg = self.cfg
        bg = _resolve_bg(self.field, params, o, d, cfg, bg_color)
        image = image + (1.0 - ws)[:, None] * bg
        depth = torch.clamp(depth - nears, min=0.0) / torch.clamp(fars - nears, min=1e-6)
        return image, depth

    def _read(self, *scalars) -> list:
        """One device-to-host copy of device scalars, counted."""
        self.host_reads += 1
        return torch.stack([s.reshape(()).long() for s in scalars]).tolist()

    # ------------------------------------------------------------------ drive
    def _quantum(self, n: int) -> int:
        """Frames are padded to a 65,536-ray multiple when the chunk divides
        it, so the frame state's shapes do not depend on the chunk."""
        return 65536 if (n >= 65536 and 65536 % self.chunk == 0) else self.chunk

    @torch.no_grad()
    def warmup(self, params, bitfield, n_rays: int):
        """Run every stage once at its shapes for a frame of `n_rays` rays
        (the first pass on one chunk of rays through the scene's centre, then
        one compaction and march at each tier width over a dead frame), so
        that the kernels' libraries are loaded and the allocator holds its
        blocks before a timed frame.  The JAX package compiles its programs
        here."""
        cfg = self.cfg
        dev = bitfield.device
        n = n_rays + ((-n_rays) % self._quantum(n_rays))
        dgrid = self._dg(bitfield)
        b = float(cfg.bound)
        o = torch.tensor([0.0, 0.0, 3.0 * b], device=dev).expand(self.chunk, 3).contiguous()
        d = torch.tensor([0.0, 0.0, -1.0], device=dev).expand(self.chunk, 3).contiguous()
        nears, fars = near_far_from_aabb(o, d, cfg.aabb, cfg.min_near)
        cm = _eval_stream_march(o, d, nears, fars, bitfield, cfg, dgrid, self.G_eval)
        _eval_stream_query(self.field, params, cm, o, d, nears, cfg)
        o_f = torch.zeros((n, 3), device=dev)
        z = torch.zeros((n,), device=dev)
        for na in self.tiers:
            self._round_march(na, bitfield, dgrid, o_f, o_f, z, z, z)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    @torch.no_grad()
    def render(self, params, rays_o, rays_d, bitfield, dgrid=None, bg_color=None,
               max_rounds: int = 64):
        """Render a batch of rays (a whole frame, typically).  `dgrid` is the
        caller's dilated grid at `cfg.march_chunk`; the eval march builds its
        own when its granularity differs.  Returns (image [N, 3], depth [N])
        on the rays' device."""
        cfg = self.cfg
        dev = rays_o.device
        self.host_reads = 0
        stats = {"samples": 0, "valid_samples": 0, "host_reads": 0}
        if self.G_eval != cfg.march_chunk or dgrid is None:
            dgrid = self._dg(bitfield)
        n = rays_o.shape[0]
        chunk = self.chunk
        pad = (-n) % self._quantum(n)
        # padding rays miss the box (origin outside, pointing away), so the
        # first pass retires them; zero rays would get far = +inf and stay
        # alive to max_rounds
        b = float(cfg.bound)
        o = torch.cat([rays_o.float(), torch.tensor([0.0, 0.0, 3.0 * b], device=dev).expand(pad, 3)])
        d = torch.cat([rays_d.float(), torch.tensor([0.0, 0.0, 1.0], device=dev).expand(pad, 3)])
        nf_f, ff_f = near_far_from_aabb(o, d, cfg.aabb, cfg.min_near)
        nchunks = (n + pad) // chunk
        # sky-chunk skip: a chunk none of whose rays enters the occupied
        # cells' box selects no sample; one read of the per-chunk bitmap
        nb, fb = near_far_from_aabb(o, d, self._occ_bbox(bitfield), cfg.min_near)
        self.host_reads += 1
        hits = (nb < fb).reshape(nchunks, chunk).any(dim=1).tolist()

        # first pass: every marched chunk's march queued, their sample
        # counts read in one copy, then every chunk's query
        marched = {}
        for ci in range(nchunks):
            if hits[ci]:
                s = slice(ci * chunk, (ci + 1) * chunk)
                marched[ci] = _eval_stream_march(o[s], d[s], nf_f[s], ff_f[s], bitfield, cfg,
                                                 dgrid, self.G_eval)
        m_effs = self._read(*[cm.m_eff for cm in marched.values()]) if marched else []
        parts = []
        for ci in range(nchunks):
            s = slice(ci * chunk, (ci + 1) * chunk)
            if ci in marched:
                parts.append(_eval_stream_query(self.field, params, marched.pop(ci), o[s], d[s],
                                                nf_f[s], cfg, stats, m_eff=m_effs.pop(0)))
            else:
                z = torch.zeros((chunk,), dtype=torch.float32, device=dev)
                parts.append((ff_f[s], z, z, torch.zeros((chunk, 3), dtype=torch.float32,
                                                         device=dev)))
        rays_t, ws, depth, image = (torch.cat([p[i] for p in parts]) for i in range(4))

        # residual rounds: the tier loops of the JAX package, on the host
        self.last_rounds = 0
        self.last_tiers = []
        state = (rays_t, ws, depth, image)
        n_alive = self._read(self._alive(rays_t, ws, ff_f).sum())[0] if any(hits) else 0
        while n_alive > 0 and self.last_rounds < max_rounds:
            ti = next((i for i, t in enumerate(self.tiers) if t >= n_alive), len(self.tiers) - 1)
            na = self.tiers[ti]
            stop = self.tiers[ti - 1] if ti > 0 else 0
            cap = max_rounds - self.last_rounds
            self.last_tiers.append(na)
            it, alive_dev = 0, None
            while it < cap:
                gathered, cm = self._round_march(na, bitfield, dgrid, o, d, state[0], state[1],
                                                 ff_f)
                if alive_dev is None:  # the tier's first round: the count is known
                    (m_eff,) = self._read(cm.m_eff)
                else:
                    n_alive, m_eff = self._read(alive_dev, cm.m_eff)
                    if n_alive <= stop:
                        break  # the tier's loop ends: this march is dropped
                state = self._round_update(na, params, state, gathered, cm, m_eff, stats)
                it += 1
                self.last_rounds += 1
                alive_dev = self._alive(state[0], state[1], ff_f).sum()

        self.last_cut = self._alive(state[0], state[1], ff_f)[:n]
        image, depth = self._finalize(params, o, d, state[1], state[2], state[3], nf_f, ff_f,
                                      bg_color)
        self.last_stats = dict(
            samples=stats["samples"], valid_samples=stats["valid_samples"],
            rounds=self.last_rounds, tiers=list(self.last_tiers), host_reads=self.host_reads,
            chunks=nchunks, chunks_marched=sum(hits))
        return image[:n], depth[:n]
