"""Bilinear and linear grid sampling, channels-first — the port of
`tngp/ops/grid_sample.py`, TensoRF's and CCNeRF's lookup primitive.

`grid_sample_2d_cf(plane [R, H, W], u, v)` and `grid_sample_1d_cf(line
[R, D], w)` take coordinates in [-1, 1] of shape [B] and return [R, B].
`align_corners=True` maps -1 and 1 to the first and last texel centres,
`(u + 1) * 0.5 * (W - 1)`; `align_corners=False` to the outer texel edges,
`((u + 1) * W - 1) * 0.5` (CCNeRF's).  Out-of-range corners are clipped for
the gather and weighted 0 (torch's zeros padding).  The arithmetic is the
JAX package's, operation by operation: corner values times weights summed
in the order (dy, dx) = (0, 0), (0, 1), (1, 0), (1, 1).

`grid_sample_2d_cf_vjp` / `grid_sample_1d_cf_vjp` are `torch.autograd.
Function`s with the JAX package's hand-written backward: the plane (line)
gradient is one `scatter_add(idx, vals, H * W, indices="any")` of the four
(two) corners' weighted cotangents, `vals` [4B, R] ([2B, R]) as JAX
concatenates them — on the card the `scatter_add_any` kernel, which the JAX
package reaches on the TPU through `scatter_add_auto`.  The coordinate
gradients are analytic and computed only when autograd asks for them
(TensoRF and CCNeRF never do: their positions come from the march).
"""

from __future__ import annotations

import torch

from ..kernels.scatter import scatter_add


def _frac_pos(u: torch.Tensor, n: int, align_corners: bool) -> torch.Tensor:
    u = u.float()
    if align_corners:
        return (u + 1.0) * 0.5 * (n - 1)
    return ((u + 1.0) * n - 1.0) * 0.5


def _scale(n: int, align_corners: bool) -> float:
    """d(texel position) / d(coordinate)."""
    return 0.5 * (n - 1) if align_corners else 0.5 * n


def _corners_2d(H: int, W: int, u, v, align_corners: bool):
    """[(flat index [B], weight * in-bounds [B], in-bounds [B] f32)] for the
    corners (dy, dx) = (0, 0), (0, 1), (1, 0), (1, 1); and (tx, ty)."""
    fx = _frac_pos(u, W, align_corners)
    fy = _frac_pos(v, H, align_corners)
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = fx - x0
    ty = fy - y0
    x0i = x0.long()
    y0i = y0.long()
    out = []
    for dy in (0, 1):
        for dx in (0, 1):
            xi = x0i + dx
            yi = y0i + dy
            inb = ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)).float()
            idx = torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1)
            w = (tx if dx else 1.0 - tx) * (ty if dy else 1.0 - ty)
            out.append((idx, w * inb, inb))
    return out, tx, ty


def _corners_1d(D: int, w, align_corners: bool):
    """[(index [B], weight * in-bounds [B], in-bounds [B] f32)] for dx = 0, 1."""
    fx = _frac_pos(w, D, align_corners)
    x0 = torch.floor(fx)
    tx = fx - x0
    x0i = x0.long()
    out = []
    for dx in (0, 1):
        xi = x0i + dx
        inb = ((xi >= 0) & (xi < D)).float()
        out.append((torch.clamp(xi, 0, D - 1), (tx if dx else 1.0 - tx) * inb, inb))
    return out


def grid_sample_2d_cf(plane: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                      align_corners: bool = True) -> torch.Tensor:
    """plane [R, H, W]; u (width coordinate), v (height coordinate) [B] in
    [-1, 1] -> [R, B] f32."""
    R, H, W = plane.shape
    flat = plane.reshape(R, H * W)
    corners, _, _ = _corners_2d(H, W, u, v, align_corners)
    out = torch.zeros((R, u.shape[0]), dtype=torch.float32, device=plane.device)
    for idx, w, _ in corners:
        out = out + flat[:, idx] * w[None, :]
    return out


def grid_sample_1d_cf(line: torch.Tensor, w: torch.Tensor,
                      align_corners: bool = True) -> torch.Tensor:
    """line [R, D]; w [B] in [-1, 1] -> [R, B] f32."""
    R, D = line.shape
    out = torch.zeros((R, w.shape[0]), dtype=torch.float32, device=line.device)
    for idx, wgt, _ in _corners_1d(D, w, align_corners):
        out = out + line[:, idx] * wgt[None, :]
    return out


def _gather_dot(g: torch.Tensor, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """sum_r g[r, b] * table[r, idx[b]] -> [B]."""
    return (g * table[:, idx]).sum(dim=0)


class _GridSample2D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plane, u, v, align_corners):
        ctx.align_corners = align_corners
        ctx.save_for_backward(plane, u, v)
        return grid_sample_2d_cf(plane, u, v, align_corners)

    @staticmethod
    def backward(ctx, g):
        plane, u, v = ctx.saved_tensors
        R, H, W = plane.shape
        g = g.float()
        corners, tx, ty = _corners_2d(H, W, u, v, ctx.align_corners)
        grad_plane = du = dv = None
        if ctx.needs_input_grad[0]:
            idx = torch.cat([c[0] for c in corners])  # [4B]
            vals = torch.cat([(g * c[1][None, :]).T for c in corners])  # [4B, R]
            grad_flat = scatter_add(idx, vals, H * W, indices="any")  # [H*W, R]
            grad_plane = grad_flat.T.reshape(R, H, W).to(plane.dtype)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            # each corner's forward weight is w_k * inb_k, so its term in
            # d/dfrac carries inb_k
            flat = plane.float().reshape(R, H * W)
            gd = [_gather_dot(g, flat, c[0]) * c[2] for c in corners]
            du = (-(1 - ty) * gd[0] + (1 - ty) * gd[1] - ty * gd[2] + ty * gd[3]) * _scale(
                W, ctx.align_corners)
            dv = (-(1 - tx) * gd[0] - tx * gd[1] + (1 - tx) * gd[2] + tx * gd[3]) * _scale(
                H, ctx.align_corners)
            du, dv = du.to(u.dtype), dv.to(v.dtype)
        return grad_plane, du, dv, None


class _GridSample1D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, line, w, align_corners):
        ctx.align_corners = align_corners
        ctx.save_for_backward(line, w)
        return grid_sample_1d_cf(line, w, align_corners)

    @staticmethod
    def backward(ctx, g):
        line, w = ctx.saved_tensors
        R, D = line.shape
        g = g.float()
        corners = _corners_1d(D, w, ctx.align_corners)
        grad_line = dw = None
        if ctx.needs_input_grad[0]:
            idx = torch.cat([c[0] for c in corners])  # [2B]
            vals = torch.cat([(g * c[1][None, :]).T for c in corners])  # [2B, R]
            grad_line = scatter_add(idx, vals, D, indices="any").T.to(line.dtype)
        if ctx.needs_input_grad[1]:
            lf = line.float()
            gd = [_gather_dot(g, lf, c[0]) * c[2] for c in corners]
            dw = ((gd[1] - gd[0]) * _scale(D, ctx.align_corners)).to(w.dtype)
        return grad_line, dw, None


def grid_sample_2d_cf_vjp(plane: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                          align_corners: bool = True) -> torch.Tensor:
    """`grid_sample_2d_cf` whose plane gradient is the `scatter_add_any`
    kernel on the card (module docstring)."""
    return _GridSample2D.apply(plane, u, v, align_corners)


def grid_sample_1d_cf_vjp(line: torch.Tensor, w: torch.Tensor,
                          align_corners: bool = True) -> torch.Tensor:
    """`grid_sample_1d_cf` whose line gradient is the `scatter_add_any`
    kernel on the card (module docstring)."""
    return _GridSample1D.apply(line, w, align_corners)
