"""The plain reference's volume rendering, shared by the configurations:
camera rays, the occupancy-grid ladder march, transmittance compositing
with early termination, the masked photometric loss, Adam, and the checks
of a training batch and of the grid's bits.  A configuration's module
(`ngp.py`, `tensorf.py`) brings its field.

Plain PyTorch in float32 with TF32 off, from the published equations and
the configuration file alone: it imports nothing of the program.  It walks
every rung of every ray and composites dense `[rays, rungs]` slabs, and
autograd takes the gradients, where the program compacts samples and
writes its backward out by hand.

The control (`precision="low"`) rounds a field's operands one step below
the configuration's precision: `fp8` (float8 e4m3 under a per-tensor
scale) for bfloat16, `bf16` for float32."""

from __future__ import annotations

import math

import torch

BIG = 3.4e38  # near and far of a ray that misses the box


def no_tf32() -> None:
    """float32 matrix products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (amax -> 448), the
    gradient passed straight through."""
    s = torch.clamp(x.detach().abs().amax(), min=1e-30) / 448.0
    q = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - x.detach())


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, the gradient passed straight through."""
    return x + (x.detach().to(torch.bfloat16).float() - x.detach())


def same(x: torch.Tensor) -> torch.Tensor:
    return x


class TruncExp(torch.autograd.Function):
    """exp, its gradient taken at the input clamped to [-15, 15]."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def mlp(h: torch.Tensor, weights: list, q=same) -> torch.Tensor:
    """Bias-free ReLU MLP, weights [fan_in, fan_out]; with `q` (the
    control) each product's operands rounded by q and its output to
    bfloat16, the precision the configuration states for it."""
    for i, w in enumerate(weights):
        h = q(h) @ q(w)
        if q is not same:
            h = bf16(h)
        if i != len(weights) - 1:
            h = torch.relu(h)
    return h


# ------------------------------------------------------------- rays, march
def pixel_rays(pose: torch.Tensor, intr, rows: torch.Tensor, cols: torch.Tensor):
    """Rays through pixel centres (row, col) of a pinhole camera (pose [4,
    4] camera-to-world, the camera looking down its +z; intr fx, fy, cx,
    cy).  Returns o, d [n, 3], d of unit length."""
    fx, fy, cx, cy = (float(v) for v in intr)
    u = ((cols.float() + 0.5) - cx) / fx
    v = ((rows.float() + 0.5) - cy) / fy
    dc = torch.stack([u, v, torch.ones_like(u)], dim=1)
    dc = dc / torch.sqrt((dc * dc).sum(dim=1, keepdim=True))
    R = pose[:3, :3]
    d = torch.stack([dc[:, 0] * R[r, 0] + dc[:, 1] * R[r, 1] + dc[:, 2] * R[r, 2]
                     for r in range(3)], dim=1)
    return pose[:3, 3].expand(d.shape), d


def near_far(o: torch.Tensor, d: torch.Tensor, bound: float, min_near: float):
    """Entry and exit t of the box [-bound, bound]^3 (entry at least
    min_near); BIG for both where the ray misses."""
    inv = 1.0 / d
    t_a = (-bound - o) * inv
    t_b = (bound - o) * inv
    near = torch.minimum(t_a, t_b).amax(dim=1)
    far = torch.maximum(t_a, t_b).amin(dim=1)
    miss = near > far
    near = torch.clamp(near, min=min_near)
    big = torch.full_like(near, BIG)
    return torch.where(miss, big, near), torch.where(miss, big, far)


def occupied(bitfield: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
    """Bit `cell` of the packed grid: byte cell // 8, bit cell % 8."""
    byte = bitfield.long()[cell >> 3]
    return ((byte >> (cell & 7)) & 1).bool()


def rungs(o, d, t_start, noise, bitfield, cfg):
    """The ladder of each ray, all `max_steps` rungs: t_j = t0 + j dt with
    dt = 2 sqrt(3) / max_steps and t0 = t_start + dt * noise.  Returns (t0
    [n], t [n, S], occupied [n, S]): the grid cell of each rung's point,
    (x, y, z) -> (x H + y) H + z, is occupied."""
    r = cfg["render"]
    if r["dt_gamma"] != 0.0 or r["cascades"] != 1:
        raise ValueError("the reference marches one cascade at a constant step")
    S, H, b = r["max_steps"], r["grid_size"], cfg["bound"]
    dt = 2.0 * math.sqrt(3.0) / S
    dt_max = 2.0 * math.sqrt(3.0) / H
    t0 = t_start
    if noise is not None:
        t0 = t0 + torch.clamp(t0 * 0.0, dt, dt_max) * noise
    t = t0[:, None] + torch.arange(S, device=o.device).float()[None, :] * dt
    cell = torch.zeros(t.shape, dtype=torch.long, device=o.device)
    for a in range(3):
        p = torch.clamp(o[:, a:a + 1] + t * d[:, a:a + 1], -b, b)
        ix = torch.clamp(torch.nan_to_num(0.5 * (p / min(1.0, b) + 1.0) * H, nan=0.0),
                         0.0, float(H - 1)).long()
        cell = cell * H + ix
    return t0, t, occupied(bitfield, cell)


def composite(sigma, rgb, dt, t_rel, mask, T_thresh):
    """Dense slabs [n, S] (rgb [n, S, 3]) -> (weights sum [n], sum of w *
    t_rel [n], colour [n, 3]): w_i = T_i (1 - exp(-sigma_i dt)), T the
    transmittance before the rung, and every rung after the first one whose
    transmittance after it falls below T_thresh gets no weight."""
    m = mask.float()
    tau = sigma * dt * m
    acc = torch.cumsum(tau.double(), dim=1).float()
    w = torch.exp(-(acc - tau)) * -torch.expm1(-tau) * m
    stop = (torch.exp(-acc) < T_thresh).float() * m
    alive = ((torch.cumsum(stop, dim=1) - stop) < 0.5).float()
    w = w * alive
    return w.sum(dim=1), (w * t_rel).sum(dim=1), (w[..., None] * rgb).sum(dim=1)


# ------------------------------------------------------------------ training
def train_budget(n_rays: int, cfg: dict, fraction: float | None = None) -> int:
    """Samples a training step may query: n_rays K compact_fraction (or
    `fraction`), rounded up to a multiple of 128 (at least 128, at most
    every rung)."""
    r = cfg["render"]
    f = r["compact_fraction"] if fraction is None else fraction
    m = -(-int(n_rays * r["K"] * f) // 128) * 128
    return min(n_rays * r["max_steps"], max(128, m))


def adapted_budgets(demand: int, kept_share, tiers: list) -> set:
    """Of the sample budgets `tiers` (ascending) of an adaptive sample
    budget, those that a step whose valid rungs number `demand` may run at
    once its tier has adapted: a tier up as soon as fewer than 98% of the
    rays are kept (`kept_share(budget)`), a tier down where the demand
    leaves 1.6x headroom below the next tier down.  A single tier is always
    the one."""
    top = len(tiers) - 1
    return {m for i, m in enumerate(tiers)
            if (i == top or kept_share(m) >= 0.98) and (i == 0 or demand * 1.6 >= tiers[i - 1])}


def march_train(batch, bitfield, cfg, budget: int | None = None, tiers: list | None = None):
    """The samples a training step composites: every valid rung (occupied,
    t < far) in ray order, cut after the first `budget` of them
    (`train_budget` where None); a ray stays in the loss where none of its
    rungs was cut.  With `tiers`, the budgets of an adaptive sample budget,
    also the set of them the step may run at (`adapted_budgets`; `budget`
    is marched at where it is one of them, else the least of them).
    Returns dict(t0, t, valid [n, S], sel (flat indices ray * S + rung of
    the kept prefix), m_eff, kept [n], and with tiers, budget_off (1 where
    `budget` is not allowed))."""
    o, d = batch["rays_o"].float(), batch["rays_d"].float()
    r = cfg["render"]
    n = o.shape[0]
    near, far = near_far(o, d, cfg["bound"], r["min_near"])
    t0, t, occ = rungs(o, d, near, batch["noise"].float(), bitfield, cfg)
    valid = occ & (t < far[:, None])
    flat = torch.nonzero(valid.reshape(-1)).reshape(-1)

    def first_cut(m: int) -> int:  # the first ray with a rung past the budget (n: none)
        return n if m >= flat.numel() else int(flat[m]) // r["max_steps"]

    M = train_budget(n, cfg) if budget is None else budget
    out = {}
    if tiers is not None:
        allowed = adapted_budgets(flat.numel(), lambda m: first_cut(m) / n, tiers)
        out = {"budget_off": int(M not in allowed)}
        M = M if M in allowed else min(allowed)
    m_eff = min(M, flat.numel())
    kept = torch.ones(n, dtype=torch.bool, device=o.device)
    kept[first_cut(M):] = False
    return {"t0": t0, "t": t, "valid": valid, "sel": flat[:m_eff], "m_eff": m_eff,
            "kept": kept, **out}


def render_train(field, batch, march, cfg):
    """Colour of each ray of a training batch over its kept samples, on a
    white background.  Returns [n, 3]."""
    n, S = march["valid"].shape
    dt = 2.0 * math.sqrt(3.0) / S
    sel = march["sel"]
    ray = sel // S
    o, d = batch["rays_o"].float(), batch["rays_d"].float()
    t = march["t"].reshape(-1)[sel]
    x = torch.clamp(o[ray] + t[:, None] * d[ray], -cfg["bound"], cfg["bound"])
    sigma, rgb = field(x, d[ray])
    mask = torch.zeros(n * S, dtype=torch.bool, device=o.device)
    mask[sel] = True
    sig_slab = torch.zeros(n * S, device=o.device).index_put((sel,), sigma)
    rgb_slab = torch.zeros((n * S, 3), device=o.device).index_put((sel,), rgb)
    t_rel = march["t"] + dt - march["t0"][:, None]
    ws, _, color = composite(sig_slab.reshape(n, S), rgb_slab.reshape(n, S, 3), dt, t_rel,
                             mask.reshape(n, S), cfg["render"]["T_thresh"])
    return color + (1.0 - ws)[:, None]


def step_loss(field, batch, march, cfg):
    """(mean over the kept rays of each ray's mean squared colour error,
    the rays' colours)."""
    color = render_train(field, batch, march, cfg)
    per_ray = ((color - batch["gt_rgb"].float()) ** 2).mean(dim=1)
    kept = march["kept"].float()
    return (per_ray * kept).sum() / torch.clamp(kept.sum(), min=1.0), color


def adam_step(w: dict, g: dict, state: dict, step: int, cfg: dict) -> None:
    """One Adam step in place (bias-corrected, eps outside the root), at the
    learning rate lr * 0.1 ** (step / iters), `step` the steps taken since
    the moments started from zero."""
    tr = cfg["train"]
    b1, b2 = tr["betas"]
    lr = tr["lr"] * 0.1 ** min(step / tr["iters"], 1.0)
    t = step + 1
    for k in w:
        m, v = state.setdefault(k, (torch.zeros_like(w[k]), torch.zeros_like(w[k])))
        m = b1 * m + (1.0 - b1) * g[k]
        v = b2 * v + (1.0 - b2) * g[k] * g[k]
        state[k] = (m, v)
        denom = torch.sqrt(v) / math.sqrt(1.0 - b2 ** t) + tr["eps"]
        w[k] = w[k] - (lr / (1.0 - b1 ** t)) * m / denom


def train_steps(make_field, start: dict, batches: list, bitfields: list, cfg: dict,
                extra_loss=None, tiers: list | None = None) -> dict:
    """Follow len(batches) training steps from `start` on the given batches,
    step i marching through bitfields[i]; `make_field(leaves)` is the field
    over a dict of leaves, `extra_loss(leaves)` a term added to the
    photometric loss.  `start` holds `weights` (a dict of leaves), and
    where the steps do not start from fresh moments, `adam` ({leaf: (first,
    second moment)}) and `adam_step` (the steps those moments have taken),
    and where the steps do not start from the configured budget, `budget`:
    the samples the program's steps queried, held to the budgets `tiers`
    of the configuration's adaptive sample budget (`adapted_budgets`, at
    each step's batch) or, without tiers, to the configured one.  Returns
    dict(marches (each step's selection, kept rays and colours), losses
    [steps], grad_norms {leaf: norm of the first step's gradient}, grads
    (that gradient), change_norms {leaf: norm of the weights' change over
    all steps}, budget_off (the steps whose budget was not allowed))."""
    no_tf32()
    weights0 = start["weights"]
    w = {k: v.detach().float().clone() for k, v in weights0.items()}
    names = list(w)
    state = {k: (m.float().clone(), v.float().clone())
             for k, (m, v) in start.get("adam", {}).items()}
    step0 = int(start.get("adam_step", 0))
    budget = start.get("budget")
    if budget is not None and tiers is None:
        tiers = [train_budget(batches[0]["rays_o"].shape[0], cfg)]
    out = {"marches": [], "losses": [], "grad_norms": None, "change_norms": None,
           "budget_off": 0}
    for step, (batch, bitfield) in enumerate(zip(batches, bitfields)):
        with torch.no_grad():
            march = march_train(batch, bitfield, cfg, budget, tiers if budget else None)
        out["budget_off"] += march.get("budget_off", 0)
        leaves = {k: v.clone().requires_grad_(True) for k, v in w.items()}
        loss, color = step_loss(make_field(leaves), batch, march, cfg)
        if extra_loss is not None:
            loss = loss + extra_loss(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
        g = {k: (gk if gk is not None else torch.zeros_like(w[k])).detach()
             for k, gk in zip(names, grads)}
        if step == 0:
            out["grad_norms"] = {k: float(g[k].norm()) for k in names}
            out["grads"] = {k: g[k].clone() for k in names}
        with torch.no_grad():
            adam_step(w, g, state, step0 + step, cfg)
        out["losses"].append(float(loss.detach()))
        out["marches"].append({"sel": march["sel"], "m_eff": march["m_eff"],
                               "kept": march["kept"], "image": color.detach()})
        del leaves, grads, g, loss, color
    out["change_norms"] = {k: float((w[k] - weights0[k].float()).norm()) for k in names}
    return out


def grid_bits_off(density_grid: torch.Tensor, bitfield: torch.Tensor, cfg: dict) -> int:
    """Cells whose occupancy bit is not (density > the smaller of the mean
    density over known cells, unknown ones counted as 0, and the
    configuration's threshold)."""
    g = density_grid.reshape(-1).float()
    thresh = min(float(torch.clamp(g, min=0.0).mean()), cfg["render"]["density_thresh"])
    cells = torch.arange(g.numel(), device=g.device)
    return int((occupied(bitfield, cells) != (g > thresh)).sum())


def check_batch(batch, images: torch.Tensor, poses: torch.Tensor, intr) -> int:
    """Rays of a training batch that are not the camera ray of a pixel of
    the batch's frame with that pixel's colour as target: each ray's pixel
    is found from its direction, the ray built again and compared."""
    frame = int(batch["frame"])
    pose = poses[frame].float()
    d = batch["rays_d"].float()
    R = pose[:3, :3]
    dc = torch.stack([(d * R[:, k]).sum(dim=1) for k in range(3)], dim=1)  # R^T d
    fx, fy, cx, cy = (float(v) for v in intr)
    col = torch.round(dc[:, 0] / dc[:, 2] * fx + cx - 0.5).long()
    row = torch.round(dc[:, 1] / dc[:, 2] * fy + cy - 0.5).long()
    H, W = images.shape[1:3]
    inside = (col >= 0) & (col < W) & (row >= 0) & (row < H)
    rr, cc = torch.clamp(row, 0, H - 1), torch.clamp(col, 0, W - 1)
    o_ref, d_ref = pixel_rays(pose, intr, rr, cc)
    ok = inside & ((d_ref - d).abs().amax(dim=1) <= 1e-6)
    ok &= (o_ref == batch["rays_o"].float()).all(dim=1)
    ok &= (images[frame][rr, cc, :3].float() == batch["gt_rgb"].float()).all(dim=1)
    return int((~ok).sum())


# ---------------------------------------------------------------------- eval
@torch.no_grad()
def render_frame(field, bitfield: torch.Tensor, cfg: dict, pose, intr, H: int, W: int,
                 block: int = 16384):
    """A full frame of H x W pixels through `field`: every valid rung of
    every ray from its near point, composited with early termination on a
    white background.  Returns (image [H * W, 3], depth [H * W]): depth is
    the weighted sum of each sample's far end, from near (0) to far (1)."""
    no_tf32()
    r = cfg["render"]
    S = r["max_steps"]
    dt = 2.0 * math.sqrt(3.0) / S
    dev = bitfield.device
    pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
    pix = torch.arange(H * W, device=dev)
    chunk = 1 << 20
    images, depths = [], []
    for s in range(0, H * W, block):
        p = pix[s:s + block]
        o, d = pixel_rays(pose, intr, p // W, p % W)
        near, far = near_far(o, d, cfg["bound"], r["min_near"])
        _, t, occ = rungs(o, d, near, None, bitfield, cfg)
        valid = occ & (t < far[:, None])
        n = o.shape[0]
        sel = torch.nonzero(valid.reshape(-1)).reshape(-1)
        ray = sel // S
        ts = t.reshape(-1)[sel]
        x = torch.clamp(o[ray] + ts[:, None] * d[ray], -cfg["bound"], cfg["bound"])
        sig = torch.zeros(n * S, device=dev)
        rgb = torch.zeros((n * S, 3), device=dev)
        for c in range(0, sel.numel(), chunk):
            sg, cl = field(x[c:c + chunk], d[ray[c:c + chunk]])
            sig[sel[c:c + chunk]] = sg
            rgb[sel[c:c + chunk]] = cl
        ws, tw, color = composite(sig.reshape(n, S), rgb.reshape(n, S, 3), dt, t + dt, valid,
                                  r["T_thresh"])
        images.append(color + (1.0 - ws)[:, None])
        depths.append(torch.clamp(tw - near, min=0.0) / torch.clamp(far - near, min=1e-6))
    return torch.cat(images), torch.cat(depths)
