"""The JAX hash encode's input gradient, the compositor's forward and
backward and the uniform render path against the torch oracles of
`test_torch_parity.py` (its set-up and tolerances), in a file that the
tier-1 run queues behind the longest JAX test file."""

import numpy as np
import torch
import jax
import jax.numpy as jnp

from tngp.ops.hashgrid import hash_encode_cf_vjp
from test_torch_parity import _TinyField, _spec, torch_hash_encode


def test_hash_encode_input_grad_vs_torch():
    spec = _spec("hash")
    rng = np.random.default_rng(2)
    x = rng.uniform(0.1, 0.9, (64, 3)).astype(np.float32)
    table = rng.normal(0, 0.1, (spec.total_params, spec.level_dim)).astype(np.float32)
    cot = rng.normal(0, 1, (64, spec.output_dim)).astype(np.float32)

    def f(xc):
        out = hash_encode_cf_vjp(xc, jnp.asarray(table), spec)
        return jnp.sum(out * jnp.asarray(cot).T)

    g_ours = np.asarray(jax.grad(f)(jnp.asarray(x).T)).T  # [B, 3]

    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    out = torch_hash_encode(xt, torch.from_numpy(table), spec)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(g_ours, xt.grad.numpy(), atol=2e-3, rtol=2e-3)


def test_composite_fwd_bwd_vs_torch():
    """Slab compositing (exp-cumsum form) vs the reference run()-style
    cumprod-of-(1-alpha) form in torch, fwd + grads wrt sigmas
    (nerf/renderer.py:219-230; raymarching.cu:500-577 closed form)."""
    from tngp.ops.composite import composite_rays

    rng = np.random.default_rng(4)
    N, K = 32, 24
    sig = rng.uniform(0, 12, (N, K)).astype(np.float32)
    rgb = rng.uniform(0, 1, (N, K, 3)).astype(np.float32)
    dts = rng.uniform(0.005, 0.03, (N, K)).astype(np.float32)
    mask = rng.uniform(size=(N, K)) < 0.8
    # make masks prefix-contiguous like real marched slabs
    mask = np.sort(mask, axis=1)[:, ::-1].copy()
    cot_img = rng.normal(size=(N, 3)).astype(np.float32)

    def ours(s):
        ws, depth, image, w = composite_rays(
            s, jnp.asarray(rgb), jnp.asarray(dts), jnp.asarray(dts),
            jnp.asarray(mask), T_thresh=0.0,
        )
        return jnp.sum(image * jnp.asarray(cot_img)), (ws, image)

    (loss, (ws_o, img_o)), g_ours = jax.value_and_grad(ours, has_aux=True)(
        jnp.asarray(sig)
    )

    st = torch.from_numpy(sig.copy()).requires_grad_(True)
    m = torch.from_numpy(mask.astype(np.float32))
    tau = st * torch.from_numpy(dts) * m
    alpha = 1.0 - torch.exp(-tau)
    shifted = torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-15], dim=1)
    w = alpha * torch.cumprod(shifted, dim=1)[:, :-1] * m
    img_t = torch.einsum("nk,nkc->nc", w, torch.from_numpy(rgb))
    (img_t * torch.from_numpy(cot_img)).sum().backward()

    np.testing.assert_allclose(np.asarray(img_o), img_t.detach().numpy(),
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(g_ours), st.grad.numpy(),
                               atol=2e-4, rtol=2e-3)


def test_uniform_render_path_vs_torch():
    """Deterministic uniform+importance path: pixel values AND parameter grads
    allclose vs a from-spec torch replica of nerf/renderer.py:126-254."""
    from tngp.render import RenderConfig, render_rays_uniform

    field = _TinyField()
    cfg = RenderConfig(bound=1.0, min_near=0.05)
    N, S, U = 16, 16, 16
    rng = np.random.default_rng(6)
    rays_o = np.zeros((N, 3), np.float32)
    rays_o[:, 2] = -2.5
    d = rng.normal(0, 0.08, (N, 3)).astype(np.float32)
    d[:, 2] += 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    cot = rng.normal(size=(N, 3)).astype(np.float32)

    def ours(p):
        out = render_rays_uniform(
            field.field_fns(), p, jnp.asarray(rays_o), jnp.asarray(d), cfg,
            num_steps=S, upsample_steps=U, key=None, bg_color=None,
        )
        return jnp.sum(out["image"] * jnp.asarray(cot)), out["image"]

    (_, img_o), g_ours = jax.value_and_grad(ours, has_aux=True)(field.params_jax())

    # ---- torch replica (from the reference `run` spec) ----
    to = torch.from_numpy(rays_o)
    td = torch.from_numpy(d)
    field.torch_params()
    # near/far from aabb (slab method), min_near clamp
    inv = 1.0 / td
    t0 = (-1.0 - to) * inv
    t1 = (1.0 - to) * inv
    tmin = torch.minimum(t0, t1).amax(dim=1)
    tmax = torch.maximum(t0, t1).amin(dim=1)
    nears = torch.clamp(tmin, min=cfg.min_near)
    fars = tmax
    z = torch.linspace(0.0, 1.0, S)
    z_vals = nears[:, None] + (fars - nears)[:, None] * z[None, :]
    sample_dist = (fars - nears) / S

    def composite(zv):
        pts = to[:, None, :] + td[:, None, :] * zv[:, :, None]
        pts = torch.clamp(pts, -1.0, 1.0)
        sig, rgb = field.torch_eval(pts.reshape(-1, 3))
        sig = sig.reshape(zv.shape)
        rgb = rgb.reshape(*zv.shape, 3)
        deltas = torch.cat([zv[:, 1:] - zv[:, :-1], sample_dist[:, None]], dim=1)
        alpha = 1.0 - torch.exp(-deltas * sig)
        shifted = torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-15], dim=1)
        w = alpha * torch.cumprod(shifted, dim=1)[:, :-1]
        return w, rgb

    with torch.no_grad():
        w, _ = composite(z_vals)
        # sample_pdf (det) on interior weights, renderer.py:36-46
        z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
        wts = w[:, 1:-1] + 1e-5
        pdf = wts / wts.sum(dim=1, keepdim=True)
        cdf = torch.cumsum(pdf, dim=1)
        cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=1)
        u = torch.linspace(0.5 / U, 1.0 - 0.5 / U, U).expand(N, U).contiguous()
        inds = torch.searchsorted(cdf, u, right=True)
        below = torch.clamp(inds - 1, min=0)
        above = torch.clamp(inds, max=cdf.shape[1] - 1)
        cdf_b = torch.gather(cdf, 1, below)
        cdf_a = torch.gather(cdf, 1, above)
        bins_b = torch.gather(z_mid, 1, torch.clamp(below, max=z_mid.shape[1] - 1))
        bins_a = torch.gather(z_mid, 1, torch.clamp(above, max=z_mid.shape[1] - 1))
        denom = torch.where(cdf_a - cdf_b < 1e-5, torch.ones_like(cdf_b), cdf_a - cdf_b)
        new_z = bins_b + (u - cdf_b) / denom * (bins_a - bins_b)
    z_all, _ = torch.sort(torch.cat([z_vals, new_z], dim=1), dim=1)
    w, rgb = composite(z_all)
    img_t = torch.einsum("nk,nkc->nc", w, rgb) + (1.0 - w.sum(dim=1))[:, None] * 1.0
    (img_t * torch.from_numpy(cot)).sum().backward()

    np.testing.assert_allclose(np.asarray(img_o), img_t.detach().numpy(),
                               atol=5e-5, rtol=5e-4)
    for name, gj, tt in (("w1", g_ours["w1"], field.tw1),
                         ("w2", g_ours["w2"], field.tw2),
                         ("w3", g_ours["w3"], field.tw3)):
        np.testing.assert_allclose(
            np.asarray(gj), tt.grad.numpy(), atol=3e-4, rtol=3e-3,
            err_msg=f"param grad mismatch: {name}",
        )
