"""`tngp_torch/ops/compaction.py` against `tngp/ops/compaction.py`, and the
slab compositors `composite_rays` / `composite_rays_flat` of
`tngp_torch/ops/composite.py` against `tngp/ops/composite.py`:

- `compact_mask` with a budget below and above the valid count: `sel`,
  `sel_valid`, `rank` and `in_budget` exactly; `ray_in_budget_from_counts`
  exactly against the JAX function, and equal, on the rays with samples, to
  the slab form `all(in_budget == mask)` the slab training render uses; `gather_cf` and `expand_to_slab`
  exactly (gathers);
- `composite_rays` (colours last) and `composite_rays_flat` against the
  JAX functions under `jit`, forward and the gradients of sigmas and
  colours, at `test_torch_slab_march.py`'s stated tolerances for
  `composite_rays_cf`, which they call: an early-stop flip counted (at
  most 1 sample), the other rays within 1e-6 (weights, depth, image) and
  1e-5 (gradients, norm-relative).

`compact_mask_hier` is `test_torch_compaction_hier.py`'s.  The cases
compile JAX programs: this file has three."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tngp.ops import compaction as jcomp
from tngp.ops import composite as jc
from tngp_torch.ops import compaction as tcomp
from tngp_torch.ops import composite as tc
from torch_tensorf_helpers import rel_err
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _mask(N, K, seed, p=0.3):
    """Run-clustered validity, as a march gives it, with empty rays."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(size=(N, K)) < p
    m[:, 1:] |= m[:, :-1] & (rng.uniform(size=(N, K - 1)) < 0.6)
    m[::7] = False
    return m


@pytest.mark.parametrize("M_budget", [256, 4096])
def test_compact_mask_exact(M_budget):
    N, K = 96, 24
    m = _mask(N, K, 1)
    assert 256 < m.sum() < 4096
    cj = jcomp.compact_mask(jnp.asarray(m), M_budget)
    ct = tcomp.compact_mask(torch.from_numpy(m), M_budget)
    for name in ("sel", "sel_valid", "rank", "in_budget"):
        np.testing.assert_array_equal(getattr(ct, name).numpy(), np.asarray(getattr(cj, name)),
                                      err_msg=name)
    counts = m.sum(axis=1)
    m_eff = min(M_budget, int(m.sum()))
    rj = jcomp.ray_in_budget_from_counts(jnp.asarray(counts), m_eff)
    rt = tcomp.ray_in_budget_from_counts(torch.from_numpy(counts), m_eff)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    # the slab form agrees on every ray with samples (an empty ray past the
    # budget is out under the counts form, in under the slab form)
    has = counts > 0
    np.testing.assert_array_equal(rt.numpy()[has], (ct.in_budget.numpy() == m).all(axis=1)[has])
    assert rt.all() == (M_budget > m.sum())
    x = np.random.default_rng(2).normal(size=(3, N * K)).astype(np.float32)
    gj = jcomp.gather_cf(jnp.asarray(x), cj)
    gt = tcomp.gather_cf(torch.from_numpy(x), ct)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    for vals in (gt, gt[0]):
        ej = jcomp.expand_to_slab(jnp.asarray(vals.numpy()), cj, N, K)
        et = tcomp.expand_to_slab(vals, ct, N, K)
        np.testing.assert_array_equal(et.numpy(), np.asarray(ej))


def test_composite_rays_and_flat_match():
    N, K = 80, 32
    rng = np.random.default_rng(12)
    sig = (rng.exponential(3.0, (N, K)) * (rng.uniform(size=(N, K)) < 0.8)).astype(np.float32)
    sig[:10] *= 60.0  # rays that stop early
    rgb = rng.uniform(size=(N, K, 3)).astype(np.float32)
    dts = rng.uniform(0.005, 0.05, (N, K)).astype(np.float32)
    gaps = (dts * rng.uniform(1.0, 3.0, (N, K))).astype(np.float32)
    mask = rng.uniform(size=(N, K)) < 0.9
    gw, gd = rng.normal(size=(2, N)).astype(np.float32)
    gi = rng.normal(size=(N, 3)).astype(np.float32)

    for jfn, tfn, shape in ((jc.composite_rays, tc.composite_rays, (N, K)),
                            (jc.composite_rays_flat, tc.composite_rays_flat, (N * K,))):
        def jloss(s, c):
            ws, dep, img, w = jfn(s, c, jnp.asarray(dts.reshape(shape)),
                                  jnp.asarray(gaps.reshape(shape)), jnp.asarray(mask), 1e-4)
            return (ws * gw).sum() + (dep * gd).sum() + (img * gi).sum(), (ws, dep, img, w)

        (_, jout), (jgs, jgc) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
            jnp.asarray(sig.reshape(shape)), jnp.asarray(rgb.reshape(*shape, 3)))
        ts_ = torch.tensor(sig.reshape(shape), requires_grad=True)
        tc_ = torch.tensor(rgb.reshape(*shape, 3), requires_grad=True)
        tout = tfn(ts_, tc_, torch.tensor(dts.reshape(shape)), torch.tensor(gaps.reshape(shape)),
                   torch.tensor(mask), 1e-4)
        ((tout[0] * torch.tensor(gw)).sum() + (tout[1] * torch.tensor(gd)).sum()
         + (tout[2] * torch.tensor(gi)).sum()).backward()
        wj, wt = np.asarray(jout[3]), tout[3].detach().numpy()
        flips = ((wj == 0) != (wt == 0)) & mask
        assert int(flips.sum()) <= 1
        ok = ~flips.any(axis=1)
        assert (wj[:10] == 0).any()  # the early stop happened
        for a, b in zip(tout[:3], jout[:3]):
            np.testing.assert_allclose(a.detach().numpy()[ok], np.asarray(b)[ok], rtol=1e-6,
                                       atol=1e-6)
        np.testing.assert_allclose(wt[ok], wj[ok], rtol=1e-6, atol=1e-6)
        gs, gc = ts_.grad.numpy().reshape(N, K), tc_.grad.numpy().reshape(N, K, 3)
        assert rel_err(gs[ok], np.asarray(jgs).reshape(N, K)[ok]) <= 1e-5
        assert rel_err(gc[ok], np.asarray(jgc).reshape(N, K, 3)[ok]) <= 1e-5
