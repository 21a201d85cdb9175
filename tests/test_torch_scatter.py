"""Port parity: `tngp_torch.kernels.scatter.scatter_add` against the JAX
package's scatter semantics `jnp.zeros(...).at[idx].add(vals)` for each
index pattern and each statement a caller can make about it (`indices`:
"unique", "sorted", "any"), the check of a false statement, and the
statements the port's callers make, on the indices those callers really
build."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tngp_torch.kernels.scatter import INDICES, scatter_add, scatter_add_plain
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _jax_scatter(idx, vals, rows):
    return np.asarray(jnp.zeros((rows, vals.shape[1]), jnp.float32).at[idx].add(vals))


def _pattern(pattern, rng, M, rows):
    """Indices of one pattern, and the row count they scatter into."""
    if pattern == "unique":  # the encoder's sorts: a permutation's prefix
        rows = 4096
        return rng.permutation(rows)[:M], rows
    if pattern == "ascending_unique":  # unique and sorted at once
        rows = 4096
        return np.sort(rng.permutation(rows)[:M]), rows
    if pattern == "sorted":  # a ray id per sample, repeats
        return np.sort(rng.integers(0, rows, M)), rows
    if pattern == "sorted_padded":  # the compositor's: a tail of row `rows`, dropped
        idx = np.sort(rng.integers(0, rows, M))
        idx[-M // 8:] = rows
        return idx, rows
    return rng.integers(0, rows, M), rows  # random


# (pattern, statement, C); the first three ids are the cases this test had
# before statements existed, under their old ids
CASES = [
    pytest.param("unique", "unique", 5, id="unique"),
    pytest.param("sorted", "sorted", 5, id="sorted"),
    pytest.param("random", "any", 5, id="random"),
    *[pytest.param(p, s, C, id=f"{p}-{s}-C{C}")
      for p, s in (("unique", "any"), ("sorted", "any"), ("ascending_unique", "unique"),
                   ("ascending_unique", "sorted"), ("sorted_padded", "sorted"))
      for C in (4, 5, 6, 32)],
]


@pytest.mark.parametrize("pattern,indices,C", CASES)
def test_scatter_add_matches_jax(pattern, indices, C):
    """Unique indices: exact.  Repeated indices: both sides add in index
    order on the CPU, so the sums agree to f32 rounding of ~100-term sums
    (rtol 1e-6); the card's orders are held to the reordering bound in
    tests/test_torch_kernels_gpu.py and chip_smoke.py.  Rows at or past
    num_rows are dropped, as JAX's scatter drops them."""
    rng = np.random.default_rng(0)
    M, rows = 3000, 257
    vals = rng.normal(size=(M, C)).astype(np.float32)
    idx, rows = _pattern(pattern, rng, M, rows)
    got = scatter_add(torch.from_numpy(idx), torch.from_numpy(vals), rows,
                      indices=indices).numpy()
    want = _jax_scatter(jnp.asarray(idx), jnp.asarray(vals), rows)
    assert got.shape == (rows, C)
    if pattern in ("unique", "ascending_unique"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("indices", INDICES)
def test_scatter_add_empty(indices):
    """M = 0 gives zeros of [num_rows, C] under every statement."""
    out = scatter_add(torch.zeros((0,), dtype=torch.int64), torch.zeros((0, 6)), 9,
                      indices=indices)
    assert out.shape == (9, 6) and bool((out == 0).all())


def check_scatter_add_false_statement_raises(indices, idx):
    """The plain version checks the statement on the CPU: a caller that
    states what its indices do not hold is caught by the CPU tests."""
    vals = torch.ones((len(idx), 4))
    with pytest.raises(ValueError):
        scatter_add(torch.tensor(idx), vals, 5, indices=indices)
    with pytest.raises(ValueError):
        scatter_add(torch.tensor([0, 1]), torch.ones((2, 4)), 5, indices="ascending")
    # the same indices under the statement they do hold
    torch.testing.assert_close(scatter_add(torch.tensor(idx), vals, 5, indices="any"),
                               scatter_add_plain(torch.tensor(idx), vals, 5))


def test_scatter_add_plain_is_cpu_route():
    idx = torch.tensor([2, 0, 2])
    vals = torch.ones(3, 2)
    out = scatter_add(idx, vals, 4)
    assert out.tolist() == [[1, 1], [0, 0], [2, 2], [0, 0]]
    torch.testing.assert_close(out, scatter_add_plain(idx, vals, 4))


def _recording(monkeypatch, module, calls):
    """Replace `module.scatter_add` by a wrapper that records (caller, idx,
    indices, num_rows) and calls the real one (whose CPU path checks the
    statement)."""
    def rec(idx, vals, num_rows, *, indices="any"):
        calls.append((module.__name__, idx.clone(), indices, num_rows))
        return scatter_add(idx, vals, num_rows, indices=indices)

    monkeypatch.setattr(module, "scatter_add", rec)


def _ascending(t):
    return bool((t[1:] >= t[:-1]).all())


def test_callers_indices_hold_their_statements(monkeypatch):
    """Each caller's real indices, built on the CPU, hold what it states:
    `bin_dest`'s destinations are unique (the payload and cotangent sorts);
    the compositor's ray ids ascend on marches with padding slots, the
    train march's and the eval march's, where the padding used to fall back
    to the first sample's ray; the eval round update's
    `nonzero_static(alive, Na, N - 1)` ascends, with fewer and with more
    alive rays than Na; the frame renderer's round update (the same
    compaction at each tier width) is unique, its unused slots given
    distinct rows past the frame, which the scatter drops; the grid
    samples' plane and line gradients (TensoRF VM and CP, CCNeRF's
    `align_corners=False` factors) state "any", one call per factor, their
    indices inside the plane or line, repeats included."""
    from tngp_torch.kernels import window_encoder as kw
    from tngp_torch.ops import composite
    from tngp_torch.ops.grid_utils import packbits
    from tngp_torch.ops.march import nonzero_static
    from tngp_torch.render import FieldFns, RenderConfig, render_rays_eval, render_rays_train
    from tngp_torch.render import frame_eval, renderer

    gen = torch.Generator().manual_seed(0)
    x01 = torch.rand((3, 5000), generator=gen) ** 2
    dest, _ = kw.bin_dest(x01)
    assert torch.unique(dest).numel() == dest.numel()
    assert int(dest.min()) >= 0 and int(dest.max()) < kw.padded_size(5000, kw.DEFAULT_BLOCK)

    for n_alive, Na in ((40, 64), (300, 64)):
        alive = torch.zeros(512, dtype=torch.bool)
        alive[torch.randperm(512, generator=gen)[:n_alive]] = True
        sel = nonzero_static(alive, Na, 511)
        assert _ascending(sel) and sel.shape == (Na,)

    calls = []
    _recording(monkeypatch, composite, calls)
    _recording(monkeypatch, renderer, calls)
    field = FieldFns(
        sigma_rgb=lambda p, x, d: (20.0 * torch.exp(-4.0 * (x * x).sum(0)), torch.sigmoid(x)),
        density=lambda p, x: 20.0 * torch.exp(-4.0 * (x * x).sum(0)),
    )
    H = 16
    ax = (torch.arange(H) + 0.5) / H * 2.0 - 1.0
    g = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij")).reshape(3, -1)
    bitfield = packbits(((g * g).sum(0) < 0.6**2).float()[None], 0.5).reshape(-1)
    n = 72
    o = torch.tensor([0.0, 0.0, -2.5]) + 0.05 * torch.randn((n, 3), generator=gen)
    d = torch.rand((n, 3), generator=gen) - 0.5 - o
    d = d / d.norm(dim=-1, keepdim=True)
    kw_cfg = dict(bound=1.0, grid_size=H, max_steps=128, K=32, K_eval=16, min_near=0.05,
                  march_chunk=8)
    render_rays_eval(field, None, o, d, bitfield, RenderConfig(**kw_cfg, eval_budget=0.05))
    render_rays_train(field, None, o, d, bitfield,
                      RenderConfig(**kw_cfg, compact_fraction=0.5, march_dense=True),
                      noise=torch.rand((n,), generator=gen))
    _recording(monkeypatch, frame_eval, calls)
    fr = frame_eval.FrameRenderer(field, RenderConfig(**kw_cfg, eval_budget=0.05,
                                                      eval_tiers=(16, 64)), chunk=32)
    fr.render(None, o, d, bitfield)
    comp = [(i, r) for m, i, s, r in calls if m == composite.__name__]
    rounds = [(i, r) for m, i, s, r in calls if m == renderer.__name__]
    frame_rounds = [(i, r) for m, i, s, r in calls if m == frame_eval.__name__]
    assert {s for m, _, s, _ in calls if m != frame_eval.__name__} == {"sorted"}
    assert {s for m, _, s, _ in calls if m == frame_eval.__name__} == {"unique"}
    assert comp and rounds and frame_rounds
    assert fr.last_rounds == len(frame_rounds) and {i.numel() for i, _ in frame_rounds} <= {16, 64}
    for i, r in frame_rounds:
        assert torch.unique(i).numel() == i.numel() and int(i.min()) >= 0
    # some round left slots unused, which carry rows past the frame
    assert any(bool((i >= r).any()) for i, r in frame_rounds)
    # some march left padding slots, which now carry the dropped row n_rays
    assert any(bool((i == r).any()) for i, r in comp)
    for i, _ in comp + rounds:
        assert _ascending(i)

    from tngp_torch.models import TensoRFNetwork
    from tngp_torch.models.ccnerf import CCConfig, CCNeRF
    from tngp_torch.ops import grid_sample

    gs_calls = []
    _recording(monkeypatch, grid_sample, gs_calls)
    x = torch.rand((3, 300), generator=gen) * 2.4 - 1.2
    dd = torch.nn.functional.normalize(torch.randn((3, 300), generator=gen), dim=0)
    for decomposition, n_calls in (("vm", 12), ("cp", 6)):
        net = TensoRFNetwork(resolution=(8, 10, 12), sigma_rank=(2, 2, 2),
                             color_rank=(3, 3, 3), color_feat_dim=4, hidden_dim=8,
                             decomposition=decomposition, device="cpu")
        before = len(gs_calls)
        sig, rgb = net.sigma_rgb_cf(x, dd)
        (sig.sum() + rgb.sum()).backward()
        assert len(gs_calls) - before == n_calls
    cc = CCNeRF(CCConfig(resolution=(8, 10, 12), rank_vec_density=(2, 2),
                         rank_mat_density=(0, 2), rank_vec=(2, 2), rank_mat=(0, 2)),
                device="cpu")
    before = len(gs_calls)
    sig, rgb = cc.sigma_rgb_cf(x, dd, residual=True)
    (sig.sum() + rgb.sum()).backward()
    assert len(gs_calls) - before == 12  # 3 factors x (vd, md, vc, mc)
    assert {s for _, _, s, _ in gs_calls} == {"any"}
    for _, i, _, r in gs_calls:
        assert int(i.min()) >= 0 and int(i.max()) < r and torch.unique(i).numel() < i.numel()
