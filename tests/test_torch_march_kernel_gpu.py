"""The march kernels (`tngp_torch/csrc/march.cu`) against their plain
version on a card, every output bit for bit: `sel` with its padded tail,
`sel_valid`, `m_eff`, `ray_mask`, `num_points`, `t0` and `resume_t`.

This file imports no JAX, so it runs on a machine with a card and without
JAX:  python -m pytest --noconftest -m gpu tests/test_torch_march_kernel_gpu.py
Without a card every test skips (`chip_smoke.py` holds the kernels to the
plain version at the main paths' shapes too)."""

import pytest
import torch

from test_torch_march_kernel import CASES, assert_same, case_inputs
from tngp_torch.kernels import march as km
from tngp_torch.kernels import plain_versions
from tngp_torch.ops import march as tm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs these checks on the card)")
    return torch.device("cuda")


def on(dev, args, kw):
    move = (lambda t: t.to(dev) if torch.is_tensor(t) else t)
    return [move(a) for a in args], {k: move(v) for k, v in kw.items()}


def check_case(args, kw):
    """The kernels' outputs against the plain version's on the same CUDA
    inputs; the kernels launched once."""
    with plain_versions():
        want = tm.march_rays_chunked(*args, **kw)
    before = km.MARCH.launches
    got = tm.march_rays_chunked(*args, **kw)
    torch.cuda.synchronize()
    assert km.MARCH.launches == before + 1
    assert_same(got, want)
    return got


@pytest.mark.gpu
def test_march_kernel_matches_plain_on_the_chunked_cases(cuda):
    """The four cases of `test_torch_march_chunked.py` (the budget covering
    everything; the first pass's cap and chunk budget; a ladder window with
    noise; every truncation at once), the grid built by the call, and the
    first again with the rays as strided views of one [N, 6] tensor."""
    for i, (ikw, mkw) in enumerate(CASES[:4]):
        args, kw = on(cuda, *case_inputs(ikw, mkw, seed=5 + i))
        check_case(args, kw)
    args, kw = on(cuda, *case_inputs(*CASES[0], seed=5))
    od = torch.cat([args[0], args[1]], dim=1)
    check_case([od[:, :3], od[:, 3:]] + args[2:], kw)


@pytest.mark.gpu
def test_march_kernel_matches_plain_with_dt_gamma_and_cascades(cuda):
    """dt_gamma 1/128 (the ladder's three pieces: expf, logf, the
    reciprocals torch's division takes) on two cascades (mip levels) at
    bound 2, with noise and the cap, and without the cap."""
    args, kw = on(cuda, *case_inputs(*CASES[4], seed=9))
    check_case(args, kw)
    check_case(args, dict(kw, ray_chunk_cap=None, M_budget=8192))


@pytest.mark.gpu
def test_march_kernel_at_the_main_paths_shapes(cuda, monkeypatch):
    """A frame's first pass (65,536 rays, G 16, the cap, `eval_cb_mult` 6),
    a residual round (a 256-rung window) and a TensoRF training step
    (noise, the chunk budget cutting rays off), as `kernel_times.py`
    times them.  One call is at most 6 device operations (the profiler's
    device events) and reads nothing back to the host; the plain version
    is never reached."""
    from tngp_torch.diagnostics.kernel_times import MARCH_CASES, device_ms, march_inputs

    calls = {}
    for case in MARCH_CASES:
        args, kw = march_inputs(case, cuda, seed=3)
        got = check_case(args, kw)
        assert 0 < int(got.m_eff) and not bool(got.ray_mask.all())
        calls[case] = (args, kw)

    def boom(*a, **k):
        raise AssertionError("plain version reached with CUDA tensors")

    monkeypatch.setattr(km, "march_rays_chunked_plain", boom)
    args, kw = calls["eval_first"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        tm.march_rays_chunked(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _, events, method = device_ms(lambda: tm.march_rays_chunked(*args, **kw))
    assert method == "profiler" and events <= 6


@pytest.mark.gpu
def test_march_kernel_edge_cases(cuda):
    """n_live above the chunk budget (rays past it keep nothing and leave
    the loss), an empty bitfield (nothing live: the tail's fill is the last
    ray's last chunk), every ray starting at its far, and one ray."""
    for i, (ikw, mkw) in enumerate(CASES[5:]):
        args, kw = on(cuda, *case_inputs(ikw, mkw, seed=10 + i))
        check_case(args, kw)
    args, kw = on(cuda, *case_inputs(*CASES[0], seed=13))
    check_case([a[1:2] for a in args[:4]] + args[4:], dict(kw, M_budget=128))
