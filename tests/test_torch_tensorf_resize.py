"""Port parity for TensoRF's host-side surgery (`tngp_torch/models/tensorf.py`
`shrink_params`, `upsample_params`, `jnp_linspace_f32`; `tngp_torch/train/
tensorf_trainer.py` `upsample_resolutions`) against `tngp/models/tensorf.py`
and `tngp/train/tensorf_trainer.py`, all exact:

- the resize positions equal `jnp.linspace(0, old - 1, new)` bit for bit,
  in the trainer's cases (128 -> 196, 196 -> 300, 128 -> 300, the default
  schedule's steps) and small ones; `torch.linspace` does not (counted, so
  that a port that took it would show);
- `upsample_params` of VM and CP factors equal the JAX function's (eager
  jnp ops, one rounding per operation, as numpy's float32);
- `shrink_params` crops to the same box, resolution and `aabb` on a density
  grid with an occupied block, and leaves everything as it was on an empty
  one;
- the layout of TensoRF's colour encoding (`_freq_encode_cf`) is the port's
  `freq_encode_cf` (values within 2e-7: XLA's and torch's sin/cos differ
  by an ulp), and the JAX `init` of a field with `bg_radius > 0` builds
  `bg_mat` but no `bg_net` (the reference's fault, ROADMAP section 3), the
  port both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tngp.models.tensorf as jtf
from tngp_torch.models import tensorf as ttf
from tngp_torch.ops.freq import freq_encode_cf
from tngp_torch.train.tensorf_trainer import upsample_resolutions
from torch_tensorf_helpers import DTYPES, RANKS, TF_KW, np_tree, tensorf_nets
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CASES = [(128, 196), (196, 300), (128, 300), (128, 151), (16, 20), (12, 40), (300, 128)]


def test_resize_positions_are_jnp_linspace():
    torch_diffs = 0
    for old, new in CASES + [(a, b) for a, b in zip([128] + upsample_resolutions(128, 300, 5),
                                                    upsample_resolutions(128, 300, 5))]:
        want = np.asarray(jnp.linspace(0.0, old - 1.0, new))
        np.testing.assert_array_equal(ttf.jnp_linspace_f32(old - 1.0, new), want)
        torch_diffs += int((torch.linspace(0.0, old - 1.0, new).numpy() != want).sum())
    assert torch_diffs > 0  # the trap the port avoids
    # the schedule of the JAX trainer (tensorf_trainer.py:53-58)
    for res0, res1, n in ((128, 300, 5), (16, 24, 2), (128, 300, 6)):
        want = np.round(np.exp(np.linspace(np.log(res0), np.log(res1), n + 1))).astype(
            np.int32).tolist()[1:]
        assert upsample_resolutions(res0, res1, n) == want


@pytest.mark.parametrize("decomposition", ["vm", "cp"])
def test_upsample_and_shrink_are_exact(decomposition):
    # the colour factors at the density factors' ranks: their resizes share
    # the eager JAX ops' compiled shapes (the axes still differ in size)
    ranks = RANKS[decomposition]["sigma_rank"]
    jnet, params, tnet = tensorf_nets(decomposition, aabb=(), color_rank=ranks)
    flat = ttf.numpy_state(tnet)
    # upsample: a non-cubic target
    for new in ((31, 29, 40),):
        got = ttf.upsample_params(flat, new)
        want = np_tree(jtf.upsample_params(params, new))
        assert set(got) == set(ttf.numpy_state(tnet))
        for name, arr in got.items():
            ref = want["params"]
            for part in name.split("."):
                ref = ref[part]
            np.testing.assert_array_equal(arr, np.asarray(ref), err_msg=name)
    # shrink: an occupied block in a 16^3 grid
    H = 16
    grid = np.random.default_rng(0).uniform(0, 5, (H, H, H)).astype(np.float32)
    grid[3:11, 5:9, 2:15] += 20.0
    jp, jm = jtf.shrink_params(params, jnet, grid.reshape(-1), H, 10.0)
    tp, tm = ttf.shrink_params(flat, tnet, grid.reshape(-1), H, 10.0)
    assert tm.resolution == jm.resolution and tm.aabb == tuple(float(a) for a in jm.aabb)
    assert tm.resolution != tnet.resolution
    jp = np_tree(jp)["params"]
    for name, arr in tp.items():
        ref = jp
        for part in name.split("."):
            ref = ref[part]
        np.testing.assert_array_equal(arr, np.asarray(ref), err_msg=name)
    # an empty grid leaves the model alone
    tp0, tm0 = ttf.shrink_params(flat, tnet, np.zeros(H**3, np.float32), H, 10.0)
    assert tm0 is tnet and all(np.array_equal(tp0[k], flat[k]) for k in flat)


def test_freq_layout_and_the_reference_background_init():
    x = jnp.asarray(np.random.default_rng(0).normal(size=(6, 50)).astype(np.float32))
    np.testing.assert_allclose(np.asarray(jtf._freq_encode_cf(x, 2)),
                               freq_encode_cf(torch.tensor(np.asarray(x)), 2).numpy(),
                               rtol=2e-7, atol=2e-7)
    args = {**TF_KW, **RANKS["vm"], "compute_dtype": DTYPES["f32"][0]}
    xs = jnp.zeros((8, 3))
    # the shapes of what `init` builds, traced without compiling
    tree = jax.eval_shape(lambda k: jtf.TensoRFNetwork(**args).init(k, xs, xs + 1.0),
                          jax.random.PRNGKey(0))["params"]
    assert "bg_mat" in tree and "bg_net" not in tree
    _, params, tnet = tensorf_nets("vm")
    assert "bg_net" in params["params"] and "bg_net.dense_1" in dict(tnet.named_parameters())
