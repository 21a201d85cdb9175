"""The port's web viewer (`tngp_torch/cli/viewer.py`) against the JAX
package's (`tngp/cli/viewer.py`): the orbit camera's pose, the
dynamic-resolution and train-steps decisions for the same timing sequence,
and a dt_gamma / max_steps override, which the next frame must render with
(the grid path's frame renderer and dilated grid, and the grid-free path's
chunked render) and whose revert gives the first frame back exactly.  The
HTTP routes are driven through the entry points in `test_torch_cli.py`."""

import dataclasses

import numpy as np
import pytest
import torch

from tngp.cli.viewer import ViewerState as JaxViewerState
from tngp.cli.viewer import _orbit_pose as jax_orbit_pose
from tngp_torch.cli.viewer import ViewerState, _orbit_pose
from tngp_torch.data import make_synthetic_dataset
from tngp_torch.models import NGPNetwork
from tngp_torch.render import RenderConfig, dilated_chunk_grid
from tngp_torch.train import Trainer
from tngp_torch.utils import TrainConfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_orbit_pose_equals_jax():
    for theta, phi, radius in [(1.2, 0.6, 2.5), (0.0, 0.05, 1.0), (-2.3, 3.09, 4.2),
                               (7.0, 1.57, 0.3)]:
        p = _orbit_pose(theta, phi, radius)
        np.testing.assert_array_equal(p, jax_orbit_pose(theta, phi, radius))
        np.testing.assert_allclose(p[:3, :3] @ p[:3, :3].T, np.eye(3), atol=1e-5)


class _Renders:
    """A stand-in trainer: `ViewerState` reads only `render_image`'s
    signature."""

    def __init__(self, with_time):
        if with_time:
            self.render_image = lambda pose, time=0.0, W=None, H=None: None
        else:
            self.render_image = lambda pose, W=None, H=None: None


def test_viewer_state_decisions_equal_jax():
    """One timing sequence through both packages' `ViewerState`, for a
    trainer without and with a time axis."""
    rng = np.random.default_rng(0)
    render_ms = np.concatenate([[3200.0, 10.0, 200.0, 199.0, 5000.0],
                                rng.lognormal(5, 1.5, 60)])
    train_ms = np.concatenate([[4000.0, 10.0, 500.0], rng.lognormal(6, 1.5, 60)])
    for with_time in (False, True):
        t, j = ViewerState(_Renders(with_time)), JaxViewerState(_Renders(with_time))
        assert t.supports_time == j.supports_time == with_time
        for k, ms in enumerate(render_ms):
            enabled = k % 7 != 3
            t.update_downscale(float(ms), enabled)
            j.update_downscale(float(ms), enabled)
            assert t.downscale == j.downscale, k
        seen = {t.train_steps}
        for k, ms in enumerate(train_ms):
            t.update_train_steps(float(ms))
            j.update_train_steps(float(ms))
            assert t.train_steps == j.train_steps, k
            seen.add(t.train_steps)
        assert len(seen) > 3


@pytest.mark.parametrize("use_grid", [True, False], ids=["grid", "grid_free"])
def test_cfg_override_reaches_the_next_frame(use_grid, tmp_path):
    ds = make_synthetic_dataset(n_frames=3, H=32, W=32, device="cpu")
    net = NGPNetwork(encoding="hashgrid", num_levels=4, log2_hashmap_size=12, hidden_dim=16,
                     hidden_dim_color=16, device="cpu")
    with torch.no_grad():
        net.encoder.embeddings.normal_(0, 0.3, generator=torch.Generator().manual_seed(0))
    cfg = RenderConfig(bound=1.0, grid_size=16, max_steps=64, K=16, K_eval=16, min_near=0.05,
                       compact_fraction=0.5, march_dense=True, num_steps=16,
                       upsample_steps=16)
    tr = Trainer(net, ds, cfg, TrainConfig(workspace=str(tmp_path), num_rays=128,
                                           use_checkpoint="scratch", bf16=False),
                 device="cpu", use_grid=use_grid)
    tr.set_grid(dataclasses.replace(tr.grid, bitfield=torch.full_like(tr.grid.bitfield, 255)))
    st = ViewerState(tr)
    img0, _ = tr.render_image(ds.poses[0])
    st.apply_render_overrides({"dt_gamma": 0.02, "max_steps": 128, "num_steps": 4})
    assert (tr.cfg.dt_gamma, tr.cfg.max_steps) == (0.02, 128) and tr.cfg.num_steps == 16
    assert all(c.max_steps == 128 for c in tr._tier_cfgs)
    img1, _ = tr.render_image(ds.poses[0])
    assert np.isfinite(img1).all()
    if use_grid:
        assert torch.equal(tr._dgrid, dilated_chunk_grid(tr.grid.bitfield, tr.cfg))
        assert any(fr.cfg == tr.cfg for fr in tr._frame_renderers.values())
        for (_, key_cfg), fr in tr._frame_renderers.items():
            assert fr.cfg == key_cfg
        assert not np.array_equal(img1, img0)  # dt_gamma moved the samples
    else:
        # the grid-free render reads neither dt_gamma nor max_steps
        assert tr._dgrid is None and not tr._frame_renderers
        np.testing.assert_array_equal(img1, img0)
        st.apply_render_overrides({"dt_gamma": 0.02, "max_steps": 128})
        tr.set_cfg(type(cfg)(**{**vars(tr.cfg), "num_steps": 8}))
        img2, _ = tr.render_image(ds.poses[0])
        assert tr.last_render_stats["samples"] == 4096 * (8 + 16)  # one padded chunk
        assert not np.array_equal(img2, img0)
    st.apply_render_overrides({"dt_gamma": cfg.dt_gamma, "max_steps": cfg.max_steps})
    if not use_grid:
        tr.set_cfg(cfg)
    assert tr.cfg == cfg
    img3, _ = tr.render_image(ds.poses[0])
    np.testing.assert_array_equal(img3, img0)
