"""The frame renderer's whole-frame parity case of `test_torch_frame_eval.py`
(its set-up and tolerances are that file's), in a file of its own so that
the tier-1 run queues it behind the longest JAX test file."""

import numpy as np
import pytest

from test_torch_frame_eval import FRAME_H, FRAME_W, _render_both, scene
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("case", ["full", "max_rounds"])
def test_frame_renderer_matches_jax(scene, case):
    """The whole frame: padding rays (24 in the last chunk) that die in the
    first pass, sky chunks skipped, both tiers, a bg colour, and a cut at
    max_rounds.  Tolerances are tests/test_frame_eval.py:59-60's (image
    1e-4, depth 1e-3); the rounds are integers and must be equal."""
    bg = [0.25, 0.5, 1.0]
    max_rounds = 64 if case == "full" else 3
    jimg, jdep, timg, tdep = _render_both(scene, bg_color=bg, max_rounds=max_rounds)
    jfr, tfr = scene["jfr"], scene["tfr"]
    assert timg.shape == (FRAME_H * FRAME_W, 3) and np.isfinite(timg).all()
    np.testing.assert_allclose(timg, jimg, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tdep, jdep, rtol=1e-3, atol=1e-3)
    assert tfr.last_rounds == jfr.last_rounds
    st = tfr.last_stats
    assert st["chunks"] == 9 and 0 < st["chunks_marched"] < 9  # sky chunks skipped
    if case == "full":
        assert 3 < tfr.last_rounds < max_rounds  # the rounds ran the frame to its end
        assert tfr.last_tiers[0] == 64 and tfr.last_tiers[-1] == 16
        # rays that miss the occupied box render pure background
        sky = ~np.any(timg != np.float32(bg), axis=1)
        assert sky[:FRAME_W].all() and not sky.all()
        assert not bool(tfr.last_cut.any())
    else:
        assert tfr.last_rounds == max_rounds == jfr.last_rounds
        assert tfr.last_cut.shape == (FRAME_H * FRAME_W,) and bool(tfr.last_cut.any())
