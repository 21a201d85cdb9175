"""The window encoder's table gradient on rows no sample reaches and on rows
many samples reach: cases of `test_torch_window_encoder_bwd.py` (its set-up
and tolerances), in a file that the tier-1 run queues behind the longest
JAX test file."""

import numpy as np

from tngp.ops.window_table import WindowSpec as JaxWindowSpec
from tngp_torch.ops import window_table as wt
from test_torch_window_encoder_bwd import (
    SPEC_KW,
    _abs_contrib_sum_and_count,
    _inputs,
    _jax_grad,
    _torch_grad,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_unvisited_windows_and_untouched_rows_are_exactly_zero():
    spec, jspec = wt.WindowSpec.create(**SPEC_KW), JaxWindowSpec.create(**SPEC_KW)
    x, win, g = _inputs(5, 160, spec, crowd=True)
    got = _torch_grad(x, win, g, spec).numpy()
    want = _jax_grad(x, win, g, jspec, False)
    # level 3 has 5 windows; the samples' one tile maps to its first only
    assert spec.level_n_win(3) > 1
    first = spec.win_offsets[3]
    assert np.abs(got[first]).max() > 0
    assert (got[first + 1: spec.win_offsets[4]] == 0).all()
    assert ((got == 0) == (want == 0)).all()


def test_many_contributions_per_row():
    """All samples in one tile: level 0's 216 rows take hundreds of
    contributions each; the gradient stays within the reordering bound."""
    spec, jspec = wt.WindowSpec.create(**SPEC_KW), JaxWindowSpec.create(**SPEC_KW)
    x, win, g = _inputs(7, 160, spec, crowd=True)
    got = _torch_grad(x, win, g, spec).numpy()
    want = _jax_grad(x, win, g, jspec, False)
    sabs, n = _abs_contrib_sum_and_count(x, g, spec)
    assert (np.abs(got - want) <= np.maximum(n - 1, 0) * 2.0**-24 * sabs + 1e-30).all()
