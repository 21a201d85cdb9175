"""Cases 1-4 of `test_torch_bin_dest.py`'s three-stage mirror (the check
and its inputs are that file's)."""

import pytest

from test_torch_bin_dest import MIRROR_CASES, check_three_stage_mirror_matches_jax_bin_dest
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("case,M,block", MIRROR_CASES[:4])
def test_three_stage_mirror_matches_jax_bin_dest(case, M, block):
    """The three stages mirrored in numpy against JAX's `bin_dest`, exactly."""
    check_three_stage_mirror_matches_jax_bin_dest(case, M, block)
