"""`test_torch_window_encoder.py`'s bin sort against both JAX
formulations, in a file of its own (the check is that file's)."""

import pytest

from test_torch_window_encoder import check_bin_dest_exact
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("M,block", [(200, 64), (1100, 512), (37, 128)])
def test_bin_dest_exact(M, block):
    """dest and tob are integers: exact against both JAX formulations."""
    check_bin_dest_exact(M, block)
