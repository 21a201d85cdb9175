"""The last case of `test_torch_scatter_set.py`'s set-scatter check, its
errors and the grid-update bench's stages (the checks and their inputs are
that file's)."""

import pytest

from test_torch_scatter_set import (
    CASES,
    check_grid_update_bench_stages_on_a_small_network,
    check_scatter_set_matches_interpret_kernel_xla_and_loop,
    check_scatter_set_num_cells_and_range_errors,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("case", list(CASES)[4:])
def test_scatter_set_matches_interpret_kernel_xla_and_loop(case):
    """Exact (max error 0), the last write winning every repeated cell."""
    check_scatter_set_matches_interpret_kernel_xla_and_loop(case)


def test_scatter_set_num_cells_and_range_errors():
    """Both packages refuse num_cells % 128 != 0, and the range errors."""
    check_scatter_set_num_cells_and_range_errors()


def test_grid_update_bench_stages_on_a_small_network():
    """The bench's stage shapes at H = 16 on a small network."""
    check_grid_update_bench_stages_on_a_small_network()
