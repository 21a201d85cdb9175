"""`update_density_grid` (`full`, `resample`, `slab`, and the
generator-driven entry point) of `test_torch_occupancy.py`, in a file of
its own (the set-up, the checks and their tolerances are that file's)."""

import pytest

from test_torch_occupancy import (  # noqa: F401  (after_full: the module fixture)
    after_full,
    check_update_density_grid_draws_its_own_numbers,
    check_update_density_grid_full_matches,
    check_update_density_grid_partial_matches,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_update_density_grid_full_matches(after_full):
    """One full update from the marked grid, both packages."""
    check_update_density_grid_full_matches(after_full)


@pytest.mark.parametrize("mode", ["resample", "slab"])
def test_update_density_grid_partial_matches(after_full, mode):
    """One partial update after the full one, both packages."""
    check_update_density_grid_partial_matches(after_full, mode)


def test_update_density_grid_draws_its_own_numbers(after_full):
    """The generator-driven entry point runs both modes and counts up."""
    check_update_density_grid_draws_its_own_numbers(after_full)
