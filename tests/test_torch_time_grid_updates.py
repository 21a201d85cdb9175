"""The time grid's updates and the dynamic dataset of
`test_torch_time_grid.py`, in a file of its own (the set-up, the checks and
their tolerances are that file's)."""

from test_torch_time_grid import (
    check_dynamic_dataset_matches_jax,
    check_full_then_partial_time_grid_updates_match,
    check_generator_driven_update_and_create_time,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_full_then_partial_time_grid_updates_match():
    """A full update, then a partial one, both packages."""
    check_full_then_partial_time_grid_updates_match()


def test_generator_driven_update_and_create_time():
    """The generator-driven entry point and `create_time`."""
    check_generator_driven_update_and_create_time()


def test_dynamic_dataset_matches_jax():
    """The dynamic blob scene's views and times."""
    check_dynamic_dataset_matches_jax()
