"""Cases 5-6 of `test_torch_window_schedule.py`'s `accumulation_per_piece_matches_plain` check, and
one more of its checks (the checks and their inputs are that file's)."""

import pytest

from test_torch_window_schedule import (
    SCHEDULE_CASES,
    check_entries_of_two_terms_do_not_depend_on_the_order,
    check_accumulation_per_piece_matches_plain,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("spec_name,input_name", SCHEDULE_CASES[4:])
def test_accumulation_per_piece_matches_plain(spec_name, input_name):
    """The table gradient's per-piece store/add flush against the plain version."""
    check_accumulation_per_piece_matches_plain(spec_name, input_name)


@pytest.mark.parametrize("input_name", ["uniform", "crowded"])
def test_entries_of_two_terms_do_not_depend_on_the_order(input_name):
    """Entries of at most two terms equal in any summation order."""
    check_entries_of_two_terms_do_not_depend_on_the_order(input_name)
