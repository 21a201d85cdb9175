"""Cases 1-4 of `test_torch_window_schedule.py`'s `accumulation_per_piece_matches_plain` check (the
check and its inputs are that file's)."""

import pytest

from test_torch_window_schedule import SCHEDULE_CASES, check_accumulation_per_piece_matches_plain
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("spec_name,input_name", SCHEDULE_CASES[:4])
def test_accumulation_per_piece_matches_plain(spec_name, input_name):
    """The table gradient's per-piece store/add flush against the plain version."""
    check_accumulation_per_piece_matches_plain(spec_name, input_name)
