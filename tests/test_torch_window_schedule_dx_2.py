"""Cases 5-6 of `test_torch_window_schedule.py`'s `input_gradient_schedule_matches_plain` check, and
one more of its checks (the checks and their inputs are that file's)."""

import pytest

from test_torch_window_schedule import (
    SCHEDULE_CASES,
    check_encoder_bytes_count_the_table_entries_read,
    check_input_gradient_schedule_matches_plain,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("spec_name,input_name", SCHEDULE_CASES[4:])
def test_input_gradient_schedule_matches_plain(spec_name, input_name):
    """The input gradient's chunk and level-pair walk against the plain version."""
    check_input_gradient_schedule_matches_plain(spec_name, input_name)


@pytest.mark.parametrize("input_name", ["tiny", "out_of_range"])
def test_encoder_bytes_count_the_table_entries_read(input_name):
    """The encoder's byte bound counts the table entries read."""
    check_encoder_bytes_count_the_table_entries_read(input_name)
