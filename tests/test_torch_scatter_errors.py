"""`test_torch_scatter.py`'s false statements, in a file of its own (the
check is that file's)."""

import pytest

from test_torch_scatter import check_scatter_add_false_statement_raises
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("indices,idx", [
    ("unique", [3, 1, 3]),
    ("sorted", [0, 2, 1]),
    ("sorted", [0, 4, 4, 2]),  # a padding tail that falls back, as the march's did
])
def test_scatter_add_false_statement_raises(indices, idx):
    """A caller whose indices break its statement gets a `ValueError`."""
    check_scatter_add_false_statement_raises(indices, idx)
