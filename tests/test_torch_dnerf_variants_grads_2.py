"""Cases 2 of 2 of `test_torch_dnerf_variants.py`'s
`test_forward_and_gradients_match_jax` (the set-up, the check and its tolerances are that file's)."""

import pytest

from test_torch_dnerf_variants import GRAD_CASES, GRAD_IDS, check_forward_and_gradients_match_jax
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("name,bf16", GRAD_CASES[3:], ids=GRAD_IDS[3:])
def test_forward_and_gradients_match_jax(name, bf16):
    """The forward and every parameter's gradient against the JAX module's."""
    check_forward_and_gradients_match_jax(name, bf16)
