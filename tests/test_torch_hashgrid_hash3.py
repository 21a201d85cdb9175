"""The golden hash grid on the `hash3` spec of `test_torch_hashgrid.py`
against the JAX package: cases of that file (its set-up,
checks and tolerances), in a file of at most four cases that the tier-1 run
queues behind the longest JAX test file."""

import pytest

from test_torch_hashgrid import (
    check_encode_matches_jax,
    check_rows_and_weights_exact,
    check_tv_grad_matches_jax,
    check_vjp_matches_jax,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("name", ["hash3"])
def test_rows_and_weights_exact(name):
    """The rows and corner weights against the JAX package's."""
    check_rows_and_weights_exact(name)


@pytest.mark.parametrize("name", ["hash3"])
def test_encode_matches_jax(name):
    """The encode against the JAX package's."""
    check_encode_matches_jax(name)


@pytest.mark.parametrize("name", ["hash3"])
def test_vjp_matches_jax(name):
    """The table gradient and dy_dx against the JAX package's."""
    check_vjp_matches_jax(name)


@pytest.mark.parametrize("name", ["hash3"])
def test_tv_grad_matches_jax(name):
    """The total-variation gradient against the JAX package's."""
    check_tv_grad_matches_jax(name)
