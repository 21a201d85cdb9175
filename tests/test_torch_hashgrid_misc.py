"""The input-gradient switch, `GridEncoder` and the factory, `sph_from_ray`
and `morton3D` of `test_torch_hashgrid.py`, in a file of its own (the
set-up, the checks and their tolerances are that file's)."""

from test_torch_hashgrid import (
    check_grid_encoder_and_factory,
    check_morton3d_matches_jax_and_inverts,
    check_no_input_gradient_when_input_grad_is_off,
    check_sph_from_ray_matches_jax,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_no_input_gradient_when_input_grad_is_off():
    """input_grad=False: no dy_dx."""
    check_no_input_gradient_when_input_grad_is_off()


def test_grid_encoder_and_factory():
    """`GridEncoder` and `get_encoder` against the JAX modules."""
    check_grid_encoder_and_factory()


def test_sph_from_ray_matches_jax():
    """The background sphere's coordinates."""
    check_sph_from_ray_matches_jax()


def test_morton3d_matches_jax_and_inverts():
    """`morton3D` and its inverse."""
    check_morton3d_matches_jax_and_inverts()
