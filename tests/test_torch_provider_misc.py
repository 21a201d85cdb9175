"""`rand_poses`, the colour conversions, SSIM and the mesh extraction of
`test_torch_provider.py`, in a file of its own (the set-up, the checks and
their tolerances are that file's)."""

from test_torch_provider import (
    check_mesh_extraction_matches_the_jax_wrapper,
    check_rand_poses_colors_and_ssim,
)


def test_rand_poses_colors_and_ssim():
    """`rand_poses` exact; colour conversions and SSIM."""
    check_rand_poses_colors_and_ssim()


def test_mesh_extraction_matches_the_jax_wrapper(tmp_path):
    """One shared volume through both packages' mesh wrappers."""
    check_mesh_extraction_matches_the_jax_wrapper(tmp_path)
