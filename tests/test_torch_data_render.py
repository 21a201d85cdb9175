"""`sample_pdf`, `render_rays_uniform` and the synthetic dataset of
`test_torch_data.py`, in a file of its own (the set-up, the checks and their
tolerances are that file's)."""

import pytest

from test_torch_data import (
    check_make_synthetic_dataset_matches_jax_ground_truth,
    check_render_rays_uniform_matches_jax_on_the_blob_field,
    check_sample_pdf_det_matches_jax_and_explicit_u_matches_oracle,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_sample_pdf_det_matches_jax_and_explicit_u_matches_oracle():
    """`sample_pdf`, deterministic and with explicit draws."""
    check_sample_pdf_det_matches_jax_and_explicit_u_matches_oracle()


@pytest.mark.parametrize("upsample", [0, 16])
def test_render_rays_uniform_matches_jax_on_the_blob_field(upsample):
    """The grid-free render of the analytic field."""
    check_render_rays_uniform_matches_jax_on_the_blob_field(upsample)


def test_make_synthetic_dataset_matches_jax_ground_truth():
    """The blob scene's views, both packages."""
    check_make_synthetic_dataset_matches_jax_ground_truth()
