"""Cases 2 of 2 of `test_torch_dnerf_variants.py`'s
`test_defaults_build_the_jax_param_tree` (the set-up, the check and its tolerances are that file's)."""

import pytest

from test_torch_dnerf_variants import TREE_CASES, TREE_IDS, check_defaults_build_the_jax_param_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("jcls,tcls,kw", TREE_CASES[3:], ids=TREE_IDS[3:])
def test_defaults_build_the_jax_param_tree(jcls, tcls, kw):
    """Each class at its own defaults builds the JAX module's parameter names and shapes."""
    check_defaults_build_the_jax_param_tree(jcls, tcls, kw)
