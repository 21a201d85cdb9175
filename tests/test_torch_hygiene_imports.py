"""`test_torch_hygiene.py`'s import of every module of `tngp_torch` in a
clean interpreter, in a file of its own (the check is that file's)."""

from test_torch_hygiene import check_importing_every_module_loads_no_jax


def test_importing_every_module_loads_no_jax():
    """Every module of `tngp_torch`, `tngp_torch.diagnostics` included."""
    check_importing_every_module_loads_no_jax()
