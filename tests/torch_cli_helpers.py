"""Shared set-up of the port's CLI tests (`test_torch_cli.py`,
`test_torch_cli_runs.py`, `test_torch_sdf_cli.py`): the small runs' flags
and `small_models`, which runs the CLIs in the process, on the CPU, at small
width: the models narrowed to 2 levels of 2^12 rows and hidden widths 16,
the occupancy grid to 32^3 (a time slice's for D-NeRF), so that a full grid
update and each checkpoint stay small on the CPU."""

import functools

import pytest

FLAGS = ["--num_rays", "128", "--max_steps", "48", "--sample_budget", "16", "--bound", "1.0",
         "--dt_gamma", "0", "--min_near", "0.05", "--eval_interval", "100",
         "--skip_test_render", "--mesh_resolution", "24", "--workspace", "ws"]


DNERF_FLAGS = ["--time_size", "4", "--num_rays", "128", "--max_steps", "48", "--sample_budget",
               "16", "--bound", "1.0", "--dt_gamma", "0", "--min_near", "0.05",
               "--eval_interval", "100"]


@pytest.fixture
def small_models(monkeypatch):
    """The CLIs in the process, on the CPU, at small width (module
    docstring); the SDF network's grid too (4 levels of 2^12 rows)."""
    import tngp_torch.models as models
    from tngp_torch.cli import common

    monkeypatch.setenv("TNGP_PLATFORM", "cpu")
    monkeypatch.setenv("TNGP_SYNTH", "4,32,32")
    small = dict(num_levels=2, log2_hashmap_size=12, hidden_dim=16, hidden_dim_color=16)
    for name, extra in (("DNeRFNetwork", dict(hidden_dim_deform=16, num_layers_deform=3)),
                        ("DNeRFBasisNetwork", dict(hidden_dim_basis=16, num_layers_basis=3)),
                        ("DNeRFHyperNetwork", dict(hidden_dim_ambient=16)),
                        ("NGPNetwork", dict(hidden_dim_bg=16))):
        monkeypatch.setattr(models, name, functools.partial(getattr(models, name),
                                                            **small, **extra))
    build = common.build_configs

    def small_grid(opt):
        import dataclasses

        cfg, tc = build(opt)
        return dataclasses.replace(cfg, grid_size=32), tc

    monkeypatch.setattr(common, "build_configs", small_grid)
    import tngp_torch.models.sdf as sdf

    monkeypatch.setattr(sdf, "get_encoder", functools.partial(
        sdf.get_encoder, num_levels=4, log2_hashmap_size=12))
