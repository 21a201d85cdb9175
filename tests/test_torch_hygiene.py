"""Boundaries of the port: `tngp_torch`, `chip_smoke.py` and `bench_torch.py`
import neither JAX nor the JAX package, nor `flax`, `msgpack`, `cv2` or
`imageio`, whose work the port does with its own code, and a CUDA tensor
never reaches a plain version."""

import importlib
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
_LIBS = ("jax", "flax", "tngp", "msgpack", "cv2", "imageio")
_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:" + "|".join(_LIBS) + r")(?:[.\s,]|$)", re.M)


def check_importing_every_module_loads_no_jax():
    """Every module of `tngp_torch`, `tngp_torch.diagnostics` included."""
    code = (
        "import importlib, pkgutil, sys, tngp_torch\n"
        "for m in pkgutil.walk_packages(tngp_torch.__path__, 'tngp_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "for m in ('data.sdf', 'models.sdf', 'train.sdf_trainer', 'cli.main_sdf',\n"
        "          'cli.viewer', 'utils.profiling', 'ops.grid_sample', 'models.tensorf',\n"
        "          'models.ccnerf', 'train.tensorf_trainer', 'train.cc_trainer',\n"
        "          'cli.main_tensorf', 'cli.main_ccnerf', 'diagnostics.tensor_steps',\n"
        "          'ops.compaction'):\n"
        "    assert 'tngp_torch.' + m in sys.modules, m\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {_LIBS!r})\n"
        "print(len(list(pkgutil.walk_packages(tngp_torch.__path__))), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_source_imports_jax_or_tngp():
    files = sorted((ROOT / "tngp_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                            ROOT / "bench_torch.py"]
    assert len(files) > 10
    assert {"diagnostics", "cli", "native"} <= {f.parent.name for f in files}
    assert {"tngp_torch/data/sdf.py", "tngp_torch/models/sdf.py",
            "tngp_torch/train/sdf_trainer.py", "tngp_torch/cli/main_sdf.py",
            "tngp_torch/cli/viewer.py", "tngp_torch/utils/profiling.py",
            "tngp_torch/ops/grid_sample.py", "tngp_torch/models/tensorf.py",
            "tngp_torch/models/ccnerf.py", "tngp_torch/train/tensorf_trainer.py",
            "tngp_torch/train/cc_trainer.py", "tngp_torch/cli/main_tensorf.py",
            "tngp_torch/cli/main_ccnerf.py", "tngp_torch/diagnostics/tensor_steps.py",
            "tngp_torch/ops/compaction.py"} <= {
        str(f.relative_to(ROOT)) for f in files}
    offenders = [str(f.relative_to(ROOT)) for f in files if _FORBIDDEN.search(f.read_text())]
    assert not offenders, offenders
    for line in ("from tngp.ops import x\n", "import msgpack\n", "import cv2, numpy\n",
                 "    import imageio.v2 as imageio\n", "from flax import serialization\n"):
        assert _FORBIDDEN.search(line), line
    assert not _FORBIDDEN.search("from tngp_torch.ops import x\n")
    assert not _FORBIDDEN.search("from ..utils import msgpack_codec\n")


def test_scripts_train_from_scratch():
    """`TrainConfig`'s default resumes from `<workspace>/checkpoints`, as the
    CLI wants; every script that builds a trainer of random weights asks for
    a fresh one, so that no checkpoint left in its directory loads into it."""
    import ast

    files = sorted((ROOT / "tngp_torch" / "diagnostics").glob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "bench_torch.py"]
    calls = [(f.name, node) for f in files for node in ast.walk(ast.parse(f.read_text()))
             if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "TrainConfig"]
    assert len(calls) >= 7
    loose = [(name, node.lineno) for name, node in calls
             if not any(k.arg == "use_checkpoint" and getattr(k.value, "value", None) == "scratch"
                        for k in node.keywords)]
    assert not loose, loose


def test_every_kernel_is_registered_with_its_source():
    import tngp_torch

    for m in pkgutil.walk_packages(tngp_torch.__path__, "tngp_torch."):
        importlib.import_module(m.name)
    from tngp_torch.kernels import KERNELS

    assert set(KERNELS) == {"scatter_add_unique", "scatter_add_sorted", "scatter_add_any",
                            "scatter_set", "bin_dest", "window_encode_fwd",
                            "window_encode_bwd", "window_encode_dx", "int_mul_probe",
                            "window_encode_fwd_f32", "window_encode_bwd_f32",
                            "window_encode_dx_f32", "march_chunked"}
    for info in KERNELS.values():
        assert (ROOT / info.source).is_file()
        # a kernel that replaces no Pallas kernel names the XLA function it runs
        xla = info.replaces.startswith("none (XLA): ")
        path, line = info.replaces.removeprefix("none (XLA): ").split(":")
        assert ("pallas_call" in (ROOT / path).read_text()) != xla and int(line) > 0


def test_native_library_is_registered_with_its_source():
    """The mesh library is the port's own copy of the JAX package's C++
    source, byte for byte, built from the port's tree at first use."""
    from tngp_torch import native

    src = ROOT / native.SOURCE
    assert src.is_file() and src.read_bytes() == (ROOT / native.COPY_OF).read_bytes()
    assert native._SRC == src and native._BUILD_DIR == ROOT / "tngp_torch" / "_build"


def test_diagnostics_declare_registered_kernels():
    """The kernels each diagnostic declares (and `chip_smoke.py` requires to
    have launched on its path) are registered ones."""
    from tngp_torch.diagnostics import bench_grid_update, device_parity
    from tngp_torch.kernels import KERNELS

    for declared in (device_parity.KERNELS, bench_grid_update.KERNELS):
        assert declared and set(declared) <= set(KERNELS)
    assert "scatter_set" in bench_grid_update.KERNELS
    # both paths sort the encoder's samples, whose destinations are unique;
    # device parity holds every scatter-add form
    assert {"scatter_add_unique", "scatter_add_sorted", "scatter_add_any"} <= set(
        device_parity.KERNELS)
    assert "scatter_add_unique" in bench_grid_update.KERNELS


@pytest.mark.gpu
def test_cuda_tensors_never_reach_the_plain_versions(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tngp_torch.kernels import scatter, window_encoder
    from tngp_torch.ops.window_table import WindowSpec

    def boom(*a, **k):
        raise AssertionError("plain version reached with a CUDA tensor")

    from tngp_torch.kernels import int_mul

    for mod, name in ((scatter, "scatter_add_plain"), (scatter, "scatter_set_flat_plain"),
                      (window_encoder, "bin_ranks_plain"),
                      (window_encoder, "window_encode_fwd_plain"),
                      (window_encoder, "window_encode_bwd_plain"),
                      (window_encoder, "window_encode_dx_plain"),
                      (int_mul, "int_mul_hash_plain")):
        monkeypatch.setattr(mod, name, boom)
    spec = WindowSpec.create(num_levels=2, log2_hashmap_size=15)
    x = torch.rand(3, 1000, device="cuda").requires_grad_(True)
    table = spec.init_table_win(device="cuda").requires_grad_(True)
    out = window_encoder.window_encode_binned(x, table, spec, input_grads=True)
    assert out.shape == (4, 1000) and out.is_cuda
    out.sum().backward()
    assert table.grad.shape == table.shape and table.grad.is_cuda
    assert x.grad.shape == x.shape and x.grad.is_cuda
    assert int_mul.int_mul_hash(torch.arange(64, dtype=torch.int32, device="cuda")).is_cuda
    vals = torch.ones((4, 6), device="cuda")
    for indices, idx in (("unique", [4, 0, 2, 5]), ("sorted", [0, 2, 2, 5]),
                         ("any", [2, 0, 5, 2])):
        out = scatter.scatter_add(torch.tensor(idx, device="cuda"), vals, 5, indices=indices)
        assert out.is_cuda and out.sum().item() == 18.0  # row 5 dropped
    out = scatter.scatter_set_flat(torch.tensor([3, -1, 3], device="cuda"),
                                   torch.tensor([1.0, 2.0, 3.0], device="cuda"), 128)
    assert out.is_cuda and out[3].item() == 3.0 and out[0].item() == -1.0
    torch.cuda.synchronize()
