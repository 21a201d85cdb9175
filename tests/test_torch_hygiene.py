"""Boundaries of the port: `tngp_torch` and `chip_smoke.py` import neither
JAX nor the JAX package, and a CUDA tensor never reaches a plain version."""

import importlib
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|flax|tngp)(?:[.\s,]|$)", re.M)


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys, tngp_torch\n"
        "for m in pkgutil.walk_packages(tngp_torch.__path__, 'tngp_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'flax', 'tngp'))\n"
        "print(len(list(pkgutil.walk_packages(tngp_torch.__path__))), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_source_imports_jax_or_tngp():
    files = sorted((ROOT / "tngp_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files if _FORBIDDEN.search(f.read_text())]
    assert not offenders, offenders
    assert _FORBIDDEN.search("from tngp.ops import x\n")
    assert not _FORBIDDEN.search("from tngp_torch.ops import x\n")


def test_every_kernel_is_registered_with_its_source():
    import tngp_torch

    for m in pkgutil.walk_packages(tngp_torch.__path__, "tngp_torch."):
        importlib.import_module(m.name)
    from tngp_torch.kernels import KERNELS

    assert set(KERNELS) == {"scatter_add", "bin_ranks", "window_encode_fwd",
                            "window_encode_bwd"}
    for info in KERNELS.values():
        assert (ROOT / info.source).is_file()
        path, line = info.replaces.split(":")
        assert "pallas_call" in (ROOT / path).read_text() and int(line) > 0


@pytest.mark.gpu
def test_cuda_tensors_never_reach_the_plain_versions(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tngp_torch.kernels import scatter, window_encoder
    from tngp_torch.ops.window_table import WindowSpec

    def boom(*a, **k):
        raise AssertionError("plain version reached with a CUDA tensor")

    for mod, name in ((scatter, "scatter_add_plain"), (window_encoder, "bin_ranks_plain"),
                      (window_encoder, "window_encode_fwd_plain"),
                      (window_encoder, "window_encode_bwd_plain")):
        monkeypatch.setattr(mod, name, boom)
    spec = WindowSpec.create(num_levels=2, log2_hashmap_size=15)
    x = torch.rand(3, 1000, device="cuda")
    table = spec.init_table_win(device="cuda").requires_grad_(True)
    out = window_encoder.window_encode_binned(x, table, spec)
    assert out.shape == (4, 1000) and out.is_cuda
    out.sum().backward()
    assert table.grad.shape == table.shape and table.grad.is_cuda
    torch.cuda.synchronize()
