"""The general scatter-add's dispatch (`any_form`), the exactness of its
zero skip, and the data-parallel backend's choice, on the CPU with torch
alone.  The designs' kernels run on the card only
(tests/test_torch_kernels_gpu.py, chip_smoke.py); here the choice each
path's shape gets, the shared-memory request it makes, and the arithmetic
fact the kernels rest on when they skip zeros."""

import pytest
import torch

from tngp_torch.kernels import scatter as ks
from tngp_torch.parallel import distributed

# (n, C, rows) of every call of the form on the port's paths (a training
# step of each) -> the design it gets
PATH_SHAPES = {
    # D-NeRF's default tiled grid (131,072 samples x 8 corners), levels 0-4
    # dense, 5-15 wrapped; the same levels' shapes on NGP's tiled grid
    "tiled level 0": ((1_048_576, 2, 4_920), "shared"),
    "tiled level 1": ((1_048_576, 2, 13_824), "warp"),
    "tiled level 2": ((1_048_576, 2, 32_768), "warp"),
    "tiled level 3": ((1_048_576, 2, 85_184), "warp"),
    "tiled level 4": ((1_048_576, 2, 216_000), "warp"),
    "tiled level 15": ((1_048_576, 2, 524_288), "warp"),
    # the hyper variant's 5-D grid (32 corners), level 8
    "hyper level 8": ((4_194_304, 2, 524_288), "warp"),
    # the background model's 2-D grid (4,096 rays x 4 corners), levels 0-3
    "bg level 0": ((16_384, 2, 296), "warp"),
    "bg level 1": ((16_384, 2, 6_728), "warp"),
    "bg level 3": ((16_384, 2, 524_288), "warp"),
    # SDF's hashed grid (262,144 samples x 8 corners)
    "sdf level 0": ((2_097_152, 2, 4_920), "shared"),
    "sdf level 1": ((2_097_152, 2, 13_824), "warp"),
    "sdf level 2": ((2_097_152, 2, 32_768), "warp"),
    "sdf level 15": ((2_097_152, 2, 524_288), "warp"),
    # TensoRF VM (131,072 samples): planes x 4 corners, lines x 2, at 128
    # and at the last resolution (307, 307, 285)
    "vm plane 128": ((524_288, 48, 16_384), "rows"),
    "vm line 128": ((262_144, 48, 128), "owner"),
    "vm sigma line 128": ((262_144, 16, 128), "shared"),
    "vm plane last": ((524_288, 48, 87_495), "rows"),
    "vm line last": ((262_144, 48, 307), "rows"),
    "vm sigma line last": ((262_144, 16, 303), "rows"),
    # TensoRF CP at 128: lines of rank 96 and 288
    "cp sigma line": ((262_144, 96, 128), "owner"),
    "cp colour line": ((262_144, 288, 128), "rows"),
    # CCNeRF (4096 rays x 128 slab slots): rank-64 lines, planes of rank
    # 4-32 on 128 x 128
    "cc line": ((1_048_576, 64, 128), "owner"),
    "cc plane 4": ((2_097_152, 4, 16_384), "warp"),
    "cc plane 32": ((2_097_152, 32, 16_384), "rows"),
    # the per-ray rows of the device-parity probe (393,216 into 4096 rays)
    "per-ray rows": ((393_216, 5, 4_096), "warp"),
}


def test_any_form_at_every_path_shape():
    """Each path's shape gets its design, within the block's shared-memory
    opt-in, with the threads and scratch its kernel is launched with."""
    for label, ((n, C, rows), want) in PATH_SHAPES.items():
        plan = ks.any_form(n, C, rows)
        assert plan.form == want, label
        assert 0 <= plan.smem <= ks.SMEM_BUDGET == 232_448, label
        if plan.form in ("shared", "owner"):
            assert plan.smem >= rows * C * 4 and 1 <= plan.blocks <= ks.H100_SMS, label
            assert plan.scratch == (plan.blocks * rows * C if plan.blocks > 1 else 0), label
        if plan.form == "owner":
            width = -(-C // 32) * 32  # a copy's threads: C in whole warps
            assert plan.threads % width == 0 and plan.threads <= ks.OWNER_MAX_THREADS, label
            assert plan.threads // width * C >= ks.OWNER_MIN_COLUMNS, label
            assert plan.smem == plan.threads // width * rows * C * 4, label
    # the choice reads shapes only, never the data: a card's SM count moves
    # the grid, not the design
    assert ks.any_form(1_048_576, 64, 128, sms=114).blocks == 114
    assert ks.any_form(0, 4, 100).form == "rows"


def test_any_form_at_the_shared_memory_budget():
    """An output of exactly 232,448 bytes takes a shared-memory design; one
    row more does not, and forcing one there raises."""
    rows, n = ks.SMEM_BUDGET // 8, 8_388_608  # C = 2, ~289 adds a row
    plan = ks.any_form(n, 2, rows)
    assert plan.form == "shared" and plan.smem == rows * 2 * 4 == ks.SMEM_BUDGET
    plan = ks.any_form(n, 2, rows + 1)
    assert plan.form == "warp" and plan.smem == 0
    for form in ("shared", "owner"):
        with pytest.raises(ValueError, match="does not fit"):
            ks.any_form(n, 2, rows + 1, form=form)
    with pytest.raises(ValueError):
        ks.any_form(10, 2, rows, form="sorted")
    # on the CPU a forced design is the plain version
    idx = torch.tensor([0, 3, 3, -1, rows])
    vals = torch.arange(10, dtype=torch.float32).reshape(5, 2)
    assert torch.equal(ks.scatter_add_any_as(idx, vals, rows, "warp"),
                       ks.scatter_add_plain(idx, vals, rows))


def test_zero_rows_and_elements_skip_exactly():
    """`index_add_` into +0.0 over all rows equals it over the rows that are
    not all zero, bit for bit, with +0.0 and -0.0 rows among them, and equals
    it with every zero element (either sign) dropped: the skip the kernels
    make changes no sum, and no sum ends at -0.0."""
    g = torch.Generator().manual_seed(0)
    n, C, rows = 20_000, 6, 50
    idx = torch.randint(0, rows, (n,), generator=g)
    vals = torch.randn((n, C), generator=g)
    zero_rows = torch.randperm(n, generator=g)[: n // 5]
    vals[zero_rows] = 0.0
    vals[zero_rows[::2]] = -0.0
    vals[torch.rand((n, C), generator=g) < 0.1] = -0.0
    vals[:, 0][idx == 7] = -0.0  # a column of one row that only ever gets -0.0
    full = ks.scatter_add_plain(idx, vals, rows)
    keep = (vals != 0).any(1)
    assert torch.equal(full, ks.scatter_add_plain(idx[keep], vals[keep], rows))
    nonzero = torch.where(vals != 0, vals, torch.zeros(()))
    assert torch.equal(full, ks.scatter_add_plain(idx, nonzero, rows))
    assert not bool(((full == 0) & torch.signbit(full)).any())
    assert full[7, 0].item() == 0.0


def test_default_backend_needs_the_card_or_the_cpu_setting(monkeypatch):
    """gloo only under TNGP_PLATFORM=cpu; NCCL on the card; with neither it
    raises, as `select_device` does, instead of running the ranks on the CPU."""
    monkeypatch.setenv("TNGP_PLATFORM", "cpu")
    assert distributed.default_backend() == "gloo"
    for plat in ("", "cuda"):
        monkeypatch.setenv("TNGP_PLATFORM", plat)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        assert distributed.default_backend() == "nccl"
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="TNGP_PLATFORM=cpu"):
            distributed.default_backend()
    monkeypatch.delenv("TNGP_PLATFORM")
    with pytest.raises(RuntimeError):
        distributed.default_backend()
