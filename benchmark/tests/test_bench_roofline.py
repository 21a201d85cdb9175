"""The yardstick's arithmetic against the port's own: the frozen encoder
byte bound and corner addressing against `tngp_torch`'s on seeded inputs,
the scatter-add's bytes, and each configuration's FLOPs a sample written
out by hand."""

import math

import torch

from benchmark import harness, roofline
from benchmark.reference import ngp, tensorf


def _small_cfg():
    cfg = harness.load_json(harness.ROOT / "benchmark" / "configs" / "instant-ngp.json")
    cfg.update(num_levels=6, log2_hashmap_size=15)
    return cfg


def _encoder_inputs(cfg, M=3000, seed=0):
    from tngp_torch.kernels import window_encoder as kw
    from tngp_torch.kernels.scatter import scatter_add
    from tngp_torch.ops.window_table import WindowSpec

    spec = WindowSpec.create(num_levels=cfg["num_levels"], level_dim=cfg["level_dim"],
                             base_resolution=cfg["base_resolution"],
                             log2_hashmap_size=cfg["log2_hashmap_size"],
                             desired_resolution=cfg["desired_resolution"])
    x01 = torch.rand((3, M), generator=torch.Generator().manual_seed(seed))
    dest, tob = kw.bin_dest(x01, block=kw.DEFAULT_BLOCK)
    payload = torch.cat([x01, torch.ones((1, M))]).T.contiguous()
    xyz4 = scatter_add(dest, payload, kw.padded_size(M, kw.DEFAULT_BLOCK), indices="unique")
    return spec, xyz4, kw._wob_local(spec, tob), kw


def test_encoder_bytes_match_the_ports():
    from tngp_torch.diagnostics.kernel_times import encoder_bytes

    cfg = _small_cfg()
    spec, xyz4, wob, kw = _encoder_inputs(cfg)
    assert roofline.encoder_bytes(xyz4, wob, cfg, kw.DEFAULT_BLOCK) == \
        encoder_bytes("fwd", xyz4, wob, spec, kw.DEFAULT_BLOCK)


def test_encoder_bwd_bytes_match_the_ports():
    from tngp_torch.diagnostics.kernel_times import encoder_bytes

    cfg = _small_cfg()
    spec, xyz4, wob, kw = _encoder_inputs(cfg, seed=2)
    assert roofline.encoder_bwd_bytes(xyz4.shape[0], wob.numel(), cfg) == \
        encoder_bytes("bwd", xyz4, wob, spec, kw.DEFAULT_BLOCK)


def test_corner_addresses_match_the_ports():
    cfg = _small_cfg()
    spec, xyz4, wob, kw = _encoder_inputs(cfg, seed=1)
    for lv in range(cfg["num_levels"]):
        a, w = roofline.corner_addresses(xyz4, wob, cfg, kw.DEFAULT_BLOCK, lv)
        pa, pw = kw.sorted_corner_addresses(xyz4, wob, spec, kw.DEFAULT_BLOCK, lv)
        assert torch.equal(a, pa) and torch.equal(w, pw)


def test_add_bytes_and_share():
    assert roofline.add_bytes(10, 4, 3) == 10 * 8 + 10 * 4 * 4 + 3 * 4 * 4
    assert roofline.bound_share(3.35e12, 2.0) == 50.0
    assert roofline.bound_share(1.0, 0.0) is None


def test_ngp_flops_a_sample_by_hand():
    cfg = harness.load_json(harness.ROOT / "benchmark" / "configs" / "instant-ngp.json")
    mlp = 2 * (32 * 64 + 64 * 16) + 2 * (32 * 64 + 64 * 64 + 64 * 3)
    enc = 16 * (9 + 8 * (3 + 2 + 2 * 2))
    assert ngp.forward_flops(cfg) == mlp + enc + 30 + 4 + 12 == 20158


def test_tensorf_flops_a_sample_by_hand():
    cfg = harness.load_json(harness.ROOT / "benchmark" / "configs" / "tensorf-vm192.json")
    pairs = 3 * (14 * 16 + 12) + 3 * (14 * 48 + 12)
    basis = 2 * 144 * 27
    freq = 4 * 2 * 2 * (27 + 3)
    mlp = 2 * (150 * 128 + 128 * 128 + 128 * 3)
    assert tensorf.forward_flops(cfg) == pairs + basis + freq + mlp + 16 == 82968
    assert math.prod(tensorf.layer_shapes(cfg)["color_net.dense_0"]) == 150 * 128
