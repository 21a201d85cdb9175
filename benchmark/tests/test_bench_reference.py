"""The plain reference's pieces against the port's plain CPU versions at
small sizes: the windowed encoding, the harmonics, the factor samples and
the weights' shapes (whole steps and frames are held in
test_bench_cells.py)."""

import torch

from benchmark import harness
from benchmark.reference import ngp, tensorf, volume


def _cfg(name):
    return harness.load_json(harness.ROOT / "benchmark" / "configs" / f"{name}.json")


def test_window_encoding_matches_the_ports():
    from tngp_torch.ops.window_table import WindowSpec, window_encode_ref, window_unview

    cfg = _cfg("instant-ngp")
    cfg.update(num_levels=6, log2_hashmap_size=15)
    spec = WindowSpec.create(num_levels=6, level_dim=2, base_resolution=16,
                             log2_hashmap_size=15, desired_resolution=2048)
    assert ngp.n_windows(cfg) == spec.n_windows
    g = torch.Generator().manual_seed(3)
    table = torch.rand((spec.n_windows, 2, 128, 64), generator=g) * 2e-4 - 1e-4
    x01 = torch.rand((4000, 3), generator=g)
    want = window_encode_ref(x01.T.contiguous(), window_unview(table, spec), spec).T
    torch.testing.assert_close(ngp.encode(x01, table, cfg), want, rtol=1e-5, atol=1e-10)


def test_harmonics_match_the_ports():
    from tngp_torch.ops.sh import sh_encode_cf

    d = torch.nn.functional.normalize(torch.randn((500, 3),
                                                  generator=torch.Generator().manual_seed(4)))
    torch.testing.assert_close(ngp.sh4(d), sh_encode_cf(d.T.contiguous(), 4).T,
                               rtol=1e-5, atol=1e-6)


def test_factor_samples_match_the_ports():
    from tngp_torch.ops.grid_sample import grid_sample_1d_cf, grid_sample_2d_cf

    g = torch.Generator().manual_seed(5)
    plane, line = torch.randn((4, 9, 7), generator=g), torch.randn((4, 11), generator=g)
    u, v, w = (torch.rand((300,), generator=g) * 2.2 - 1.1 for _ in range(3))
    torch.testing.assert_close(tensorf.sample2d(plane, u, v), grid_sample_2d_cf(plane, u, v).T)
    torch.testing.assert_close(tensorf.sample1d(line, w), grid_sample_1d_cf(line, w).T)


def test_weights_have_the_ports_shapes():
    from tngp_torch.models import NGPNetwork, TensoRFNetwork

    cfg = _cfg("instant-ngp")
    cfg.update(num_levels=4, log2_hashmap_size=14)
    net = NGPNetwork(encoding="hashgrid_window", num_levels=4, log2_hashmap_size=14,
                     device="cpu")
    w = ngp.make_weights(cfg, 2**32 + 7, "cpu")
    assert {k: tuple(v.shape) for k, v in w.items()} == \
        {k: tuple(p.shape) for k, p in net.named_parameters()}
    assert torch.equal(w["sigma_net.dense_0"], ngp.make_weights(cfg, 2**32 + 7, "cpu")
                       ["sigma_net.dense_0"])
    cfg = _cfg("tensorf-vm192")
    cfg.update(resolution0=16)
    net = TensoRFNetwork(resolution=(16, 16, 16), device="cpu")
    w = tensorf.make_weights(cfg, 11, "cpu")
    assert {k: tuple(v.shape) for k, v in w.items()} == \
        {k: tuple(p.shape) for k, p in net.named_parameters()}


def test_compositing_stops_after_opacity():
    sigma = torch.tensor([[0.0, 50.0, 50.0, 50.0]])
    rgb = torch.ones((1, 4, 3))
    mask = torch.tensor([[True, True, True, True]])
    ws, _, color = volume.composite(sigma, rgb, 0.2, torch.ones((1, 4)), mask, 1e-4)
    assert 0.9999 < float(ws) <= 1.0 and torch.allclose(color, ws[:, None].expand(1, 3))


def test_budgets_a_step_may_run_at_follow_its_demand():
    """instant-NGP's tiers, and which of them a step of a given demand (its
    valid rungs) may run at once its tier has adapted; a configuration
    without tiers runs at its one budget."""
    cfg = _cfg("instant-ngp")
    tiers = ngp.budget_tiers(16384, cfg)
    assert tiers == [131072, 262144, 524288, 1048576]

    def allowed(demand):  # rays cut in proportion to the samples past the budget
        return volume.adapted_budgets(demand, lambda m: min(1.0, m / demand), tiers)

    assert allowed(330_000) == {524288, 1048576}  # the top tier within 1.6x headroom
    assert allowed(320_000) == {524288}
    assert allowed(100_000) == {131072, 262144}
    assert allowed(80_000) == {131072}
    assert allowed(2_000_000) == {1048576}  # rays dropped at every tier: the top one
    one = [volume.train_budget(16384, _cfg("tensorf-vm192"))]
    assert volume.adapted_budgets(80_000, lambda m: 1.0, one) == set(one)
    assert volume.adapted_budgets(2_000_000, lambda m: 0.1, one) == set(one)
