"""Port parity for the D-NeRF field and step: the frequency encoding, the
weight converter's D-NeRF names, and one step of `DNeRFTrainer` (render at
the frame's time through its bitfield slice, ray-masked MSE plus 1e-3
mean|dx|) with f32 and with bf16 MLPs against the JAX package's step on the
same weights (through `tngp_torch.convert`), rays, noise, targets and
bitfield, at small width (`torch_train_helpers.py`: hidden 16, a 3-layer
deform net, a 2-level window encoder).  The deform net learns through the
encoder's position gradient; samples outside the unit cube are held in
`test_torch_window_encoder_dx.py`.

The JAX step is `torch_train_helpers.jax_dnerf_step`: the loss of
`tngp/train/dnerf_trainer.py` `_build_train_step` on the march_dense branch
of `render_rays_train`, with the test's rays, noise and targets in place of
its key-driven draws; the field op by op around the JAX encoder's binned
Pallas path in interpret mode (`mxu_f32=False`, `input_grads=True` as the
JAX module sets it), which is compiled once for both steps.

Tolerances.  f32 MLPs, as the NGP step (`test_torch_train_step.py`):
integers of the march exact, image 2e-4, loss 1e-5 relative, every
gradient 1e-3 norm-relative (f32 summation order).  bf16 MLPs,
norm-relative: every layer's output rounds to bf16 in both packages but
products are summed in another order, so single roundings flip by a bf16
ulp (2^-7 relative) along the chain of eight layers and the deform offsets
move the encoder's positions with them: field outputs 2e-2, gradients 3e-2
(the training-slice limit), the loss, which averages them, 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tngp.models.dnerf import _freq_cf as jax_freq_cf
from tngp.ops.freq import freq_encode as jax_freq_encode
from tngp_torch.convert import flax_params_from_ngp_state_dict, ngp_state_dict_from_flax
from tngp_torch.models import DNeRFNetwork
from tngp_torch.ops.freq import freq_encode_cf
from tngp_torch.render import render_rays_train
from torch_train_helpers import (
    N_RAYS,
    DNERF_NAMES,
    dnerf_nets,
    jax_dnerf_step,
    port_dnerf_step,
    rel_err,
    scene_inputs,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TIME = float(np.float32(0.6))  # a frame time (f32); slice 2 of 4


def test_frequency_encoding_matches_jax():
    x = np.random.default_rng(0).uniform(-1.1, 1.1, (40, 3)).astype(np.float32)
    got = freq_encode_cf(torch.from_numpy(x.T.copy()), 10).numpy()
    np.testing.assert_allclose(got.T, np.asarray(jax_freq_encode(jnp.asarray(x), 10)),
                               rtol=1e-6, atol=1e-6)
    got_cf = freq_encode_cf(torch.from_numpy(x.T.copy()), 6).numpy()
    np.testing.assert_allclose(got_cf, np.asarray(jax_freq_cf(jnp.asarray(x.T), 6)),
                               rtol=1e-6, atol=1e-6)


def test_f32_step_matches_jax_and_the_hoisted_dilated_grid_is_the_inline_one():
    scene = scene_inputs()
    jnet, params, tnet = dnerf_nets("f32")
    (jloss, (jimage, jnpts, jmask, *_)), jgrads = jax_dnerf_step(jnet, params, scene, TIME)
    tr, batch, tloss, npts, kept = port_dnerf_step(tnet, scene, TIME)
    s = batch["slice"]
    assert s == 2 and tr.sample_batch()["slice"] in (0, s)

    assert int(npts) == int(jnpts) > 200
    assert int(kept) == int(jmask.sum()) < N_RAYS
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    want = ngp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    got = dict(tnet.named_parameters())
    assert set(want) == set(got) == set(DNERF_NAMES)
    for name in DNERF_NAMES:
        g, w = got[name].grad.numpy(), want[name].numpy()
        assert np.isfinite(g).all() and np.linalg.norm(w) > 0, name
        assert rel_err(g, w) <= 1e-3, (name, rel_err(g, w))

    # the slice's dilated grid, built at set_grid, is the one the march
    # builds inline from the same bitfield
    field = tr.field_at_time(tnet, TIME, with_aux=True)
    args = (field, None, batch["rays_o"], batch["rays_d"], tr.grid.bitfield[s], tr.cfg)
    with torch.no_grad():
        hoisted = render_rays_train(*args, noise=batch["noise"], dilated_grid=tr._dgrids[s])
        inline = render_rays_train(*args, noise=batch["noise"])
    for k in ("image", "num_points", "ray_mask"):
        assert torch.equal(hoisted[k], inline[k]), k
    assert torch.equal(hoisted["aux"]["deform_abs"], inline["aux"]["deform_abs"])
    np.testing.assert_allclose(hoisted["image"].numpy(), np.asarray(jimage), atol=2e-4)


def test_bf16_step_field_outputs_and_every_gradient_match_jax():
    scene = scene_inputs()
    jnet, params, tnet = dnerf_nets("bf16")
    (jloss, (_, jnpts, _, jsig, jrgb, jdeform)), jgrads = jax_dnerf_step(jnet, params, scene,
                                                                        TIME)
    captured = {}
    sigma_rgb_cf = tnet.sigma_rgb_cf

    def capture(x_cf, d_cf, t):
        captured["out"] = sigma_rgb_cf(x_cf, d_cf, t)
        return captured["out"]

    tnet.sigma_rgb_cf = capture
    _, _, tloss, npts, _ = port_dnerf_step(tnet, scene, TIME)
    assert int(npts) == int(jnpts)
    sig, rgb, deform = (o.detach().float().numpy() for o in captured["out"])
    for got, want in zip((sig, rgb, deform), (jsig, jrgb, jdeform)):
        assert rel_err(got, np.asarray(want, np.float32)) <= 2e-2
    assert abs(float(tloss.detach()) - float(jloss)) <= 1e-3 * abs(float(jloss))

    want = ngp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    got = dict(tnet.named_parameters())
    assert set(want) == set(got) == set(DNERF_NAMES)
    for name in DNERF_NAMES:
        g, w = got[name].grad.numpy(), want[name].numpy()
        assert np.isfinite(g).all() and np.linalg.norm(w) > 0, name
        assert rel_err(g, w) <= 3e-2, (name, rel_err(g, w))


def test_converter_round_trip_and_unported_options():
    tnet = DNeRFNetwork(encoding="hashgrid_window", device="cpu", hidden_dim=8,
                        hidden_dim_color=8, hidden_dim_deform=8, num_levels=2,
                        log2_hashmap_size=12)
    sd = {k: v.detach().clone() for k, v in tnet.state_dict().items()}
    tree = flax_params_from_ngp_state_dict(sd)
    assert set(tree["params"]) == {"deform_net", "encoder", "sigma_net", "color_net"}
    back = ngp_state_dict_from_flax(tree)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    # as the JAX module: deform input freq(x) 63 + freq(t) 13; sigma input
    # 2 levels x 2 features + 13 + 63; colour input SH 16 + 15 geo features
    assert tnet.deform_net.dense_0.shape == (76, 8)
    assert tnet.sigma_net.dense_0.shape == (4 + 13 + 63, 8)
    assert tnet.color_net.dense_0.shape == (16 + 15, 8)
    # the defaults: the tiled golden grid at the JAX width (16 levels x 2,
    # 2^19 rows a level, 6,119,864 rows), position gradients on; the
    # background model's 2-D grid (4 levels, 697,776 rows) and 2x64 MLP
    dnet = DNeRFNetwork(device="cpu")
    spec = dnet.encoder.spec
    assert (spec.gridtype, spec.num_levels, spec.level_dim, spec.input_grad) == (
        "tiled", 16, 2, True)
    assert dnet.encoder.embeddings.shape == (6_119_864, 2)
    assert dnet.sigma_net.dense_0.shape == (32 + 13 + 63, 64)
    bnet = DNeRFNetwork(encoding="hashgrid_window", bg_radius=1.0, device="cpu")
    assert bnet.encoder_bg.embeddings.shape == (697_776, 2)
    assert bnet.bg_net.dense_0.shape == (16 + 8, 64) and bnet.bg_net.dense_1.shape == (64, 3)
