"""Port parity for the models that default to the golden hash grid:
`DNeRFNetwork` on `tiledgrid` (with and without the background model),
`DNeRFBasisNetwork`, `DNeRFHyperNetwork` and `NGPNetwork(encoding="hashgrid",
bg_radius > 0)`, against the JAX modules on the same weights (through
`tngp_torch.convert`), and the default widths of every ported model class.

At small width (2 levels of 2^10 rows from base resolution 4, hidden
widths 16, N(0, 0.3) tables) with f32 MLPs: the forward (sigma, rgb, deform, the background) and the
gradient of every parameter of a weighted sum of the outputs, the JAX side
op by op (`jax.grad` without `jit`; its hash encode is jitted inside, as in
the package).  A JAX-written checkpoint of each loads into the port exactly,
and the port's loads into the JAX package exactly.

The forward and gradient cases and the default-width cases compile JAX
programs; they run from test_torch_dnerf_variants_{grads,tree}_{1,2}.py,
files of three cases each, which the tier-1 run queues behind the longest
JAX test file.

The JAX modules size their canonical encoder with the factory's defaults;
the tests narrow it through `small_jax_encoders`.  The JAX trainers' `init`
never reaches `background_cf`, so flax creates no background parameters
there (ROADMAP section 3); the JAX side's trees here come from an `init`
that calls the background too.

Base resolution 4 makes level 0's dense index cover all five dimensions of
the hyper grid (5^4 <= 2^10), so the ambient net gets a gradient.  Where a
level's index leaves a dimension out (level 1 here, and the fine levels at
the default width: the running stride outgrows the table), the corners
along it share rows, and its gradient is 0 up to f32 cancellation of the
2^D terms, whose residue depends on the summation order (about 1e-5 of the
ambient net's gradient here).

Tolerances, norm-relative: outputs 1e-5 and gradients 1e-4 (f32 summation
order in the MLPs and the corner sums, and the residue above; the JAX
backward's weights come from x * scale + shift rounded twice, the
forward's once)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tngp.models.dnerf as jdnerf
import tngp.train.checkpoint as jckpt
from tngp.models import DNeRFBasisNetwork as JBasis
from tngp.models import DNeRFHyperNetwork as JHyper
from tngp.models import DNeRFNetwork as JDNeRF
from tngp.models import NGPNetwork as JNGP
from tngp_torch.convert import flax_params_from_ngp_state_dict, ngp_state_dict_from_flax
from tngp_torch.models import DNeRFBasisNetwork, DNeRFHyperNetwork, DNeRFNetwork, NGPNetwork
from tngp_torch.train import checkpoint as tckpt
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SMALL_ENC = dict(num_levels=2, log2_hashmap_size=10, base_resolution=4)
TIME = float(np.float32(0.6))
B = 256
# name -> (JAX class, port class, shared widths)
CASES = {
    "dnerf": (JDNeRF, DNeRFNetwork, dict(hidden_dim=16, hidden_dim_color=16,
                                         hidden_dim_deform=16, num_layers_deform=3)),
    "dnerf_bg": (JDNeRF, DNeRFNetwork, dict(hidden_dim=16, hidden_dim_color=16,
                                            hidden_dim_deform=16, num_layers_deform=3,
                                            hidden_dim_bg=16, bg_radius=2.0)),
    "basis": (JBasis, DNeRFBasisNetwork, dict(hidden_dim=16, hidden_dim_color=16,
                                              hidden_dim_basis=16, num_layers_basis=3)),
    "hyper": (JHyper, DNeRFHyperNetwork, dict(hidden_dim=16, hidden_dim_color=16,
                                              hidden_dim_ambient=16)),
    "ngp_bg": (JNGP, NGPNetwork, dict(encoding="hashgrid", hidden_dim=16, hidden_dim_color=16,
                                      hidden_dim_bg=16, bg_radius=2.0, **SMALL_ENC)),
}


@contextlib.contextmanager
def small_jax_encoders():
    """Inside this scope the JAX D-NeRF modules build their canonical hash
    or tiled grid with SMALL_ENC (the 2-D background grid keeps its size)."""
    orig = jdnerf.get_encoder

    def small(encoding, **kw):
        if encoding in ("hashgrid", "tiledgrid") and kw.get("input_dim", 3) != 2:
            kw = {**kw, **SMALL_ENC}
        return orig(encoding, **kw)

    jdnerf.get_encoder = small
    try:
        yield
    finally:
        jdnerf.get_encoder = orig


def is_dynamic(jcls):
    return jcls is not JNGP


def init_all(mod, x, d, *t):
    """Flax init method reaching every submodule: the field and, where the
    module has one, the background."""
    out = mod(x, d, *t)
    if getattr(mod, "bg_radius", -1.0) > 0 and hasattr(mod, "background_cf"):
        out = (out, mod.background_cf(x[:, :2].T, d.T))
    return out


def flat_shapes(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_shapes(net) -> dict:
    return {"params/" + n.replace(".", "/"): tuple(p.shape) for n, p in net.named_parameters()}


# `test_defaults_build_the_jax_param_tree`'s cases, split over
# test_torch_dnerf_variants_tree_{1,2}.py
TREE_CASES = [
    (JNGP, NGPNetwork, {}), (JDNeRF, DNeRFNetwork, {}), (JBasis, DNeRFBasisNetwork, {}),
    (JHyper, DNeRFHyperNetwork, {}), (JNGP, NGPNetwork, dict(bg_radius=2.0)),
    (JDNeRF, DNeRFNetwork, dict(bg_radius=2.0)),
]
TREE_IDS = ["ngp", "dnerf", "basis", "hyper", "ngp_bg", "dnerf_bg"]


def check_defaults_build_the_jax_param_tree(jcls, tcls, kw):
    """Each class at its own defaults builds the JAX module's parameter
    names and shapes (the JAX side by `jax.eval_shape` of `init`, so no
    50-67 MB table is drawn)."""
    jnet = jcls(**kw)
    args = (jnp.zeros((8, 3)), jnp.ones((8, 3)) / np.sqrt(3.0))
    args += (jnp.float32(0.0),) if is_dynamic(jcls) else ()
    shapes = jax.eval_shape(lambda k: jnet.init(k, *args, method=init_all),
                            jax.random.PRNGKey(0))
    tnet = tcls(device="cpu", **kw)
    assert port_shapes(tnet) == flat_shapes(shapes)
    if tcls is not NGPNetwork:
        assert tnet.encoder.spec.gridtype == "tiled" and tnet.encoder.spec.input_grad
    else:
        assert tnet.encoder.spec.gridtype == "hash" and not tnet.encoder.spec.input_grad


def build(name, seed=0, bf16=False):
    """(JAX module, its params as numpy, the port's module) with the same
    weights: the port's init, tables N(0, 0.3); f32 MLPs, or bf16 ones."""
    jcls, tcls, kw = CASES[name]
    tnet = tcls(device="cpu", seed=seed, **kw,
                **({} if tcls is NGPNetwork else SMALL_ENC),
                **({"compute_dtype": torch.bfloat16} if bf16 else {}))
    rng = np.random.default_rng(seed + 1)
    with torch.no_grad():
        for n, p in tnet.named_parameters():
            if n.endswith("embeddings"):
                p.copy_(torch.from_numpy(rng.normal(0, 0.3, tuple(p.shape)).astype(np.float32)))
    jnet = jcls(**kw, **({"compute_dtype": jnp.bfloat16} if bf16 else {}))
    return jnet, flax_params_from_ngp_state_dict(tnet.state_dict()), tnet


def field_inputs(seed=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (3, B)).astype(np.float32)
    d = rng.normal(0, 1, (3, B)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    sph = rng.uniform(-1, 1, (2, B)).astype(np.float32)
    w = rng.normal(0, 1, (8, B)).astype(np.float32)  # output weights of the loss
    return x, d, sph, w


def jax_outputs(jnet, p, x, d, sph):
    """{'sigma', 'rgb'[, 'deform'][, 'bg']} of the JAX module, op by op."""
    dyn = is_dynamic(type(jnet))
    args = (jnp.asarray(x), jnp.asarray(d)) + ((jnp.float32(TIME),) if dyn else ())
    out = jnet.apply(p, *args, method=type(jnet).sigma_rgb_cf)
    res = {"sigma": out[0], "rgb": out[1]}
    if dyn and out[2] is not None:
        res["deform"] = out[2]
    if jnet.bg_radius > 0:
        res["bg"] = jnet.apply(p, jnp.asarray(sph), jnp.asarray(d),
                               method=type(jnet).background_cf)
    return res


def port_outputs(tnet, x, d, sph):
    dyn = not isinstance(tnet, NGPNetwork)
    args = (torch.from_numpy(x), torch.from_numpy(d)) + ((TIME,) if dyn else ())
    out = tnet.sigma_rgb_cf(*args)
    res = {"sigma": out[0], "rgb": out[1]}
    if dyn and out[2] is not None:
        res["deform"] = out[2]
    if tnet.bg_radius > 0:
        res["bg"] = tnet.background_cf(torch.from_numpy(sph), torch.from_numpy(d))
    return res


def weighted_sum(outs, w, xp):
    """sum of every output times a fixed weight row (the same in both)."""
    total = (outs["sigma"] * w[0]).sum() + (outs["rgb"] * w[1:4]).sum()
    if "deform" in outs:
        total = total + (outs["deform"] * w[4:7]).sum()
    if "bg" in outs:
        total = total + (outs["bg"] * w[5:8]).sum()
    return total


def rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                 / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-30))


# `test_forward_and_gradients_match_jax`'s cases, split over
# test_torch_dnerf_variants_grads_{1,2}.py
GRAD_CASES = [(n, False) for n in CASES] + [("dnerf_bg", True)]
GRAD_IDS = list(CASES) + ["dnerf_bg_bf16"]


def check_forward_and_gradients_match_jax(name, bf16):
    """f32 MLPs at 1e-5 / 1e-4; bf16 MLPs (-O) at the bf16 limits of
    `test_torch_dnerf.py`: outputs 2e-2, gradients 3e-2 norm-relative (a
    layer's output rounds to bf16 in both packages, its products summed in
    another order, so single roundings flip by a bf16 ulp)."""
    tol_out, tol_grad = (2e-2, 3e-2) if bf16 else (1e-5, 1e-4)
    jnet, params, tnet = build(name, bf16=bf16)
    x, d, sph, w = field_inputs()
    with small_jax_encoders():
        jout = jax_outputs(jnet, params, x, d, sph)
        jgrad = jax.grad(lambda p: weighted_sum(jax_outputs(jnet, p, x, d, sph),
                                                jnp.asarray(w), jnp))(params)
    tout = port_outputs(tnet, x, d, sph)
    assert set(tout) == set(jout)
    for k in jout:
        assert tout[k].shape == jout[k].shape, k
        out_k = tout[k].detach().float().numpy()
        assert rel(out_k, np.asarray(jout[k], np.float32)) <= tol_out, (k, rel(out_k, jout[k]))
    weighted_sum(tout, torch.from_numpy(w), torch).backward()
    want = ngp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrad))
    got = {n: p.grad for n, p in tnet.named_parameters()}
    assert set(got) == set(want)
    for n in want:
        assert got[n] is not None and np.linalg.norm(want[n].numpy()) > 0, n
        assert rel(got[n].numpy(), want[n].numpy()) <= tol_grad, (n, rel(got[n].numpy(),
                                                                         want[n].numpy()))


@pytest.mark.parametrize("name", list(CASES))
def test_checkpoints_load_both_ways_exactly(name, tmp_path):
    """A checkpoint the JAX package writes (its msgpack writer) loads into
    the port's module bit for bit, and the port's loads into the JAX
    package's reader bit for bit."""
    _, params, tnet = build(name, seed=5)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    path = jckpt.save_checkpoint(str(tmp_path / "jax"), "m", 3, 17, {"params": jparams})
    fresh = type(tnet)(device="cpu", seed=9, **CASES[name][2],
                       **({} if isinstance(tnet, NGPNetwork) else SMALL_ENC))
    template = {"params": flax_params_from_ngp_state_dict(fresh.state_dict())}
    payload, meta = tckpt.load_checkpoint(path, template, strict=True)
    assert (meta["epoch"], meta["global_step"]) == (3, 17)
    fresh.load_state_dict(ngp_state_dict_from_flax(payload["params"]))
    for n, v in tnet.state_dict().items():
        assert torch.equal(fresh.state_dict()[n], v), n

    ppath = tckpt.save_checkpoint(str(tmp_path / "port"), "m", 4, 21,
                                  {"params": flax_params_from_ngp_state_dict(fresh.state_dict())})
    zeros = jax.tree_util.tree_map(jnp.zeros_like, jparams)
    back, _ = jckpt.load_checkpoint(ppath, {"params": zeros}, strict=True)
    for a, b in zip(jax.tree_util.tree_leaves(back["params"]),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
