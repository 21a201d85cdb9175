"""Shared set-up of the TensoRF and CCNeRF parity tests
(`test_torch_grid_sample.py`, `test_torch_tensorf*.py`,
`test_torch_slab_march.py`, `test_torch_ccnerf.py`,
`test_torch_cc_trainer.py`): a small TensoRF in both packages with the
same weights (the port's initial weights, handed to the JAX module through
`tngp_torch.convert`), on a non-cubic resolution and a shrunk box so that
an axis or a bound mixed up shows; a small CCNeRF config (as
`tests/test_ccnerf.py`'s `small_cfg`); and the JAX TensoRF module applied
to a flax tree that has the background MLP (the JAX trainers' `init` never
calls `background_cf`, so flax builds no `bg_net` there: ROADMAP section 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tngp_torch.convert import flax_params_from_ngp_state_dict
from tngp_torch.models.ccnerf import CCConfig

TF_KW = dict(resolution=(12, 16, 20), color_feat_dim=6, hidden_dim=16, bg_radius=2.0,
             bg_resolution=(16, 24), bg_rank=3, hidden_dim_bg=16,
             aabb=(-0.8, -0.9, -1.0, 0.9, 0.8, 1.0))
RANKS = {"vm": dict(sigma_rank=(2, 3, 4), color_rank=(3, 4, 5)),
         "cp": dict(sigma_rank=(3, 3, 3), color_rank=(4, 4, 4))}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}

CC_SMALL = dict(resolution=(20, 24, 28), rank_vec_density=(8, 8, 8),
                rank_mat_density=(0, 2, 4), rank_vec=(8, 8, 8), rank_mat=(0, 2, 4))


def small_cc_cfg(**kw) -> CCConfig:
    return CCConfig(**{**CC_SMALL, **kw})


def tensorf_nets(decomposition: str, dtype_name: str = "f32", seed: int = 1, **kw):
    """(JAX module, its {'params': ...} tree, the port's module)."""
    from tngp.models.tensorf import TensoRFNetwork as JaxTensoRF
    from tngp_torch.models import TensoRFNetwork

    jdt, tdt = DTYPES[dtype_name]
    args = {**TF_KW, **RANKS[decomposition], **kw, "decomposition": decomposition}
    tnet = TensoRFNetwork(**args, compute_dtype=tdt, device="cpu", seed=seed)
    jnet = JaxTensoRF(**args, compute_dtype=jdt)
    return jnet, flax_params_from_ngp_state_dict(tnet.state_dict()), tnet


def points(n: int, seed: int = 0, lo: float = -1.1, hi: float = 1.1):
    """(x [3, n] in [lo, hi], unit d [3, n]) as numpy float32."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    return x, (d / np.linalg.norm(d, axis=0, keepdims=True)).astype(np.float32)


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)
