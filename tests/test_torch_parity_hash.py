"""The JAX hash encode's forward and table gradient against the torch
oracle of `test_torch_parity.py` (its set-up and tolerances), in a file of
four cases that the tier-1 run queues behind the longest JAX test file."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tngp.ops.hashgrid import hash_encode, hash_encode_cf_vjp
from test_torch_parity import _spec, torch_hash_encode


@pytest.mark.parametrize("gridtype", ["hash", "tiled"])
def test_hash_encode_forward_vs_torch(gridtype):
    spec = _spec(gridtype)
    rng = np.random.default_rng(0)
    x = rng.uniform(0.02, 0.98, (256, 3)).astype(np.float32)
    table = rng.normal(0, 0.1, (spec.total_params, spec.level_dim)).astype(np.float32)

    ours = np.asarray(hash_encode(jnp.asarray(x), jnp.asarray(table), spec))
    theirs = torch_hash_encode(torch.from_numpy(x), torch.from_numpy(table), spec).numpy()
    np.testing.assert_allclose(ours, theirs, atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("gridtype", ["hash", "tiled"])
def test_hash_encode_table_grad_vs_torch(gridtype):
    spec = _spec(gridtype)
    rng = np.random.default_rng(1)
    x = rng.uniform(0.02, 0.98, (128, 3)).astype(np.float32)
    table = rng.normal(0, 0.1, (spec.total_params, spec.level_dim)).astype(np.float32)
    cot = rng.normal(0, 1, (128, spec.output_dim)).astype(np.float32)

    # ours: custom-VJP channels-first path
    def f(tbl):
        out = hash_encode_cf_vjp(jnp.asarray(x).T, tbl, spec)  # [L*C, B]
        return jnp.sum(out * jnp.asarray(cot).T)

    g_ours = np.asarray(jax.grad(f)(jnp.asarray(table)))

    tt = torch.from_numpy(table.copy()).requires_grad_(True)
    out = torch_hash_encode(torch.from_numpy(x), tt, spec)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(g_ours, tt.grad.numpy(), atol=5e-5, rtol=1e-4)
