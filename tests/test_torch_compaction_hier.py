"""`compact_mask_hier` of `tngp_torch/ops/compaction.py` against
`tngp/ops/compaction.py`, on `test_torch_compaction.py`'s run-clustered
masks: with the default chunk budget, with one so small that it truncates
the selection (m_eff below both the budget and the valid count), and with a
slab whose size is not a multiple of G: `sel`, `sel_valid` and `m_eff`
exactly, the selection the first m_eff valid samples in flat order.  Each
case compiles a JAX program: this file has three."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_compaction import _mask
from tngp.ops import compaction as jcomp
from tngp_torch.ops import compaction as tcomp
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("N,K,G,chunk_budget,M_budget", [
    (96, 24, 8, None, 512),
    (96, 24, 8, 40, 1024),
    (77, 13, 8, None, 384),
])
def test_compact_mask_hier_exact(N, K, G, chunk_budget, M_budget):
    m = _mask(N, K, 3)
    cj = jcomp.compact_mask_hier(jnp.asarray(m), M_budget, G=G, chunk_budget=chunk_budget)
    ct = tcomp.compact_mask_hier(torch.from_numpy(m), M_budget, G=G, chunk_budget=chunk_budget)
    for name in ("sel", "sel_valid", "m_eff"):
        np.testing.assert_array_equal(getattr(ct, name).numpy(), np.asarray(getattr(cj, name)),
                                      err_msg=name)
    m_eff = int(ct.m_eff)
    # the selection is the first m_eff valid samples in flat order
    np.testing.assert_array_equal(ct.sel[:m_eff].numpy(), np.flatnonzero(m)[:m_eff])
    if chunk_budget is not None:  # the chunk budget truncates the selection
        assert m_eff < min(M_budget, int(m.sum()))
