"""Data parallelism in the port (`tngp_torch/parallel`, `Trainer(mesh=)`)
against the JAX package's (`tngp/parallel`): the environment contract of
`init_distributed`; two gloo processes on the CPU
(`tests/torch_dist_worker.py`), whose `data_parallel_value_and_grad`
agrees with the JAX function's on a 2-device CPU mesh, whose first
training batch's loss and gradients (a budget that drops no ray) equal one
process's over the concatenated batch, and whose parameters are bitwise
equal after three `Trainer(mesh=make_mesh())` steps; and a trainer without
a mesh (or with a one-rank mesh) taking the step it took before
parallelism.

Tolerances: the regression's loss and gradients 1e-6 relative (the same
f32 terms, each shard's sum and the mean of the two in another order); the
first batch's loss 1e-6 relative, gradients 1e-5 norm-relative (two
partial sums of every gradient added, the table's bf16-rounded products
in another order); equality across ranks and with the unmeshed step
bitwise."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tngp.parallel import data_parallel_value_and_grad as jax_dpvg
from tngp.parallel import make_mesh as jax_make_mesh
from tngp_torch.parallel import init_distributed, make_mesh, param_sharding_rules, ray_sharding
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

sys.path.insert(0, str(Path(__file__).parent))
import torch_dist_worker as worker  # noqa: E402


def _rel(a, b):
    a, b = torch.as_tensor(np.array(a)).double(), torch.as_tensor(np.array(b)).double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def test_init_distributed_env_contract(monkeypatch):
    for k in ("TNGP_COORDINATOR", "TNGP_NUM_PROCESSES", "TNGP_PROCESS_ID", "TNGP_MULTIHOST"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is False  # one process: nothing set, nothing given
    monkeypatch.setenv("TNGP_MULTIHOST", "1")
    with pytest.raises(RuntimeError, match="TNGP_COORDINATOR"):
        init_distributed()
    monkeypatch.delenv("TNGP_MULTIHOST")
    monkeypatch.setenv("TNGP_COORDINATOR", "localhost:1")
    with pytest.raises(ValueError, match="TNGP_PROCESS_ID"):
        init_distributed()  # a rank and a count are needed too
    mesh = make_mesh()  # no group: one rank
    assert (mesh.n_data, mesh.n_model, mesh.rank, mesh.world) == (1, 1, 0, 1)
    with pytest.raises(ValueError):
        make_mesh(2, 1)
    two = mesh.__class__(2, 1, 1, 2)
    assert ray_sharding(two).bounds(256) == (128, 256)
    with pytest.raises(ValueError):
        ray_sharding(two).bounds(255)
    rule = param_sharding_rules(two, shard_table=True)
    assert rule("encoder.embeddings", torch.zeros(8, 2)).local(torch.ones(3)).shape == (3,)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks(tmp_path):
    env = {**os.environ, "TNGP_COORDINATOR": f"localhost:{_free_port()}",
           "TNGP_NUM_PROCESSES": "2", "TNGP_PLATFORM": "cpu", "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, worker.__file__, str(tmp_path / f"r{r}.pt")],
                              env={**env, "TNGP_PROCESS_ID": str(r)}, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    r0, r1 = (torch.load(tmp_path / f"r{r}.pt") for r in range(2))
    assert (r0["rank"], r1["rank"], r0["world"]) == (0, 1, 2)

    # data_parallel_value_and_grad against the JAX function on 2 CPU devices
    params, x, y = worker.regression()
    jmesh = jax_make_mesh(2, 1, devices=jax.devices()[:2])

    def jloss(p, xx, yy):
        return jnp.mean((jnp.sum(xx[:, :, None] * p[0][None], axis=1) + p[1] - yy) ** 2)

    jl, jg = jax_dpvg(jloss, jmesh, 2)([jnp.asarray(p) for p in params], jnp.asarray(x),
                                        jnp.asarray(y))
    for r in (r0, r1):
        assert abs(float(r["dp_loss"]) - float(jl)) <= 1e-6 * abs(float(jl))
        for g, want in zip(r["dp_grads"], jg):
            assert _rel(g, want) <= 1e-6

    # the first batch: one process over the whole batch
    tr = worker.make_trainer(None, str(tmp_path / "one"), compact_fraction=0.9)
    loss, kept, grads = worker.first_batch_grads(tr)
    assert int(kept) == worker.N  # the budget dropped no ray
    assert int(r0["one_kept"]) + int(r1["one_kept"]) == worker.N
    for r in (r0, r1):
        assert abs(float(r["one_loss"]) - float(loss)) <= 1e-6 * float(loss)
        for g, want in zip(r["one_grads"], grads):
            assert _rel(g, want) <= 1e-5
    for a, b in zip(r0["one_grads"], r1["one_grads"]):
        assert torch.equal(a, b)

    # three steps: the ranks' weights, EMA, grid and losses bitwise equal
    assert torch.isfinite(r0["losses"]).all()
    assert torch.equal(r0["losses"], r1["losses"])
    for key in ("params", "ema"):
        for a, b in zip(r0[key], r1[key]):
            assert torch.equal(a, b)
    assert torch.equal(r0["grid"], r1["grid"])
    init = worker.make_trainer(None, str(tmp_path / "init"), compact_fraction=0.25)
    assert not all(torch.equal(a, p) for a, p in zip(r0["params"], init.params))


def test_unmeshed_step_is_the_step_before_parallelism(tmp_path):
    """`Trainer()` steps as the plain sequence loss -> backward -> Adam ->
    schedule -> EMA did before `mesh=` existed, and a one-rank mesh gives
    the same bits."""
    from tngp_torch.train.ema import ema_update

    trs = [worker.make_trainer(m, str(tmp_path / f"t{i}"), compact_fraction=0.25)
           for i, m in enumerate((None, make_mesh(), None))]
    for _ in range(2):
        for tr in trs[:2]:
            tr.train_step()
        ref = trs[2]
        loss, _, _ = ref.loss_on_batch(ref.sample_batch())
        ref.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        ref.optimizer.step()
        ref.scheduler.step()
        ema_update(ref.ema_params, ref.params, ref.tc.ema_decay)
    for tr in trs[:2]:
        for a, b in zip(tr.params, trs[2].params):
            assert torch.equal(a, b)
        for a, b in zip(tr.ema_params, trs[2].ema_params):
            assert torch.equal(a, b)
