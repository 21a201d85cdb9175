"""Multi-process initialization — the port of `tngp/parallel/distributed.py`
over `torch.distributed`.

Every process runs the same program; `init_distributed` joins the process
group and `mesh.make_mesh` (or `global_mesh`) lays the ranks out as
('data', 'model').  Environment contract (set by the launcher):
  TNGP_COORDINATOR   host:port of process 0 (e.g. "localhost:29500")
  TNGP_NUM_PROCESSES total process count
  TNGP_PROCESS_ID    this process's rank
The backend is NCCL for the card and gloo for the CPU (`TNGP_PLATFORM=cpu`);
with no card and no such setting `default_backend` raises, as
`cli.common.select_device` does; `backend=` overrides it (gloo ranks that
share one card).  The
JAX package's `TNGP_MULTIHOST=1` cluster auto-detection has no torch
counterpart and raises.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def default_backend() -> str:
    """gloo under `TNGP_PLATFORM=cpu`, else NCCL on the card, which must be
    there: no card and no setting raises rather than quietly running the
    ranks on the CPU."""
    if os.environ.get("TNGP_PLATFORM", "") == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card visible for NCCL; set TNGP_PLATFORM=cpu to run the "
                           "ranks on the CPU over gloo")
    return "nccl"


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Join the process group at tcp://<coordinator> as rank `process_id` of
    `num_processes`, each read from the environment when not given.  Returns
    True once a group is up (a repeated call is a no-op), False for a single
    process (nothing given, nothing set)."""
    coordinator = coordinator or os.environ.get("TNGP_COORDINATOR")
    if num_processes is None and os.environ.get("TNGP_NUM_PROCESSES"):
        num_processes = int(os.environ["TNGP_NUM_PROCESSES"])
    if process_id is None and os.environ.get("TNGP_PROCESS_ID"):
        process_id = int(os.environ["TNGP_PROCESS_ID"])
    if coordinator is None and num_processes is None:
        if os.environ.get("TNGP_MULTIHOST"):
            raise RuntimeError(
                "TNGP_MULTIHOST=1 asks for the JAX runtime's cluster auto-detection, which "
                "torch.distributed does not have: set TNGP_COORDINATOR, TNGP_NUM_PROCESSES "
                "and TNGP_PROCESS_ID")
        return False
    if dist.is_initialized():
        return True
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("init_distributed needs the coordinator, the process count and this "
                         "process's rank (TNGP_COORDINATOR, TNGP_NUM_PROCESSES, "
                         "TNGP_PROCESS_ID)")
    dist.init_process_group(backend or default_backend(), init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return True


def global_mesh(n_model: int = 1):
    """The ('data', 'model') mesh over every process (one device each);
    ranks are process-major, so 'data' splits across processes first.
    Requires world size % n_model == 0."""
    from .mesh import make_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh(world // n_model, n_model)


def is_primary() -> bool:
    """True on the process that writes checkpoints, logs and TensorBoard."""
    return not dist.is_initialized() or dist.get_rank() == 0
