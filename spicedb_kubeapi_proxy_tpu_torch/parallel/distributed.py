"""Multi-process runtime glue: `torch.distributed` for a mesh across
processes.

The torch counterpart of the reference's parallel/distributed.py.  Every
proxy process joins one `torch.distributed` group; a `torch://?distributed=
1&mesh=...` endpoint then places the mesh's shards over every rank's card
(parallel/sharding.py `make_process_mesh`) and runs the same sharded
program on every rank, SPMD: every rank must issue the same verbs on the
same batches in the same order.

Environment contract (the reference's, so one deployment's environment
serves both packages; all three set together, or none):

    SPICEDB_TPU_COORDINATOR   host:port of rank 0's rendezvous store
    SPICEDB_TPU_NUM_PROCESSES world size
    SPICEDB_TPU_PROCESS_ID    this process's rank

With none set, the runtime's own detection runs: `init_method="env://"`
(`MASTER_ADDR`, `MASTER_PORT`, `WORLD_SIZE`, `RANK`, as `torchrun` sets
them).  `strict` re-raises a failure there; otherwise the process stays
standalone.  The backend is "cpu:gloo,cuda:nccl": CPU tensors go over gloo,
card tensors over NCCL (gloo alone in a torch built without NCCL).  A
rank's card is `LOCAL_RANK`, or else its rank
modulo the visible cards.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch

BACKEND = "cpu:gloo,cuda:nccl"
# a rank that cannot reach its peers fails the collective after this
TIMEOUT_S = 300


def _runtime_initialized() -> bool:
    """True when torch.distributed is up in this process (whether or not
    this module did it)."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _init(**kw) -> None:
    import torch.distributed as dist

    # a torch built without NCCL (no card to reach) carries gloo only
    backend = BACKEND if dist.is_nccl_available() else "gloo"
    dist.init_process_group(backend=backend,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S),
                            **kw)
    if torch.cuda.is_available():
        torch.cuda.set_device(local_card())


def init_from_env(coordinator: Optional[str] = None,
                  num_processes: Optional[int] = None,
                  process_id: Optional[int] = None,
                  strict: bool = True) -> bool:
    """Join (or start) the process group described by the SPICEDB_TPU_*
    env triplet or the explicit arguments.  Idempotent against the real
    runtime state.  Returns True when the process is part of an
    initialized process group.

    `strict` governs the no-explicit-config path (`env://`): True
    re-raises its failure (a misconfigured worker must fail loudly, not
    serve answers over a partial mesh); False treats it as "not a
    cluster" and returns False."""
    if _runtime_initialized():
        return True

    coordinator = coordinator or os.environ.get("SPICEDB_TPU_COORDINATOR")
    n_env = os.environ.get("SPICEDB_TPU_NUM_PROCESSES")
    p_env = os.environ.get("SPICEDB_TPU_PROCESS_ID")
    if num_processes is None and n_env:
        num_processes = int(n_env)
    if process_id is None and p_env:
        process_id = int(p_env)

    if coordinator is None and num_processes is None and process_id is None:
        try:
            _init(init_method="env://")
        except Exception:
            if strict:
                raise
            return False
        return True

    if not (coordinator and num_processes is not None
            and process_id is not None):
        raise ValueError(
            "partial multi-host config: SPICEDB_TPU_COORDINATOR, "
            "SPICEDB_TPU_NUM_PROCESSES and SPICEDB_TPU_PROCESS_ID must be "
            "set together")
    _init(init_method=f"tcp://{coordinator}", world_size=num_processes,
          rank=process_id)
    return True


def is_initialized() -> bool:
    return _runtime_initialized()


def world() -> tuple:
    """(rank, world size); (0, 1) outside a process group."""
    if not _runtime_initialized():
        return 0, 1
    import torch.distributed as dist

    return dist.get_rank(), dist.get_world_size()


def local_card() -> int:
    """This rank's card: LOCAL_RANK, or else its rank modulo the visible
    cards."""
    local = os.environ.get("LOCAL_RANK")
    if local:
        return int(local)
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA card visible to this rank")
    return world()[0] % n


def destroy() -> None:
    """Leave the process group (a no-op outside one)."""
    if _runtime_initialized():
        import torch.distributed as dist

        dist.destroy_process_group()
