"""Multi-process entry point (PyTorch port of ``flexflow_tpu/distributed.py``).

Every rank runs the same program, one process per device, and
:func:`initialize` joins them into one process group and returns the
:class:`~flexflow_tpu_torch.machine.MachineModel` of the world::

    torchrun --nproc-per-node 4 -m flexflow_tpu_torch.apps.cnn alexnet \\
        -s strategy.json -ll:gpu 4

    from flexflow_tpu_torch import distributed
    machine = distributed.initialize()        # torchrun's environment
    ff = build_alexnet(cfg, machine)

The rank, world size and local rank come from torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``)
or from the arguments.  The backend is NCCL on ``cuda:LOCAL_RANK`` and
gloo on the CPU, unless ``backend`` names one; it is never switched at
run time because something failed.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import torch

from flexflow_tpu_torch.machine import MachineModel, Topology

# whether this process's group was brought up by initialize(): release()
# tears down only such a group
_STATE = {"initialized": False}
_RELEASE_LOCK = threading.Lock()


def is_initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def initialize(device="cuda", backend: Optional[str] = None,
               rank: Optional[int] = None, world_size: Optional[int] = None,
               local_rank: Optional[int] = None,
               init_method: Optional[str] = None,
               topology: Optional[Topology] = None) -> MachineModel:
    """Join this process to the world and return its machine.

    ``device`` ``"cuda"`` runs on ``cuda:LOCAL_RANK`` (raising when CUDA
    is absent), ``"cpu"`` on the CPU.  ``backend`` defaults to NCCL for
    CUDA and gloo for the CPU; ``init_method`` to ``env://`` (torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``).  A process group this process made
    already is reused."""
    import torch.distributed as dist

    from flexflow_tpu_torch.machine import resolve_device

    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None \
        else int(world_size)
    local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None \
        else int(local_rank)
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank if dev.index is None
                           else dev.index)
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world_size)
        with _RELEASE_LOCK:
            _STATE["initialized"] = True
    elif (dist.get_rank(), dist.get_world_size()) != (rank, world_size):
        raise RuntimeError(
            f"a process group of rank {dist.get_rank()} in "
            f"{dist.get_world_size()} exists; asked for rank {rank} in "
            f"{world_size}")
    # gloo has no all-to-all and no point-to-point for CUDA tensors (its
    # send of one fails with "writev ... Bad address" and closes the
    # pair): regrid moves and ring rotations then gather
    gloo_cuda = str(dist.get_backend()) == "gloo" and dev.type == "cuda"
    return MachineModel(dev, world_size, rank, topology, distributed=True,
                        all_to_all=not gloo_cuda, send_recv=not gloo_cuda)


def shutdown() -> None:
    """Leave the process group (a no-op when there is none)."""
    import torch.distributed as dist

    with _RELEASE_LOCK:
        _STATE["initialized"] = False
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def release() -> bool:
    """Leave the world on the way out of ``fit`` (its error exit and the
    end of a graceful drain, ``flexflow_tpu/distributed.py:166``): tear
    down the process group IF :func:`initialize` brought it up, else do
    nothing.  Idempotent and re-entrant: both paths may call it, in any
    order, and only the first tears down.  True when this call did."""
    import torch.distributed as dist

    with _RELEASE_LOCK:
        if not _STATE["initialized"]:
            return False
        _STATE["initialized"] = False
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    return True


def elastic_rejoin(*args, **kwargs):
    """Rejoining a running world waits for ROADMAP Queue A item 5,
    elastic training."""
    raise NotImplementedError(
        "distributed.elastic_rejoin: elastic training is not ported yet "
        "(ROADMAP Queue A item 5, elastic training)")
