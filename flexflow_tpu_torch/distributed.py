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

Elastic training (``utils/elastic.py``) loses a RANK, one process, where
the JAX package loses a device inside one process.  No process group
can drop a member, so :func:`reform` makes a new world over the
survivors: each leaves the old group and joins a world of
``len(members)`` ranks, renumbered in their old order, over a fresh
rendezvous in the key-value store the first world used
(``PrefixStore("elastic/<generation>", store)``).  That store is kept
from :func:`initialize` on, and the elastic runtime's messages (probe
outcomes, the re-searched strategy, a grow's call to a standing-by
rank) pass through it too (:func:`control_store`).  The store lives on
rank 0 (or in torchrun's agent): a loss of rank 0 is not recoverable.
:func:`elastic_rejoin` is the protocol of a respawned process.
"""

from __future__ import annotations

import datetime
import os
import threading
from typing import Optional, Sequence, Tuple

import torch

from flexflow_tpu_torch.machine import MachineModel, Topology

# whether this process's group was brought up by initialize(): release()
# tears down only such a group; the first world's store, this process's
# rank in that world ("member"), its backend, device and topology, kept
# for reform()
_STATE = {"initialized": False, "store": None, "member": None,
          "backend": None, "device": None, "topology": None,
          "generation": 0}
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
    if _STATE["store"] is None or _STATE["member"] is None:
        from torch.distributed.distributed_c10d import _get_default_store

        _STATE.update(store=_get_default_store(), member=rank)
    _STATE.update(backend=str(dist.get_backend()), device=dev,
                  topology=topology)
    return _world_machine(dev, world_size, rank, topology,
                          generation=_STATE["generation"])


def _world_machine(dev, world_size, rank, topology, members=None,
                   generation=0) -> MachineModel:
    import torch.distributed as dist

    # gloo has no all-to-all and no point-to-point for CUDA tensors (its
    # send of one fails with "writev ... Bad address" and closes the
    # pair): regrid moves and ring rotations then gather
    gloo_cuda = str(dist.get_backend()) == "gloo" and dev.type == "cuda"
    return MachineModel(dev, world_size, rank, topology, distributed=True,
                        all_to_all=not gloo_cuda, send_recv=not gloo_cuda,
                        members=members, generation=generation)


def member() -> Optional[int]:
    """This process's rank in the first world :func:`initialize` made."""
    return _STATE["member"]


def generation() -> int:
    """How many times :func:`reform` re-formed this process's world."""
    return _STATE["generation"]


def control_store():
    """The first world's key-value store (None before :func:`initialize`):
    the elastic runtime's control plane, which outlives every process
    group :func:`reform` replaces."""
    return _STATE["store"]


def reform(members: Sequence[int], generation: int,
           timeout_s: float = 1800.0) -> Optional[MachineModel]:
    """Leave this world and, when this process is one of ``members``
    (ranks of the first world), join the world of ``len(members)`` ranks
    over a fresh rendezvous ``elastic/<generation>`` in the first world's
    store, as rank ``members.index(member())``, with :func:`initialize`'s
    backend and device.  Returns that world's machine (its ``members``
    and ``generation`` set), or None on a process left out (it is in no
    world until a later :func:`reform` names it).  Every member must
    call it with the same arguments."""
    import torch.distributed as dist
    from torch.distributed import PrefixStore

    store = _STATE["store"]
    if store is None:
        raise RuntimeError("distributed.reform needs a world that "
                           "distributed.initialize made")
    members = [int(m) for m in members]
    me = _STATE["member"]
    if dist.is_initialized():
        dist.destroy_process_group()
    with _RELEASE_LOCK:
        _STATE["initialized"] = False
    _STATE["generation"] = int(generation)
    if me not in members:
        return None
    dev = _STATE["device"]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    rank = members.index(me)
    dist.init_process_group(
        _STATE["backend"], store=PrefixStore(f"elastic/{generation}", store),
        rank=rank, world_size=len(members),
        timeout=datetime.timedelta(seconds=timeout_s))
    with _RELEASE_LOCK:
        _STATE["initialized"] = True
    return _world_machine(dev, len(members), rank, _STATE["topology"],
                          members, generation)


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


def elastic_rejoin(ckpt_dir: str, device="cuda",
                   backend: Optional[str] = None,
                   rank: Optional[int] = None,
                   world_size: Optional[int] = None,
                   init_method: Optional[str] = None, model=None,
                   topology: Optional[Topology] = None, olog=None,
                   log=print) -> Tuple[MachineModel, int, Optional[dict],
                                       Optional[dict], Optional[dict]]:
    """The ``--elastic`` restart protocol of a RESPAWNED process
    (``flexflow_tpu/distributed.py:187-246``): leave any stale process
    group, :func:`initialize` the world again (torchrun's environment or
    the arguments; every process of the world restarts with the same
    flags and meets at its rendezvous), build the model when ``model``
    is a factory ``machine -> model`` (a respawned process cannot build
    it before the world exists), and restore the newest verified
    checkpoint under ``ckpt_dir`` onto it, each rank keeping its blocks
    (``FFModel._restore``).  Returns ``(machine, step, params, state,
    opt_state)``: step 0 and None trees when there is no checkpoint (a
    restart before the first save begins again), the whole trees when
    ``model`` is None; writes one ``elastic_rejoin`` record."""
    from flexflow_tpu_torch.utils import checkpoint as ckpt

    shutdown()
    machine = initialize(device, backend=backend, rank=rank,
                         world_size=world_size, init_method=init_method,
                         topology=topology)
    if model is not None and callable(model) \
            and not hasattr(model, "layers"):
        model = model(machine)
    step, params, state, opt_state = 0, None, None, None
    if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        if model is not None:
            step, params, state, opt_state = model._restore(ckpt_dir, olog)
        else:
            step, params, state, opt_state = ckpt.restore_checkpoint(
                ckpt_dir, None, device=machine.device, olog=olog)
        log(f"elastic rejoin: restored verified checkpoint step {step} "
            f"from {ckpt_dir!r} on a {machine.num_devices}-device world")
    else:
        log(f"elastic rejoin: no checkpoint under {ckpt_dir!r}; "
            f"rejoining from step 0")
    if olog is not None and getattr(olog, "enabled", False):
        olog.event("elastic_rejoin", step=step, dir=ckpt_dir,
                   devices=machine.num_devices)
    return machine, step, params, state, opt_state
