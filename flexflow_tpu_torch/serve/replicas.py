"""Routed serving replicas over a world of ranks: the router of
``serve/router.py`` when a replica is wider than one card.

One process drives one card, so a replica of N cards is N ranks of the
world ``torchrun`` started, and the router must drive replicas that live
in other processes.  Every rank runs the same :class:`ServeRouter` loop
and keeps every replica's scheduler state (queue, slots, virtual clock,
handoffs, crash and revival); a replica's model runs only on its own
ranks, on a slice machine of them (``MachineModel.running_slice``).  The
rest of the world follows through three collectives, entered by every
rank they name at the same point of the loop on every rank, so that no
rank waits on one another rank does not enter:

* after each replica step its first rank broadcasts the step's sampled
  tokens and its wall seconds over the world (:meth:`ReplicaSeat.share`),
  so every rank's schedule takes the same tokens;
* an exported KV payload moves from the prefill replica that exported it
  (its first rank) to every rank of the decode replica it is routed to,
  one broadcast over that pair's group (:meth:`ReplicaWorld.move`); the
  other ranks keep its bookkeeping alone (``kv_cache.KVLedger``);
* the drain flag is agreed at each router iteration, an all-reduce MAX
  over the world (:meth:`ReplicaWorld.agreed`).

Every group is made on every rank in one order (``new_group`` needs every
rank of the process group): each replica's own when its model is set up,
in replica order, then the pair groups here.  Under NCCL the buffers go
as CUDA tensors on the rank's card; under gloo (which carries no
point-to-point and no all-to-all of CUDA tensors) as CPU tensors.  The
transport is chosen once from the backend.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.serve.kv_cache import host_dtype


class ReplicaSeat:
    """One replica of a :class:`ReplicaWorld` as this rank sees it: its
    world ``ranks`` in order, whether this rank ``runs`` its model, and
    whether it ``leads`` (is its first rank)."""

    def __init__(self, world: "ReplicaWorld", ranks: Sequence[int]):
        self.world = world
        self.ranks = tuple(int(r) for r in ranks)
        self.first = self.ranks[0]
        self.runs = world.machine.rank in self.ranks
        self.leads = world.machine.rank == self.first

    def share(self, tokens: Optional[List[int]], wall: float,
              n: int) -> Tuple[List[int], float]:
        """The ``n`` tokens this replica's step sampled and the step's wall
        seconds, as its first rank has them, on every rank of the world
        (every rank calls this after the step, ``tokens`` None where the
        replica does not run)."""
        import torch.distributed as dist

        w = self.world
        buf = torch.zeros(n + 1, dtype=torch.float64, device=w.transport)
        if self.leads:
            buf[:n] = torch.tensor(tokens, dtype=torch.float64)
            buf[n] = wall
        dist.broadcast(buf, src=w.process_rank(self.first),
                       group=w.group.handle)
        vals = buf.cpu().tolist()
        return [int(v) for v in vals[:n]], float(vals[n])


class ReplicaWorld:
    """The prefill and decode replicas of one routed run over the world
    ``machine`` (``torchrun``'s): ``prefill_ranks`` and ``decode_ranks``
    list each replica's world ranks.  Makes the KV moves' pair groups on
    every rank, in one order; call it on every rank after every
    replica's model is set up."""

    def __init__(self, machine, prefill_ranks: Sequence[Sequence[int]],
                 decode_ranks: Sequence[Sequence[int]]):
        from flexflow_tpu_torch import distributed

        self.machine = machine
        self.transport = distributed.control_device(machine.device)
        self.group = machine.world_group()
        self.prefill = [ReplicaSeat(self, r) for r in prefill_ranks]
        self.decode = [ReplicaSeat(self, r) for r in decode_ranks]
        # each prefill replica's first rank with each decode replica's
        # ranks: the group a payload it exported moves over
        self._pairs: Dict[Tuple[int, int], Tuple[tuple, object]] = {}
        for i, src in enumerate(self.prefill):
            for j, dst in enumerate(self.decode):
                ranks = (src.first,) + dst.ranks
                self._pairs[(i, j)] = (ranks, machine.group_of(ranks))

    def process_rank(self, rank: int) -> int:
        pr = self.machine.process_ranks
        return rank if pr is None else pr[rank]

    def agreed(self, flag) -> bool:
        """``flag`` agreed over the world: any rank's true makes it true
        on every rank (an all-reduce MAX)."""
        from flexflow_tpu_torch import distributed

        return distributed.agreed(flag, self.transport, self.group.handle)

    def move(self, req, layout, dst_idx: int) -> None:
        """Move ``req``'s exported KV rows (``layout``: the exporting
        replica's) from the first rank of the prefill replica that holds
        them (``kv_payload["holder"]``) to every rank of decode replica
        ``dst_idx``, which fill them into their copy of the payload; a
        rank of neither does nothing.  Every rank calls this at the same
        point of the loop."""
        import torch.distributed as dist

        p = req.kv_payload
        holder = int(p["holder"])
        ranks, group = self._pairs[(holder, dst_idx)]
        me = self.machine.rank
        if me not in ranks:
            return
        src = self.prefill[holder].first
        if me == src:
            t = torch.from_numpy(np.ascontiguousarray(
                np.stack([p["k"], p["v"]]))).to(self.transport)
        else:
            shape = (2, layout.num_layers, int(p["length"]) - int(p["start"]),
                     layout.num_heads, layout.head_dim)
            dtype = torch.from_numpy(np.zeros(0, host_dtype(layout))).dtype
            t = torch.empty(shape, dtype=dtype, device=self.transport)
        dist.broadcast(t, src=self.process_rank(src), group=group.handle)
        if me != src:
            kv = t.cpu().numpy()
            p["k"], p["v"] = kv[0], kv[1]
