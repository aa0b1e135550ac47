"""The machine a model runs on (PyTorch port of ``flexflow_tpu/machine.py``).

A :class:`MachineModel` is a world of ranks, one process and one device
each: ``num_devices`` is the world size and ``rank`` this process's
rank.  One process on one device (the default) is a world of 1; a world
of several comes from :func:`flexflow_tpu_torch.distributed.initialize`
under ``torchrun``.

Every op runs on the partition grid and device list of its
``ParallelConfig``.  The grid point with multi-index ``(i0, i1, ...)``
over ``pc.dims`` runs on rank ``pc.devices[i0 + d0*(i1 + d1*(...))]``
(dim 0 fastest, ``mesh_for``'s map in the JAX package).  As there, the
machine is prime-factored once into global mesh axes ``_g0, _g1, ...``
(ascending sizes, the last axis fastest over the ranks) and each grid
dim is realized by a tuple of those axes (:meth:`global_assign`), so
that a producer->consumer grid change decomposes into single-axis hops
(:meth:`regrid_steps`, ``parallel/regrid.py``) and the shard->rank map
equals the per-op map above.  A strategy whose full-machine device lists
all name one permutation of the ranks is honored by relabelling the
machine (:meth:`permuted`, ``flexflow_tpu/model.py:152-221``): rank
``perm[i]`` then plays position ``i``.

Collectives run over process groups of the ranks along a set of global
axes; :meth:`create_groups` makes every group of such a partition, in
one order on every rank (``torch.distributed.new_group`` must be called
by every rank, members or not).

The GPipe pipelined LM (``parallel/pipeline.py``) runs on a mesh of its
own instead, ``(stage, n, tp)`` with tp fastest
(:meth:`MachineModel.pipeline_mesh`, the JAX package's
``dev.reshape(num_stages, dp, tp)``): rank ``s*dp*tp + n*tp + t``.

An op whose device list is a strict subset of the machine (or a second,
conflicting permutation of it) runs on those ranks alone
(``parallel/placement.py``): its grid map is the JAX package's for the
block, stride and set families (``placement_mesh``, ``flat_mesh``:
``placement.point_positions``), and its collectives run over explicit
rank sets (:meth:`group_of`), made at build time on every rank in one
order.

Every entry point of the package resolves its ``device`` argument here
(:func:`resolve_device`).  It defaults to ``"cuda"``, and asking for CUDA
on a machine without it raises: the package never falls back to the CPU
unless the caller passed ``device="cpu"``.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import logging
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from flexflow_tpu_torch.strategy import ParallelConfig

logger = logging.getLogger(__name__)


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and
    CUDA is not available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            f"pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev


#: NVLink 4 between the eight H100 SXM cards of one node: 900 GB/s per
#: card in both directions together, 450 GB/s each way (NVIDIA's H100
#: data sheet)
NVLINK4_BANDWIDTH = 4.5e11

#: between nodes, one 400 Gb/s NDR InfiniBand port per card (NVIDIA's
#: DGX H100 data sheet: eight ConnectX-7 ports per node): 50 GB/s each way
NDR_BANDWIDTH = 5.0e10


@dataclasses.dataclass(frozen=True)
class Topology:
    """Two-tier interconnect model that prices regrid hops and the
    strategy search's transfers and collectives
    (``flexflow_tpu/machine.py:34``): ranks ``r // devices_per_ici_group``
    share the fast tier ("ici"), the rest talk over the slow one ("dcn").
    Bandwidths are per direction, in bytes/s.  The defaults are the JAX
    package's modeled constants, kept so that the regrid planner and the
    search pick what the JAX package picks; they are not measurements of
    any GPU interconnect.  :meth:`hopper` is the card's."""

    devices_per_ici_group: int = 8
    ici_bandwidth: float = 9.0e10
    dcn_bandwidth: float = 2.5e10
    ici_latency: float = 1.0e-6
    dcn_latency: float = 1.0e-5

    @classmethod
    def hopper(cls, devices_per_ici_group: int = 8) -> "Topology":
        """H100 SXM nodes: an NVLink tier of ``devices_per_ici_group``
        cards (8 in a node) and an InfiniBand tier between nodes, at the
        published per-direction bandwidths.  The latencies stay the
        model's defaults: neither is published nor measured here."""
        return cls(devices_per_ici_group=devices_per_ici_group,
                   ici_bandwidth=NVLINK4_BANDWIDTH,
                   dcn_bandwidth=NDR_BANDWIDTH)

    def with_calibration(self, path: str) -> "Topology":
        """This topology with the slow tier's bandwidth and latency read
        from a calibration file (``dcn_bandwidth``, ``dcn_latency``)."""
        import json

        with open(path) as f:
            cal = json.load(f)
        return dataclasses.replace(self,
                                   dcn_bandwidth=float(cal["dcn_bandwidth"]),
                                   dcn_latency=float(cal["dcn_latency"]))

    @classmethod
    def from_calibration(cls, path: str,
                         devices_per_ici_group: int = 8) -> "Topology":
        """The default topology with the slow tier from a calibration file
        (``flexflow_tpu/machine.py:50``)."""
        return cls(devices_per_ici_group=devices_per_ici_group
                   ).with_calibration(path)

    def bandwidth(self, dev_a: int, dev_b: int) -> float:
        """Point-to-point bandwidth between two device ordinals: infinite
        on one device, the fast tier inside a group, else the slow one
        (``flexflow_tpu/machine.py:63``)."""
        if dev_a == dev_b:
            return float("inf")
        g = self.devices_per_ici_group
        if dev_a // g == dev_b // g:
            return self.ici_bandwidth
        return self.dcn_bandwidth


@dataclasses.dataclass(frozen=True)
class Group:
    """The ranks along some global axes that hold this rank's position on
    every other axis: ``positions`` in mixed-radix order of those axes
    (the first axis slowest), ``ranks`` the same as ranks, ``handle`` the
    process group (None for one member of a larger world, and when the
    machine is not distributed)."""

    positions: Tuple[int, ...]
    ranks: Tuple[int, ...]
    handle: object = None

    @property
    def size(self) -> int:
        return len(self.positions)


@dataclasses.dataclass(frozen=True)
class PipelineMesh:
    """This rank's place on a ``(stage, n, tp)`` mesh and its groups:
    ``stage`` along the stages (one per (n, t), members in stage order),
    ``data`` along n (the ranks holding the same tp block of a stage's
    leaves), ``tp`` along tp (one stage's Megatron group), ``block``
    along (n, tp) (the ranks holding a stage's replicated leaves) and
    ``world``."""

    stages: int
    dp: int
    tp: int
    coords: Tuple[int, int, int]
    stage: Group
    data: Group
    tp_group: Group
    block: Group
    world: Group


class MachineModel:
    """A world of ``world_size`` ranks, this process being ``rank`` on
    ``device``.  ``default_pc`` is the pure-DP config an op takes when the
    strategy has no entry for it.  ``distributed`` says whether
    collectives go through ``torch.distributed`` (set by
    ``distributed.initialize``, also for a world of one); a machine of
    several ranks without it plans (the regrid planner, strategy checks)
    but cannot run a collective.  ``all_to_all`` says whether the process
    group's backend has an all-to-all for the device's tensors (gloo has
    none for CUDA tensors); without it a regrid's move is an all-gather
    and a slice.  ``send_recv`` says whether it has point-to-point sends
    for them; without it a ring's rotation is an all-gather
    (``collectives.rotate``).

    ``members`` names the process behind each rank: its rank in the world
    ``torchrun`` made (``range(world_size)`` there).  Elastic training
    re-forms the world over the ranks that survive a loss
    (``distributed.reform``), renumbered in their old order, and
    ``generation`` counts those re-forms; :meth:`shrink` and :meth:`grow`
    plan such a resize.

    A machine may run on a slice of the process group's ranks while the
    rest of the world does something else (:meth:`running_slice`, a
    serving replica of several ranks): ``process_ranks`` then names each
    of its ranks' rank in the process group (None: the machine is the
    whole process group), every group it opens is a ``new_group`` of
    those ranks, and a rank outside the slice holds a *bystander* view of
    it (``bystander``: position 0, device ``meta``) that makes the same
    groups in the same order and runs nothing."""

    def __init__(self, device="cuda", world_size: int = 1, rank: int = 0,
                 topology: Optional[Topology] = None,
                 distributed: bool = False,
                 view: Optional[Sequence[int]] = None,
                 all_to_all: bool = True, send_recv: bool = True,
                 members: Optional[Sequence[int]] = None,
                 generation: int = 0,
                 process_ranks: Optional[Sequence[int]] = None):
        if world_size < 1 or not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} of world size {world_size}")
        self.device = resolve_device(device)
        self.world_size = int(world_size)
        self.rank = int(rank)
        self.distributed = bool(distributed)
        self.all_to_all = bool(all_to_all)
        self.send_recv = bool(send_recv)
        self.topology = topology or Topology(
            devices_per_ici_group=max(self.world_size, 1))
        self.view = tuple(view) if view is not None \
            else tuple(range(self.world_size))
        if sorted(self.view) != list(range(self.world_size)):
            raise ValueError(f"view {self.view} is not a permutation of "
                             f"the {self.world_size} ranks")
        self.position = self.view.index(self.rank)
        self.members = tuple(int(m) for m in members) \
            if members is not None else tuple(range(self.world_size))
        if len(self.members) != self.world_size:
            raise ValueError(f"{len(self.members)} members for a world of "
                             f"{self.world_size}")
        self.generation = int(generation)
        self.process_ranks = tuple(int(r) for r in process_ranks) \
            if process_ranks is not None else None
        if self.process_ranks is not None \
                and len(self.process_ranks) != self.world_size:
            raise ValueError(f"{len(self.process_ranks)} process ranks for "
                             f"a world of {self.world_size}")
        self.bystander = False
        self._gfactors = None
        # process groups by rank set; partitions by axis set
        self._handles: Dict[Tuple[int, ...], object] = {}
        self._groups: Dict[Tuple[str, ...], Group] = {}
        self._warned: set = set()

    @classmethod
    def virtual(cls, num_devices: int, topology: Optional[Topology] = None,
                members: Optional[Sequence[int]] = None) -> "MachineModel":
        """A machine of ``num_devices`` for an offline strategy search
        (``flexflow_tpu/machine.py:127``): graphs build on it for any
        size, but it opens no process group and touches no device (its
        device is ``meta``), so nothing can run on it."""
        m = cls.__new__(cls)
        m.device = torch.device("meta")
        m.world_size = int(num_devices)
        m.rank = m.position = 0
        m.distributed = False
        m.all_to_all = m.send_recv = True
        m.topology = topology or Topology(
            devices_per_ici_group=max(m.world_size, 1))
        m.view = tuple(range(m.world_size))
        m.members = tuple(int(x) for x in members) if members is not None \
            else tuple(range(m.world_size))
        m.generation = 0
        m.process_ranks, m.bystander = None, False
        m._gfactors = None
        m._handles, m._groups, m._warned = {}, {}, set()
        return m

    @property
    def num_devices(self) -> int:
        return self.world_size

    # ------------------------------------------------------------------
    # elastic resizes (flexflow_tpu/machine.py:148-222): planning views;
    # the running machine of a resized world is distributed.reform's

    def _resized(self, members: List[int]) -> "MachineModel":
        """A virtual machine over ``members`` with the topology re-derived
        (:meth:`_sliced_topology`)."""
        return MachineModel.virtual(len(members),
                                    self._sliced_topology(len(members)),
                                    members)

    def _sliced_topology(self, n: int) -> Topology:
        """The topology of ``n`` of this machine's ranks: a machine that
        was one fast-tier group stays one, a larger one keeps its group
        size."""
        topo = self.topology
        if topo.devices_per_ici_group >= self.num_devices:
            topo = dataclasses.replace(topo, devices_per_ici_group=n)
        return topo

    def shrink(self, live: Sequence[int]) -> "MachineModel":
        """The machine over the SURVIVING rank ordinals ``live`` (into
        this machine's ranks), in their old order, as a virtual machine
        (the strategy search's view of the resized world); this one is
        never mutated."""
        idx = sorted(set(int(i) for i in live))
        if not idx:
            raise ValueError("cannot shrink to an empty device set")
        bad = [i for i in idx if i < 0 or i >= self.num_devices]
        if bad:
            raise ValueError(
                f"live ordinals {bad} out of range for this "
                f"{self.num_devices}-device machine")
        return self._resized([self.members[i] for i in idx])

    def slice_of(self, ordinals: Sequence[int]) -> "MachineModel":
        """:meth:`shrink`, named for carving a pool into disjoint slices:
        nothing died.  A planning view; :meth:`running_slice` is the
        machine a slice runs on."""
        return self.shrink(ordinals)

    def running_slice(self, ordinals: Sequence[int]) -> "MachineModel":
        """The machine that runs on the ranks at ``ordinals`` while the
        rest of this world does something else (a serving replica),
        ranks renumbered in their order, with the topology of
        :meth:`shrink`'s view.  On a rank of the slice: one process on
        this device when the slice is one rank, else a distributed
        machine whose collectives go to a ``new_group`` of those ranks
        (``process_ranks``).  On any other rank: the slice's bystander
        view (device ``meta``, position 0), which builds the same graph
        and, for a slice of several ranks, makes the same groups in the
        same order (``torch.distributed.new_group`` needs every rank of
        the process group) but runs nothing.  Every rank calls this for
        every slice, in one order, and sets up the slice's model
        (``FFModel._setup_sharded``) before any slice runs."""
        idx = sorted(set(int(i) for i in ordinals))
        self.shrink(idx)            # the same checks
        members = [self.members[i] for i in idx]
        topo = self._sliced_topology(len(idx))
        process = [self.process_ranks[i] if self.process_ranks is not None
                   else i for i in idx]
        if self.rank in idx and self.device.type != "meta":
            if len(idx) == 1:
                return MachineModel(self.device, topology=topo,
                                    members=members,
                                    generation=self.generation)
            return MachineModel(self.device, len(idx), idx.index(self.rank),
                                topo, self.distributed,
                                all_to_all=self.all_to_all,
                                send_recv=self.send_recv, members=members,
                                generation=self.generation,
                                process_ranks=process)
        m = MachineModel.virtual(len(idx), topo, members)
        m.all_to_all, m.send_recv = self.all_to_all, self.send_recv
        if len(idx) > 1:
            m.distributed, m.process_ranks = self.distributed, tuple(process)
        m.bystander = True
        return m

    def devices_at(self, ordinals: Sequence[int]) -> list:
        """The members (processes) at rank ``ordinals``, in the given
        order: what :meth:`grow` takes back."""
        n = self.num_devices
        out = []
        for i in ordinals:
            i = int(i)
            if not 0 <= i < n:
                raise ValueError(
                    f"ordinal {i} out of range for this {n}-device "
                    f"machine")
            out.append(self.members[i])
        return out

    def grow(self, returned: Sequence) -> "MachineModel":
        """The inverse of :meth:`shrink`: the machine over this one's
        members plus ``returned`` (members a shrink took out), sorted
        back into their first world's order, as a virtual machine."""
        extra = [int(m) for m in returned]
        if not extra:
            raise ValueError("grow needs at least one returned device")
        dup = [m for m in extra if m in self.members]
        if dup:
            raise ValueError(
                f"returned devices {dup} are already part of this "
                f"{self.num_devices}-device machine")
        if len(set(extra)) != len(extra):
            raise ValueError("returned devices contain duplicates")
        return self._resized(sorted(list(self.members) + extra))

    def is_canonical(self, pc: ParallelConfig) -> bool:
        """Whether ``pc`` names the whole machine in natural order."""
        return pc.devices == tuple(range(self.num_devices))

    def warn_once(self, key, msg: str) -> None:
        """Log ``msg`` as a warning the first time ``key`` is seen on this
        machine (``flexflow_tpu/machine.py`` ``_warn_once``)."""
        if key not in self._warned:
            self._warned.add(key)
            logger.warning(msg)

    def default_pc(self, ndims: int) -> ParallelConfig:
        """Pure-DP default, the reference's fallback when an op has no
        strategy entry (cnn.cc:76-86)."""
        return ParallelConfig.data_parallel(ndims, self.num_devices)

    def permuted(self, perm: Sequence[int]) -> "MachineModel":
        """The same world with position ``i`` played by the rank at this
        view's position ``perm[i]`` (``flexflow_tpu/model.py:152-221``);
        a bystander's view stays one."""
        m = copy.copy(self)
        m.view = tuple(self.view[d] for d in perm)
        m.position = m.view.index(m.rank)
        m._gfactors = None
        m._handles, m._groups, m._warned = {}, {}, set()
        return m

    # ------------------------------------------------------------------
    # the per-op grid map (mesh_for, flexflow_tpu/machine.py:240-265)

    @staticmethod
    def grid_index(pc: ParallelConfig, position: int) -> Optional[tuple]:
        """Multi-index over ``pc.dims`` of the grid point that runs at
        ``position`` (``pc.devices`` linearized with dim 0 fastest), or
        None when the grid has no point there."""
        if position not in pc.devices:
            return None
        lin = pc.devices.index(position)
        idx = []
        for d in pc.dims:
            idx.append(lin % d)
            lin //= d
        return tuple(idx)

    # ------------------------------------------------------------------
    # the global factored mesh (flexflow_tpu/machine.py:386-475)

    def global_factors(self) -> List[Tuple[str, int]]:
        """``[(axis_name, prime_size), ...]``: the ascending prime
        factorization of the world size."""
        if self._gfactors is None:
            n = self.num_devices
            sizes = []
            f = 2
            while f * f <= n:
                while n % f == 0:
                    sizes.append(f)
                    n //= f
                f += 1
            if n > 1:
                sizes.append(n)
            self._gfactors = [(f"_g{i}", s) for i, s in enumerate(sizes)]
        return list(self._gfactors)

    def axis_sizes(self) -> Dict[str, int]:
        return dict(self.global_factors())

    def coords(self, position: Optional[int] = None) -> Dict[str, int]:
        """Coordinates of ``position`` (default this rank's) on the global
        axes: the row-major unflattening, the last axis fastest."""
        pos = self.position if position is None else position
        out = {}
        for name, size in reversed(self.global_factors()):
            out[name] = pos % size
            pos //= size
        return out

    def global_assign(self, pc: ParallelConfig,
                      axis_names: Tuple[str, ...]) -> Optional[Dict]:
        """{op axis name -> tuple of global axes realizing that grid dim},
        or None when the grid does not decompose over the factors.  Grid
        dim 0 consumes factors from the fast end backwards; within one
        grid dim the axes are ordered slow-first.  The induced shard ->
        position map equals :meth:`grid_index`'s for a canonical pc."""
        fac = self.global_factors()
        idx = len(fac)
        assign: Dict[str, Tuple[str, ...]] = {}
        for name, g in zip(axis_names, pc.dims):
            take = []
            while g > 1:
                if idx == 0:
                    return None
                aname, size = fac[idx - 1]
                if g % size:
                    return None
                idx -= 1
                take.append(aname)
                g //= size
            assign[name] = tuple(reversed(take))
        return assign

    def global_entries(self, pc: ParallelConfig, axis_names: Tuple[str, ...],
                       spec, rank: Optional[int] = None) -> Optional[Tuple]:
        """``spec`` (per tensor dim: None, an op axis name or a tuple of
        them) as per-dim tuples of global axes, padded to ``rank`` dims;
        None on a machine of one rank or when the grid does not
        decompose."""
        if self.num_devices <= 1:
            return None
        assign = self.global_assign(pc, axis_names)
        if assign is None:
            return None
        entries = []
        for entry in spec:
            if entry is None:
                entries.append(())
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            axes = []
            for nm in names:
                axes.extend(assign.get(nm, ()))
            entries.append(tuple(axes))
        if rank is not None:
            entries.extend(() for _ in range(rank - len(entries)))
        return tuple(entries)

    def regrid_steps(self, src: Tuple, dst: Tuple) -> Optional[list]:
        """The greedy decomposition of the regrid ``src -> dst`` into hops
        that each change one axis (drops first, then moves and splits in
        destination order), excluding ``dst``; None when the greedy order
        cannot reach ``dst`` (``flexflow_tpu/machine.py:483``)."""
        if len(src) != len(dst):
            return None
        if src == dst:
            return []
        steps = []
        cur = [list(t) for t in src]
        dst_axes = {a for t in dst for a in t}
        if any(a not in dst_axes for t in cur for a in t):
            cur = [[a for a in t if a in dst_axes] for t in cur]
            steps.append(tuple(tuple(t) for t in cur))
        loc = {a: j for j, t in enumerate(cur) for a in t}
        order = [(j, p, a) for j, t in enumerate(dst)
                 for p, a in enumerate(t)]

        def done():
            return all(tuple(t) == d for t, d in zip(cur, dst))

        progress = True
        while progress and not done():
            progress = False
            for j, p, a in order:
                if p < len(cur[j]) and cur[j][p] == a:
                    continue
                if len(cur[j]) != p or tuple(cur[j]) != dst[j][:p]:
                    continue
                if a in loc:
                    cur[loc[a]].remove(a)
                cur[j].append(a)
                loc[a] = j
                steps.append(tuple(tuple(t) for t in cur))
                progress = True
        if not done():
            return None
        if steps and steps[-1] == tuple(tuple(t) for t in dst):
            steps.pop()
        return steps

    # ------------------------------------------------------------------
    # blocks of a sharded tensor

    def block(self, entries: Tuple, shape: Tuple[int, ...],
              position: Optional[int] = None) -> Tuple[Tuple[int, int], ...]:
        """``((lo, hi), ...)`` per dim: the block of a ``shape`` tensor laid
        out as ``entries`` held at ``position``.  A dim split over axes
        ``(a, b, ...)`` has ``P = |a|*|b|*...`` ceil-divided blocks, the
        block index the mixed radix of the coordinates (``a`` slowest);
        the last blocks are short or empty, as XLA's padded sharding."""
        c = self.coords(position)
        sizes = self.axis_sizes()
        out = []
        for n, axes in zip(shape, entries):
            parts, idx = 1, 0
            for a in axes:
                parts *= sizes[a]
                idx = idx * sizes[a] + c[a]
            b = -(-n // parts)
            out.append((min(idx * b, n), min((idx + 1) * b, n)))
        out.extend((0, n) for n in shape[len(entries):])
        return tuple(out)

    def batch_block(self, batch: int) -> Tuple[int, int]:
        """``(lo, hi)``: the rows of a global batch this rank holds when
        the batch splits over every rank (the layout model inputs arrive
        in, ``MachineModel.input_sharding`` in the JAX package)."""
        axes = tuple(a for a, _ in self.global_factors())
        return self.block((axes,), (int(batch),))[0]

    # ------------------------------------------------------------------
    # process groups

    def group(self, axes: Sequence[str]) -> Group:
        """This rank's :class:`Group` along global ``axes`` (made by
        :meth:`create_groups`)."""
        key = tuple(axes)
        if key not in self._groups:
            raise RuntimeError(
                f"no process group along {key}: create_groups must make it "
                f"on every rank first")
        return self._groups[key]

    def create_groups(self, axes_list: Sequence[Sequence[str]]) -> None:
        """Make the groups along each axis tuple of ``axes_list`` that are
        not made yet: every group of the partition, in one order, so that
        every rank calls ``new_group`` for each rank set in the same
        sequence."""
        sizes = self.axis_sizes()
        for axes in axes_list:
            key = tuple(axes)
            if key in self._groups:
                continue
            for pos in range(self.num_devices):
                members = self._members(key, pos, sizes)
                if members[0] != pos:
                    continue   # each group once, from its first position
                ranks = self._process(members)
                handle = self._handle(ranks)
                if self.position in members:
                    self._groups[key] = Group(members, ranks, handle)

    def _members(self, axes, pos, sizes) -> Tuple[int, ...]:
        """Positions sharing ``pos``'s coordinates off ``axes``, in mixed
        radix order of ``axes`` (the first slowest)."""
        c = self.coords(pos)
        strides = {}
        stride = 1
        for name, size in reversed(self.global_factors()):
            strides[name] = stride
            stride *= size
        base = pos - sum(c[a] * strides[a] for a in axes)
        members = [base]
        for a in axes:
            members = [m + i * strides[a] for m in members
                       for i in range(sizes[a])]
        return tuple(members)

    def _process(self, positions) -> Tuple[int, ...]:
        """The process-group ranks of the ranks at ``positions``."""
        ranks = [self.view[p] for p in positions]
        if self.process_ranks is not None:
            ranks = [self.process_ranks[r] for r in ranks]
        return tuple(ranks)

    def _handle(self, ranks: Tuple[int, ...]):
        """The process group of process ranks ``ranks`` (one per rank set;
        called on every rank for every set)."""
        key = tuple(sorted(ranks))
        if key in self._handles or not self.distributed:
            return self._handles.get(key)
        import torch.distributed as dist

        if len(key) == self.num_devices and self.process_ranks is None:
            handle = dist.group.WORLD   # also a world of one rank
        elif len(key) == 1:
            return None
        else:
            handle = dist.new_group(list(key))
        self._handles[key] = handle
        return handle

    def group_of(self, positions: Sequence[int]) -> Group:
        """The :class:`Group` of the ranks at ``positions``, in that order
        (a placed op's ranks along some grid axes, the union of a move's
        sources and destinations).  Every rank calls this for every such
        set, members or not, in one order (``new_group`` needs them
        all)."""
        positions = tuple(positions)
        ranks = self._process(positions)
        return Group(positions, ranks, self._handle(ranks))

    def pipeline_mesh(self, stages: int, dp: int, tp: int) -> PipelineMesh:
        """The ``(stage, n, tp)`` mesh of ``stages * dp * tp`` ranks, tp
        fastest: position ``s*dp*tp + n*tp + t`` (``pipeline.py:331``'s
        ``dev.reshape(num_stages, dp, tp)``).  Every group of each of its
        partitions is made on every rank, in one order."""
        if stages * dp * tp != self.num_devices:
            raise ValueError(f"a {stages} x {dp} x {tp} pipeline mesh needs "
                             f"{stages * dp * tp} ranks, the world has "
                             f"{self.num_devices}")
        shape = (stages, dp, tp)

        def pos(c):
            return (c[0] * dp + c[1]) * tp + c[2]

        me = self.position
        coords = (me // (dp * tp), me // tp % dp, me % tp)
        mine = {}
        for name, axes in (("stage", (0,)), ("data", (1,)), ("tp", (2,)),
                           ("block", (1, 2))):
            others = [a for a in range(3) if a not in axes]
            for fixed in itertools.product(*(range(shape[a])
                                             for a in others)):
                members = []
                for along in itertools.product(*(range(shape[a])
                                                 for a in axes)):
                    c = [0, 0, 0]
                    for a, v in zip(others, fixed):
                        c[a] = v
                    for a, v in zip(axes, along):
                        c[a] = v
                    members.append(pos(c))
                group = self.group_of(members)
                if me in group.positions:
                    mine[name] = group
        return PipelineMesh(stages, dp, tp, coords, mine["stage"],
                            mine["data"], mine["tp"], mine["block"],
                            self.world_group())

    def world_group(self) -> Group:
        """Every rank, in position order."""
        axes = tuple(name for name, _ in self.global_factors())
        self.create_groups([axes])
        return self._groups[axes]
