"""Op / Tensor base abstractions (PyTorch port of ``flexflow_tpu/ops/base.py``).

A ``Tensor`` is symbolic: static shape, dtype name and producing op.
Concrete values flow through each op's ``forward(params, state, xs,
train)``, a plain function of tensors that returns ``(output,
new_state)``, or ``((output, ...), new_state)`` for an op with several
outputs (``outputs``, the LSTM chunk's y, hy and cy).  Parameters live
outside the ops in one tree, ``{param_key: {leaf: tensor}}``, the same
tree the JAX package's ``FFModel.init`` builds, so that one tree serves
both packages; so does per-op state, ``{op_name: {leaf: tensor}}``.

Over several ranks (``flexflow_tpu/ops/base.py``'s sharding hooks) every
op says how its grid splits each tensor: ``output_specs``
the outputs, ``regrid_input_specs`` the layout it wants its inputs in,
``param_specs`` and ``state_specs`` its leaves.  An op with a
``placement_signature`` also runs on a device subset
(``parallel/placement.py``): ``input_specs`` and ``point_placeable`` are
the JAX op's rules for which placement family takes which grid, and
:class:`OpGrid` then maps the grid onto the ranks its device list
names.  A spec names, per
tensor dim, the grid axes (``AXIS_NAMES``) that split it, or None.  The
model reshards each input to the wanted layout (``parallel/regrid.py``)
and calls ``sharded_forward`` on this rank's blocks with an
:class:`OpGrid`; the default is the plain ``forward``, right for every
op whose block of output depends on its blocks of input alone.  Blocks
are ceil-divided, so a spatial extent may split unevenly (27 columns
over 4: 7, 7, 7, 6), and the ops compute exactly the global function.

The strategy search (``sim/``) reads the JAX op's cost hooks:
``local_clone`` (the op at one grid point's shapes, which the measured
cost model times on the card), ``flops_per_sample``, ``shard_flops_fwd``,
``param_bytes`` and ``cost_signature``.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from flexflow_tpu_torch.strategy import ParallelConfig, uneven_spatial_ok

_tensor_ids = itertools.count()

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int32": torch.int32}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a dtype name as the JAX package spells it."""
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


def glorot_uniform(shape: Tuple[int, ...], gen: torch.Generator,
                   device, fans: Optional[Tuple[int, int]] = None
                   ) -> torch.Tensor:
    """``jax.nn.initializers.glorot_uniform``: U(-a, a) with
    a = sqrt(6 / (fan_in + fan_out)); ``fans`` defaults to the two dims
    of a (fan_in, fan_out) matrix."""
    fan_in, fan_out = fans if fans is not None else shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return (u * 2.0 - 1.0) * limit


class Tensor:
    """Symbolic tensor: static shape + dtype + producing op."""

    def __init__(self, shape: Tuple[int, ...], dtype: str = "float32",
                 producer: Optional["Op"] = None, name: str = ""):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.producer = producer
        self.name = name
        self.tid = next(_tensor_ids)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def size(self) -> int:
        return math.prod(self.shape)

    def __repr__(self):
        p = self.producer.name if self.producer else "input"
        return f"Tensor(name={self.name!r}, shape={self.shape}, from={p})"


class Op:
    """Base operator: named, with inputs, one output (or several, in
    ``outputs``), a ParallelConfig and a functional forward."""

    #: grid axis names, innermost (grid dim 0) first
    AXIS_NAMES: Tuple[str, ...] = ("n",)

    def __init__(self, name: str, pc: ParallelConfig,
                 inputs: Sequence[Tensor]):
        if len(pc.dims) != len(self.AXIS_NAMES):
            raise ValueError(
                f"op {name!r}: ParallelConfig rank {pc.ndims} does not match "
                f"op grid rank {len(self.AXIS_NAMES)} ({self.AXIS_NAMES})"
            )
        self.name = name
        self.pc = pc
        self.inputs: List[Tensor] = list(inputs)
        self.output: Tensor = None  # set by subclass
        #: every output of a multi-output op, ``output`` first; empty for
        #: the single-output ops
        self.outputs: List[Tensor] = []
        #: params-tree key; ops sharing a key share weights
        self.param_key: str = name

    def all_outputs(self) -> List[Tensor]:
        """Every output tensor (the single ``output`` unless the op sets
        ``outputs``)."""
        return self.outputs if self.outputs else [self.output]

    def init_params(self, gen: torch.Generator, device) -> Dict:
        """Trainable params drawn from ``gen``; {} for parameterless ops."""
        return {}

    @functools.cached_property
    def leaf_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """``{leaf: shape}`` of :meth:`init_params`, drawn once on the meta
        device (nothing is allocated)."""
        return {k: tuple(v.shape) for k, v in
                self.init_params(None, torch.device("meta")).items()}

    def init_state(self, device) -> Dict:
        """Per-op state on ``device`` (BatchNorm's running statistics); {}
        for stateless ops."""
        return {}

    def forward(self, params: Dict, state: Dict, xs: List, train: bool):
        """Returns (output, new_state); a multi-output op returns a tuple
        of its outputs' values in the order of ``outputs``."""
        raise NotImplementedError

    # ---- grids over several ranks -----------------------------------

    def output_spec(self):
        """Spec of the output over ``AXIS_NAMES``."""
        raise NotImplementedError

    def output_specs(self) -> List:
        return [self.output_spec()]

    def regrid_input_specs(self):
        """Spec per input of the layout the op computes from; None: no
        preference (the input is taken as it comes)."""
        return None

    def param_specs(self) -> Dict:
        """Spec per param leaf; a leaf not named is replicated."""
        return {}

    def state_specs(self) -> Dict:
        """Spec per state leaf; a leaf not named is replicated."""
        return {}

    # ---- placement on device subsets (parallel/placement.py) ----------

    #: True for the ops whose JAX ``point_forward`` computes a point from
    #: whole inputs (windows, global statistics): the set family takes
    #: them without sliceable input specs
    POINT_WINDOWS = False

    def placement_signature(self):
        """The hyperparameters that determine the op's computation beyond
        its shapes (``flexflow_tpu/ops/base.py:169``); None for an op
        without placed execution, which normalizes onto the whole machine
        (and which the search gives no device-subset candidates)."""
        return None

    def input_specs(self, pc: Optional[ParallelConfig] = None):
        """Spec per input under ``pc`` (default the op's own) when the op
        runs it as a block or stride placement, else None
        (``flexflow_tpu/ops/base.py:161``): where None, a device subset is
        honored as a set, or normalized, and the search emits no
        sub-machine candidate of that grid."""
        return None

    def point_placeable(self) -> bool:
        """Whether the JAX op runs as set-family points (``point_placeable``,
        ``flexflow_tpu/ops/base.py:206``)."""
        return True

    def grid_collectives(self) -> List[Tuple[str, ...]]:
        """Tuples of grid axes over whose ranks ``sharded_forward`` runs a
        collective (their process groups are made at build time)."""
        return []

    def sharded_forward(self, params: Dict, state: Dict, xs: List,
                        train: bool, grid: "OpGrid"):
        """The forward on this rank's blocks: inputs in the layouts of
        ``regrid_input_specs``, params and state as their specs split
        them; returns the output blocks of ``output_specs``."""
        return self.forward(params, state, xs, train)

    def validate_partitioning(self) -> None:
        """Each grid dim must divide the tensor dims it splits; spatial
        (h, w) dims may split unevenly when every ceil-sized block is
        non-empty (``flexflow_tpu/ops/base.py:252``)."""
        sizes = dict(zip(self.AXIS_NAMES, self.pc.dims))
        for t, spec in zip(self.all_outputs(), self.output_specs()):
            for d, entry in enumerate(spec or ()):
                if entry is None:
                    continue
                axes = entry if isinstance(entry, tuple) else (entry,)
                parts = math.prod(sizes.get(a, 1) for a in axes)
                if t.shape[d] % parts == 0:
                    continue
                if all(a in ("h", "w") for a in axes) \
                        and uneven_spatial_ok(t.shape[d], parts):
                    continue
                raise ValueError(
                    f"op {self.name!r}: output dim {d} of size "
                    f"{t.shape[d]} not divisible by its partition count "
                    f"{parts} (grid {self.pc.dims})")

    # ---- cost model hooks (sim/, flexflow_tpu/ops/base.py:290-317) -----

    def local_clone(self, pc: ParallelConfig):
        """A new op at the shard-local shapes of one grid point under
        ``pc``: what one device computes, which ``MeasuredCostModel``
        times on the card.  None: the analytic cost prices the shard."""
        return None

    def cost_signature(self) -> tuple:
        """Compute-determining hyperparameters absent from the shapes
        (the MoE's expert count and width), folded into the measured
        cost cache's key."""
        return ()

    def flops_per_sample(self) -> float:
        """Forward FLOPs per sample (the simulator models fwd+bwd as 3x)."""
        return 0.0

    def shard_flops_fwd(self, pc: ParallelConfig):
        """Forward FLOPs of one shard under ``pc`` for ops whose work does
        not divide evenly over the grid; None: flops_per_sample * batch /
        num_parts."""
        return None

    def param_bytes(self) -> int:
        """Parameter bytes in the float32 convention."""
        return 0

    def __repr__(self):
        return (f"{type(self).__name__}(name={self.name!r}, grid={self.pc.dims}, "
                f"out={self.output.shape if self.output else None})")


class OpGrid:
    """One op's grid as this rank runs it.

    On the whole machine each grid axis is realized by a tuple of the
    machine's global axes (``MachineModel.global_assign``) and this rank's
    index along it is the mixed radix of its coordinates on them.  A placed
    op, or one whose grid does not factor over those axes (``positions``:
    the machine position of each grid point, dim 0 fastest, from
    ``placement.placed``) runs only on those
    positions (``runs``), its index is that of its point, and its
    collectives run over the positions of the points along the named grid
    axes.  A tensor dim of extent ``n`` split ``P`` ways has ceil-sized
    blocks."""

    def __init__(self, machine, op: Op,
                 positions: Optional[Tuple[int, ...]] = None):
        self.machine = machine
        self.positions = positions
        self.dims = dict(zip(op.AXIS_NAMES, op.pc.dims))
        self._groups: Dict[Tuple[str, ...], object] = {}
        if positions is not None:
            from flexflow_tpu_torch.parallel.placement import grid_index

            self.axis_names = op.AXIS_NAMES
            self.runs = machine.position in positions
            self.point = grid_index(positions.index(machine.position),
                                    op.pc.dims, op.AXIS_NAMES) \
                if self.runs else None
            return
        self.runs = True
        if machine.num_devices > 1:
            self.assign = machine.global_assign(op.pc, op.AXIS_NAMES)
        else:
            self.assign = {a: () for a in op.AXIS_NAMES}
        self._sizes = machine.axis_sizes()
        self._coords = machine.coords()

    def axes(self, *names: str) -> Tuple[str, ...]:
        """The global axes realizing the grid axes ``names``, in the
        machine's axis order (whole-machine grids)."""
        want = {a for nm in names for a in self.assign.get(nm, ())}
        return tuple(a for a, _ in self.machine.global_factors()
                     if a in want)

    def parts(self, name: str) -> int:
        if self.positions is not None:
            return self.dims.get(name, 1)
        return math.prod(self._sizes[a] for a in self.assign.get(name, ()))

    def index(self, name: str) -> int:
        if self.positions is not None:
            return self.point.get(name, 0)
        idx = 0
        for a in self.assign.get(name, ()):
            idx = idx * self._sizes[a] + self._coords[a]
        return idx

    def block(self, name: str, extent: int, index: int = None
              ) -> Tuple[int, int]:
        """``(lo, hi)`` of block ``index`` (default this rank's) of a dim
        of ``extent`` split along grid axis ``name``."""
        b = -(-extent // self.parts(name))
        i = self.index(name) if index is None else index
        return min(i * b, extent), min((i + 1) * b, extent)

    def _group_axes(self, names) -> Tuple[str, ...]:
        """The global axes of a collective along grid axes ``names``: one
        grid axis's in its own order (its members then come in block
        order), several in the machine's."""
        if len(names) == 1:
            return self.assign.get(names[0], ())
        return self.axes(*names)

    def _placed_groups(self, names) -> None:
        """The groups of a placed grid's points along ``names``: one per
        setting of the other axes, members in mixed-radix order of
        ``names`` (the first slowest), made on every rank."""
        from flexflow_tpu_torch.parallel.placement import grid_index

        pts = [grid_index(j, [self.dims[a] for a in self.axis_names],
                          self.axis_names)
               for j in range(len(self.positions))]
        classes: Dict[tuple, list] = {}
        for j, idx in enumerate(pts):
            other = tuple(idx[a] for a in self.axis_names if a not in names)
            order = 0
            for a in names:
                order = order * self.dims[a] + idx[a]
            classes.setdefault(other, []).append((order, j))
        for members in classes.values():
            group = self.machine.group_of(
                self.positions[j] for _, j in sorted(members))
            if self.machine.position in group.positions:
                self._groups[tuple(names)] = group

    def prepare(self, names_list) -> None:
        """Make the process groups of :meth:`gather` / :meth:`all_reduce`
        along each tuple of grid axes in ``names_list`` (on every rank,
        in one order)."""
        if self.positions is not None:
            for names in names_list:
                self._placed_groups(tuple(names))
            return
        self.machine.create_groups([self._group_axes(names)
                                    for names in names_list])

    def group(self, names):
        """The process group of this rank's points along grid axes
        ``names`` (made by :meth:`prepare`), members in block order."""
        if self.positions is not None:
            return self._groups[tuple(names)]
        return self.machine.group(self._group_axes(names))

    def gather(self, x, name: str, dim: int, extent: int):
        """The whole ``extent`` of ``x`` along tensor ``dim`` from the
        blocks of the ranks along grid axis ``name`` (an autograd
        all-gather; its backward reduce-scatters)."""
        from flexflow_tpu_torch.parallel.collectives import gather_copy

        parts = self.parts(name)
        if parts == 1:
            return x
        group = self.group((name,))

        def box(lo_hi):
            return tuple(lo_hi if d == dim else (0, x.shape[d])
                         for d in range(x.dim()))

        src = tuple(box(self.block(name, extent, i)) for i in range(parts))
        return gather_copy(x, group, src, tuple(range(parts)),
                           box((0, extent)), self.index(name))

    def halo(self, x, name: str, dim: int, extent: int, spans):
        """Rows ``spans[i]`` (``(lo, hi)``, one per block along grid axis
        ``name``, split over several ranks) of a dim of ``extent``: this
        rank's span, from its own block ``x`` and the rows of it that other
        ranks' blocks hold, each sent by its owner alone (the neighbour
        exchange, ``collectives.halo_exchange``; its backward sends the
        gradients back).  The transport follows the backend: point-to-
        point on the device where it carries one, else through host
        copies."""
        from flexflow_tpu_torch.parallel.collectives import halo_exchange

        blocks = [self.block(name, extent, i)
                  for i in range(self.parts(name))]
        return halo_exchange(x, self.group((name,)), dim, blocks, spans,
                             self.index(name),
                             "p2p" if self.machine.send_recv else "host")

    def all_reduce(self, x, names: Tuple[str, ...]):
        """The sum of ``x`` over the ranks along grid axes ``names`` (an
        autograd all-reduce; its backward all-reduces)."""
        from flexflow_tpu_torch.parallel.collectives import all_reduce_sum

        if math.prod(self.parts(a) for a in names) == 1:
            return x
        return all_reduce_sum(x, self.group(names))
