"""Op placement on device subsets (PyTorch port of
``flexflow_tpu/parallel/placement.py``).

A FlexFlow strategy gives every op a partition grid *and* a device list
(the reference's ``strategy.proto``; its mappers pin each op instance to
the GPUs named, ``nmt/rnn_mapper.cc:28-41``).  An op whose list is the
whole machine in order runs on the global factored mesh
(``machine.py``).  Any other duplicate-free list is *placed*: the op runs
on the ranks it names and nowhere else.

What carries over from the JAX package is the semantics: which grid
point lives on which device, for the three families of
:func:`placement_slot` (an aligned block ``[g*P, (g+1)*P)``, a constant
stride ``{b + j*N/P}``, any other set in its named order;
:func:`point_positions`), and the eligibility rule that sends the rest
to the normalized form with JAX's warning (:func:`placed`).

What does not carry over is the mechanism.  One XLA program spans every
device, so JAX compiles placement into it: ops on disjoint subsets merge
into placement groups run by one ``shard_map`` that switches on a
``_pg`` axis (``_run_group_homogeneous`` / ``_run_group_hetero``), their
parameters stacked ``(G, ...)`` over that axis or raveled into padded
vectors, members of other grids translated onto an owner grid, and the
set family replicating operands to a flat mesh.  A process per rank
needs none of it:

* a rank runs an op only when its device list names the rank
  (``FFModel.apply`` skips the others), so ops on disjoint subsets run at
  the same time because each rank walks only its own ops;
* a rank holds an op's parameters and state only when it runs the op
  (``FFModel.shard_params``), so the stacked storage, the ravel vectors
  and the owner-grid translation have no counterpart;
* a grid that does not factor over the machine's prime axes (a (2, 3)
  grid on 6 ranks) runs the same way, on the ranks of its device list
  (:func:`unfactored_positions`), as JAX runs it on a mesh of its own
  (``MachineModel.mesh_for``);
* a value crosses from a producer's ranks to a consumer's by a move by
  box overlap over the union of both (``parallel/regrid.py`` ``BoxPlan``,
  ``collectives.box_move``), and an op's own collectives (a halo exchange,
  BatchNorm's statistics) run over the process group of its points along
  the grid axes (``OpGrid``), so the set family needs no replicated
  operands either.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from flexflow_tpu_torch.strategy import ParallelConfig


def placement_slot(op, num_devices: int,
                   pc: Optional[ParallelConfig] = None):
    """``("block", g)`` when ``op``'s device list names the aligned block
    ``[g*P, (g+1)*P)`` (P = its grid size), ``("stride", b)`` for the
    constant-stride set ``{b + j*(N/P)}``, ``("set", devices)`` for any
    other duplicate-free list the op can run under; None for the
    canonical whole-machine list and for a list the op cannot run placed
    (duplicates, an op without placed support), which normalize
    (``flexflow_tpu/parallel/placement.py:95``).  ``pc`` overrides the
    op's own config."""
    if pc is None:
        pc = op.pc
    p = pc.num_parts
    if num_devices <= 1 or p > num_devices:
        return None
    if op.placement_signature() is None:
        return None
    if len(set(pc.devices)) != p or \
            any(d < 0 or d >= num_devices for d in pc.devices):
        return None
    if p == num_devices and pc.devices == tuple(range(num_devices)):
        return None
    as_set = ("set", tuple(pc.devices)) if _set_eligible(op, pc) else None
    if op.input_specs(pc) is None or num_devices % p or p == num_devices:
        return as_set
    devs = tuple(sorted(pc.devices))
    d0 = devs[0]
    g, rem = divmod(d0, p)
    if rem == 0 and devs == tuple(range(g * p, (g + 1) * p)):
        return ("block", g)
    s = num_devices // p
    if d0 < s and devs == tuple(d0 + j * s for j in range(p)):
        return ("stride", d0)
    return as_set


def _set_eligible(op, pc: Optional[ParallelConfig] = None) -> bool:
    """The JAX package's bar for set-family dispatch (``_set_eligible``,
    ``placement.py:163``): the op is point-placeable, every split entry
    of its output and parameter specs names one grid axis and divides
    evenly, a stateful op computes its points from whole inputs
    (``POINT_WINDOWS``), and an op without that override also has input
    specs that divide evenly."""
    import torch

    if pc is None:
        pc = op.pc
    if not op.point_placeable():
        return False
    meta = torch.device("meta")
    if op.init_state(meta) and not op.POINT_WINDOWS:
        return False
    sizes = dict(zip(op.AXIS_NAMES, pc.dims))

    def ok(spec, shape):
        if spec is None:
            return False
        for d, e in enumerate(tuple(spec)):
            if e is None:
                continue
            if not isinstance(e, str):
                return False
            parts = sizes.get(e, 1)
            if parts > 1 and (d >= len(shape) or shape[d] % parts):
                return False
        return True

    if not all(ok(s, t.shape)
               for s, t in zip(op.output_specs(), op.all_outputs())):
        return False
    specs = op.param_specs()
    if specs:
        shapes = op.leaf_shapes
        if not all(ok(specs[k], shapes[k]) for k in specs):
            return False
    if not op.POINT_WINDOWS:
        want = op.regrid_input_specs()
        if op.input_specs(pc) is None or want is None or not all(
                ok(s, t.shape) for s, t in zip(want, op.inputs)):
            return False
    return True


def grid_index(j: int, dims: Sequence[int],
               axes: Sequence[str]) -> Dict[str, int]:
    """Grid-linear ``j`` (dim 0 fastest) as ``{axis: index}``
    (``placement.py:690``)."""
    idx = {}
    for a, d in zip(axes, dims):
        idx[a] = j % d
        j //= d
    return idx


def set_group_assignment(device_rows: Sequence[Sequence[int]],
                         dims: Sequence[int], axes: Sequence[str]):
    """``{device: (member, grid-linear j, {axis: index})}`` of set-family
    members: member m's grid point j runs on ``device_rows[m][j]``
    (``placement.py:700``; the reference's RnnMapper pins a task to any
    named GPU, ``nmt/rnn_mapper.cc:131-135``)."""
    out = {}
    for m, row in enumerate(device_rows):
        for j, dev in enumerate(row):
            out[dev] = (m, j, grid_index(j, dims, axes))
    return out


def slot_positions(slot, num_parts: int,
                   num_devices: int) -> Tuple[int, ...]:
    """The device of each grid point (grid-linear, dim 0 fastest) under
    ``slot``: the JAX placement meshes' order.  A block (``placement_mesh``
    group axis major) puts point j on ``g*P + j`` whatever order the list
    names the block in; a stride set (group axis minor) on
    ``b + j*(N/P)``; a set (``flat_mesh`` dispatch) on the j-th device
    it names."""
    family, arg = slot
    if family == "block":
        return tuple(arg * num_parts + j for j in range(num_parts))
    if family == "stride":
        s = num_devices // num_parts
        return tuple(arg + j * s for j in range(num_parts))
    return tuple(arg)


def point_positions(op, num_devices: int) -> Optional[Tuple[int, ...]]:
    """The machine position of each of ``op``'s grid points when it runs
    placed, else None (the whole machine, canonical or normalized)."""
    slot = placement_slot(op, num_devices)
    if slot is None:
        return None
    return slot_positions(slot, op.pc.num_parts, num_devices)


def unfactored_positions(op, num_devices: int) -> Tuple[int, ...]:
    """The positions of a grid that does not factor over the machine's
    prime axes (a (2, 3) grid on 6 ranks): grid point j on
    ``pc.devices[j]``, dim 0 fastest, the per-op mesh of JAX's
    ``MachineModel.mesh_for`` (``flexflow_tpu/machine.py:240``).  The op
    then runs as a placed one: its moves by box overlap, its
    collectives over the groups of its points."""
    devices = tuple(op.pc.devices)
    if len(set(devices)) != len(devices) or \
            any(d < 0 or d >= num_devices for d in devices):
        raise ValueError(
            f"op {op.name!r}: grid {op.pc.dims} does not factor over the "
            f"machine's prime axes and its devices {devices} are not "
            f"{op.pc.num_parts} distinct ranks of {num_devices}")
    return devices


def placed(op, machine) -> Optional[Tuple[int, ...]]:
    """:func:`point_positions` on ``machine``, or for a grid that does
    not factor over its prime axes :func:`unfactored_positions`; warns once per
    (grid, devices) when a list that is not the whole machine in order is
    normalized instead: the op then runs on the global mesh, its grid on
    the fastest axes and replicated along the rest, as JAX's
    ``MachineModel.sharding`` does (``flexflow_tpu/machine.py:535``)."""
    n = machine.num_devices
    positions = point_positions(op, n)
    pc = op.pc
    if positions is None and n > 1 \
            and machine.global_assign(pc, op.AXIS_NAMES) is None:
        return unfactored_positions(op, n)
    if positions is None and n > 1 and pc.devices != tuple(range(n)):
        machine.warn_once(
            ("norm", pc.dims, pc.devices),
            f"devices {pc.devices} for grid {pc.dims} of op {op.name!r}: "
            f"op cannot execute placed (duplicate devices, or an op "
            f"without placed support under this grid); the device list is "
            f"normalized onto the canonical order (placement not honored)")
    return positions

