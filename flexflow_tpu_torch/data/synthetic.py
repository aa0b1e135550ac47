"""Synthetic image batches and token streams (PyTorch port of
``flexflow_tpu/data/synthetic.py``): ``ones`` mode is the reference's
image = 1.0, label = 1; ``random`` mode draws Gaussian images and uniform
labels, and the token stream uniform int32 ids, from
``np.random.RandomState(seed)`` in the JAX package's order, so both
packages see the same arrays.  Given a machine of several ranks, every
rank draws the same global batches and keeps its own rows of each
(``MachineModel.batch_block``).

Both sources are :class:`BlockStream` objects: a ring of global host
batches and the block of them the current machine holds, on its device.
An elastic resize rebinds the stream to the resized machine
(:meth:`BlockStream.rebind`) at the same position, so that the next
step takes the same global batch cut by the new machine's blocks."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from flexflow_tpu_torch.machine import resolve_device


class BlockStream:
    """Yield, round robin, this rank's blocks of the global batches in
    ``ring`` (a list of tuples of host arrays whose first dim is the
    batch): the rows ``machine.batch_block`` names, or every row without
    a machine, as tensors on the machine's device (or ``device``).  The
    blocks are copied to the device once per binding; ``position``
    counts the batches yielded.  ``select`` picks (and may repeat) the
    fields of each batch that are yielded."""

    def __init__(self, ring: Sequence[tuple], device="cuda", machine=None,
                 select: Optional[Sequence[int]] = None):
        self._ring = [tuple(batch) for batch in ring]
        self._select = tuple(select) if select is not None \
            else tuple(range(len(self._ring[0])))
        self._device = device
        self.position = 0
        self.rebind(machine)

    def rebind(self, machine, position: Optional[int] = None) -> None:
        """Yield ``machine``'s blocks from now on (every row when it is
        None), from ``position`` when given (the batches already yielded
        elsewhere), else from where the stream stands."""
        self.machine = machine
        dev = resolve_device(self._device) if machine is None \
            else machine.device
        rows = len(self._ring[0][0])
        lo, hi = (0, rows) if machine is None else machine.batch_block(rows)
        self._blocks = [tuple(torch.from_numpy(
            np.ascontiguousarray(batch[i][lo:hi])).to(dev)
            for i in self._select) for batch in self._ring]
        if position is not None:
            self.position = int(position)

    def __iter__(self) -> "BlockStream":
        return self

    def __next__(self) -> tuple:
        out = self._blocks[self.position % len(self._blocks)]
        self.position += 1
        return out


def synthetic_batches(batch_size: int, height: int, width: int,
                      channels: int = 3, num_classes: int = 1000,
                      mode: str = "ones", seed: int = 0, cycle: int = 2,
                      device="cuda", machine=None) -> BlockStream:
    """Yield (float32 image NHWC, int32 labels) on ``device`` (the
    machine's device when ``machine`` is given) forever; with ``machine``
    each is this rank's block of the global batch.

    ``cycle`` batches (one in ``ones`` mode) are drawn up front, moved to
    the device once and yielded round-robin, so the training loop does no
    host-side data work."""
    if mode not in ("ones", "random"):
        raise ValueError(f"mode must be 'ones' or 'random', got {mode!r}")
    rng = np.random.RandomState(seed)

    def make():
        if mode == "ones":
            return (np.ones((batch_size, height, width, channels),
                            np.float32), np.ones((batch_size,), np.int32))
        return (rng.randn(batch_size, height, width,
                          channels).astype(np.float32),
                rng.randint(0, num_classes,
                            size=(batch_size,)).astype(np.int32))

    return BlockStream([make() for _ in range(1 if mode == "ones"
                                              else cycle)], device, machine)


def synthetic_token_stream(batch_size: int, seq_length: int,
                           vocab_size: int, seed: int = 0, streams: int = 2,
                           cycle: int = 2, device="cuda", machine=None,
                           select: Optional[Sequence[int]] = None
                           ) -> BlockStream:
    """Yield tuples of ``streams`` int32 (batch_size, seq_length) token
    tensors on ``device`` forever (streams=2: (src, dst) pairs; streams=1:
    (tokens,) for LMs that reuse tokens as labels).  ``cycle`` distinct
    batches are drawn up front, moved to the device once and cycled; with
    ``machine`` each is this rank's rows, on its device.  ``select``
    repeats or picks streams (:class:`BlockStream`)."""
    rng = np.random.RandomState(seed)
    ring = [tuple(rng.randint(0, vocab_size, (batch_size, seq_length))
                  .astype("int32") for _ in range(streams))
            for _ in range(cycle)]
    return BlockStream(ring, device, machine, select)
