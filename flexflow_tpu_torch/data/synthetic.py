"""Synthetic image batches and token streams (PyTorch port of
``flexflow_tpu/data/synthetic.py``): ``ones`` mode is the reference's
image = 1.0, label = 1; ``random`` mode draws Gaussian images and uniform
labels, and the token stream uniform int32 ids, from
``np.random.RandomState(seed)`` in the JAX package's order, so both
packages see the same arrays.  Given a machine of several ranks, every
rank draws the same global batches and keeps its own rows of each
(``MachineModel.batch_block``)."""

from __future__ import annotations

import itertools
from typing import Iterator, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.machine import resolve_device


def synthetic_batches(batch_size: int, height: int, width: int,
                      channels: int = 3, num_classes: int = 1000,
                      mode: str = "ones", seed: int = 0, cycle: int = 2,
                      device="cuda", machine=None
                      ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Yield (float32 image NHWC, int32 labels) on ``device`` (the
    machine's device when ``machine`` is given) forever; with ``machine``
    each is this rank's block of the global batch.

    ``cycle`` batches (one in ``ones`` mode) are drawn up front, moved to
    the device once and yielded round-robin, so the training loop does no
    host-side data work."""
    if mode not in ("ones", "random"):
        raise ValueError(f"mode must be 'ones' or 'random', got {mode!r}")
    dev = resolve_device(device) if machine is None else machine.device
    lo, hi = (0, batch_size) if machine is None \
        else machine.batch_block(batch_size)
    rng = np.random.RandomState(seed)

    def make():
        if mode == "ones":
            img = np.ones((batch_size, height, width, channels), np.float32)
            lbl = np.ones((batch_size,), np.int32)
        else:
            img = rng.randn(batch_size, height, width,
                            channels).astype(np.float32)
            lbl = rng.randint(0, num_classes,
                              size=(batch_size,)).astype(np.int32)
        return (torch.from_numpy(img[lo:hi]).to(dev),
                torch.from_numpy(lbl[lo:hi]).to(dev))

    return itertools.cycle([make()
                            for _ in range(1 if mode == "ones" else cycle)])


def synthetic_token_stream(batch_size: int, seq_length: int,
                           vocab_size: int, seed: int = 0, streams: int = 2,
                           cycle: int = 2, device="cuda", machine=None
                           ) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Yield tuples of ``streams`` int32 (batch_size, seq_length) token
    tensors on ``device`` forever (streams=2: (src, dst) pairs; streams=1:
    (tokens,) for LMs that reuse tokens as labels).  ``cycle`` distinct
    batches are drawn up front, moved to the device once and cycled; with
    ``machine`` each is this rank's rows, on its device."""
    dev = resolve_device(device) if machine is None else machine.device
    lo, hi = (0, batch_size) if machine is None \
        else machine.batch_block(batch_size)
    rng = np.random.RandomState(seed)
    ring = [tuple(
        torch.from_numpy(rng.randint(0, vocab_size, (batch_size, seq_length))
                         .astype("int32")[lo:hi]).to(dev)
        for _ in range(streams)) for _ in range(cycle)]
    return itertools.cycle(ring)
