"""Debug-dump helpers (PyTorch port of ``flexflow_tpu/utils/debug.py``):
the reference's ``print_tensor`` (cuda_helper.h:67-84) and the
``PRINT_INTERMEDIATE_RESULT`` switch (nmt/rnn.h:25).

A tensor is printed as its shape and summary statistics, in the JAX
package's line::

    {tag}: shape=(...) dtype=float32 mean=... std=... absmax=...

with JAX's dtype names and the population std.  Set
``FFConfig.print_intermediates`` (CLI ``--print-intermediates``) to dump
every op output (``FFModel.apply``).

Over several ranks each rank holds a block of the value, and a block may
be held by several ranks: :func:`block_sums` gives one rank's count,
sum, sum of squares and max |x| (zeros where it does not count its
block), :func:`print_sums` the whole tensor's line from their sums over
the ranks.  The JAX package gathers the values instead.
"""

from __future__ import annotations

import math
import sys

import torch


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _line(tag: str, shape, dtype, mean: float, std: float,
          absmax: float) -> str:
    return (f"{tag}: shape={tuple(shape)} dtype={_dtype_name(dtype)} "
            f"mean={mean:.6f} std={std:.6f} absmax={absmax:.6f}")


def _emit(line: str) -> None:
    print(line)
    sys.stdout.flush()


def block_sums(x) -> torch.Tensor:
    """``[count, sum, sum of squares, max |x|]`` of ``x`` in float64 (all
    zero for None: a rank that does not count its block)."""
    if x is None:
        return torch.zeros(4, dtype=torch.float64)
    xf = x.detach().double()
    if xf.numel() == 0:
        return torch.zeros(4, dtype=torch.float64, device=xf.device)
    return torch.stack([torch.tensor(float(xf.numel()), dtype=torch.float64,
                                     device=xf.device),
                        xf.sum(), (xf * xf).sum(), xf.abs().max()])


def print_sums(tag: str, shape, dtype, sums) -> None:
    """Print the line of a tensor whose ``[count, sum, sum of squares]``
    (added up) and max |x| are ``sums``."""
    n, s, s2, a = (float(v) for v in sums)
    mean = s / n if n else math.nan
    var = max(s2 / n - mean * mean, 0.0) if n else math.nan
    _emit(_line(tag, shape, dtype, mean, math.sqrt(var), a))


def print_tensor(tag: str, x) -> None:
    """Print the shape and summary statistics of ``x`` (float64 sums)."""
    xf = x.detach().double()
    _emit(_line(tag, x.shape, x.dtype, float(xf.mean()),
                float(xf.std(unbiased=False)), float(xf.abs().max())))
