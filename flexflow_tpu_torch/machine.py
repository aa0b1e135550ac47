"""The machine a model runs on (PyTorch port of ``flexflow_tpu/machine.py``).

This slice runs on one GPU: ``num_devices`` is 1 and every op's default
config is the trivial one-point grid.  Placement over several GPUs comes
with the multi-GPU slice.

Every entry point of the package resolves its ``device`` argument here.
It defaults to ``"cuda"``, and asking for CUDA on a machine without it
raises: the package never falls back to the CPU unless the caller passed
``device="cpu"``.
"""

from __future__ import annotations

import torch

from flexflow_tpu_torch.strategy import ParallelConfig


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


class MachineModel:
    """One device.  ``default_pc`` is the pure-DP fallback an op takes when
    the strategy has no entry for it."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    @property
    def num_devices(self) -> int:
        return 1

    def default_pc(self, ndims: int) -> ParallelConfig:
        return ParallelConfig.data_parallel(ndims, self.num_devices)
