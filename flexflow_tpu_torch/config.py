"""Run configuration (PyTorch port): the ``FFConfig`` fields the serving
path reads, with the JAX package's defaults (``flexflow_tpu/config.py``)."""

from __future__ import annotations

import dataclasses

from flexflow_tpu_torch.strategy import Strategy


@dataclasses.dataclass
class FFConfig:
    batch_size: int = 64
    # dtype of the activations ("float32" or "bfloat16")
    compute_dtype: str = "float32"
    # STORAGE dtype of the parameters; anything but float32 is mixed
    # precision, and the predict step casts float params to compute_dtype
    param_dtype: str = "float32"
    seed: int = 0
    strategies: Strategy = dataclasses.field(default_factory=Strategy)
