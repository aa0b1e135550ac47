"""Op / Tensor base abstractions (PyTorch port of ``flexflow_tpu/ops/base.py``).

A ``Tensor`` is symbolic: static shape, dtype name and producing op.
Concrete values flow through each op's ``forward(params, state, xs,
train)``, a plain function of tensors that returns ``(output,
new_state)``.  Parameters live outside the ops in one tree,
``{param_key: {leaf: tensor}}``, the same tree the JAX package's
``FFModel.init`` builds, so that one tree serves both packages; so does
per-op state, ``{op_name: {leaf: tensor}}``.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from flexflow_tpu_torch.strategy import ParallelConfig

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

    def __repr__(self):
        p = self.producer.name if self.producer else "input"
        return f"Tensor(name={self.name!r}, shape={self.shape}, from={p})"


class Op:
    """Base operator: named, with inputs, one output, a ParallelConfig and
    a functional forward."""

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
        #: params-tree key; ops sharing a key share weights
        self.param_key: str = name

    def init_params(self, gen: torch.Generator, device) -> Dict:
        """Trainable params drawn from ``gen``; {} for parameterless ops."""
        return {}

    def init_state(self, device) -> Dict:
        """Per-op state on ``device`` (BatchNorm's running statistics); {}
        for stateless ops."""
        return {}

    def forward(self, params: Dict, state: Dict, xs: List, train: bool):
        """Returns (output, new_state)."""
        raise NotImplementedError

    def __repr__(self):
        return (f"{type(self).__name__}(name={self.name!r}, grid={self.pc.dims}, "
                f"out={self.output.shape if self.output else None})")
