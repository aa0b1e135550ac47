"""Operators of the PyTorch port (counterparts of ``flexflow_tpu/ops/``)."""

from flexflow_tpu_torch.ops.base import Op, Tensor  # noqa: F401
