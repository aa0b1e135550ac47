"""Parameter trees across the two packages.

``FFModel.init()`` in the JAX package returns ``{op_name: {leaf: array}}``
and the port's models name their ops and leaves the same way, with the
same shapes and layouts: ``(d_in, d_out)`` linear and projection
kernels, ``(vocab, d)`` tables, HWIO convolution kernels (the port's
``Conv2D`` reads them through an OIHW view), ``(d_out,)`` biases.
:func:`params_from_jax` carries such a tree, converted to numpy by the
caller, into the port unchanged: no renames, no transposes.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from flexflow_tpu_torch.machine import resolve_device


def _to_tensor(arr, device) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        # numpy has no native bfloat16 (ml_dtypes supplies it); widen on
        # the host, narrow on the device — exact both ways
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(tree: Mapping[str, Mapping[str, object]],
                    device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """The port's params from a JAX ``FFModel.init()`` tree of numpy
    arrays: same keys, same shapes, same dtypes, on ``device``."""
    dev = resolve_device(device)
    return {key: {leaf: _to_tensor(v, dev) for leaf, v in leaves.items()}
            for key, leaves in tree.items()}
