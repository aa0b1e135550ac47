"""Parameter and state trees across the two packages.

``FFModel.init()`` in the JAX package returns two trees, the params
``{param_key: {leaf: array}}`` and the per-op state ``{op_name: {leaf:
array}}`` (BatchNorm's running ``mean`` and ``var``).  The port's models
name their ops and leaves the same way, with the same shapes and
layouts: ``(d_in, d_out)`` linear and projection kernels, ``(vocab, d)``
tables, HWIO convolution kernels (the port's ``Conv2D`` reads them
through an OIHW view), ``(d_out,)`` biases, ``(C,)`` BatchNorm vectors.
:func:`params_from_jax` and :func:`state_from_jax` carry such a tree,
converted to numpy by the caller, into the port unchanged: no renames,
no transposes.  So does ``PipelinedLM``'s tree (``parallel/pipeline.py``:
the stage-stacked ``blocks`` and the whole embeddings and head).  On
several ranks :func:`shard_params` and :func:`shard_state` then give
each rank its blocks of the full trees.
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


def params_from_jax(tree: Mapping[str, object], device="cuda", model=None
                    ) -> Dict[str, object]:
    """The port's params from a JAX params tree of numpy arrays: same
    keys, same shapes, same dtypes, on ``device``.  The tree is
    ``FFModel.init()``'s ``{param_key: {leaf: array}}`` or
    ``PipelinedLM.init``'s, whose stage-stacked ``blocks`` sit beside
    whole arrays (``embed``, ``pos``, ``ln_f``, ``head_w``,
    ``head_b``).  With ``model`` (a port ``FFModel`` or ``PipelinedLM``)
    every key, leaf and shape must be the ones the model's ``init``
    makes (``check_param_shapes``)."""
    dev = resolve_device(device)
    out = {key: {leaf: _to_tensor(v, dev) for leaf, v in sub.items()}
           if isinstance(sub, Mapping) else _to_tensor(sub, dev)
           for key, sub in tree.items()}
    if model is not None:
        check_param_shapes(out, model.param_shapes())
    return out


def shard_params(params, model, rank=None):
    """The blocks of a full params tree (``params_from_jax``'s result) that
    ``rank`` (default the model machine's own) holds under the model's
    strategy (a ``PipelinedLM``: its stage slice at its tp columns), so
    that every rank starts from the JAX package's weights."""
    m = model.machine
    return model.shard_params(params, m.view.index(
        m.rank if rank is None else rank))


def shard_state(state, model, rank=None):
    """The blocks of a full state tree that ``rank`` holds."""
    m = model.machine
    return model.shard_state(state, m.view.index(
        m.rank if rank is None else rank))


def check_param_shapes(params: Mapping, want: Mapping) -> None:
    """Raise ValueError unless ``params`` has exactly the keys, leaves and
    shapes of ``want`` (``{param_key: {leaf: shape}}``)."""
    got = {key: {leaf: tuple(v.shape) for leaf, v in sub.items()}
           if isinstance(sub, Mapping) else tuple(sub.shape)
           for key, sub in params.items()}
    if got != want:
        def leaves(tree):
            return {f"{key}.{leaf}": shape for key, sub in tree.items()
                    for leaf, shape in (sub.items() if isinstance(sub, dict)
                                        else [("", sub)])}

        g, w = leaves(got), leaves(want)
        diff = sorted(f"{name}: {g.get(name)} != {w.get(name)}"
                      for name in set(g) | set(w)
                      if g.get(name) != w.get(name))
        raise ValueError(f"parameter tree does not match the model "
                         f"({len(diff)} leaves, e.g. {diff[:3]})")


def state_from_jax(tree: Mapping[str, Mapping[str, object]],
                   device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """The port's state from a JAX ``FFModel.init()`` state tree of numpy
    arrays (``{op_name: {"mean", "var"}}``), carried as the params are."""
    return params_from_jax(tree, device)
