"""Continuous-batching inference runtime of the PyTorch port (counterpart
of ``flexflow_tpu/serve/``):

  * :mod:`~flexflow_tpu_torch.serve.loadgen` — seeded synthetic requests
    with VIRTUAL arrival times;
  * :mod:`~flexflow_tpu_torch.serve.batcher` — the request queue, the
    continuous batcher's decode slots and the forward-only service's
    padded batches;
  * :mod:`~flexflow_tpu_torch.serve.kv_cache` — the KV-cache layout, ring
    slots, byte accounting and the prefill-to-decode handoff;
  * :mod:`~flexflow_tpu_torch.serve.engine` — the executor: decode and
    the forward-only service over one or several ranks, the queue-driven
    autoscaler, the drain, and the prefill and decode phases;
  * :mod:`~flexflow_tpu_torch.serve.router` — the disaggregated pools'
    router;
  * :mod:`~flexflow_tpu_torch.serve.replicas` — the router over a world
    of ranks whose replicas are slices of it of any width.

``apps/serve.py`` is the command-line entry point.
"""

from flexflow_tpu_torch.serve.batcher import (ContinuousBatcher,
                                              RequestQueue, batch_requests)
from flexflow_tpu_torch.serve.engine import ServeEngine
from flexflow_tpu_torch.serve.kv_cache import (KVCache, KVCacheLayout,
                                               kv_cache_bytes)
from flexflow_tpu_torch.serve.loadgen import Request, synthetic_requests

__all__ = [
    "ContinuousBatcher", "KVCache", "KVCacheLayout", "Request",
    "RequestQueue", "ServeEngine", "batch_requests", "kv_cache_bytes",
    "synthetic_requests",
]
