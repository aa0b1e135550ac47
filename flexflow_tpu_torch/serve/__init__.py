"""Continuous-batching inference runtime of the PyTorch port (counterpart
of ``flexflow_tpu/serve/``):

  * :mod:`~flexflow_tpu_torch.serve.loadgen` — seeded synthetic requests
    with VIRTUAL arrival times;
  * :mod:`~flexflow_tpu_torch.serve.batcher` — the request queue and the
    continuous batcher's decode slots;
  * :mod:`~flexflow_tpu_torch.serve.kv_cache` — the KV-cache layout, ring
    slots and byte accounting;
  * :mod:`~flexflow_tpu_torch.serve.engine` — the decode executor.

``apps/serve.py`` is the command-line entry point.
"""

from flexflow_tpu_torch.serve.batcher import ContinuousBatcher, RequestQueue
from flexflow_tpu_torch.serve.engine import ServeEngine
from flexflow_tpu_torch.serve.kv_cache import KVCache, KVCacheLayout
from flexflow_tpu_torch.serve.loadgen import Request, synthetic_requests

__all__ = [
    "ContinuousBatcher", "KVCache", "KVCacheLayout", "Request",
    "RequestQueue", "ServeEngine", "synthetic_requests",
]
