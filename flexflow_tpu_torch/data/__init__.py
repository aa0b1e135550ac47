"""Input pipelines of the PyTorch port (counterparts of
``flexflow_tpu/data/``): synthetic image batches and token streams, and
the device prefetcher (``data/prefetch.py``) so far."""

from flexflow_tpu_torch.data.synthetic import (synthetic_batches,
                                               synthetic_token_stream)

__all__ = ["synthetic_batches", "synthetic_token_stream"]
