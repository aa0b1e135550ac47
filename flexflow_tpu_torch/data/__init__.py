"""Input pipelines of the PyTorch port (counterparts of
``flexflow_tpu/data/``): synthetic batches so far."""

from flexflow_tpu_torch.data.synthetic import synthetic_batches

__all__ = ["synthetic_batches"]
