"""Command-line drivers of the PyTorch port (counterparts of ``flexflow_tpu/apps/``)."""
