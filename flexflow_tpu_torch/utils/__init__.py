"""Utilities of the PyTorch port (counterparts of ``flexflow_tpu/utils/``)."""
