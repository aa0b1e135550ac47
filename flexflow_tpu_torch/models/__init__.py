"""Model definitions of the PyTorch port (counterparts of ``flexflow_tpu/models/``)."""
