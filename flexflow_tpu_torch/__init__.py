"""flexflow_tpu_torch: the PyTorch and CUDA port of ``flexflow_tpu``.

The JAX package stays the reference; this package mirrors its module
names and imports nothing of it (nor JAX).  Every entry point takes a
``device`` that defaults to ``"cuda"`` and raises when CUDA is absent
unless the caller asked for ``device="cpu"``.
"""
