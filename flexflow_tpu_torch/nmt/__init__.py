"""The NMT seq2seq trainer, the reference's second application (PyTorch
port of ``flexflow_tpu/nmt/``)."""

from flexflow_tpu_torch.nmt.rnn_model import RnnConfig, RnnModel

__all__ = ["RnnConfig", "RnnModel"]
