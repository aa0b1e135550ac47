"""GPT size presets (PyTorch port of ``flexflow_tpu/models/gpt.py``):
the same ``GPT_SIZES``, :func:`gpt_config` and the analytic
:func:`gpt_param_count`, so that the port's parameter trees are checked
against the JAX package's formula, and :func:`build_gpt`, a preset's
``TransformerLM`` on a machine under a strategy (``gpt.py:62``).  The
JAX module's search over these graphs comes with the cost model.

    0.1b       12 x  768, ff  3072, vocab 32768  -> ~0.14 B params
    0.4b       24 x 1024, ff  4096, vocab 32768  -> ~0.37 B params
    1.3b       24 x 2048, ff  8192, vocab 32768  -> ~1.34 B params
    1.3b-deep  96 x 1024, ff  4096, vocab 32768  -> ~1.28 B params

``gpt_config("0.1b", num_experts=8)`` is the MoE path ``chip_smoke.py``
trains: 8 experts in every block, ~0.53 B params.
"""

from __future__ import annotations

from typing import Dict

from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                   TransformerLM)

# name -> TransformerConfig field overrides (always causal)
GPT_SIZES: Dict[str, dict] = {
    "0.1b": dict(num_layers=12, d_model=768, num_heads=12, d_ff=3072,
                 vocab_size=32768, seq_length=512, batch_size=16),
    "0.4b": dict(num_layers=24, d_model=1024, num_heads=16, d_ff=4096,
                 vocab_size=32768, seq_length=1024, batch_size=16),
    "1.3b": dict(num_layers=24, d_model=2048, num_heads=16, d_ff=8192,
                 vocab_size=32768, seq_length=512, batch_size=16),
    "1.3b-deep": dict(num_layers=96, d_model=1024, num_heads=16, d_ff=4096,
                      vocab_size=32768, seq_length=256, batch_size=16),
}


def gpt_config(size: str, **overrides) -> TransformerConfig:
    """TransformerConfig of a named preset; overrides win (e.g.
    ``num_experts=8`` turns the dense FFN stack into MoE)."""
    if size not in GPT_SIZES:
        raise KeyError(
            f"unknown GPT size {size!r}; have {sorted(GPT_SIZES)}")
    kw = dict(GPT_SIZES[size])
    kw.setdefault("causal", True)
    kw.update(overrides)
    return TransformerConfig(**kw)


def build_gpt(size: str, machine=None, strategies=None, device="cuda",
              **overrides) -> TransformerLM:
    """The preset's LM on ``machine`` (default one device) with every op
    on the grid and device list ``strategies`` names."""
    return TransformerLM(gpt_config(size, **overrides), machine, strategies,
                         device)


def gpt_param_count(cfg: TransformerConfig) -> int:
    """Analytic parameter count: the attention's four d x d projections
    and its output bias, a 2-matmul FFN with biases, two LayerNorms per
    block; an MoE block's experts and router in place of its FFN; token
    and positional embeddings, the final LayerNorm and the untied vocab
    head.  The JAX package's formula counts 4d attention biases where
    its attention op (like the port's) has one, d: it is 3 d per block
    above the leaves both packages make."""
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    per_block = 4 * d * d + d              # wq, wk, wv, wo and bo
    per_block += 2 * 2 * d                 # ln1 + ln2
    if cfg.num_experts > 0:
        moe = cfg.num_experts * (d * ff + ff + ff * d + d) \
            + d * cfg.num_experts
        dense = d * ff + ff + ff * d + d
        n_moe = len([i for i in range(cfg.num_layers)
                     if i % cfg.moe_every == 0])
        total_blocks = (cfg.num_layers - n_moe) * (per_block + dense) \
            + n_moe * (per_block + moe)
    else:
        per_block += d * ff + ff + ff * d + d
        total_blocks = cfg.num_layers * per_block
    embed = v * d + cfg.seq_length * d     # token + learned positional
    head = d * v + v                       # lm_head (untied)
    final_ln = 2 * d
    return embed + total_blocks + final_ln + head
