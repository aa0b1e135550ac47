"""The port's CUDA kernels on the card: each held against its plain
PyTorch version on the same inputs, and the serving path counted through
them.  Every test carries the ``cuda`` marker and skips, with the reason,
where no GPU is present (kernels have no CPU mode).  This file imports
neither JAX nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: 1e-4 absolute, float32 sums over up to 512 keys in another
order (the kernel accumulates bf16 inputs in float32, as the plain
version does).
"""

import contextlib

import numpy as np
import pytest
import torch

from flexflow_tpu_torch.ops import attention, kernels
from flexflow_tpu_torch.ops.kernels.flash_attention import (
    NAME, flash_attention_fwd, flash_attention_fwd_cuda,
    flash_attention_fwd_plain)

pytestmark = pytest.mark.cuda

ATOL = 1e-4


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(seed, shape, sk, dtype, device):
    rng = np.random.RandomState(seed)
    b, h, sq, d = shape
    q = rng.randn(b, h, sq, d).astype("float32")
    k, v = (rng.randn(b, h, sk, d).astype("float32") for _ in range(2))
    return [torch.from_numpy(a).to(device, dtype) for a in (q, k, v)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,sk,causal", [
    ((8, 12, 512, 64), 512, True),     # the GPT serving shape
    ((2, 3, 77, 64), 77, True),        # ragged S
    ((2, 3, 77, 64), 77, False),
    ((1, 2, 40, 16), 100, False),      # Sq != Sk, small head dim
    ((2, 2, 33, 8), 33, True),
])
def test_flash_kernel_matches_plain(gpu, dtype, shape, sk, causal):
    q, k, v = _qkv(0, shape, sk, dtype, gpu)
    kernels.reset_launches()
    o, lse = flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert kernels.launches[NAME] == 1
    o_p, lse_p = flash_attention_fwd_plain(q, k, v, causal)
    torch.testing.assert_close(o, o_p, rtol=0, atol=ATOL)
    torch.testing.assert_close(lse, lse_p, rtol=0, atol=ATOL)


def test_flash_kernel_empty_keys(gpu):
    q, k, v = _qkv(1, (1, 2, 5, 64), 0, torch.float32, gpu)
    o, lse = flash_attention_fwd_cuda(q, k, v, False)
    torch.cuda.synchronize()
    assert bool((o == 0).all()) and bool(torch.isneginf(lse).all())


def test_flash_kernel_refuses_what_it_does_not_take(gpu):
    q, k, v = _qkv(2, (1, 2, 16, 64), 16, torch.float32, gpu)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q.transpose(2, 3).contiguous().transpose(2, 3),
                            k, v)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_fwd(q[..., :48].contiguous(),
                            k[..., :48].contiguous(),
                            v[..., :48].contiguous())
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_fwd(q, k.bfloat16(), v)


@contextlib.contextmanager
def _plain_attention():
    kernel = attention.flash_attention_fwd
    attention.flash_attention_fwd = flash_attention_fwd_plain
    try:
        yield
    finally:
        attention.flash_attention_fwd = kernel


def test_tiny_gpt_serves_through_the_kernel(gpu):
    from flexflow_tpu_torch.apps.serve import build_lm
    from flexflow_tpu_torch.serve.engine import ServeEngine
    from flexflow_tpu_torch.serve.loadgen import synthetic_requests

    def requests():
        return synthetic_requests(10, seed=2, rate_qps=400.0, vocab_size=64,
                                  prompt_len=4, max_new_tokens=3)

    model = build_lm(batch=8, seed=0, tiny=True, device=gpu)
    engine = ServeEngine(model, log=lambda *a: None)
    reqs = requests()
    kernels.reset_launches()
    summary = engine.run(reqs)
    assert summary["completed"] == 10
    assert kernels.launches[NAME] == model.t.num_layers * summary["steps"]
    with _plain_attention():
        ref = requests()
        ServeEngine(model, params=engine.params,
                    log=lambda *a: None).run(ref)
    assert [r.reply for r in reqs] == [r.reply for r in ref]
