"""The port's CUDA kernels on the card: each held against its plain
PyTorch version on the same inputs, and the serving and CNN training
paths counted through them.  Every test carries the ``cuda`` marker and
skips, with the reason, where no GPU is present (kernels have no CPU
mode).  This file imports neither JAX nor the JAX package, so it also
runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: flash attention 1e-4 absolute, float32 sums over up to 512
keys in another order (the kernel accumulates bf16 inputs in float32, as
the plain version does).  The pool kernels equal their plain versions:
the same float32 compares, and the same float32 adds in the same order,
cast once.
"""

import contextlib

import numpy as np
import pytest
import torch

from flexflow_tpu_torch.ops import attention, kernels
from flexflow_tpu_torch.ops.kernels import avgpool, maxpool
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k,p,relu,ties", [
    ((8, 147, 147, 64), 3, 0, True, False),   # Inception pool1 at N=8
    ((8, 73, 73, 192), 3, 0, True, True),
    ((4, 17, 17, 768), 3, 0, True, True),
    ((3, 15, 17, 4), 3, 1, True, True),       # pad 1, h != w
    ((2, 12, 12, 3), 2, 0, False, True),      # 2x2
    ((2, 23, 19, 6), 3, 0, False, False),
])
def test_maxpool_kernels_match_plain(gpu, dtype, shape, k, p, relu, ties):
    rng = np.random.RandomState(0)
    x = rng.randint(-3, 4, size=shape) if ties else rng.randn(*shape)
    x = torch.from_numpy(x.astype("float32")).to(gpu, dtype)
    kernels.reset_launches()
    y, sel = maxpool.maxpool_fwd(x, k, p, relu)
    y_p, sel_p = maxpool.maxpool_fwd_plain(x, k, p, relu)
    assert torch.equal(y, y_p) and torch.equal(sel, sel_p)
    dy = torch.from_numpy(rng.randn(*y.shape).astype("float32")).to(
        gpu, dtype)
    h, w = shape[1], shape[2]
    dx = maxpool.maxpool_bwd(dy, sel, h, w, k, p)
    torch.cuda.synchronize()
    assert torch.equal(dx, maxpool.maxpool_bwd_plain(dy, sel, h, w, k, p))
    assert dict(kernels.launches) == {maxpool.NAME_FWD: 1,
                                      maxpool.NAME_BWD: 1}


def test_maxpool_bwd_reads_a_channel_slice(gpu):
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, 9, 9, 5).astype("float32")).to(gpu)
    y, sel = maxpool.maxpool_fwd(x, 3, 0, True)
    wide = torch.from_numpy(rng.randn(2, 4, 4, 12).astype("float32")).to(gpu)
    dy = wide[..., 3:8]       # what a concat's backward hands back
    assert not dy.is_contiguous()
    dx = maxpool.maxpool_bwd(dy, sel, 9, 9, 3, 0)
    torch.cuda.synchronize()
    assert torch.equal(dx, maxpool.maxpool_bwd_plain(dy.contiguous(), sel,
                                                     9, 9, 3, 0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kh,kw,relu", [
    ((16, 8, 8, 2048), 8, 8, False),   # Inception pool3 at N=16
    ((4, 8, 8, 3), 2, 2, True),
    ((2, 12, 9, 24), 3, 3, True),
])
def test_avgpool_kernel_matches_plain(gpu, dtype, shape, kh, kw, relu):
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(*shape).astype("float32")).to(gpu, dtype)
    y = avgpool.avgpool_fwd(x, kh, kw, relu)
    dy = torch.from_numpy(rng.randn(*y.shape).astype("float32")).to(
        gpu, dtype)
    kernels.reset_launches()
    dx = avgpool.avgpool_bwd(dy, y if relu else None, kh, kw)
    torch.cuda.synchronize()
    assert kernels.launches[avgpool.NAME] == 1
    assert torch.equal(
        dx, avgpool.avgpool_bwd_plain(dy, y if relu else None, kh, kw))


def test_pool_kernels_refuse_what_they_do_not_take(gpu):
    x = torch.randn(2, 9, 9, 4, device=gpu)
    with pytest.raises(ValueError, match="dtype"):
        maxpool.maxpool_fwd(x.half(), 3, 0, False)
    with pytest.raises(ValueError, match="contiguous"):
        maxpool.maxpool_fwd(x.transpose(1, 2), 3, 0, False)
    with pytest.raises(ValueError, match="not supported"):
        maxpool.maxpool_fwd_cuda(x, 5, 0, False)
    y, sel = maxpool.maxpool_fwd(x, 3, 0, False)
    with pytest.raises(ValueError, match="channel stride"):
        maxpool.maxpool_bwd(y.transpose(2, 3).contiguous().transpose(2, 3),
                            sel, 9, 9, 3, 0)
    with pytest.raises(ValueError, match="dtype"):
        avgpool.avgpool_bwd(torch.randn(2, 1, 1, 4, device=gpu).half(),
                            None, 9, 9)


def test_tiny_cnn_trains_through_the_pool_kernels(gpu):
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.model import FFModel

    def build():
        ff = FFModel(FFConfig(batch_size=4, compute_dtype="bfloat16",
                              seed=1), device=gpu)
        t = ff.create_input((4, 19, 19, 3), name="image")
        t = ff.conv2d("conv1", t, 16, 3, 3, 1, 1, 1, 1, relu=True)
        t = ff.pool2d("pool1", t, 3, 3, 2, 2, 0, 0)
        t = ff.conv2d("conv2", t, 32, 3, 3, 1, 1, 1, 1, relu=True)
        t = ff.pool2d("pool2", t, 9, 9, 1, 1, 0, 0, pool_type="avg")
        t = ff.flat("flat", t)
        t = ff.linear("fc", t, 10, relu=False)
        ff.softmax("softmax", t)
        return ff

    rng = np.random.RandomState(3)
    image = rng.randn(4, 19, 19, 3).astype("float32")
    labels = rng.randint(0, 10, 4).astype("int32")
    ff = build()
    params, state = ff.init()
    opt = ff.init_opt_state(params)
    step = ff.make_train_step()
    kernels.reset_launches()
    _, _, _, loss = step(params, state, opt, image, labels)
    torch.cuda.synchronize()
    assert dict(kernels.launches) == {maxpool.NAME_FWD: 1,
                                      maxpool.NAME_BWD: 1, avgpool.NAME: 1}
    assert bool(torch.isfinite(loss))
