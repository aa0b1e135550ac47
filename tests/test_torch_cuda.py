"""The port's CUDA kernels on the card: each held against its plain
PyTorch version on the same inputs, and the serving, CNN training, LM
training (dense and mixture of experts) and NMT training paths counted
through them.  Every test
carries the ``cuda`` marker and skips, with the reason, where no GPU is
present (kernels have no CPU mode).  This file imports neither JAX nor
the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: flash attention forward 1e-4 absolute, float32 sums over up
to 512 keys in another order (the kernel's float32 products are 3xTF32
on the tensor cores, its bf16 products exact with float32 sums and P
split into two bf16 parts, so both keep close to float32's error).  The flash backward and the fused
cross-entropy kernels are held to a share of the largest magnitude of
each output: 1e-4 in float32 (sums over up to 512 keys or 50257 vocab
columns in another order; the cross-entropy backward's 3xTF32 products
keep close to float32's error), 1e-2 with bfloat16 operands (both versions
round p, ds or t to bfloat16 before a product, and a float32 sum taken in
another order can tip a rounding by one bfloat16 step).  The pool kernels
equal their plain versions: the same float32 compares, and the same
float32 adds in the same order, cast once.  So do the BN kernels' y and
dx (the same unfused float32 multiply, add and compare, cast once);
their per-channel sums are held to 1e-5 of sum |g x| and sum |g| (float32
sums over the rows in another order, which the sums themselves, able to
cancel, cannot scale).
"""

import contextlib

import numpy as np
import pytest
import torch

from flexflow_tpu_torch.ops import kernels
from flexflow_tpu_torch.ops.kernels import avgpool, maxpool
from flexflow_tpu_torch.ops.kernels import flash_attention as fa
from flexflow_tpu_torch.ops.kernels import fused_ce as ce
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
    ((2, 4, 256, 128), 256, True),     # head dim 128, forward only
    ((2, 3, 77, 128), 77, True),
    ((2, 3, 77, 128), 300, False),
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
    flat = torch.empty(q.numel() + 1, device=gpu)
    q_odd = flat[1:].view(q.shape)
    q_odd.copy_(q)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention_fwd(q_odd, k, v)
    # head dim 128: the forward takes it
    q, k, v = _qkv(3, (1, 2, 16, 128), 16, torch.float32, gpu)
    o, lse = flash_attention_fwd(q, k, v, True)
    torch.cuda.synchronize()
    assert tuple(o.shape) == (1, 2, 16, 128) and bool(torch.isfinite(o).all())


@contextlib.contextmanager
def _plain_kernels():
    """Every kernel of the sequence models swapped for its plain version
    (the autograd functions look them up when called)."""
    saved = (fa.flash_attention_fwd, fa.flash_attention_bwd,
             ce.fused_linear_ce_fwd, ce.fused_linear_ce_bwd)
    fa.flash_attention_fwd = fa.flash_attention_fwd_plain
    fa.flash_attention_bwd = fa.flash_attention_bwd_plain
    ce.fused_linear_ce_fwd = ce.fused_linear_ce_fwd_plain
    ce.fused_linear_ce_bwd = ce.fused_linear_ce_bwd_plain
    try:
        yield
    finally:
        (fa.flash_attention_fwd, fa.flash_attention_bwd,
         ce.fused_linear_ce_fwd, ce.fused_linear_ce_bwd) = saved


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
    with _plain_kernels():
        ref = requests()
        ServeEngine(model, params=engine.params,
                    log=lambda *a: None).run(ref)
    assert [r.reply for r in reqs] == [r.reply for r in ref]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k,p,relu,ties", [
    ((8, 147, 147, 64), 3, 0, True, False),   # Inception pool1 at N=8
    ((8, 73, 73, 192), 3, 0, True, True),
    ((4, 17, 17, 768), 3, 0, True, True),
    ((4, 112, 112, 64), 3, 1, True, True),    # DenseNet pool1 at N=4
    ((3, 15, 17, 4), 3, 1, True, True),       # pad 1, h != w
    ((2, 12, 12, 3), 2, 0, False, True),      # 2x2
    ((8, 112, 112, 128), 2, 0, True, True),   # VGG-16 pool2 at N=8
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


# channels and the channel offset of dy in a wider tensor: 16-byte
# vectors, C = 5 (one channel a thread), and a slice whose odd offset
# admits no 16-byte access (the scalar instance of the same kernel)
POOL_INSTANCES = [(64, 0), (5, 0), (16, 1)]


def _pool_dy(rng, shape, channels, offset, dtype, gpu):
    """dy of ``shape`` as the channel slice [offset, offset + channels) of
    a wider tensor, and the width the wrappers pick for it."""
    n, oh, ow, _ = shape
    wide = rng.randn(n, oh, ow, channels + 8).astype("float32")
    dy = torch.from_numpy(wide).to(gpu, dtype)[..., offset:offset + channels]
    isz = dy.element_size()
    vec = kernels.vec_width(channels, isz, dy.stride()[:3],
                            [(dy.data_ptr(), isz)])
    assert vec == (1 if channels == 5 or offset else 16 // isz)
    return dy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,p", [(3, 0), (3, 1), (2, 0)])
@pytest.mark.parametrize("channels,offset", POOL_INSTANCES)
def test_maxpool_kernels_vector_and_scalar_instances(gpu, dtype, k, p,
                                                     channels, offset):
    rng = np.random.RandomState(4)
    shape = (3, 14, 11, channels)
    x = torch.from_numpy(rng.randint(-3, 4, size=shape).astype(
        "float32")).to(gpu, dtype)
    y, sel = maxpool.maxpool_fwd(x, k, p, True)
    y_p, sel_p = maxpool.maxpool_fwd_plain(x, k, p, True)
    assert torch.equal(y, y_p) and torch.equal(sel, sel_p)
    dy = _pool_dy(rng, y.shape, channels, offset, dtype, gpu)
    dx = maxpool.maxpool_bwd(dy, sel, 14, 11, k, p)
    again = maxpool.maxpool_bwd(dy, sel, 14, 11, k, p)
    torch.cuda.synchronize()
    assert torch.equal(dx, maxpool.maxpool_bwd_plain(dy.contiguous(), sel,
                                                     14, 11, k, p))
    assert torch.equal(dx, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kh,relu", [(2, True), (7, False)])
@pytest.mark.parametrize("channels,offset", POOL_INSTANCES)
def test_avgpool_kernel_vector_and_scalar_instances(gpu, dtype, kh, relu,
                                                    channels, offset):
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(3, 14, 14, channels).astype(
        "float32")).to(gpu, dtype)
    y = avgpool.avgpool_fwd(x, kh, kh, relu)
    dy = _pool_dy(rng, y.shape, channels, offset, dtype, gpu)
    mask = y if relu else None
    dx = avgpool.avgpool_bwd(dy, mask, kh, kh)
    again = avgpool.avgpool_bwd(dy, mask, kh, kh)
    torch.cuda.synchronize()
    assert torch.equal(dx, avgpool.avgpool_bwd_plain(dy.contiguous(), mask,
                                                     kh, kh))
    assert torch.equal(dx, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kh,kw,relu", [
    ((16, 8, 8, 2048), 8, 8, False),   # Inception pool3 at N=16
    ((4, 56, 56, 128), 2, 2, False),   # DenseNet trans1 at N=4
    ((4, 7, 7, 1024), 7, 7, False),    # DenseNet pool2 at N=4
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


def _close(got, want, dtype, what):
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    got, want = got.detach(), want.detach()
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= tol * scale, f"{what}: max err {err:.3e} > {tol} x " \
                               f"{scale:.3e}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,sk,causal", [
    ((16, 12, 512, 64), 512, True),    # the LM training shape
    ((2, 3, 77, 64), 77, True),        # ragged S
    ((2, 3, 77, 64), 77, False),
    ((1, 2, 40, 16), 100, False),      # Sq != Sk, small head dim
    ((1, 2, 100, 32), 40, True),       # Sq > Sk, causal
    ((2, 2, 33, 8), 33, True),
    ((2, 16, 512, 128), 512, True),    # the GPT-1.3B widths' head dim
    ((2, 3, 77, 128), 77, True),       # ragged, head dim 128
    ((2, 3, 77, 128), 300, False),
])
def test_flash_bwd_kernels_match_plain(gpu, dtype, shape, sk, causal):
    q, k, v = _qkv(4, shape, sk, dtype, gpu)
    o, lse = flash_attention_fwd_cuda(q, k, v, causal)
    do = torch.from_numpy(np.random.RandomState(5).randn(*shape).astype(
        "float32")).to(gpu)
    kernels.reset_launches()
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert dict(kernels.launches) == {fa.NAME_DKV: 1, fa.NAME_DQ: 1}
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32 and g.shape == w.shape
        _close(g, w, dtype, name)


def test_flash_bwd_kernels_refuse_what_they_do_not_take(gpu):
    q, k, v = _qkv(6, (1, 2, 16, 64), 16, torch.float32, gpu)
    o, lse = flash_attention_fwd_cuda(q, k, v, True)
    delta = o.sum(-1)
    with pytest.raises(ValueError, match="do must be"):
        fa.flash_attention_bwd_dkv_cuda(q, k, v, o.bfloat16(), lse, delta)
    with pytest.raises(ValueError, match="do must be"):
        fa.flash_attention_bwd_dq_cuda(q, k, v, o.transpose(2, 3)
                                       .contiguous().transpose(2, 3), lse,
                                       delta)
    with pytest.raises(ValueError, match="lse must be"):
        fa.flash_attention_bwd_dq_cuda(q, k, v, o, lse.cpu(), delta)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention_bwd_dkv_cuda(q.half(), k.half(), v.half(),
                                        o.half(), lse, delta)
    with pytest.raises(ValueError, match="one CUDA device"):
        fa.flash_attention_bwd_dkv_cuda(q, k.cpu(), v, o, lse, delta)
    # head dim 96, which no kernel is built for: the backward refuses it
    q, k, v = _qkv(6, (1, 2, 16, 96), 16, torch.float32, gpu)
    o, lse = flash_attention_fwd_plain(q, k, v, True)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_bwd(q, k, v, o, lse, torch.ones_like(o), True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,sk,causal", [
    ((4, 12, 512, 64), 512, True),
    ((2, 4, 77, 128), 300, False),
])
def test_flash_bwd_kernels_give_the_same_bits_in_every_call(gpu, dtype,
                                                           shape, sk,
                                                           causal):
    q, k, v = _qkv(7, shape, sk, dtype, gpu)
    o, lse = flash_attention_fwd_cuda(q, k, v, causal)
    do = torch.from_numpy(np.random.RandomState(8).randn(*shape).astype(
        "float32")).to(gpu)
    first = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    again = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    for a, b, name in zip(first, again, ("dq", "dk", "dv")):
        assert torch.equal(a, b), name


def _ce_inputs(seed, n, d, v, dtype, device):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(n, d).astype("float32")).to(device, dtype)
    w = torch.from_numpy((rng.randn(d, v) * 0.05).astype("float32")).to(
        device, dtype)
    b = torch.from_numpy((rng.randn(v) * 0.1).astype("float32")).to(device)
    lab = rng.randint(0, v, (n,)).astype("int32")
    lab[::5] = -1
    lab[1] = v + 2
    g = torch.from_numpy(rng.rand(n).astype("float32")).to(device)
    return x, w, b, torch.from_numpy(lab).to(device), g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,v", [
    (8192, 768, 32768),    # the LM training shape
    (1000, 768, 50257),    # GPT-2's vocab: w rows not 16-byte aligned
    (130, 1024, 4099),     # ragged N, d above 768, V % 8 != 0
    (64, 2048, 256),       # an NMT-size d
    (300, 100, 1000),      # ragged rows, depth and vocab
    (64, 32, 64),
    (5, 8, 3),
])
def test_fused_ce_kernels_match_plain(gpu, dtype, n, d, v):
    x, w, b, lab, g = _ce_inputs(7, n, d, v, dtype, gpu)
    kernels.reset_launches()
    nll, lse = ce.fused_linear_ce_fwd(x, w, b, lab)
    dx, dw, db = ce.fused_linear_ce_bwd(x, w, b, lab, lse, g)
    torch.cuda.synchronize()
    assert dict(kernels.launches) == {ce.NAME_FWD: 1, ce.NAME_FWD_COMBINE: 1,
                                      ce.NAME_DX: 1, ce.NAME_DX_SUM: 1,
                                      ce.NAME_DW: 1}
    nll_p, lse_p = ce.fused_linear_ce_fwd_plain(x, w, b, lab)
    _close(nll, nll_p, torch.float32, "nll")
    _close(lse, lse_p, torch.float32, "lse")
    for got, want, name in zip((dx, dw, db), ce.fused_linear_ce_bwd_plain(
            x, w, b, lab, lse_p, g), ("dx", "dw", "db")):
        assert got.dtype == torch.float32 and got.shape == want.shape
        _close(got, want, dtype, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,v", [
    (1000, 768, 50257),    # 8 vocab slices, w rows not 16-byte aligned
    (130, 1024, 4099),     # 17 slices, the last of 3 columns
    (77, 768, 50257),
])
def test_fused_ce_forward_over_vocab_slices_matches_plain(gpu, dtype, n, d,
                                                          v):
    """Kernel 4 at ragged N and V with S > 1 vocab slices, -1 and >= V
    labels, against its plain version."""
    assert ce.fwd_splits(n, v, torch.cuda.get_device_properties(
        gpu).multi_processor_count) > 1
    x, w, b, lab, _ = _ce_inputs(17, n, d, v, dtype, gpu)
    kernels.reset_launches()
    nll, lse = ce.fused_linear_ce_fwd(x, w, b, lab)
    torch.cuda.synchronize()
    assert dict(kernels.launches) == {ce.NAME_FWD: 1, ce.NAME_FWD_COMBINE: 1}
    nll_p, lse_p = ce.fused_linear_ce_fwd_plain(x, w, b, lab)
    assert bool(torch.isfinite(nll).all() and torch.isfinite(lse).all())
    _close(nll, nll_p, torch.float32, "nll")
    _close(lse, lse_p, torch.float32, "lse")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ce_forward_gives_the_same_bits_in_every_call(gpu, dtype):
    """No atomics and a fixed order of merges: a second call of kernel 4
    and its combine over several vocab slices repeats the first bit for
    bit."""
    x, w, b, lab, _ = _ce_inputs(18, 1000, 768, 50257, dtype, gpu)
    first = ce.fused_linear_ce_fwd(x, w, b, lab)
    again = ce.fused_linear_ce_fwd(x, w, b, lab)
    torch.cuda.synchronize()
    for a, c, name in zip(first, again, ("nll", "lse")):
        assert torch.equal(a, c), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ce_backward_gives_the_same_bits_in_every_call(gpu, dtype):
    """No atomics and a fixed order of sums: a second call of kernels 5-6
    (with the dx partials over several vocab slices) repeats the first
    bit for bit."""
    x, w, b, lab, g = _ce_inputs(16, 1000, 768, 50257, dtype, gpu)
    _, lse = ce.fused_linear_ce_fwd(x, w, b, lab)
    assert ce.dx_splits(1000, 50257, torch.cuda.get_device_properties(
        gpu).multi_processor_count) > 1
    first = ce.fused_linear_ce_bwd(x, w, b, lab, lse, g)
    again = ce.fused_linear_ce_bwd(x, w, b, lab, lse, g)
    torch.cuda.synchronize()
    for a, c, name in zip(first, again, ("dx", "dw", "db")):
        assert torch.equal(a, c), name


def test_fused_ce_kernels_refuse_what_they_do_not_take(gpu):
    x, w, b, lab, g = _ce_inputs(8, 64, 32, 100, torch.float32, gpu)
    nll, lse = ce.fused_linear_ce_fwd(x, w, b, lab)
    with pytest.raises(ValueError, match="dtype"):
        ce.fused_linear_ce_fwd(x.half(), w.half(), b, lab)
    with pytest.raises(ValueError, match="dtype"):
        ce.fused_linear_ce_fwd(x, w.bfloat16(), b, lab)
    with pytest.raises(ValueError, match="int32 labels"):
        ce.fused_linear_ce_fwd(x, w, b, lab.long())
    with pytest.raises(ValueError, match="contiguous"):
        ce.fused_linear_ce_fwd(x, w.t().contiguous().t(), b, lab)
    with pytest.raises(ValueError, match="one CUDA device"):
        ce.fused_linear_ce_bwd_dx_cuda(x, w, b, lab, lse, g.cpu())
    with pytest.raises(ValueError, match="one CUDA device"):
        ce.fused_linear_ce_bwd(x, w, b.cpu(), lab, lse, g)
    with pytest.raises(ValueError, match="workspace"):
        ce.fused_linear_ce_bwd_dx_sum_cuda(
            torch.zeros((2, 64, 128), device=gpu), 64, 32)
    with pytest.raises(ValueError, match="workspace"):
        ce.fused_linear_ce_fwd_combine_cuda(torch.zeros((2, 64, 2),
                                                        device=gpu))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_gradients_match_autograd(gpu, dtype):
    """``FlashAttention`` (kernels 1-3) against autograd through the plain
    forward."""
    q, k, v = _qkv(9, (2, 4, 70, 64), 70, dtype, gpu)
    do = torch.randn(2, 4, 70, 64, device=gpu)
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    o = fa.flash_attention(*ts, True)
    grads = torch.autograd.grad(o, ts, do)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    o_p, _ = flash_attention_fwd_plain(*ref, True)
    want = torch.autograd.grad(o_p, ref, do)
    _close(o, o_p, torch.float32, "o")
    for g, w, name in zip(grads, want, ("dq", "dk", "dv")):
        assert g.dtype == dtype
        _close(g.float(), w.float(), dtype, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ce_gradients_match_autograd(gpu, dtype):
    """``FusedLinearCE`` (kernels 4-6) against autograd through the
    unfused log-softmax."""
    x, w, b, lab, g = _ce_inputs(10, 200, 64, 500, dtype, gpu)
    ts = [t.clone().requires_grad_() for t in (x, w, b)]
    nll = ce.fused_linear_ce(*ts, lab)
    grads = torch.autograd.grad(nll, ts, g)
    ref = [t.clone().float().requires_grad_() for t in (x, w, b)]
    lp = torch.log_softmax(ref[0] @ ref[1] + ref[2], dim=-1)
    hit = (lab >= 0) & (lab < 500)
    picked = lp.gather(1, torch.where(hit, lab, 0).long()[:, None])[:, 0]
    lse = torch.logsumexp(ref[0] @ ref[1] + ref[2], dim=1)
    nll_ref = torch.where(hit, -picked, lse)   # no target: nll = lse
    want = torch.autograd.grad(nll_ref, ref, g)
    _close(nll, nll_ref.detach(), torch.float32, "nll")
    for got, w_, name in zip(grads, want, ("dx", "dw", "db")):
        _close(got.float(), w_, dtype, name)


def _tiny_lm(gpu, dtype="float32"):
    from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                       TransformerLM)

    return TransformerLM(TransformerConfig(
        batch_size=4, seq_length=64, num_layers=2, d_model=64, num_heads=4,
        d_ff=128, vocab_size=300, causal=True, learning_rate=0.1,
        compute_dtype=dtype), device=gpu)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_lm_trains_through_the_kernels(gpu, dtype):
    model = _tiny_lm(gpu, dtype)
    toks = np.random.RandomState(11).randint(0, 300, (4, 64)).astype("int32")

    def run():
        params, state = model.init()
        opt = model.init_opt_state(params)
        step = model.make_train_step()
        losses = []
        for _ in range(3):
            params, state, opt, loss = step(params, state, opt, toks, toks)
            losses.append(float(loss))
        return losses

    kernels.reset_launches()
    losses = run()
    torch.cuda.synchronize()
    layers = model.t.num_layers
    assert dict(kernels.launches) == {
        fa.NAME: 3 * layers, fa.NAME_DKV: 3 * layers, fa.NAME_DQ: 3 * layers,
        ce.NAME_FWD: 3, ce.NAME_FWD_COMBINE: 3, ce.NAME_DX: 3,
        ce.NAME_DX_SUM: 3, ce.NAME_DW: 3}
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    with _plain_kernels():
        kernels.reset_launches()
        ref = run()
        assert sum(kernels.launches.values()) == 0
    np.testing.assert_allclose(losses, ref,
                               rtol=1e-4 if dtype == "float32" else 2e-2)


def test_tiny_moe_lm_trains_through_the_kernels(gpu):
    """A small MoE LM (2 layers, 4 experts in every block, top-2) for
    three float32 SGD steps: kernels 1-6 launch as in the dense LM (the
    experts have no kernel of their own), the losses within 1e-4 of the
    run with the plain kernels, and two runs give the same bits (the
    dispatch and combine backward has no atomics)."""
    from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                       TransformerLM)

    model = TransformerLM(TransformerConfig(
        batch_size=4, seq_length=64, num_layers=2, d_model=64, num_heads=4,
        d_ff=128, vocab_size=300, causal=True, learning_rate=0.1,
        num_experts=4, moe_capacity_factor=1.0), device=gpu)
    toks = np.random.RandomState(13).randint(0, 300, (4, 64)).astype("int32")

    def run():
        params, state = model.init()
        opt = model.init_opt_state(params)
        step = model.make_train_step()
        losses = []
        for _ in range(3):
            params, state, opt, loss = step(params, state, opt, toks, toks)
            losses.append(float(loss))
        return losses, params

    kernels.reset_launches()
    losses, params = run()
    torch.cuda.synchronize()
    layers = model.t.num_layers
    assert dict(kernels.launches) == {
        fa.NAME: 3 * layers, fa.NAME_DKV: 3 * layers, fa.NAME_DQ: 3 * layers,
        ce.NAME_FWD: 3, ce.NAME_FWD_COMBINE: 3, ce.NAME_DX: 3,
        ce.NAME_DX_SUM: 3, ce.NAME_DW: 3}
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    again, params2 = run()
    assert again == losses
    for key, sub in params.items():
        for leaf, v in sub.items():
            assert torch.equal(v, params2[key][leaf]), f"{key}.{leaf}"
    with _plain_kernels():
        kernels.reset_launches()
        ref, _ = run()
        assert sum(kernels.launches.values()) == 0
    np.testing.assert_allclose(losses, ref, rtol=1e-4)


def test_tiny_nmt_trains_through_the_kernels(gpu):
    """A small NMT model (2 layers, 2 decoder chunks of 8 tokens x batch
    4, vocab 300) for three float32 SGD steps: each decoder chunk's vocab
    head runs kernels 4-6 once a step, over the one shared ``linear``
    leaf; the losses within 1e-4 of the run with the plain kernels."""
    from flexflow_tpu_torch.nmt.rnn_model import RnnConfig, RnnModel

    model = RnnModel(RnnConfig(batch_size=4, num_layers=2, seq_length=16,
                               hidden_size=64, embed_size=32,
                               vocab_size=300, lstm_per_node_length=8,
                               learning_rate=0.5, seed=2), device=gpu)
    rng = np.random.RandomState(12)
    src, dst = (rng.randint(0, 300, (4, 16)).astype("int32")
                for _ in range(2))

    def run():
        params, state = model.init()
        opt = model.init_opt_state(params)
        step = model.make_train_step()
        losses = []
        for _ in range(3):
            params, state, opt, loss = step(params, state, opt, src, dst)
            losses.append(float(loss))
        return losses

    kernels.reset_launches()
    losses = run()
    torch.cuda.synchronize()
    assert dict(kernels.launches) == {
        ce.NAME_FWD: 6, ce.NAME_FWD_COMBINE: 6, ce.NAME_DX: 6,
        ce.NAME_DX_SUM: 6, ce.NAME_DW: 6}
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    with _plain_kernels():
        kernels.reset_launches()
        ref = run()
        assert sum(kernels.launches.values()) == 0
    np.testing.assert_allclose(losses, ref, rtol=1e-4)


def _bn_inputs(seed, m, c, dtype, device):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(m, c).astype("float32")).to(device, dtype)
    inv = torch.from_numpy((1 + 0.5 * rng.randn(c)).astype("float32")).to(
        device)
    shift = torch.from_numpy((0.3 * rng.randn(c)).astype("float32")).to(
        device)
    g = torch.from_numpy(rng.randn(m, c).astype("float32")).to(device, dtype)
    return x, inv, shift, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("m,c", [
    (64 * 56 * 56, 256),   # dense1's widest BN at batch 8 x 8
    (8 * 7 * 7, 992),      # dense4's widest at batch 8
    (4096, 130),           # ragged C: the scalar path
    (64, 7),               # tiny C
    (50, 64),              # ragged M (the JAX gate refuses it; the kernels
                           # take it)
])
def test_bn_act_kernels_match_plain(gpu, dtype, relu, m, c):
    """Kernels 9 and 10: y and dx equal the plain versions (the same
    float32 mul, add, compare and product, cast once); d_inv and d_shift
    within 1e-5 of sum |g x| and sum |g| (float32 sums in another
    order)."""
    from flexflow_tpu_torch.ops.kernels import bn_act

    x, inv, shift, g = _bn_inputs(12, m, c, dtype, gpu)
    kernels.reset_launches()
    y = bn_act.bn_act_fwd(x, inv, shift, relu)
    dx, d_inv, d_shift = bn_act.bn_act_bwd(x, inv, shift, g, relu)
    torch.cuda.synchronize()
    assert dict(kernels.launches) == {bn_act.NAME_FWD: 1, bn_act.NAME_BWD: 1,
                                      bn_act.NAME_SUM: 1}
    assert torch.equal(y, bn_act.bn_act_fwd_plain(x, inv, shift, relu))
    dx_p, d_inv_p, d_shift_p = bn_act.bn_act_bwd_plain(x, inv, shift, g,
                                                       relu)
    assert torch.equal(dx, dx_p)
    gm = g.float()
    if relu:
        gm = torch.where(x.float() * inv + shift > 0, gm, 0.0)
    for got, want, mag in ((d_inv, d_inv_p, (gm * x.float()).abs().sum(0)),
                           (d_shift, d_shift_p, gm.abs().sum(0))):
        assert got.dtype == torch.float32 and got.shape == (c,)
        assert bool(((got - want).abs() <= 1e-5 * mag + 1e-30).all())


def test_bn_act_sums_are_the_same_in_every_run(gpu):
    from flexflow_tpu_torch.ops.kernels import bn_act

    x, inv, shift, g = _bn_inputs(13, 64 * 28 * 28, 128, torch.bfloat16, gpu)
    first = bn_act.bn_act_bwd(x, inv, shift, g, True)
    for _ in range(3):
        again = bn_act.bn_act_bwd(x, inv, shift, g, True)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_bn_act_kernels_take_unaligned_rows(gpu):
    """A row slice whose address is not 16-byte aligned takes the scalar
    path and still agrees."""
    from flexflow_tpu_torch.ops.kernels import bn_act

    x, inv, shift, g = _bn_inputs(14, 257, 64, torch.bfloat16, gpu)
    xs = x.reshape(-1)[1:1 + 200 * 64].reshape(200, 64)
    gs = g.reshape(-1)[3:3 + 200 * 64].reshape(200, 64)
    assert xs.data_ptr() % 16 and xs.is_contiguous()
    y = bn_act.bn_act_fwd(xs, inv, shift, True)
    dx, _, _ = bn_act.bn_act_bwd(xs, inv, shift, gs, True)
    torch.cuda.synchronize()
    assert torch.equal(y, bn_act.bn_act_fwd_plain(xs, inv, shift, True))
    assert torch.equal(dx, bn_act.bn_act_bwd_plain(xs, inv, shift, gs,
                                                   True)[0])


def test_bn_act_kernels_refuse_what_they_do_not_take(gpu):
    from flexflow_tpu_torch.ops.kernels import bn_act

    x, inv, shift, g = _bn_inputs(15, 64, 16, torch.float32, gpu)
    with pytest.raises(ValueError, match="dtype"):
        bn_act.bn_act_fwd(x.half(), inv, shift, True)
    with pytest.raises(ValueError, match="dtype"):
        bn_act.bn_act_bwd(x, inv, shift, g.bfloat16(), True)
    with pytest.raises(ValueError, match="float32"):
        bn_act.bn_act_fwd(x, inv.bfloat16(), shift, True)
    with pytest.raises(ValueError, match="contiguous"):
        bn_act.bn_act_fwd(x.t().contiguous().t(), inv, shift, True)
    with pytest.raises(ValueError, match="one CUDA device"):
        bn_act.bn_act_fwd(x, inv.cpu(), shift, True)
    with pytest.raises(ValueError, match=r"\(M, C\)"):
        bn_act.bn_act_fwd(x, inv[:8], shift[:8], True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_densenet_trains_through_the_kernels(gpu, dtype):
    """A downsized DenseNet (batch 8, 32x32) through kernels 7-10: one max
    pool, one transition and the global pool, seven BNs; three steps, the
    first loss equal to the run with every CNN kernel swapped for its
    plain version and the next two within 1e-4 (float32) / 2e-2 (bf16)."""
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.model import FFModel
    from flexflow_tpu_torch.models.densenet import dense_block, transition
    from flexflow_tpu_torch.ops.kernels import bn_act

    torch.backends.cudnn.allow_tf32 = False
    ff = FFModel(FFConfig(batch_size=8, compute_dtype=dtype, seed=1,
                          momentum=0.9), device=gpu)
    t = ff.create_input((8, 32, 32, 3), name="image")
    t = ff.conv2d("conv1", t, 16, 3, 3, 1, 1, 1, 1, relu=False)
    t = ff.batch_norm("bn1", t, relu=True)
    t = ff.pool2d("pool1", t, 3, 3, 2, 2, 1, 1)
    t = dense_block(ff, "d1", t, 3, 8)
    t = transition(ff, "t1", t, 20)
    t = ff.pool2d("gap", t, 8, 8, 1, 1, 0, 0, pool_type="avg", relu=False)
    t = ff.flat("flat", t)
    t = ff.linear("fc", t, 10, relu=False)
    ff.softmax("softmax", t)
    rng = np.random.RandomState(4)
    image = rng.randn(8, 32, 32, 3).astype("float32")
    labels = rng.randint(0, 10, 8).astype("int32")

    def run():
        params, state = ff.init()
        opt = ff.init_opt_state(params)
        step = ff.make_train_step()
        losses = []
        for _ in range(3):
            params, state, opt, loss = step(params, state, opt, image,
                                            labels)
            losses.append(float(loss))
        return losses, state

    kernels.reset_launches()
    losses, state = run()
    torch.cuda.synchronize()
    assert dict(kernels.launches) == {
        bn_act.NAME_FWD: 21, bn_act.NAME_BWD: 21, bn_act.NAME_SUM: 21,
        maxpool.NAME_FWD: 3, maxpool.NAME_BWD: 3, avgpool.NAME: 6}
    assert all(np.isfinite(losses))
    assert state["bn1"]["mean"].dtype == torch.float32
    with _plain_cnn_kernels():
        kernels.reset_launches()
        ref, _ = run()
        assert sum(kernels.launches.values()) == 0
    assert losses[0] == ref[0]
    np.testing.assert_allclose(losses, ref,
                               rtol=1e-4 if dtype == "float32" else 2e-2)


@contextlib.contextmanager
def _plain_cnn_kernels():
    """Kernels 7-10 swapped for their plain versions."""
    from flexflow_tpu_torch.ops.kernels import bn_act

    saved = (maxpool.maxpool_fwd, maxpool.maxpool_bwd, avgpool.avgpool_bwd,
             bn_act.bn_act_fwd, bn_act.bn_act_bwd)
    maxpool.maxpool_fwd = maxpool.maxpool_fwd_plain
    maxpool.maxpool_bwd = maxpool.maxpool_bwd_plain
    avgpool.avgpool_bwd = avgpool.avgpool_bwd_plain
    bn_act.bn_act_fwd = bn_act.bn_act_fwd_plain
    bn_act.bn_act_bwd = bn_act.bn_act_bwd_plain
    try:
        yield
    finally:
        (maxpool.maxpool_fwd, maxpool.maxpool_bwd, avgpool.avgpool_bwd,
         bn_act.bn_act_fwd, bn_act.bn_act_bwd) = saved
