"""Flash attention: the hand-written CUDA kernels of the forward
(``csrc/flash_attention_fwd.cu``) and the backward
(``csrc/flash_attention_bwd.cu``), their plain PyTorch versions, the
wrappers that pick between them by the tensors' device, and the
differentiable op built from them.

Port of ``flexflow_tpu/ops/pallas/flash_attention.py``: the forward kernel
replaces the Pallas ``_fwd_kernel``, the two backward kernels replace
``_bwd_dkv_kernel`` (dk, dv) and ``_bwd_dq_kernel`` (dq).  The forward
returns ``(o, lse)``: o is the float32 attention output (B, H, Sq, d) and
lse the float32 per-row log-sum-exp (B, H, Sq) of the scaled scores,
``-inf`` for a fully masked row (whose o is 0).  Scores are
``(q . k) / sqrt(d)``; with ``causal`` query row i sees keys 0..i.  The
backward recomputes the probabilities from the saved lse and takes
``delta = rowsum(do * o)`` in float32 from a PyTorch reduction outside the
kernels, as the JAX package leaves it to XLA.

:func:`flash_attention_fwd` and :func:`flash_attention_bwd` run the plain
versions for tensors on the CPU and the kernels for tensors on a CUDA
device.  There is no fallback: a CUDA tensor the kernels do not take
raises.  Any head dim up to 128 is taken: q, k and v are zero-padded
along d to the smallest head dim the kernels are built for
(:func:`padded_head_dim`), the kernels scale the scores by the true
``1/sqrt(d)``, and o, dq, dk and dv are sliced back to d; zero columns
change no score, as in the JAX package's ``_make_flash``.  The plain
versions take the same padded path on the CPU.  :func:`flash_attention`
is the differentiable op (the
``FlashAttention`` autograd function); it looks both up when called, so a
caller can swap in the plain versions for a reference run.
:func:`flash_attention_partial` is its partial form, the step of ring
attention (``flash_attention.py:385``): ``(o, lse)`` over one K/V chunk,
differentiable in both (the lse cotangent folds into delta, kernels 2-3
unchanged), and :func:`combine_partials` merges two such partials.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.ops import kernels

NAME = "flash_attention_fwd"
SOURCE = "flash_attention_fwd.cu"
NAME_DKV = "flash_attention_bwd_dkv"
NAME_DQ = "flash_attention_bwd_dq"
SOURCE_BWD = "flash_attention_bwd.cu"
#: head dims the forward kernel and the backward kernels are instantiated
#: for
HEAD_DIMS_FWD = (8, 16, 32, 64, 128)
HEAD_DIMS_BWD = HEAD_DIMS_FWD
DTYPES = (torch.float32, torch.bfloat16)


def padded_head_dim(d: int) -> int:
    """The smallest head dim in :data:`HEAD_DIMS_FWD` that is >= ``d``;
    ValueError above the largest."""
    for hd in HEAD_DIMS_FWD:
        if d <= hd:
            return hd
    raise ValueError(f"head dim {d} is above {HEAD_DIMS_FWD[-1]}, the "
                     f"largest the flash kernels are built for")


def _pad_head_dim(dp, *ts):
    """Each of ``ts`` zero-padded along its last dim to ``dp``."""
    return [t if t.shape[-1] == dp else F.pad(t, (0, dp - t.shape[-1]))
            for t in ts]


def _scale(d, scale):
    return 1.0 / math.sqrt(d) if scale is None else scale


def flash_attention_fwd_plain(q, k, v, causal: bool = False, scale=None):
    """The same function in plain PyTorch, computed in float32 with the
    whole score matrix materialized; ``scale`` defaults to
    ``1/sqrt(d)``."""
    d = q.shape[-1]
    sq, sk = q.shape[2], k.shape[2]
    if sk == 0:  # no keys: every row fully masked
        return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
                torch.full(q.shape[:3], float("-inf"), device=q.device))
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * _scale(d, scale)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(qpos < kpos, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    finite = torch.isfinite(m)
    safe_m = torch.where(finite, m, torch.zeros_like(m))
    p = torch.exp(s - safe_m)            # masked scores give exactly 0
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p, v.float()) / denom
    lse = torch.where(finite, safe_m + torch.log(denom),
                      torch.full_like(m, float("-inf")))
    return o, lse.squeeze(-1)


def _lib() -> ctypes.CDLL:
    lib = kernels.load(SOURCE)
    fn = lib.ff_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ff_flash_attention_fwd_smem.argtypes = [ctypes.c_int] * 2
        lib.ff_flash_attention_fwd_smem.restype = ctypes.c_int
    return lib


def _check_qkv(name, q, k, v, head_dims):
    """Raise unless q (B, H, Sq, d) and k, v (B, H, Sk, d) are contiguous,
    16-byte aligned, of one dtype (float32 or bfloat16) and on one CUDA
    device, with a head dim in ``head_dims``."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{name}: q, k, v must be on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k, v must share a dtype in {DTYPES}, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"{name}: need q (B,H,Sq,d) and k, v (B,H,Sk,d), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[3] not in head_dims:
        raise ValueError(f"{name}: head dim {q.shape[3]} not in {head_dims}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k, v must be 16-byte aligned")


def flash_attention_fwd_cuda(q, k, v, causal: bool = False, scale=None):
    """Launch the CUDA kernel on the current stream.  q (B, H, Sq, d) and
    k, v (B, H, Sk, d), contiguous, one dtype (float32 or bfloat16), on
    one CUDA device, head dim in :data:`HEAD_DIMS_FWD`; the scores are
    scaled by ``scale`` (default ``1/sqrt(d)``)."""
    _check_qkv(NAME, q, k, v, HEAD_DIMS_FWD)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    o = torch.empty((b, h, sq, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if b * h == 0 or sq == 0:
        return o, lse
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.ff_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b * h, sq, sk, d, int(bool(causal)),
            int(q.dtype == torch.bfloat16), _scale(d, scale), stream)
    kernels.check(lib, code, NAME)
    kernels.count(NAME)
    return o, lse


def flash_attention_fwd(q, k, v, causal: bool = False):
    """``(o, lse)`` of attention at any head dim up to 128, through the
    head-dim padding: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors, their shapes for meta tensors, an error for
    anything else."""
    if kernels.on_meta(NAME, q, k, v):
        return (q.new_empty(q.shape[:3] + v.shape[3:], dtype=torch.float32),
                q.new_empty(q.shape[:3], dtype=torch.float32))
    if q.device.type == "cpu":
        if k.device.type != "cpu" or v.device.type != "cpu":
            raise ValueError(f"{NAME}: q, k, v on different devices")
        run = flash_attention_fwd_plain
    elif q.device.type == "cuda":
        run = flash_attention_fwd_cuda
    else:
        raise ValueError(f"{NAME}: no implementation for device {q.device}")
    d = q.shape[-1]
    dp = padded_head_dim(d)
    o, lse = run(*_pad_head_dim(dp, q, k, v), causal, 1.0 / math.sqrt(d))
    return (o if dp == d else o[..., :d].contiguous()), lse


# ---------------------------------------------------------------------------
# backward


def _delta(do, o, g_lse):
    """``rowsum(do * o)`` in float32 (B, H, Sq), less the lse cotangent
    ``g_lse`` of the partial form (``flash_attention.py:326-331``): then
    ds = p (dp - delta + g_lse)."""
    delta = (do.float() * o).sum(dim=-1)
    return delta if g_lse is None else delta - g_lse.float()


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = False,
                              scale=None, g_lse=None):
    """``(dq, dk, dv)`` in float32, in plain PyTorch with the whole score
    matrix materialized: p recomputed from the saved lse (a fully masked
    row, lse = -inf, read as lse = 0), ``delta = rowsum(do * o)`` in
    float32 (less ``g_lse``, the cotangent of lse, where given), and
    ``do`` cast to q's dtype before the products, as the Pallas
    backward's caller does (``flash_attention.py:320-331``).  With
    bfloat16 inputs p and ds are rounded to the operand dtype before the
    products that read them, as the Pallas kernels cast them.  ``scale``
    defaults to ``1/sqrt(d)``."""
    d = q.shape[-1]
    scale = _scale(d, scale)
    sq, sk = q.shape[2], k.shape[2]
    dof = do.float()
    delta = _delta(do, o, g_lse)[..., None]
    do_k = dof.to(q.dtype).float()
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    valid = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        valid = qpos >= kpos
    lse = lse[..., None]
    safe_lse = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    p = torch.where(valid, torch.exp(s - safe_lse), torch.zeros_like(s))
    dp = torch.matmul(do_k, vf.transpose(-1, -2))
    ds = p * (dp - delta) * scale
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), do_k)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), qf)
    dq = torch.matmul(ds.to(k.dtype).float(), kf)
    return dq, dk, dv


def _lib_bwd() -> ctypes.CDLL:
    lib = kernels.load(SOURCE_BWD)
    if lib.ff_flash_attention_bwd_dkv.argtypes is None:
        lib.ff_flash_attention_bwd_dkv.argtypes = [ctypes.c_void_p] * 8 \
            + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
        lib.ff_flash_attention_bwd_dkv.restype = ctypes.c_int
        lib.ff_flash_attention_bwd_dq.argtypes = [ctypes.c_void_p] * 7 \
            + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
        lib.ff_flash_attention_bwd_dq.restype = ctypes.c_int
        lib.ff_flash_attention_bwd_smem.argtypes = [ctypes.c_int] * 3
        lib.ff_flash_attention_bwd_smem.restype = ctypes.c_int
    return lib


def _check_bwd(name, q, k, v, do_k, lse, delta):
    _check_qkv(name, q, k, v, HEAD_DIMS_BWD)
    rows = q.shape[:3]
    if do_k.shape != q.shape or do_k.dtype != q.dtype \
            or do_k.device != q.device or not do_k.is_contiguous():
        raise ValueError(f"{name}: do must be a contiguous {q.dtype} tensor "
                         f"of q's shape {tuple(q.shape)} on {q.device}")
    for what, t in (("lse", lse), ("delta", delta)):
        if t.shape != rows or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous float32 "
                             f"{tuple(rows)} tensor on {q.device}")


def flash_attention_bwd_dkv_cuda(q, k, v, do_k, lse, delta,
                                 causal: bool = False, scale=None):
    """Launch the dk/dv kernel on the current stream: ``(dk, dv)`` float32
    of k's shape.  ``do_k`` is the output cotangent in q's dtype, lse the
    forward's, delta ``rowsum(do * o)`` in float32 (B, H, Sq); ``scale``
    as the forward's."""
    _check_bwd(NAME_DKV, q, k, v, do_k, lse, delta)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    if b * h == 0 or sk == 0:
        return dk, dv
    lib = _lib_bwd()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.ff_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do_k.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b * h, sq, sk, d, int(bool(causal)),
            int(q.dtype == torch.bfloat16), _scale(d, scale), stream)
    kernels.check(lib, code, NAME_DKV)
    kernels.count(NAME_DKV)
    return dk, dv


def flash_attention_bwd_dq_cuda(q, k, v, do_k, lse, delta,
                                causal: bool = False, scale=None):
    """Launch the dq kernel on the current stream: dq float32 of q's
    shape; the inputs as for :func:`flash_attention_bwd_dkv_cuda`."""
    _check_bwd(NAME_DQ, q, k, v, do_k, lse, delta)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if b * h == 0 or sq == 0:
        return dq
    lib = _lib_bwd()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.ff_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do_k.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b * h, sq, sk,
            d, int(bool(causal)), int(q.dtype == torch.bfloat16),
            _scale(d, scale), stream)
    kernels.check(lib, code, NAME_DQ)
    kernels.count(NAME_DQ)
    return dq


def flash_attention_bwd_cuda(q, k, v, o, lse, do, causal: bool = False,
                             scale=None, g_lse=None):
    """``(dq, dk, dv)`` float32 through the two backward kernels; delta
    (less ``g_lse`` where given) and the cast of ``do`` to q's dtype are
    PyTorch ops before them."""
    delta = _delta(do, o, g_lse).contiguous()
    do_k = do.to(q.dtype).contiguous()
    lse = lse.contiguous()
    dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, do_k, lse, delta, causal,
                                          scale)
    dq = flash_attention_bwd_dq_cuda(q, k, v, do_k, lse, delta, causal,
                                     scale)
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = False,
                        g_lse=None):
    """``(dq, dk, dv)`` float32 at any head dim up to 128, through the
    head-dim padding: the plain version for CPU tensors, the CUDA kernels
    for CUDA tensors, an error for anything else.  ``g_lse`` (B, H, Sq),
    the cotangent of the forward's lse, is the partial form's
    (:func:`flash_attention_partial`); None is zero.  Meta tensors get
    the gradients' shapes."""
    if kernels.on_meta(NAME_DKV, q, k, v, o, lse, do):
        return tuple(t.new_empty(t.shape, dtype=torch.float32)
                     for t in (q, k, v))
    if q.device.type == "cpu":
        if any(t.device.type != "cpu" for t in (k, v, o, lse, do)):
            raise ValueError(f"{NAME_DKV}: inputs on different devices")
        run = flash_attention_bwd_plain
    elif q.device.type == "cuda":
        run = flash_attention_bwd_cuda
    else:
        raise ValueError(
            f"{NAME_DKV}: no implementation for device {q.device}")
    d = q.shape[-1]
    dp = padded_head_dim(d)
    q, k, v, o, do = _pad_head_dim(dp, q, k, v, o, do)
    extra = {} if g_lse is None else {"g_lse": g_lse}
    grads = run(q, k, v, o, lse, do, causal, 1.0 / math.sqrt(d), **extra)
    return tuple(g if dp == d else g[..., :d].contiguous() for g in grads)


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) in float32.  The forward runs
    :func:`flash_attention_fwd` and saves q, k, v, o and lse; the backward
    runs :func:`flash_attention_bwd` and returns dq, dk, dv in the input
    dtypes (``flash_attention.py:332-334``).  Both are looked up when
    called."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def flash_attention(q, k, v, causal: bool = False):
    """softmax(q kᵀ / sqrt(d) [+ causal mask]) v as float32 (B, H, Sq, d),
    differentiable in q, k and v: the JAX package's ``flash_attention``."""
    return FlashAttention.apply(q, k, v, bool(causal))


# ---------------------------------------------------------------------------
# the partial form (ring attention's step)


class FlashAttentionPartial(torch.autograd.Function):
    """``(o, lse)`` of attention over one K/V chunk, differentiable in
    both outputs (``flash_attention.py:385``): the forward is
    :func:`flash_attention_fwd`; the backward folds the lse cotangent
    into delta and runs :func:`flash_attention_bwd`, kernels 2-3
    unchanged (``flash_attention.py:318-331``).  Their launches count as
    ``<name>.partial`` (``kernels.counted_as``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        with kernels.counted_as("partial"):
            o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o, lse

    @staticmethod
    def backward(ctx, do, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        with kernels.counted_as("partial"):
            dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                             ctx.causal, g_lse=g_lse)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def flash_attention_partial(q, k, v, causal: bool = False):
    """Attention of q (B, H, Sq, d) over one K/V chunk (B, H, Sk, d), Sq
    and Sk free: ``(o, lse)``, o the chunk-normalized float32 output and
    lse (B, H, Sq) the float32 log-sum-exp of its scaled scores (-inf, o
    = 0, for a row with no visible key).  Partials over disjoint key sets
    merge exactly by :func:`combine_partials`."""
    return FlashAttentionPartial.apply(q, k, v, bool(causal))


def combine_partials(o1, lse1, o2, lse2):
    """Merge two chunk-normalized partial attentions by log-sum-exp weight
    into the softmax over the union of their key sets
    (``flash_attention.py:401-414``).  A fully masked partial (lse = -inf,
    o = 0) drops out; two give o = 0, lse = -inf.  Every ``exp`` and
    ``log`` reads a finite argument (the max is made safe first), so no
    gradient through a masked branch is NaN."""
    m = torch.maximum(lse1, lse2)
    safe_m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    zero = torch.zeros_like(m)
    w1 = torch.where(torch.isfinite(lse1),
                     torch.exp(torch.where(torch.isfinite(lse1), lse1,
                                           safe_m) - safe_m), zero)
    w2 = torch.where(torch.isfinite(lse2),
                     torch.exp(torch.where(torch.isfinite(lse2), lse2,
                                           safe_m) - safe_m), zero)
    tot = w1 + w2
    denom = torch.clamp(tot, min=1e-30)
    lse = torch.where(tot > 0, safe_m + torch.log(denom),
                      torch.full_like(m, float("-inf")))
    o = (o1 * w1[..., None] + o2 * w2[..., None]) / denom[..., None]
    return o, lse
