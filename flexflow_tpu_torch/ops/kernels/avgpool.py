"""Non-overlapping average pool with a block-upsample backward: the
hand-written CUDA kernel (``csrc/avgpool_bwd.cu``), its plain PyTorch
version and the wrapper that picks between them by the tensors' device.

Port of ``flexflow_tpu/ops/pallas/avgpool.py``: ``avgpool_bwd`` replaces
the Pallas ``_bwd_kernel``.  For the geometries :func:`supported` admits
(the JAX gate: padding 0 and windows that tile the input exactly, or the
global pool) every input position lies in one window, so

    dx[n,h,w,c] = dy[n, h // kh, w // kw, c] / (kh * kw)

masked by ``y > 0`` where the ReLU is fused, in float32, cast once.  The
forward, plain XLA in the JAX package, is plain PyTorch here: a float32
sum over each window times 1/(kh*kw), cast to x's dtype.

:func:`avgpool2d` is the differentiable op (a ``torch.autograd.Function``
that saves only the pooled output, and only when the ReLU is fused).
CPU tensors take the plain version, CUDA tensors the kernel; there is no
fallback: a CUDA tensor the kernel does not take raises.  A kernel thread
takes 16 bytes of channels where C, dy's strides and every pointer allow
it, else one channel (:func:`kernels.vec_width` picks).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.ops import kernels

NAME = "avgpool_bwd"
SOURCE = "avgpool_bwd.cu"
DTYPES = (torch.float32, torch.bfloat16)
_MAX_ELEMENTS = 2 ** 31   # the kernel indexes with 32-bit ints


def supported(kh, kw, sh, sw, ph, pw, h, w, pool_type="avg") -> bool:
    """The JAX gate (``flexflow_tpu/ops/pallas/avgpool.py:supported``):
    unpadded windows that tile the input exactly, or the global pool."""
    if pool_type != "avg" or (ph, pw) != (0, 0):
        return False
    if (kh, kw) == (h, w):
        return True
    return (sh, sw) == (kh, kw) and h % kh == 0 and w % kw == 0


def avgpool_fwd(x, kh: int, kw: int, relu: bool):
    """The pooled output of an exact tiling: float32 window sums times
    1/(kh*kw), cast to x's dtype, then the optional ReLU."""
    n, h, w, c = x.shape
    s = x.float().reshape(n, h // kh, kh, w // kw, kw, c).sum(dim=(2, 4))
    y = (s * (1.0 / (kh * kw))).to(x.dtype)
    return F.relu(y) if relu else y


def avgpool_bwd_plain(dy, y, kh: int, kw: int):
    """dx in plain PyTorch: dy masked by ``y > 0`` (when ``y`` is given),
    times 1/(kh*kw) in float32, repeated over each window."""
    g = dy.float()
    if y is not None:
        g = torch.where(y.float() > 0, g, torch.zeros_like(g))
    g = g * (1.0 / (kh * kw))
    dx = g.repeat_interleave(kh, dim=1).repeat_interleave(kw, dim=2)
    return dx.to(dy.dtype)


def _lib() -> ctypes.CDLL:
    lib = kernels.load(SOURCE)
    if lib.ff_avgpool_bwd.argtypes is None:
        lib.ff_avgpool_bwd.argtypes = [ctypes.c_void_p] * 3 \
            + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 3 \
            + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.ff_avgpool_bwd.restype = ctypes.c_int
    return lib


def avgpool_bwd_cuda(dy, y, kh: int, kw: int):
    """Launch the kernel on the current stream.  dy (N, OH, OW, C) float32
    or bfloat16 with unit channel stride; y, when given, dy's shape and
    dtype, contiguous, on dy's device."""
    if not dy.is_cuda or (y is not None and y.device != dy.device):
        raise ValueError(f"{NAME}: dy (and y) must be on one CUDA device")
    if dy.dtype not in DTYPES or (y is not None and y.dtype != dy.dtype):
        raise ValueError(f"{NAME}: need dy (and y) of one dtype in "
                         f"{DTYPES}, got {dy.dtype}"
                         f"{'' if y is None else f', {y.dtype}'}")
    if dy.dim() != 4 or (y is not None and y.shape != dy.shape):
        raise ValueError(f"{NAME}: dy must be NHWC and y of its shape")
    if dy.stride(3) != 1 or (y is not None and not y.is_contiguous()):
        raise ValueError(f"{NAME}: dy needs a unit channel stride and y "
                         f"must be contiguous, got strides {dy.stride()}")
    n, oh, ow, c = dy.shape
    h, w = oh * kh, ow * kw
    if min(n, oh, ow, c, kh, kw) <= 0 or n * h * w * c >= _MAX_ELEMENTS:
        raise ValueError(f"{NAME}: unsupported shape {tuple(dy.shape)} with "
                         f"window {kh}x{kw}")
    dx = torch.empty((n, h, w, c), dtype=dy.dtype, device=dy.device)
    isz = dy.element_size()
    planes = (dy, dx) if y is None else (dy, y, dx)
    vec = kernels.vec_width(c, isz, dy.stride()[:3],
                            [(t.data_ptr(), isz) for t in planes])
    lib = _lib()
    with torch.cuda.device(dy.device):
        stream = torch.cuda.current_stream(dy.device).cuda_stream
        code = lib.ff_avgpool_bwd(
            dy.data_ptr(), None if y is None else y.data_ptr(),
            dx.data_ptr(), n, h, w, c, oh, ow, kh, kw, dy.stride(0),
            dy.stride(1), dy.stride(2), int(dy.dtype == torch.bfloat16), vec,
            stream)
    kernels.check(lib, code, NAME)
    kernels.launches[NAME] += 1
    return dx


def avgpool_bwd(dy, y, kh: int, kw: int):
    """dx: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors, its shape for meta tensors, an error for anything else."""
    if kernels.on_meta(NAME, dy, y):
        n, oh, ow, c = dy.shape
        return dy.new_empty((n, oh * kh, ow * kw, c))
    if dy.device.type == "cpu":
        if y is not None and y.device.type != "cpu":
            raise ValueError(f"{NAME}: dy and y on different devices")
        return avgpool_bwd_plain(dy, y, kh, kw)
    if dy.device.type == "cuda":
        return avgpool_bwd_cuda(dy, y, kh, kw)
    raise ValueError(f"{NAME}: no implementation for device {dy.device}")


class _AvgPool2d(torch.autograd.Function):
    """Forward through :func:`avgpool_fwd`, saving the pooled output only
    for the ReLU mask; backward through :func:`avgpool_bwd`, looked up
    when called, so a caller can swap in the plain version for a
    reference run."""

    @staticmethod
    def forward(ctx, x, kh, kw, relu):
        y = avgpool_fwd(x, kh, kw, relu)
        if relu:
            ctx.save_for_backward(y)
        ctx.window = (kh, kw, relu)
        return y

    @staticmethod
    def backward(ctx, dy):
        kh, kw, relu = ctx.window
        y = ctx.saved_tensors[0] if relu else None
        if dy.stride(3) != 1:   # e.g. the expanded ones of a sum's grad
            dy = dy.contiguous()
        return avgpool_bwd(dy, y, kh, kw), None, None, None


def avgpool2d(x, kh: int, kw: int, sh: int, sw: int, ph: int, pw: int,
              relu: bool = False):
    """Non-overlapping average pool (optionally fused ReLU) of NHWC ``x``,
    with the JAX op's signature and gradient."""
    n, h, w, c = x.shape
    if not supported(kh, kw, sh, sw, ph, pw, h, w):
        raise ValueError(f"avg pool {kh}x{kw}/({sh}, {sw}) pad ({ph}, {pw}) "
                         f"over {h}x{w} does not tile the input exactly")
    return _AvgPool2d.apply(x, kh, kw, bool(relu))
