"""Stride-2 max pool with a selection-plane backward: the hand-written CUDA
kernels (``csrc/maxpool.cu``), their plain PyTorch versions and the
wrappers that pick between them by the tensors' device.

Port of ``flexflow_tpu/ops/pallas/maxpool.py``: ``maxpool_bwd`` replaces
the Pallas ``_bwd_kernel``; ``maxpool_fwd`` computes what that module's
``fwd_xla`` computes in plain XLA, in one pass.  Geometry: NHWC, stride 2,
square window k in {2, 3}, padding p in {0, 1} (-inf fill), optional
fused ReLU (:func:`supported`, the JAX gate).

* ``maxpool_fwd(x, k, p, relu) -> (y, sel)``: y the pooled output in x's
  dtype; sel (uint8, same shape) the window rank ``jh*k + jw`` of the
  FIRST max in window order, :data:`SENTINEL` where the fused ReLU clamps
  (max <= 0) or the window holds a NaN.
* ``maxpool_bwd(dy, sel, h, w, k, p) -> dx``: dx sums dy over the windows
  whose sel names each input position, in float32 in ascending rank
  order, cast once to dy's dtype.

:func:`maxpool2d` is the differentiable op (a ``torch.autograd.Function``
that saves only sel).  CPU tensors take the plain versions, CUDA tensors
the kernels; there is no fallback: a CUDA tensor the kernel does not take
raises.  A kernel thread takes 16 bytes of channels where C, dy's strides
and every pointer allow it, else one channel (:func:`kernels.vec_width`
picks; both are instances of one template).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.ops import kernels

NAME_FWD = "maxpool_fwd"
NAME_BWD = "maxpool_bwd"
SOURCE = "maxpool.cu"
SENTINEL = 255
DTYPES = (torch.float32, torch.bfloat16)
_MAX_ELEMENTS = 2 ** 31   # the kernels index with 32-bit ints


def supported(kh, kw, sh, sw, ph, pw, pool_type="max") -> bool:
    """The geometries the kernels take: the JAX gate
    (``flexflow_tpu/ops/pallas/maxpool.py:supported``) — stride 2 and
    3x3 pad 0 or 1, or 2x2 pad 0."""
    return (pool_type == "max" and (sh, sw) == (2, 2) and kh == kw
            and ph == pw and (kh, ph) in ((3, 0), (3, 1), (2, 0)))


def out_dim(size: int, k: int, p: int) -> int:
    return 1 + (size + 2 * p - k) // 2


def _windows(x, k, p):
    """The k*k strided window slices of x padded with -inf, in rank
    order, each (N, OH, OW, C)."""
    n, h, w, c = x.shape
    oh, ow = out_dim(h, k, p), out_dim(w, k, p)
    hp, wp = 2 * (oh - 1) + k, 2 * (ow - 1) + k
    xp = x.new_full((n, hp, wp, c), float("-inf"))
    xp[:, p:p + min(h, hp - p), p:p + min(w, wp - p)] = \
        x[:, :hp - p, :wp - p]
    return [xp[:, jh:jh + 2 * oh - 1:2, jw:jw + 2 * ow - 1:2]
            for jh in range(k) for jw in range(k)]


def maxpool_fwd_plain(x, k: int, p: int, relu: bool):
    """``(y, sel)`` in plain PyTorch: the max over the window slices, then
    the smallest rank whose slice equals it (float32 compares)."""
    wins = _windows(x, k, p)
    m = wins[0]
    for s in wins[1:]:
        m = torch.maximum(m, s)
    mf = m.float()
    sel = torch.full(m.shape, SENTINEL, dtype=torch.uint8, device=x.device)
    for rank in reversed(range(len(wins))):   # the smallest rank wins
        sel = sel.masked_fill(wins[rank].float() == mf, rank)
    if relu:
        sel = sel.masked_fill(~(mf > 0), SENTINEL)
        m = F.relu(m)
    return m, sel


def maxpool_bwd_plain(dy, sel, h: int, w: int, k: int, p: int):
    """dx in plain PyTorch: for each rank in ascending order, add dy where
    sel names it into the strided positions of a padded float32 plane."""
    n, oh, ow, c = dy.shape
    hp, wp = 2 * (oh - 1) + k, 2 * (ow - 1) + k
    acc = torch.zeros((n, max(hp, h + p), max(wp, w + p), c),
                      dtype=torch.float32, device=dy.device)
    g = dy.float()
    for jh in range(k):
        for jw in range(k):
            hit = torch.where(sel == jh * k + jw, g, torch.zeros_like(g))
            acc[:, jh:jh + 2 * oh - 1:2, jw:jw + 2 * ow - 1:2] += hit
    return acc[:, p:p + h, p:p + w].to(dy.dtype)


def _lib() -> ctypes.CDLL:
    lib = kernels.load(SOURCE)
    if lib.ff_maxpool_fwd.argtypes is None:
        lib.ff_maxpool_fwd.argtypes = [ctypes.c_void_p] * 3 \
            + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        lib.ff_maxpool_fwd.restype = ctypes.c_int
        lib.ff_maxpool_bwd.argtypes = [ctypes.c_void_p] * 3 \
            + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 3 \
            + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.ff_maxpool_bwd.restype = ctypes.c_int
    return lib


def _check_geometry(name, shape, k, p):
    if (k, p) not in ((3, 0), (3, 1), (2, 0)):
        raise ValueError(f"{name}: window {k} pad {p} not supported "
                         f"(3x3 pad 0/1 or 2x2 pad 0)")
    n, h, w, c = shape
    if n * h * w * c >= _MAX_ELEMENTS:
        raise ValueError(f"{name}: input plane {tuple(shape)} has 2^31 or "
                         f"more elements")
    if min(n, c, out_dim(h, k, p), out_dim(w, k, p)) <= 0:
        raise ValueError(f"{name}: empty output for input {tuple(shape)}")


def maxpool_fwd_cuda(x, k: int, p: int, relu: bool):
    """Launch the forward kernel on the current stream.  x (N, H, W, C)
    contiguous, float32 or bfloat16, on a CUDA device."""
    if not x.is_cuda:
        raise ValueError(f"{NAME_FWD}: x must be on a CUDA device, got "
                         f"{x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"{NAME_FWD}: dtype {x.dtype} not in {DTYPES}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{NAME_FWD}: x must be a contiguous NHWC tensor, "
                         f"got shape {tuple(x.shape)} strides {x.stride()}")
    _check_geometry(NAME_FWD, x.shape, k, p)
    n, h, w, c = x.shape
    oh, ow = out_dim(h, k, p), out_dim(w, k, p)
    y = torch.empty((n, oh, ow, c), dtype=x.dtype, device=x.device)
    sel = torch.empty((n, oh, ow, c), dtype=torch.uint8, device=x.device)
    isz = x.element_size()
    vec = kernels.vec_width(c, isz, (), ((x.data_ptr(), isz),
                                         (y.data_ptr(), isz),
                                         (sel.data_ptr(), 1)))
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.ff_maxpool_fwd(
            x.data_ptr(), y.data_ptr(), sel.data_ptr(), n, h, w, c, oh, ow,
            k, p, int(bool(relu)), int(x.dtype == torch.bfloat16), vec,
            stream)
    kernels.check(lib, code, NAME_FWD)
    kernels.launches[NAME_FWD] += 1
    return y, sel


def maxpool_bwd_cuda(dy, sel, h: int, w: int, k: int, p: int):
    """Launch the backward kernel on the current stream.  dy (N, OH, OW, C)
    float32 or bfloat16 with unit channel stride; sel uint8 of the same
    shape, contiguous, on dy's device."""
    if not (dy.is_cuda and sel.device == dy.device):
        raise ValueError(f"{NAME_BWD}: dy and sel must be on one CUDA "
                         f"device, got {dy.device}, {sel.device}")
    if dy.dtype not in DTYPES or sel.dtype != torch.uint8:
        raise ValueError(f"{NAME_BWD}: need dy in {DTYPES} and uint8 sel, "
                         f"got {dy.dtype}, {sel.dtype}")
    if dy.dim() != 4 or sel.shape != dy.shape:
        raise ValueError(f"{NAME_BWD}: dy {tuple(dy.shape)} and sel "
                         f"{tuple(sel.shape)} must be one NHWC shape")
    if dy.stride(3) != 1 or not sel.is_contiguous():
        raise ValueError(f"{NAME_BWD}: dy needs a unit channel stride and "
                         f"sel must be contiguous, got strides "
                         f"{dy.stride()}, {sel.stride()}")
    n, oh, ow, c = dy.shape
    _check_geometry(NAME_BWD, (n, h, w, c), k, p)
    if (oh, ow) != (out_dim(h, k, p), out_dim(w, k, p)):
        raise ValueError(f"{NAME_BWD}: dy {tuple(dy.shape)} is not the "
                         f"output of a {k}x{k}/2 pad {p} pool over "
                         f"{h}x{w}")
    dx = torch.empty((n, h, w, c), dtype=dy.dtype, device=dy.device)
    isz = dy.element_size()
    vec = kernels.vec_width(c, isz, dy.stride()[:3], (
        (dy.data_ptr(), isz), (sel.data_ptr(), 1), (dx.data_ptr(), isz)))
    lib = _lib()
    with torch.cuda.device(dy.device):
        stream = torch.cuda.current_stream(dy.device).cuda_stream
        code = lib.ff_maxpool_bwd(
            dy.data_ptr(), sel.data_ptr(), dx.data_ptr(), n, h, w, c, oh,
            ow, k, p, dy.stride(0), dy.stride(1), dy.stride(2),
            int(dy.dtype == torch.bfloat16), vec, stream)
    kernels.check(lib, code, NAME_BWD)
    kernels.launches[NAME_BWD] += 1
    return dx


def maxpool_fwd(x, k: int, p: int, relu: bool):
    """``(y, sel)``: the plain version for a CPU tensor, the CUDA kernel
    for a CUDA tensor, their shapes for a meta tensor, an error for
    anything else."""
    if kernels.on_meta(NAME_FWD, x):
        n, h, w, c = x.shape
        shape = (n, out_dim(h, k, p), out_dim(w, k, p), c)
        return x.new_empty(shape), x.new_empty(shape, dtype=torch.uint8)
    if x.device.type == "cpu":
        return maxpool_fwd_plain(x, k, p, relu)
    if x.device.type == "cuda":
        return maxpool_fwd_cuda(x, k, p, relu)
    raise ValueError(f"{NAME_FWD}: no implementation for device {x.device}")


def maxpool_bwd(dy, sel, h: int, w: int, k: int, p: int):
    """dx: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors, its shape for meta tensors, an error for anything else."""
    if kernels.on_meta(NAME_BWD, dy, sel):
        return dy.new_empty((dy.shape[0], h, w, dy.shape[3]))
    if dy.device.type == "cpu":
        if sel.device.type != "cpu":
            raise ValueError(f"{NAME_BWD}: dy and sel on different devices")
        return maxpool_bwd_plain(dy, sel, h, w, k, p)
    if dy.device.type == "cuda":
        return maxpool_bwd_cuda(dy, sel, h, w, k, p)
    raise ValueError(f"{NAME_BWD}: no implementation for device {dy.device}")


class _MaxPool2d(torch.autograd.Function):
    """Forward through :func:`maxpool_fwd`, saving only sel (the pool's
    input drops out of the residuals); backward through
    :func:`maxpool_bwd`.  Both are looked up when called, so a caller
    can swap in the plain versions for a reference run."""

    @staticmethod
    def forward(ctx, x, k, p, relu):
        y, sel = maxpool_fwd(x, k, p, relu)
        ctx.save_for_backward(sel)
        ctx.geometry = (x.shape[1], x.shape[2], k, p)
        return y

    @staticmethod
    def backward(ctx, dy):
        (sel,) = ctx.saved_tensors
        h, w, k, p = ctx.geometry
        if dy.stride(3) != 1:   # e.g. the expanded ones of a sum's grad
            dy = dy.contiguous()
        return maxpool_bwd(dy, sel, h, w, k, p), None, None, None


def maxpool2d(x, kh: int, kw: int, ph: int, pw: int, relu: bool = False):
    """Stride-2 max pool (optionally fused ReLU) of NHWC ``x``, with the
    JAX op's signature and gradient, first-max tie rule included."""
    if not supported(kh, kw, 2, 2, ph, pw):
        raise ValueError(f"max pool {kh}x{kw}/2 pad ({ph}, {pw}) is not a "
                         f"geometry of the kernel")
    return _MaxPool2d.apply(x, kh, ph, bool(relu))
