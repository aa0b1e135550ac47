"""Fused batch-norm normalize + ReLU with a one-pass backward: the
hand-written CUDA kernels (``csrc/bn_act.cu``), their plain PyTorch
versions and the wrappers that pick between them by the tensors' device.

Port of ``flexflow_tpu/ops/pallas/bn_act.py``: kernel 9 replaces the
Pallas ``_fwd_kernel`` and kernel 10 its ``_bwd_kernel``.  Over x
flattened to (M, C) with BatchNorm's folded float32 (C,) vectors inv and
shift:

    y        = relu(x * inv + shift)            float32, cast once to x's dtype
    g'       = g where x * inv + shift > 0      (the mask recomputed from x)
    dx       = g' * inv                         cast to x's dtype
    d_inv    = sum over M of g' * x             float32
    d_shift  = sum over M of g'                 float32

Kernel 10 is two launches: ``bn_act_bwd`` writes dx and one row of
float32 partial sums per block of rows, ``bn_act_bwd_sum`` adds those rows
in a fixed order (Hopper's blocks run in no order, and no atomics are
used, so the sums are the same in every run).

:func:`bn_act` is the differentiable op (``_BnAct``, a
``torch.autograd.Function`` that saves x, inv and shift, never y).  CPU
tensors take the plain versions, CUDA tensors the kernels; there is no
fallback: a CUDA tensor the kernels do not take raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from flexflow_tpu_torch.ops import kernels

NAME_FWD = "bn_act_fwd"
NAME_BWD = "bn_act_bwd"
NAME_SUM = "bn_act_bwd_sum"
SOURCE = "bn_act.cu"
DTYPES = (torch.float32, torch.bfloat16)
THREADS = 256          # threads of a block of kernel 9 or 10's first pass
BLOCKS_PER_SM = 8      # blocks the tiling aims at per multiprocessor
MIN_ROWS = 4           # rows each row thread walks at least, where M allows


def _pick_bm(m: int):
    """Largest power-of-two row block (>= 8) dividing m (the JAX gate's)."""
    for bm in (1024, 512, 256, 128, 64, 32, 16, 8):
        if m % bm == 0:
            return bm
    return None


def supported(n, h, w, c) -> bool:
    """The JAX gate (``flexflow_tpu/ops/pallas/bn_act.py:supported``): the
    row count n*h*w has a power-of-two divisor of at least 8.  The CUDA
    kernels take any M; the gate decides BatchNorm's route, as in JAX."""
    return _pick_bm(n * h * w) is not None


def bn_act_fwd_plain(x2, inv, shift, relu: bool):
    """y in plain PyTorch: float32 multiply, then add, then the optional
    ReLU, cast once to x's dtype."""
    y = x2.float() * inv + shift
    if relu:
        y = torch.relu(y)
    return y.to(x2.dtype)


def bn_act_bwd_plain(x2, inv, shift, g2, relu: bool):
    """(dx, d_inv, d_shift) in plain PyTorch, all float32, dx cast to x's
    dtype."""
    x = x2.float()
    g = g2.float()
    if relu:
        g = torch.where(x * inv + shift > 0, g, torch.zeros_like(g))
    dx = (g * inv).to(x2.dtype)
    return dx, (g * x).sum(dim=0), g.sum(dim=0)


def tiling(m: int, c: int, vec: int, sms: int):
    """``(tx, ty, rows_per_block, row_blocks)`` of the kernels' grid over
    (m, c): tx column threads of ``vec`` channels each (at most 32), ty
    row threads filling a 256-thread block, and rows cut into blocks so
    that about ``BLOCKS_PER_SM`` blocks land on each of ``sms``
    multiprocessors while each row thread walks at least ``MIN_ROWS`` rows
    where m allows.  ``rows_per_block`` is a multiple of ty."""
    cols = c // vec
    tx = min(cols, 32)
    ty = THREADS // tx
    ctiles = -(-cols // tx)
    want = max(1, -(-BLOCKS_PER_SM * sms // ctiles))
    most = max(1, -(-m // (MIN_ROWS * ty)))
    rows = -(-m // min(want, most))
    rows = -(-rows // ty) * ty
    return tx, ty, rows, -(-m // rows)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _vec(c: int, dtype, *tensors) -> int:
    """Channels per column thread: 16 bytes of them where C and every
    tensor's address allow, else 1."""
    vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    if c % vec == 0 and all(t.data_ptr() % 16 == 0 for t in tensors):
        return vec
    return 1


def _lib() -> ctypes.CDLL:
    lib = kernels.load(SOURCE)
    if lib.ff_bn_act_fwd.argtypes is None:
        tail = [ctypes.c_longlong] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.ff_bn_act_fwd.argtypes = [ctypes.c_void_p] * 4 + tail
        lib.ff_bn_act_fwd.restype = ctypes.c_int
        lib.ff_bn_act_bwd_partial.argtypes = [ctypes.c_void_p] * 7 + tail
        lib.ff_bn_act_bwd_partial.restype = ctypes.c_int
        lib.ff_bn_act_bwd_sum.argtypes = [ctypes.c_void_p] * 4 \
            + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.ff_bn_act_bwd_sum.restype = ctypes.c_int
    return lib


def _check(what: str, x2, inv, shift, g2=None) -> None:
    """Raise unless the kernels take these operands: x (and dy) (M, C)
    float32 or bfloat16 of one dtype, inv and shift (C,) float32, all
    contiguous on one CUDA device."""
    ts = [x2, inv, shift] + ([] if g2 is None else [g2])
    if not x2.is_cuda or any(t.device != x2.device for t in ts):
        raise ValueError(f"{what}: x, inv, shift (and dy) must be on one "
                         f"CUDA device")
    if x2.dtype not in DTYPES or (g2 is not None and g2.dtype != x2.dtype):
        raise ValueError(f"{what}: need x (and dy) of one dtype in {DTYPES}, "
                         f"got {x2.dtype}"
                         f"{'' if g2 is None else f', {g2.dtype}'}")
    if inv.dtype != torch.float32 or shift.dtype != torch.float32:
        raise ValueError(f"{what}: inv and shift must be float32 (dtype "
                         f"{inv.dtype}, {shift.dtype})")
    if x2.dim() != 2 or min(x2.shape) <= 0 or \
            inv.shape != (x2.shape[1],) or shift.shape != inv.shape or \
            (g2 is not None and g2.shape != x2.shape):
        raise ValueError(f"{what}: need x (M, C) with M, C > 0, inv and "
                         f"shift (C,) and dy of x's shape, got "
                         f"{tuple(x2.shape)}, {tuple(inv.shape)}, "
                         f"{tuple(shift.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what}: operands must be contiguous")


def _grid(x2, *tensors):
    m, c = x2.shape
    vec = _vec(c, x2.dtype, x2, *tensors)
    tx, ty, rows, row_blocks = tiling(m, c, vec, _sm_count(x2.device.index))
    return m, c, vec, tx, ty, rows, row_blocks


def bn_act_fwd_cuda(x2, inv, shift, relu: bool):
    """Launch kernel 9 on the current stream: y of x's shape and dtype."""
    _check(NAME_FWD, x2, inv, shift)
    y = torch.empty_like(x2)
    m, c, vec, tx, ty, rows, _ = _grid(x2, y)
    lib = _lib()
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        code = lib.ff_bn_act_fwd(
            x2.data_ptr(), inv.data_ptr(), shift.data_ptr(), y.data_ptr(),
            m, c, vec, tx, ty, rows, int(relu),
            int(x2.dtype == torch.bfloat16), stream)
    kernels.check(lib, code, NAME_FWD)
    kernels.launches[NAME_FWD] += 1
    return y


def bn_act_bwd_partial_cuda(x2, inv, shift, g2, relu: bool):
    """Launch kernel 10's first pass: ``(dx, part_inv, part_shift)``, the
    partial sums one float32 row per block of rows."""
    _check(NAME_BWD, x2, inv, shift, g2)
    dx = torch.empty_like(x2)
    m, c, vec, tx, ty, rows, row_blocks = _grid(x2, g2, dx)
    part_inv = torch.empty((row_blocks, c), dtype=torch.float32,
                           device=x2.device)
    part_shift = torch.empty_like(part_inv)
    lib = _lib()
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        code = lib.ff_bn_act_bwd_partial(
            x2.data_ptr(), inv.data_ptr(), shift.data_ptr(), g2.data_ptr(),
            dx.data_ptr(), part_inv.data_ptr(), part_shift.data_ptr(), m, c,
            vec, tx, ty, rows, int(relu), int(x2.dtype == torch.bfloat16),
            stream)
    kernels.check(lib, code, NAME_BWD)
    kernels.launches[NAME_BWD] += 1
    return dx, part_inv, part_shift


def bn_act_bwd_sum_cuda(part_inv, part_shift):
    """Launch kernel 10's finishing pass: ``(d_inv, d_shift)``, the column
    sums of two (P, C) float32 workspaces, each column added in a fixed
    order."""
    if not part_inv.is_cuda or part_shift.device != part_inv.device or \
            part_inv.dtype != torch.float32 or \
            part_shift.dtype != torch.float32 or part_inv.dim() != 2 or \
            part_shift.shape != part_inv.shape or min(part_inv.shape) <= 0 \
            or not (part_inv.is_contiguous() and part_shift.is_contiguous()):
        raise ValueError(f"{NAME_SUM}: need two contiguous (P, C) float32 "
                         f"workspaces on one CUDA device")
    p, c = part_inv.shape
    d_inv = torch.empty((c,), dtype=torch.float32, device=part_inv.device)
    d_shift = torch.empty_like(d_inv)
    lib = _lib()
    with torch.cuda.device(part_inv.device):
        stream = torch.cuda.current_stream(part_inv.device).cuda_stream
        code = lib.ff_bn_act_bwd_sum(part_inv.data_ptr(),
                                     part_shift.data_ptr(), d_inv.data_ptr(),
                                     d_shift.data_ptr(), p, c, stream)
    kernels.check(lib, code, NAME_SUM)
    kernels.launches[NAME_SUM] += 1
    return d_inv, d_shift


def bn_act_bwd_cuda(x2, inv, shift, g2, relu: bool):
    """Kernel 10: ``(dx, d_inv, d_shift)`` from its two launches."""
    dx, part_inv, part_shift = bn_act_bwd_partial_cuda(x2, inv, shift, g2,
                                                       relu)
    return (dx,) + bn_act_bwd_sum_cuda(part_inv, part_shift)


def _route(what: str, x2, *others) -> str:
    if x2.device.type == "cpu":
        if any(t.device.type != "cpu" for t in others):
            raise ValueError(f"{what}: operands on different devices")
        return "cpu"
    if x2.device.type == "cuda":
        return "cuda"
    raise ValueError(f"{what}: no implementation for device {x2.device}")


def bn_act_fwd(x2, inv, shift, relu: bool):
    """y: the plain version for CPU tensors, kernel 9 for CUDA tensors, an
    error for anything else."""
    if _route(NAME_FWD, x2, inv, shift) == "cpu":
        return bn_act_fwd_plain(x2, inv, shift, relu)
    return bn_act_fwd_cuda(x2, inv, shift, relu)


def bn_act_bwd(x2, inv, shift, g2, relu: bool):
    """(dx, d_inv, d_shift): the plain version for CPU tensors, kernel 10
    for CUDA tensors, an error for anything else."""
    if _route(NAME_BWD, x2, inv, shift, g2) == "cpu":
        return bn_act_bwd_plain(x2, inv, shift, g2, relu)
    return bn_act_bwd_cuda(x2, inv, shift, g2, relu)


class _BnAct(torch.autograd.Function):
    """Forward through :func:`bn_act_fwd`, saving (x, inv, shift) and never
    y; backward through :func:`bn_act_bwd`, returning dx and both sums so
    that autograd carries d_inv and d_shift into scale, bias, mean and
    var.  Both are looked up when called, so a caller can swap in the
    plain versions for a reference run."""

    @staticmethod
    def forward(ctx, x2, inv, shift, relu):
        ctx.save_for_backward(x2, inv, shift)
        ctx.relu = relu
        return bn_act_fwd(x2, inv, shift, relu)

    @staticmethod
    def backward(ctx, g2):
        x2, inv, shift = ctx.saved_tensors
        dx, d_inv, d_shift = bn_act_bwd(x2, inv, shift, g2.contiguous(),
                                        ctx.relu)
        return dx, d_inv, d_shift, None


def bn_act(x, inv, shift, relu: bool = True):
    """Fused per-channel scale-shift(-ReLU) of NHWC ``x``, the JAX
    ``bn_act``'s signature and gradient: ``relu(x * inv + shift)`` with a
    one-pass backward that yields dx and both per-channel sums.  ``inv``
    and ``shift`` are BatchNorm's folded (C,) vectors, taken in float32."""
    n, h, w, c = x.shape
    if not supported(n, h, w, c):
        raise ValueError(f"bn_act: {n}*{h}*{w} rows have no power-of-two "
                         f"divisor >= 8 (the JAX gate refuses this shape)")
    y2 = _BnAct.apply(x.contiguous().reshape(n * h * w, c), inv.float(),
                      shift.float(), bool(relu))
    return y2.reshape(x.shape)
