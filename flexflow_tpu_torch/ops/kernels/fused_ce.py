"""Fused vocab projection + softmax cross-entropy: the hand-written CUDA
kernels (``csrc/fused_ce.cu``, the forward; ``csrc/fused_ce_bwd.cu``, the
backward; both on the tensor cores, sharing ``csrc/fused_ce_mma.cuh``),
their plain PyTorch versions, the wrappers that pick between them by the
tensors' device, and the differentiable op.

Port of ``flexflow_tpu/ops/pallas/fused_ce.py``: ``fused_ce_fwd`` replaces
the Pallas ``_fwd_kernel``, ``fused_ce_bwd_dx`` ``_bwd_dx_kernel`` and
``fused_ce_bwd_dw`` ``_bwd_dw_kernel``.  ``fused_ce_fwd`` writes partial
softmax states (max, rescaled sum, label logit) for :func:`fwd_splits`
slices of the vocab into a float32 workspace, and
``fused_ce_fwd_combine``, a launch of its own, merges them in a fixed
order.  ``fused_ce_bwd_dx`` writes partial dx sums for :func:`dx_splits`
slices of the vocab into a float32 workspace, and ``fused_ce_bwd_dx_sum``
adds them in a fixed order.  With ``logits = x @ w + b``
(x (N, d), w (d, V), b (V,), labels (N,) int32):

* ``fused_linear_ce_fwd(x, w, b, labels) -> (nll, lse)``, both float32
  (N,): ``lse = logsumexp(logits)`` per row and ``nll = lse -
  logits[label]``; a label that is negative or >= V matches nothing, so
  its nll is its lse (the JAX padding contract; the causal shift's -1).
* ``fused_linear_ce_bwd(x, w, b, labels, lse, gp, goh) -> (dx, dw,
  db)`` in float32 for two row vectors gp, goh (N,): ``t = gp softmax -
  goh onehot``, ``dx = t wᵀ``, ``dw = xᵀ t``, ``db = Σ_rows t``
  (``fused_ce.py:112-124``).  For a cotangent g of nll alone gp = goh =
  g (goh defaults to gp); the partial form
  :func:`fused_linear_ce_partial`, whose lse is an output too, passes gp
  = g_nll + g_lse and goh = g_nll (``fused_ce.py:262-277``).

The kernels never store the (N, V) logits; the plain versions do.  The
kernels take x and w in one dtype (float32 or bfloat16), b in float32 and
int32 labels; :class:`FusedLinearCE` casts to that as the JAX op's
``prep`` does (``fused_ce.py:250-255``) and casts the gradients back to
the dtypes of x, w and b (``:275-276``).  CPU tensors take the plain
versions, CUDA tensors the kernels; there is no fallback: a CUDA tensor
the kernels do not take raises.
"""

from __future__ import annotations

import ctypes

import torch

from flexflow_tpu_torch.ops import kernels

NAME_FWD = "fused_ce_fwd"
NAME_FWD_COMBINE = "fused_ce_fwd_combine"
NAME_DX = "fused_ce_bwd_dx"
NAME_DW = "fused_ce_bwd_dw"
NAME_DX_SUM = "fused_ce_bwd_dx_sum"
SOURCE = "fused_ce.cu"
SOURCE_BWD = "fused_ce_bwd.cu"
#: token rows and vocab columns of the forward's and the dx kernel's tile;
#: the dx workspace pads N to DX_ROWS and d to DX_COLS
#: (``csrc/fused_ce_mma.cuh``, DxGeo)
DX_ROWS, DX_COLS = 64, 256
DTYPES = (torch.float32, torch.bfloat16)


def _logits(x, w, b):
    """The (N, V) float32 logits of the plain versions: products of the
    (possibly bfloat16) operands summed in float32, plus the bias."""
    return torch.matmul(x.float(), w.float()) + b.float()


def fused_linear_ce_fwd_plain(x, w, b, labels):
    """``(nll, lse)`` in plain PyTorch, the logits materialized."""
    logits = _logits(x, w, b)
    v = logits.shape[1]
    lse = torch.logsumexp(logits, dim=1)
    labels = labels.long()
    hit = (labels >= 0) & (labels < v)
    corr = logits.gather(1, torch.where(hit, labels, 0)[:, None])[:, 0]
    return lse - torch.where(hit, corr, torch.zeros_like(corr)), lse


def fused_linear_ce_bwd_plain(x, w, b, labels, lse, gp, goh=None):
    """``(dx, dw, db)`` float32 in plain PyTorch: t = gp softmax - goh
    onehot (goh defaults to gp), rounded to x's dtype before the two
    products (as the Pallas kernels cast it to the operand dtype), summed
    unrounded for db."""
    logits = _logits(x, w, b)
    v = logits.shape[1]
    p = torch.exp(logits - lse[:, None])
    labels = labels.long()
    onehot = (labels[:, None] == torch.arange(v, device=x.device)[None, :])
    gp = gp.float()[:, None]
    goh = gp if goh is None else goh.float()[:, None]
    t = gp * p - goh * onehot.float()
    tr = t.to(x.dtype).float()
    dx = torch.matmul(tr, w.float().t())
    dw = torch.matmul(x.float().t(), tr)
    return dx, dw, t.sum(dim=0)


def _lib() -> ctypes.CDLL:
    lib = kernels.load(SOURCE)
    if lib.ff_fused_ce_fwd.argtypes is None:
        lib.ff_fused_ce_fwd.argtypes = [ctypes.c_void_p] * 5 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.ff_fused_ce_fwd.restype = ctypes.c_int
        lib.ff_fused_ce_fwd_combine.argtypes = [ctypes.c_void_p] * 3 \
            + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.ff_fused_ce_fwd_combine.restype = ctypes.c_int
        lib.ff_fused_ce_fwd_smem.argtypes = [ctypes.c_int]
        lib.ff_fused_ce_fwd_smem.restype = ctypes.c_int
    return lib


def _lib_bwd() -> ctypes.CDLL:
    lib = kernels.load(SOURCE_BWD)
    if lib.ff_fused_ce_bwd_dx.argtypes is None:
        lib.ff_fused_ce_bwd_dx.argtypes = [ctypes.c_void_p] * 8 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.ff_fused_ce_bwd_dx.restype = ctypes.c_int
        lib.ff_fused_ce_bwd_dx_sum.argtypes = [ctypes.c_void_p] * 2 \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.ff_fused_ce_bwd_dx_sum.restype = ctypes.c_int
        lib.ff_fused_ce_bwd_dw.argtypes = [ctypes.c_void_p] * 9 \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.ff_fused_ce_bwd_dw.restype = ctypes.c_int
    return lib


def _vocab_splits(n: int, v: int, sms: int) -> int:
    """Vocab slices S for a kernel of one 64 x 256 tile per block and one
    block per SM, over N rows and V columns: ceil(N/64) x S blocks, each
    over ceil(V/256)/S vocab tiles.  S minimizes the tiles of the busiest
    SM (rounds of blocks x tiles per block); among equals it takes the
    largest S up to about two blocks per SM, so short rows fill the card
    and the workspace stays small."""
    rows = -(-n // DX_ROWS)
    tiles = -(-v // DX_COLS)
    cap = max(1, min(tiles, -(-2 * sms // rows)))

    def busiest(s):
        return -(-rows * s // sms) * -(-tiles // s)

    best = min(busiest(s) for s in range(1, cap + 1))
    return max(s for s in range(1, cap + 1) if busiest(s) == best)


def fwd_splits(n: int, v: int, sms: int) -> int:
    """Vocab slices S of the forward kernel for N rows, V columns and
    ``sms`` SMs (its (S, N, 3) workspace holds one partial per slice)."""
    return _vocab_splits(n, v, sms)


def dx_splits(n: int, v: int, sms: int) -> int:
    """Vocab slices S of the dx kernel for N rows, V columns and ``sms``
    SMs (its (S, N, d) workspace holds one partial dx per slice)."""
    return _vocab_splits(n, v, sms)


def _check(name, x, w, b, labels, *rows):
    """Raise unless the operands are what the kernels take: contiguous,
    on one CUDA device, x (N, d) and w (d, V) of one dtype in
    :data:`DTYPES`, b (V,) float32, labels (N,) int32 and each of
    ``rows`` a float32 (N,) vector."""
    ts = (x, w, b, labels) + rows
    if not (x.is_cuda and all(t.device == x.device for t in ts)):
        raise ValueError(f"{name}: operands must be on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise ValueError(f"{name}: x and w must share a dtype in {DTYPES}, "
                         f"got {x.dtype}, {w.dtype}")
    if b.dtype != torch.float32 or labels.dtype != torch.int32 \
            or any(t.dtype != torch.float32 for t in rows):
        raise ValueError(f"{name}: need a float32 bias, int32 labels and "
                         f"float32 row vectors, got {b.dtype}, "
                         f"{labels.dtype}, {[t.dtype for t in rows]}")
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1] \
            or b.shape != (w.shape[1],) or w.shape[1] == 0 \
            or any(t.shape != (x.shape[0],) for t in (labels,) + rows):
        raise ValueError(f"{name}: need x (N, d), w (d, V), b (V,) and "
                         f"(N,) rows, got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)}, "
                         f"{[tuple(t.shape) for t in (labels,) + rows]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: operands must be contiguous")


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def fused_linear_ce_fwd_partial_cuda(x, w, b, labels):
    """Launch the forward kernel on the current stream: its float32
    workspace (S, N, 3), per vocab slice and row the max logit, the sum
    of exp(logit - max) and the label's logit, S = :func:`fwd_splits`.
    N must be positive."""
    _check(NAME_FWD, x, w, b, labels)
    n, d = x.shape
    v = w.shape[1]
    if n == 0:
        raise ValueError(f"{NAME_FWD}: need N > 0")
    splits = fwd_splits(n, v, kernels.sm_count(x.device.index))
    work = torch.empty((splits, n, 3), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.ff_fused_ce_fwd(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
            work.data_ptr(), n, d, v, splits,
            int(x.dtype == torch.bfloat16), _stream(x))
    kernels.check(lib, code, NAME_FWD)
    kernels.count(NAME_FWD)
    return work


def fused_linear_ce_fwd_combine_cuda(work):
    """Launch the forward's finishing pass: ``(nll, lse)`` float32 (N,)
    from the workspace's S partials, merged in slice order."""
    if not work.is_cuda or work.dtype != torch.float32 \
            or not work.is_contiguous() or work.dim() != 3 \
            or work.shape[2] != 3 or work.shape[0] < 1:
        raise ValueError(f"{NAME_FWD_COMBINE}: need a contiguous float32 "
                         f"CUDA workspace (S, N, 3), got "
                         f"{tuple(work.shape)}")
    splits, n, _ = work.shape
    nll = torch.empty((n,), dtype=torch.float32, device=work.device)
    lse = torch.empty((n,), dtype=torch.float32, device=work.device)
    lib = _lib()
    with torch.cuda.device(work.device):
        code = lib.ff_fused_ce_fwd_combine(work.data_ptr(), nll.data_ptr(),
                                           lse.data_ptr(), n, splits,
                                           _stream(work))
    kernels.check(lib, code, NAME_FWD_COMBINE)
    kernels.count(NAME_FWD_COMBINE)
    return nll, lse


def fused_linear_ce_fwd_cuda(x, w, b, labels):
    """``(nll, lse)`` through the forward kernel and its finishing
    pass."""
    _check(NAME_FWD, x, w, b, labels)
    if x.shape[0] == 0:
        empty = torch.empty((0,), dtype=torch.float32, device=x.device)
        return empty, empty.clone()
    return fused_linear_ce_fwd_combine_cuda(
        fused_linear_ce_fwd_partial_cuda(x, w, b, labels))


def _work_shape(splits: int, n: int, d: int) -> tuple:
    return (splits, -(-n // DX_ROWS) * DX_ROWS, -(-d // DX_COLS) * DX_COLS)


def fused_linear_ce_bwd_dx_partial_cuda(x, w, b, labels, lse, gp,
                                        goh=None):
    """Launch the dx kernel on the current stream: its float32 workspace
    (S, N rounded up to 64, d rounded up to 256), one partial dx per
    vocab slice, S = :func:`dx_splits`.  N and d must be positive; goh
    defaults to gp."""
    goh = gp if goh is None else goh
    _check(NAME_DX, x, w, b, labels, lse, gp, goh)
    n, d = x.shape
    v = w.shape[1]
    if n == 0 or d == 0:
        raise ValueError(f"{NAME_DX}: need N, d > 0, got {(n, d)}")
    splits = dx_splits(n, v, kernels.sm_count(x.device.index))
    work = torch.empty(_work_shape(splits, n, d), dtype=torch.float32,
                       device=x.device)
    lib = _lib_bwd()
    with torch.cuda.device(x.device):
        code = lib.ff_fused_ce_bwd_dx(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
            lse.data_ptr(), gp.data_ptr(), goh.data_ptr(), work.data_ptr(),
            n, d, v, splits,
            int(x.dtype == torch.bfloat16), _stream(x))
    kernels.check(lib, code, NAME_DX)
    kernels.count(NAME_DX)
    return work


def fused_linear_ce_bwd_dx_sum_cuda(work, n: int, d: int):
    """Launch the dx kernel's finishing pass: dx float32 (N, d), the sum
    of the workspace's S partials, added in split order."""
    want = _work_shape(work.shape[0] if work.dim() == 3 else 1, n, d)
    if not work.is_cuda or work.dtype != torch.float32 \
            or not work.is_contiguous() or tuple(work.shape) != want:
        raise ValueError(f"{NAME_DX_SUM}: need a contiguous float32 CUDA "
                         f"workspace (S, {want[1]}, {want[2]}), got "
                         f"{tuple(work.shape)}")
    dx = torch.empty((n, d), dtype=torch.float32, device=work.device)
    lib = _lib_bwd()
    with torch.cuda.device(work.device):
        code = lib.ff_fused_ce_bwd_dx_sum(work.data_ptr(), dx.data_ptr(), n,
                                          d, work.shape[0], _stream(work))
    kernels.check(lib, code, NAME_DX_SUM)
    kernels.count(NAME_DX_SUM)
    return dx


def fused_linear_ce_bwd_dx_cuda(x, w, b, labels, lse, gp, goh=None):
    """dx float32 (N, d) through the dx kernel and its finishing sum."""
    goh = gp if goh is None else goh
    _check(NAME_DX, x, w, b, labels, lse, gp, goh)
    n, d = x.shape
    if n == 0 or d == 0:
        return torch.empty((n, d), dtype=torch.float32, device=x.device)
    work = fused_linear_ce_bwd_dx_partial_cuda(x, w, b, labels, lse, gp,
                                               goh)
    return fused_linear_ce_bwd_dx_sum_cuda(work, n, d)


def fused_linear_ce_bwd_dw_cuda(x, w, b, labels, lse, gp, goh=None):
    """Launch the dw/db kernel on the current stream: ``(dw, db)``
    float32 (d, V) and (V,); goh defaults to gp."""
    goh = gp if goh is None else goh
    _check(NAME_DW, x, w, b, labels, lse, gp, goh)
    n, d = x.shape
    v = w.shape[1]
    if n == 0:   # no rows: nothing to launch, the sums are empty
        return (torch.zeros((d, v), dtype=torch.float32, device=x.device),
                torch.zeros((v,), dtype=torch.float32, device=x.device))
    dw = torch.empty((d, v), dtype=torch.float32, device=x.device)
    db = torch.empty((v,), dtype=torch.float32, device=x.device)
    lib = _lib_bwd()
    with torch.cuda.device(x.device):
        code = lib.ff_fused_ce_bwd_dw(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
            lse.data_ptr(), gp.data_ptr(), goh.data_ptr(), dw.data_ptr(),
            db.data_ptr(), n, d, v, int(x.dtype == torch.bfloat16),
            _stream(x))
    kernels.check(lib, code, NAME_DW)
    kernels.count(NAME_DW)
    return dw, db


def fused_linear_ce_bwd_cuda(x, w, b, labels, lse, gp, goh=None):
    """``(dx, dw, db)`` float32 through the two backward kernels."""
    dx = fused_linear_ce_bwd_dx_cuda(x, w, b, labels, lse, gp, goh)
    dw, db = fused_linear_ce_bwd_dw_cuda(x, w, b, labels, lse, gp, goh)
    return dx, dw, db


def _on_cpu(*ts) -> bool:
    """True when every operand is on the CPU; raises when only some are."""
    if ts[0].device.type != "cpu":
        return False
    if any(t.device.type != "cpu" for t in ts):
        raise ValueError("fused cross-entropy: operands on different "
                         "devices")
    return True


def fused_linear_ce_fwd(x, w, b, labels):
    """``(nll, lse)``: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors, their shapes for meta tensors, an error for
    anything else."""
    if kernels.on_meta(NAME_FWD, x, w, b, labels):
        return (x.new_empty(x.shape[:1], dtype=torch.float32),
                x.new_empty(x.shape[:1], dtype=torch.float32))
    if _on_cpu(x, w, b, labels):
        return fused_linear_ce_fwd_plain(x, w, b, labels)
    if x.device.type == "cuda":
        return fused_linear_ce_fwd_cuda(x, w, b, labels)
    raise ValueError(f"{NAME_FWD}: no implementation for device {x.device}")


def fused_linear_ce_bwd(x, w, b, labels, lse, gp, goh=None):
    """``(dx, dw, db)`` float32 for t = gp softmax - goh onehot (goh
    defaults to gp): the plain version for CPU tensors, the CUDA kernels
    for CUDA tensors, their shapes for meta tensors, an error for
    anything else."""
    rows = (gp,) if goh is None else (gp, goh)
    if kernels.on_meta(NAME_DX, x, w, b, labels, lse, *rows):
        return tuple(t.new_empty(t.shape, dtype=torch.float32)
                     for t in (x, w, b))
    if _on_cpu(x, w, b, labels, lse, *rows):
        return fused_linear_ce_bwd_plain(x, w, b, labels, lse, gp, goh)
    if x.device.type == "cuda":
        return fused_linear_ce_bwd_cuda(x, w, b, labels, lse, gp, goh)
    raise ValueError(f"{NAME_DX}: no implementation for device {x.device}")


class FusedLinearCE(torch.autograd.Function):
    """nll (N,) float32 of ``softmax(x @ w + b)`` at ``labels``,
    differentiable in x, w and b (``fused_ce.py:311-319``).  w is cast to
    x's dtype, b to float32 and labels to int32 before the kernels; the
    gradients come back in the dtypes of x, w and b.  The forward and
    backward functions are looked up when called."""

    @staticmethod
    def forward(ctx, x, w, b, labels):
        xk = x.contiguous()
        wk = w.to(x.dtype).contiguous()
        bk = b.float().contiguous()
        lab = labels.to(torch.int32).contiguous()
        nll, lse = fused_linear_ce_fwd(xk, wk, bk, lab)
        ctx.save_for_backward(xk, wk, bk, lab, lse)
        ctx.dtypes = (x.dtype, w.dtype, b.dtype)
        return nll

    @staticmethod
    def backward(ctx, g):
        x, w, b, labels, lse = ctx.saved_tensors
        dx, dw, db = fused_linear_ce_bwd(x, w, b, labels, lse,
                                         g.float().contiguous())
        xdt, wdt, bdt = ctx.dtypes
        return dx.to(xdt), dw.to(wdt), db.to(bdt), None


def fused_linear_ce(x, w, b, labels):
    """Per-token NLL of ``softmax(x @ w + b)`` at ``labels`` without the
    kernels storing the (N, V) logits.  x (N, d), w (d, V), b (V,), labels
    (N,) integer; returns float32 (N,), differentiable in x, w and b."""
    return FusedLinearCE.apply(x, w, b, labels)


class FusedLinearCEPartial(torch.autograd.Function):
    """``(nll_local, lse_local)`` (N,) float32 over this vocab slice
    (``fused_ce.py:322``), differentiable in both outputs: the backward
    runs kernels 5-6 with gp = g_nll + g_lse and goh = g_nll, since nll =
    lse - logit[label] and d lse / d logits = softmax
    (``fused_ce.py:262-277``).  Casts as :class:`FusedLinearCE`; the
    launches count as ``<name>.partial`` (``kernels.counted_as``)."""

    @staticmethod
    def forward(ctx, x, w, b, labels):
        xk = x.contiguous()
        wk = w.to(x.dtype).contiguous()
        bk = b.float().contiguous()
        lab = labels.to(torch.int32).contiguous()
        with kernels.counted_as("partial"):
            nll, lse = fused_linear_ce_fwd(xk, wk, bk, lab)
        ctx.save_for_backward(xk, wk, bk, lab, lse)
        ctx.dtypes = (x.dtype, w.dtype, b.dtype)
        return nll, lse

    @staticmethod
    def backward(ctx, g_nll, g_lse):
        x, w, b, labels, lse = ctx.saved_tensors
        goh = g_nll.float().contiguous()
        gp = (goh + g_lse.float()).contiguous()
        with kernels.counted_as("partial"):
            dx, dw, db = fused_linear_ce_bwd(x, w, b, labels, lse, gp, goh)
        xdt, wdt, bdt = ctx.dtypes
        return dx.to(xdt), dw.to(wdt), db.to(bdt), None


def fused_linear_ce_partial(x, w, b, labels):
    """The vocab-slice form of :func:`fused_linear_ce`: ``(nll_local,
    lse_local)`` over w's V_local columns, labels already localized to
    the slice (a label outside ``[0, V_local)`` matches nothing, so its
    nll_local is its lse_local).  Slices combine exactly: lse = logsumexp
    of the lse_c, the label's logit = the sum of (lse_c - nll_c)."""
    return FusedLinearCEPartial.apply(x, w, b, labels)
