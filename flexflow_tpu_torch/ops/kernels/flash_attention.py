"""Flash-attention forward: the hand-written CUDA kernel
(``csrc/flash_attention_fwd.cu``), its plain PyTorch version and the
wrapper that picks between them by the tensors' device.

Port of ``flexflow_tpu/ops/pallas/flash_attention.py``: the kernel replaces
the Pallas ``_fwd_kernel``.  Both return ``(o, lse)``: o is the float32
attention output (B, H, Sq, d) and lse the float32 per-row log-sum-exp
(B, H, Sq) of the scaled scores, ``-inf`` for a fully masked row (whose o
is 0).  Scores are ``(q . k) / sqrt(d)``; with ``causal`` query row i sees
keys 0..i.

:func:`flash_attention_fwd` runs the plain version for tensors on the CPU
and the kernel for tensors on a CUDA device.  There is no fallback: a CUDA
tensor the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from flexflow_tpu_torch.ops import kernels

NAME = "flash_attention_fwd"
SOURCE = "flash_attention_fwd.cu"
#: head dims the kernel is instantiated for
HEAD_DIMS = (8, 16, 32, 64)
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_fwd_plain(q, k, v, causal: bool = False):
    """The same function in plain PyTorch, computed in float32 with the
    whole score matrix materialized."""
    d = q.shape[-1]
    sq, sk = q.shape[2], k.shape[2]
    if sk == 0:  # no keys: every row fully masked
        return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
                torch.full(q.shape[:3], float("-inf"), device=q.device))
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * (1.0 / math.sqrt(d))
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
    return lib


def flash_attention_fwd_cuda(q, k, v, causal: bool = False):
    """Launch the CUDA kernel on the current stream.  q (B, H, Sq, d) and
    k, v (B, H, Sk, d), contiguous, one dtype (float32 or bfloat16), on
    one CUDA device."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{NAME}: q, k, v must be on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{NAME}: q, k, v must share a dtype in {DTYPES}, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"{NAME}: need q (B,H,Sq,d) and k, v (B,H,Sk,d), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"{NAME}: head dim {d} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{NAME}: q, k, v must be contiguous")
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
            int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(d), stream)
    kernels.check(lib, code, NAME)
    kernels.launches[NAME] += 1
    return o, lse


def flash_attention_fwd(q, k, v, causal: bool = False):
    """``(o, lse)`` of attention: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors, an error for anything else."""
    if q.device.type == "cpu":
        if k.device.type != "cpu" or v.device.type != "cpu":
            raise ValueError(f"{NAME}: q, k, v on different devices")
        return flash_attention_fwd_plain(q, k, v, causal)
    if q.device.type == "cuda":
        return flash_attention_fwd_cuda(q, k, v, causal)
    raise ValueError(f"{NAME}: no implementation for device {q.device}")
