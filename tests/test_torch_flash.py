"""The port's flash-attention forward against the Pallas kernel.

The plain PyTorch version (``flash_attention_fwd_plain``) is held against
``flexflow_tpu.ops.pallas.flash_attention.flash_attention_partial`` run in
interpret mode, on the shapes tests/test_pallas.py pins, causal and not,
comparing both outputs (o and the per-row lse) at rtol/atol 1e-5 in
float32: the same math in another summation order.  The CUDA kernel
itself runs only on a GPU: tests/test_torch_cuda.py holds it against the
plain version on the card.  A numpy model of the kernel's bf16 P V
product shows why it splits P into two bf16 parts.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops.pallas.flash_attention import flash_attention_partial
from flexflow_tpu_torch.ops import kernels
from flexflow_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_fwd, flash_attention_fwd_cuda, flash_attention_fwd_plain)

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(seed, b, h, s, d):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, s, d).astype("float32") for _ in range(3)]


def _pallas(q, k, v, causal, **blocks):
    o, lse = flash_attention_partial(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal,
                                     interpret=True, **blocks)
    return np.asarray(o), np.asarray(lse)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,h,s,d,blocks", [
    (2, 3, 16, 8, {}),
    (1, 2, 40, 16, {}),
    # S=20 with 16-blocks: the Pallas zero-pad + key-mask path
    (1, 2, 20, 8, {"block_q": 16, "block_k": 16}),
    # the largest head dim the forward kernel takes
    (1, 2, 24, 128, {}),
])
def test_plain_matches_pallas(causal, b, h, s, d, blocks):
    q, k, v = _qkv(0, b, h, s, d)
    o_ref, lse_ref = _pallas(q, k, v, causal, **blocks)
    o, lse = flash_attention_fwd_plain(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), causal)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    assert tuple(o.shape) == (b, h, s, d) and tuple(lse.shape) == (b, h, s)
    np.testing.assert_allclose(o.numpy(), o_ref, **TOL)
    np.testing.assert_allclose(lse.numpy(), lse_ref, **TOL)


def test_plain_cross_attention_matches_pallas():
    # Sq != Sk: the partial form over one K/V chunk, as ring attention
    # uses it
    rng = np.random.RandomState(3)
    q = rng.randn(1, 2, 12, 8).astype("float32")
    k, v = (rng.randn(1, 2, 28, 8).astype("float32") for _ in range(2))
    for causal in (False, True):
        o_ref, lse_ref = _pallas(q, k, v, causal)
        o, lse = flash_attention_fwd_plain(
            *(torch.from_numpy(a) for a in (q, k, v)), causal)
        np.testing.assert_allclose(o.numpy(), o_ref, **TOL)
        np.testing.assert_allclose(lse.numpy(), lse_ref, **TOL)


def test_plain_bfloat16_inputs_compute_in_float32():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(4, 1, 2, 24, 16))
    o, lse = flash_attention_fwd_plain(q, k, v, True)
    o32, lse32 = flash_attention_fwd_plain(q.float(), k.float(), v.float(),
                                           True)
    assert o.dtype == torch.float32
    torch.testing.assert_close(o, o32, rtol=0, atol=0)
    torch.testing.assert_close(lse, lse32, rtol=0, atol=0)


def test_dispatch_cpu_runs_plain_and_never_counts():
    kernels.reset_launches()
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 2, 2, 16, 8))
    o, lse = flash_attention_fwd(q, k, v, True)
    o_p, lse_p = flash_attention_fwd_plain(q, k, v, True)
    torch.testing.assert_close(o, o_p, rtol=0, atol=0)
    torch.testing.assert_close(lse, lse_p, rtol=0, atol=0)
    assert kernels.launches["flash_attention_fwd"] == 0


def test_dispatch_refuses_other_devices():
    q, k, v = (torch.from_numpy(a) for a in _qkv(6, 1, 1, 8, 8))
    # meta tensors (the dry run) get the outputs' shapes, nothing run;
    # a mix of devices is refused
    o, lse = flash_attention_fwd(q.to("meta"), k.to("meta"), v.to("meta"))
    o_p, lse_p = flash_attention_fwd_plain(q, k, v)
    assert (o.device.type, lse.device.type) == ("meta", "meta")
    assert (o.shape, o.dtype, lse.shape, lse.dtype) == \
        (o_p.shape, o_p.dtype, lse_p.shape, lse_p.dtype)
    with pytest.raises(ValueError, match="different devices"):
        flash_attention_fwd(q.to("meta"), k, v)
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_fwd_cuda(q, k, v)


def test_library_name_follows_source_and_flags():
    path = kernels.library_path("flash_attention_fwd.cu")
    assert path.parent == kernels.BUILD_DIR
    assert path.name.startswith("libflash_attention_fwd_")
    assert path.suffix == ".so"


def test_library_name_follows_the_shared_headers(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC_DIR, csrc)
    names = {s: kernels.library_path(s, csrc)
             for s in ("fused_ce.cu", "fused_ce_bwd.cu",
                       "flash_attention_fwd.cu")}
    # the same sources and headers: the same names as the package's
    assert names == {s: kernels.library_path(s) for s in names}
    with open(csrc / "fused_ce_mma.cuh", "a") as f:
        f.write("// edited\n")
    for s, before in names.items():
        assert kernels.library_path(s, csrc) != before, s
    edited = {s: kernels.library_path(s, csrc) for s in names}
    (csrc / "extra.cuh").write_text("#pragma once\n")
    for s, before in edited.items():
        assert kernels.library_path(s, csrc) != before, s


def _bf16(a):
    """float32 to bfloat16 and back, rounded to nearest even (cvt.rn)."""
    u = np.asarray(a, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def test_bf16_hi_lo_split_of_p_keeps_float32_accuracy():
    # the kernel's bf16 P V: p (float32 in meaning) = hi + lo, both bf16,
    # each multiplied with V (bf16, exact); against float64 at the serving
    # geometry (S 512, d 64, causal)
    rng = np.random.RandomState(0)
    s_len, d = 512, 64
    q, k = (rng.randn(s_len, d).astype("float32") for _ in range(2))
    v = _bf16(rng.randn(s_len, d)).astype("float64")
    s = q.astype("float64") @ k.T.astype("float64") / np.sqrt(d)
    s = np.where(np.tril(np.ones((s_len, s_len), bool)), s, -np.inf)
    p = np.exp(s - s.max(1, keepdims=True)).astype("float32")
    l = p.astype("float64").sum(1, keepdims=True)
    ref = p.astype("float64") @ v / l
    hi = _bf16(p)
    lo = _bf16(p - hi)
    two = (hi.astype("float64") @ v + lo.astype("float64") @ v) / l
    one = hi.astype("float64") @ v / l
    assert np.abs(two - ref).max() <= 1e-5
    # one bf16 rounding of p misses the kernels' 1e-4 gate
    assert np.abs(one - ref).max() > 1e-4


def test_plain_empty_keys_mask_every_row():
    q = torch.ones(1, 2, 5, 8)
    k = v = torch.ones(1, 2, 0, 8)
    o, lse = flash_attention_fwd_plain(q, k, v, False)
    assert bool((o == 0).all()) and bool(torch.isneginf(lse).all())
    assert tuple(o.shape) == (1, 2, 5, 8) and tuple(lse.shape) == (1, 2, 5)
