"""Numpy models of the pool kernels' thread mappings, held against the
plain versions they must equal bit for bit.

The CUDA kernels (``flexflow_tpu_torch/csrc/maxpool.cu``,
``csrc/avgpool_bwd.cu``) run only on a GPU; tests/test_torch_cuda.py holds
them against the plain versions on the card.  These models repeat, on the
CPU, what one kernel thread does and in which order:

* the max-pool backward as a gather over stride cells: cell (th, tw)
  holds padded rows 2th, 2th+1 and columns 2tw, 2tw+1, reached only by
  the windows (th - dh, tw - dw) with dh, dw in {0, 1} (k = 3) or 0
  (k = 2); position (a, b) of the cell is window offset (a + 2dh,
  b + 2dw), so its ranks are fixed, and it adds in ascending (dh, dw),
  which is ascending rank, in float32;
* the max-pool forward: one thread scans its window in rank order with a
  strict compare, NaN and the -inf padding as the kernel treats them;
* the avg-pool backward: one thread per (image, dx row, output column)
  stores one scaled value to the kw positions of its row, with the grid's
  row loop when the rows exceed the grid;
* the choice of the vector width (``kernels.vec_width``).

Each model equals the plain version exactly (float32 adds in the same
order, cast once), and a second case shows that the backward model's
order matters: adding in another order, or leaving a window out, gives
another result.
"""

import numpy as np
import pytest
import torch

from flexflow_tpu_torch.ops import kernels
from flexflow_tpu_torch.ops.kernels import avgpool, maxpool

torch.set_num_threads(2)

SENTINEL = maxpool.SENTINEL
GEOMETRIES = [(3, 0), (3, 1), (2, 0)]
# odd and even extents, h != w, and the smallest that pool
EXTENTS = [(9, 9), (16, 16), (15, 12), (12, 17), (4, 5)]


def _ascending(d):
    return [(dh, dw) for dh in range(d) for dw in range(d)]


def _bwd_cell_model(dy, sel, h, w, k, p, order=_ascending, drop=None):
    """dx (float32) as the backward kernel's threads compute it, every
    (image, channel) of a cell at once; each position is written once."""
    n, oh, ow, c = dy.shape
    d = 2 if k == 3 else 1
    dx = np.full((n, h, w, c), np.nan, np.float32)
    for th in range((h + p + 1) // 2):
        for tw in range((w + p + 1) // 2):
            g, s = {}, {}
            for dh, dw in _ascending(d):
                t, u = th - dh, tw - dw
                if 0 <= t < oh and 0 <= u < ow:
                    g[dh, dw], s[dh, dw] = dy[:, t, u], sel[:, t, u]
                else:   # no window: a rank no position has
                    g[dh, dw] = np.zeros((n, c), np.float32)
                    s[dh, dw] = np.full((n, c), SENTINEL, np.uint8)
            for a in range(2):
                for b in range(2):
                    hh, ww = 2 * th - p + a, 2 * tw - p + b
                    if not (0 <= hh < h and 0 <= ww < w):
                        continue
                    acc = np.zeros((n, c), np.float32)
                    for dh, dw in order(d):
                        jh, jw = a + 2 * dh, b + 2 * dw
                        if jh >= k or jw >= k or (dh, dw) == drop:
                            continue
                        hit = s[dh, dw] == jh * k + jw
                        acc = np.where(hit, acc + g[dh, dw], acc)
                    assert np.isnan(dx[:, hh, ww]).all()
                    dx[:, hh, ww] = acc
    assert not np.isnan(dx).any()
    return dx


def _fwd_thread_model(x, k, p, relu):
    """(y, sel) as the forward kernel's threads compute them: a strict
    compare over the window in rank order, NaN marked, padding skipped."""
    n, h, w, c = x.shape
    oh, ow = maxpool.out_dim(h, k, p), maxpool.out_dim(w, k, p)
    y = np.empty((n, oh, ow, c), np.float32)
    sel = np.empty((n, oh, ow, c), np.uint8)
    for t in range(oh):
        for u in range(ow):
            m = np.full((n, c), -np.inf, np.float32)
            best = np.full((n, c), SENTINEL, np.uint8)
            nan = np.zeros((n, c), bool)
            for jh in range(k):
                for jw in range(k):
                    hh, ww = 2 * t - p + jh, 2 * u - p + jw
                    if not (0 <= hh < h and 0 <= ww < w):
                        continue
                    v = x[:, hh, ww]
                    nan |= np.isnan(v)
                    win = ~np.isnan(v) & (v > m)
                    m = np.where(win, v, m)
                    best = np.where(win, jh * k + jw, best).astype(np.uint8)
            m = np.where(nan, np.nan, m).astype(np.float32)
            best = np.where(nan, SENTINEL, best).astype(np.uint8)
            if relu:
                clamp = ~(m > 0)
                best = np.where(clamp, SENTINEL, best).astype(np.uint8)
                m = np.where(clamp & ~nan, 0.0, m).astype(np.float32)
            y[:, t, u], sel[:, t, u] = m, best
    return y, sel


def _avg_thread_model(dy, y, kh, kw, max_rows):
    """dx as the avg-pool kernel's threads compute it, with a grid of at
    most ``max_rows`` rows, rounded down to whole windows."""
    n, oh, ow, c = dy.shape
    h, w = oh * kh, ow * kw
    rows = h if h <= max_rows else max_rows // kh * kh
    scale = np.float32(1.0 / (kh * kw))
    dx = np.full((n, h, w, c), np.nan, np.float32)
    for by in range(rows):
        jh, t = by % kh, by // kh
        while t < oh:
            for u in range(ow):
                g = dy[:, t, u]
                if y is not None:
                    g = np.where(y[:, t, u] > 0, g, np.float32(0))
                hh = t * kh + jh
                for jw in range(kw):
                    assert np.isnan(dx[:, hh, u * kw + jw]).all()
                    dx[:, hh, u * kw + jw] = g * scale
            t += rows // kh
    assert not np.isnan(dx).any()
    return dx


def _tie_heavy(rng, shape):
    return rng.randint(-3, 4, size=shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,w", EXTENTS)
@pytest.mark.parametrize("k,p", GEOMETRIES)
def test_bwd_cell_model_equals_plain_backward(k, p, h, w, dtype):
    rng = np.random.RandomState(h * 31 + w + k + p)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(_tie_heavy(rng, (2, h, w, 6))).to(tdt)
    _, sel = maxpool.maxpool_fwd_plain(x, k, p, relu=(h % 2 == 0))
    dy = torch.from_numpy(rng.randn(*sel.shape).astype(np.float32)).to(tdt)
    ref = maxpool.maxpool_bwd_plain(dy, sel, h, w, k, p)
    got = _bwd_cell_model(dy.float().numpy(), sel.numpy(), h, w, k, p)
    assert torch.equal(torch.from_numpy(got).to(tdt), ref)


def _order_case():
    """A 3x3/2 pool whose position (2, 2) is every covering window's first
    max, with dy of such magnitudes that the float32 sum depends on the
    order: ranks 0, 2, 6, 8 carry 8, 1e8, -1e8, 0.5 (float32 steps by 8
    near 1e8, so 1e8 + 8 is exact and 1e8 + 0.5 is not)."""
    x = torch.zeros(1, 7, 7, 1)
    x[0, 2, 2, 0] = 5.0
    _, sel = maxpool.maxpool_fwd_plain(x, 3, 0, False)
    dy = torch.zeros(1, 3, 3, 1)
    for (t, u), v in (((1, 1), 8.0), ((1, 0), 1e8), ((0, 1), -1e8),
                      ((0, 0), 0.5)):
        dy[0, t, u, 0] = v
    return dy, sel


def test_bwd_cell_model_order_and_windows_matter():
    dy, sel = _order_case()
    assert [int(sel[0, t, u, 0]) for t, u in ((1, 1), (1, 0), (0, 1),
                                              (0, 0))] == [0, 2, 6, 8]
    ref = maxpool.maxpool_bwd_plain(dy, sel, 7, 7, 3, 0).numpy()
    args = (dy.numpy(), sel.numpy(), 7, 7, 3, 0)
    assert ref[0, 2, 2, 0] == 8.5
    np.testing.assert_array_equal(_bwd_cell_model(*args), ref)
    descending = _bwd_cell_model(*args, order=lambda d: _ascending(d)[::-1])
    assert descending[0, 2, 2, 0] == 8.0
    for drop in _ascending(2):
        assert _bwd_cell_model(*args, drop=drop)[0, 2, 2, 0] != 8.5


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("h,w", [(9, 9), (16, 16), (15, 12)])
@pytest.mark.parametrize("k,p", GEOMETRIES)
def test_fwd_thread_model_equals_plain_forward(k, p, h, w, relu):
    rng = np.random.RandomState(h + w + k + p)
    x = _tie_heavy(rng, (2, h, w, 5))
    x[0, 1, 1, 0] = np.nan   # a NaN window wins over any compare
    y_ref, sel_ref = maxpool.maxpool_fwd_plain(torch.from_numpy(x), k, p,
                                               relu)
    y, sel = _fwd_thread_model(x, k, p, relu)
    np.testing.assert_array_equal(y, y_ref.numpy())
    np.testing.assert_array_equal(sel, sel_ref.numpy())


# the grid's row limit: above every row, or one or two windows' rows
# (the kernel's loop over output rows), as the C launcher rounds it
@pytest.mark.parametrize("windows", [None, 1, 2])
@pytest.mark.parametrize("kh,kw,oh,ow,relu", [
    (8, 8, 1, 1, False),   # the global pool
    (2, 2, 3, 4, True),
    (3, 3, 4, 3, True),
])
def test_avg_thread_model_equals_plain_backward(kh, kw, oh, ow, relu,
                                                 windows):
    max_rows = 65535 if windows is None else windows * kh + kh - 1
    rng = np.random.RandomState(kh + oh)
    dy = rng.randn(2, oh, ow, 6).astype(np.float32)
    y = rng.randn(2, oh, ow, 6).astype(np.float32) if relu else None
    ref = avgpool.avgpool_bwd_plain(
        torch.from_numpy(dy), None if y is None else torch.from_numpy(y),
        kh, kw)
    np.testing.assert_array_equal(
        _avg_thread_model(dy, y, kh, kw, max_rows), ref.numpy())


def test_vec_width_takes_16_bytes_where_everything_allows():
    bf16, f32 = 2, 4
    base = 1 << 20   # an allocation's address: 256-byte aligned
    assert kernels.vec_width(64, bf16, (64 * 147, 64 * 147, 64),
                             [(base, bf16), (base, 1)]) == 8
    assert kernels.vec_width(64, f32, (64, 64, 64),
                             [(base, f32), (base, 1)]) == 4
    # the uint8 plane needs 8 (bf16) or 4 (float32) bytes of alignment
    assert kernels.vec_width(64, bf16, (), [(base + 8, 1)]) == 8
    assert kernels.vec_width(64, bf16, (), [(base + 4, 1)]) == 1
    # C = 3 or 5, and an odd channel offset into a wider tensor
    assert kernels.vec_width(3, bf16) == kernels.vec_width(5, f32) == 1
    assert kernels.vec_width(16, bf16, (24 * 9, 24 * 3, 24),
                             [(base + 1 * bf16, bf16)]) == 1
    # a slice at channel 64 of 192 keeps 16-byte vectors
    assert kernels.vec_width(64, bf16, (192 * 9, 192 * 3, 192),
                             [(base + 64 * bf16, bf16)]) == 8
    # a stride that is no multiple of the vector
    assert kernels.vec_width(8, f32, (12, 4, 6), [(base, f32)]) == 1
