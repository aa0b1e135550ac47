"""The neighbour halo exchange of the PyTorch port's windowed ops
(``ops/conv.py`` ``window_blocks``, ``OpGrid.halo``,
``collectives.halo_exchange``; JAX: ``flexflow_tpu/ops/base.py:72``
``exchange_halo``).

A 17x17 net of a 3x3/1 convolution, a 3x3/2 max pool, a 5x5/2
convolution and a 3x3/1 average pool (``torch_ranks.halo_net``) trains
under h, w and h+w splits of all four ops on 4 gloo ranks (uneven blocks
5, 5, 5, 2; the stride-2 halos asymmetric) and under w and h splits on 2
(9 and 8), the h split through host copies (the transport of gloo on
CUDA tensors): losses, final params within the CNN bars of JAX's run of the
same strategy on its virtual CPU mesh and of the port's one process.
Each rank's halo byte counter equals the rows of its windows' span that
other ranks' blocks hold (forward) plus the rows of its block in other
ranks' spans (their gradients, backward), well below what an all-gather
of the whole extent moved.
"""

import pytest
import torch

import torch_ranks as tr

torch.set_num_threads(2)

SIZE, BATCH, CLASSES, STEPS = 17, 4, 10, 2
CFG = dict(batch_size=BATCH, input_height=SIZE, input_width=SIZE,
           learning_rate=0.01, weight_decay=1e-4, momentum=0.9)
#: (name, kernel, stride, pad, input extent, input channels)
WINDOWS = (("conv1", 3, 1, 1, 17, 3), ("pool1", 3, 2, 0, 17, 8),
           ("conv2", 5, 2, 2, 8, 8), ("pool2", 3, 1, 1, 4, 8))

CASES = {
    4: {"h": (1, 4), "w": (4, 1), "hw": (2, 2)},
    2: {"w": (2, 1), "h": (1, 2)},
}


def _strategy(wh, ranks):
    return tr.strategy_json({name: [wh[0], wh[1], 1, 1]
                             for name, *_ in WINDOWS}, ranks)


def _blocks(extent, parts):
    b = -(-extent // parts)
    return [(min(i * b, extent), min((i + 1) * b, extent))
            for i in range(parts)]


def _spans(size, k, s, p, parts):
    """Each block's window span over the input, clipped at the border."""
    osize = 1 + (size + 2 * p - k) // s
    return [(max(lo * s - p, 0), min((hi - 1) * s - p + k, size))
            for lo, hi in _blocks(osize, parts)]


def _overlap(a, b):
    return max(0, min(a[1], b[1]) - max(a[0], b[0]))


def _moved(blocks, spans, me):
    """Rows member ``me`` receives (of its span, from the others' blocks)
    and sends (of its block, in the others' spans)."""
    others = [m for m in range(len(blocks)) if m != me]
    return (sum(_overlap(blocks[m], spans[me]) for m in others),
            sum(_overlap(blocks[me], spans[m]) for m in others))


def _expected_bytes(wh, ranks):
    """Per rank, ``(forward, backward, whole)``: the halo bytes one
    forward receives (the rows of its windows' span that other blocks
    hold), one backward receives (the gradients of the rows of its block
    in other spans) and what the all-gather of the whole extent received
    in a training step (forward, and as much again by the backward's
    reduce-scatter)."""
    pw, ph = wh
    out = []
    for r in range(ranks):
        iw, ih = r % pw, r // pw
        fwd = bwd = whole = 0
        for _, k, s, p, size, c in WINDOWS:
            hb, hs = _blocks(size, ph), _spans(size, k, s, p, ph)
            wb, ws = _blocks(size, pw), _spans(size, k, s, p, pw)
            rows = hb[ih][1] - hb[ih][0]
            cols = wb[iw][1] - wb[iw][0]
            if ph > 1:
                f, b = _moved(hb, hs, ih)
                fwd, bwd = fwd + f * cols * c, bwd + b * cols * c
                whole += 2 * (size - rows) * cols * c
                # the w exchange then moves columns of the span's rows
                rows = hs[ih][1] - hs[ih][0]
            if pw > 1:
                f, b = _moved(wb, ws, iw)
                fwd, bwd = fwd + f * rows * c, bwd + b * rows * c
                whole += 2 * (size - cols) * rows * c
        out.append(tuple(4 * BATCH * v for v in (fwd, bwd, whole)))
    return out


@pytest.mark.parametrize("ranks", [4, 2])
def test_halo_splits_match_jax_and_one_rank(tmp_path, ranks):
    batches = tr.random_batches(STEPS, BATCH, SIZE, CLASSES)
    cases, wants, labels = [], [], []
    for label, wh in CASES[ranks].items():
        case, want = tr.jax_case(tmp_path, "halo_net", CFG,
                                 _strategy(wh, ranks), ranks, batches,
                                 tag=label)
        # the h split on 2 ranks stages its halos through host copies
        body = "train_halo_host" if (ranks, label) == (2, "h") \
            else "train_halo"
        cases.append((body, case))
        wants.append(want)
        labels.append(label)
    res = tr.run_ranks(tr.run_cases, ranks, cases, timeout=150.0)
    for i, label in enumerate(labels):
        per_rank = [r[i] for r in res]
        tr.check_case(cases[i][1], wants[i], [r[:3] for r in per_rank])
        wh = CASES[ranks][label]
        for rank, ((fwd, bwd, whole), r) in enumerate(
                zip(_expected_bytes(wh, ranks), per_rank)):
            moved = r[3]["received"]
            # STEPS training steps, then the eval step's forward
            assert moved == STEPS * (fwd + bwd) + fwd, \
                (label, rank, moved, fwd, bwd)
            assert 0 < fwd + bwd < whole, (label, rank, fwd, bwd, whole)
        total_sent = sum(r[3]["sent"] for r in per_rank)
        assert total_sent == sum(r[3]["received"] for r in per_rank)

