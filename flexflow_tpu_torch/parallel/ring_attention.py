"""Ring attention: attention over a sequence split across the ranks of a
group (PyTorch port of ``flexflow_tpu/parallel/ring_attention.py``, its
``local_flash`` body, ``:93-200``).

Each rank of the ``s`` group holds one chunk of the sequence of q, k and
v.  The K/V chunks travel round the ring: at step t a rank holds the
chunk of the rank t places before it, attends its own queries against
that chunk with :func:`flash_attention_partial` (kernels 1-3 on a GPU)
and merges the result into its running output by log-sum-exp weight
(:func:`combine_partials`).  Its memory stays O(S/P) per rank; the
scores never leave the kernels.

Causal masking needs no offsets inside the kernels.  Chunk ``src`` is,
for the queries of chunk ``i``, fully visible when ``src < i`` (the
non-causal kernel), diagonal when ``src == i`` (the causal kernel) or
fully hidden when ``src > i``: the kernel is skipped, which is exactly
the merge of a (0, -inf) partial, but the rank still rotates.  Every
rank of a group runs P - 1 rotations (the JAX scan's last one only
brings the chunks home), K and V stacked into one move, so the members'
collectives stay in step; each rotation is an autograd function on the
step's token chain (``collectives.rotate``), whose backward is the
reverse rotation.  Other grid axes (batch, heads) pass through: they
only make the blocks smaller.
"""

from __future__ import annotations

import torch

from flexflow_tpu_torch.ops.kernels import flash_attention as fa
from flexflow_tpu_torch.parallel import collectives


def ring_attention(q, k, v, group, index: int, causal: bool = False,
                   transport: str = "p2p"):
    """Attention of this rank's queries over the whole sequence.

    q, k, v: this rank's chunks (B, H, S/P, d), chunk ``index`` of the P
    members of ``group`` (a :class:`~flexflow_tpu_torch.machine.Group`,
    members in chunk order); ``transport`` "p2p" or "gather"
    (``collectives.rotate``).  Returns the float32 (B, H, S/P, d) output
    of those queries, differentiable in q, k and v."""
    p = group.size
    kv = torch.stack([k, v])
    o, lse = fa.flash_attention_partial(q, k, v, causal)
    for t in range(1, p):
        kv = collectives.rotate(kv, group, transport)
        src = (index - t) % p
        if causal and src > index:
            continue       # a hidden chunk: its partial merges as nothing
        o_t, lse_t = fa.flash_attention_partial(q, kv[0], kv[1], False)
        o, lse = fa.combine_partials(o, lse, o_t, lse_t)
    return o
