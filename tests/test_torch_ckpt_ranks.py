"""Checkpoints over several ranks in the PyTorch port (``FFModel.fit``
with ``ckpt_dir`` on a world of several ranks: ``gather_trees``, rank 0
writing, every rank restoring its own blocks; JAX:
``flexflow_tpu/model.py`` ``_fit``'s save and restore and
``flexflow_tpu/utils/checkpoint.py`` ``_load_step``).

On 2 gloo ranks, the tiny CNN with conv2 and linear1 split over their
channels (so the ranks hold different blocks of their kernels, biases
and momentum):

* 4 steps with a checkpoint every 2, against 2 steps then a run resumed
  from step 2 to 4: the resumed losses and every final param, state and
  optimizer block equal bit for bit;
* the gathered save loads in the JAX package's ``restore_checkpoint``
  equal, leaf for leaf, to a one-device save of the leaves the ranks
  hold, and verifies there;
* a checkpoint the JAX package wrote restores onto the 2 ranks as the
  blocks of its leaves each rank holds;
* ``loss_nan@3`` under ``on_divergence rollback`` rolls back on both
  ranks to the step-2 checkpoint and finishes on fresh batches.
"""

import json

import numpy as np
import torch

import torch_ranks as tr

torch.set_num_threads(2)

SPLITS = {"conv2": [1, 1, 2, 1], "linear1": [2, 1]}
CFG = dict(batch_size=4, input_height=8, input_width=8, learning_rate=0.01,
           weight_decay=1e-4, momentum=0.9, print_freq=0)


def _cfg(ckpt_dir, **kw):
    return dict(CFG, ckpt_dir=str(ckpt_dir), ckpt_freq=2, **kw)


def _full(res, kind):
    """Whole leaves from the ranks' (box, block) trees of ``kind``."""
    shapes = {}
    for r in res:
        for key, sub in r[kind].items():
            for leaf, (box, _) in sub.items():
                shapes.setdefault(key, {})[leaf] = tuple(
                    max(shapes.get(key, {}).get(leaf, (0,) * len(box))[d],
                        hi) for d, (_, hi) in enumerate(box))
    return tr.assemble(shapes, [r[kind] for r in res])


def test_checkpoints_over_two_ranks(tmp_path):
    import jax.numpy as jnp
    from flexflow_tpu.utils import checkpoint as j_ckpt

    from flexflow_tpu_torch.machine import MachineModel
    from flexflow_tpu_torch.utils import checkpoint as ckpt

    strategy = tr.strategy_json(SPLITS, 2)
    batches = tr.random_batches(4, 4, 8, 10)
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    rolled = tmp_path / "rolled"
    # a checkpoint the JAX package writes, of a seeded tree
    jdir = tmp_path / "from_jax"
    ff = tr.build(MachineModel("cpu"), "tiny", CFG)
    params, _ = ff._init_full(7)
    j_ckpt.save_checkpoint(
        str(jdir), 5,
        {k: {leaf: jnp.asarray(v.numpy()) for leaf, v in sub.items()}
         for k, sub in params.items()}, {}, {})
    cases = [
        ("fit_ckpt", ("tiny", _cfg(whole), strategy, batches, 4)),
        ("fit_ckpt", ("tiny", _cfg(cut), strategy, batches, 2)),
        ("fit_ckpt", ("tiny", _cfg(cut), strategy, batches, 4)),
        ("restored_blocks", ("tiny", CFG, strategy, str(jdir))),
        ("fit_ckpt", ("tiny", _cfg(rolled, fault_spec="loss_nan@3",
                                   on_divergence="rollback"),
                      strategy, tr.random_batches(8, 4, 8, 10), 4)),
    ]
    res = tr.run_ranks(tr.run_cases, 2, cases, timeout=150.0)
    full, first, resumed, from_jax, rollback = zip(*res)

    # the resumed run repeats steps 3-4 of the uninterrupted one, bit
    # for bit, and ends in the same blocks
    assert len(first[0][0]) == 2 and len(resumed[0][0]) == 2
    assert resumed[0][0] == full[0][0][2:]
    assert first[0][0] == full[0][0][:2]
    for kind in (1, 2, 3):
        for a, b in zip(full, resumed):
            assert a[kind].keys() == b[kind].keys()
            for key, sub in a[kind].items():
                for leaf, (box, v) in sub.items():
                    assert b[kind][key][leaf][0] == box
                    assert np.array_equal(b[kind][key][leaf][1], v), \
                        (kind, key, leaf)

    # the gathered save is a one-device save of the same leaves
    p_full, o_full = _full(full, 1), _full(full, 3)
    one = tmp_path / "one"
    ckpt.save_checkpoint(
        str(one), 4,
        {k: {leaf: torch.from_numpy(v) for leaf, v in sub.items()}
         for k, sub in p_full.items()}, {},
        {k: {leaf: torch.from_numpy(v) for leaf, v in sub.items()}
         for k, sub in o_full.items()})
    assert j_ckpt.verify_checkpoint(str(whole), 4) == (True, "ok")
    got, want = j_ckpt.restore_checkpoint(str(whole)), \
        j_ckpt.restore_checkpoint(str(one))
    assert got[0] == want[0] == 4
    for g, w in zip(got[1:], want[1:]):
        assert g.keys() == w.keys()
        for key in w:
            assert g[key].keys() == w[key].keys()
            for leaf in w[key]:
                np.testing.assert_array_equal(np.asarray(g[key][leaf]),
                                              np.asarray(w[key][leaf]))
    saved = json.loads(
        (whole / "step_00000004" / "strategy.json").read_text())
    assert saved["linear1"]["dims"] == [2, 1]

    # the JAX package's checkpoint lands as each rank's blocks
    for step, blocks, _ in from_jax:
        assert step == 5
        for key, sub in blocks.items():
            for leaf, (box, v) in sub.items():
                sl = tuple(slice(lo, hi) for lo, hi in box)
                assert np.array_equal(v, params[key][leaf].numpy()[sl])
    # linear1's 32 output channels split over the ranks
    assert [r[1]["linear1"]["kernel"][0][1] for r in from_jax] \
        == [(0, 16), (16, 32)]

    # the fault rolls both ranks back once and the run finishes
    assert [r[4] for r in rollback] == [1, 1]
    assert all(np.isfinite(r[0]).all() for r in rollback)
