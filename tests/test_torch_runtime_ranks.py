"""The training runtime's supervision over two gloo ranks in the PyTorch
port (``FFModel.fit`` with ``ckpt_async`` and the preemption drain on a
world of several ranks).

The tiny CNN with conv2 and linear1 split over their channels, as in
``tests/test_torch_ckpt_ranks.py``:

* 4 steps with a checkpoint every 2, synchronous and asynchronous: the
  losses equal bit for bit, and each committed step's files equal byte
  for byte;
* a drain asked on rank 0 alone (``preempt@1`` in its config, none in
  rank 1's): both ranks stop at the step-2 boundary with the same
  ``preempt_drain`` fields, the checkpoint of step 2 committed through
  the async writer, and the world released (the drain is the world's
  last run);
* in a second world, the run resumed from the drained checkpoint
  repeats steps 3-4 of the uninterrupted run bit for bit.
"""

import os
import signal

import torch

import torch_ranks as tr

torch.set_num_threads(2)

SPLITS = {"conv2": [1, 1, 2, 1], "linear1": [2, 1]}
CFG = dict(batch_size=4, input_height=8, input_width=8, learning_rate=0.01,
           weight_decay=1e-4, momentum=0.9, print_freq=0, ckpt_freq=2)


def _files(d, step):
    """``{name: bytes}`` of one committed step."""
    sd = os.path.join(d, f"step_{step:08d}")
    out = {}
    for name in sorted(os.listdir(sd)):
        with open(os.path.join(sd, name), "rb") as f:
            out[name] = f.read()
    return out


def test_async_save_and_drain_over_two_ranks(tmp_path):
    from flexflow_tpu_torch.utils import checkpoint as ckpt

    strategy = tr.strategy_json(SPLITS, 2)
    batches = tr.random_batches(4, 4, 8, 10)
    sync, asyn, drained = (str(tmp_path / n)
                           for n in ("sync", "async", "drained"))
    cases = [
        ("fit_supervised", ("tiny", dict(CFG, ckpt_dir=sync), strategy,
                            batches, 4)),
        ("fit_supervised", ("tiny", dict(CFG, ckpt_dir=asyn,
                                         ckpt_async=True),
                            strategy, batches, 4)),
        # the drain releases the world: the world's last run
        ("fit_supervised", ("tiny", dict(CFG, ckpt_dir=drained,
                                         ckpt_async=True,
                                         drain_budget_s=30.0),
                            strategy, batches, 4,
                            {"fault_spec": "preempt@1"})),
    ]
    res = tr.run_ranks(tr.run_cases, 2, cases, timeout=150.0)
    s, a, d = zip(*res)
    # the async run trains as the synchronous one and writes its arrays
    assert [r[0] for r in a] == [r[0] for r in s] and len(s[0][0]) == 4
    assert [r[3] for r in a] == [2, 0]   # steps 2 and 4, written by rank 0
    for step in (2, 4):
        assert ckpt.verify_checkpoint(asyn, step) == (True, "ok")
        assert _files(asyn, step) == _files(sync, step), step
    # rank 0's drain stops both ranks at the step-2 boundary
    assert [r[2] for r in d] == [2, 2]
    assert [{k: v for k, v in r[1].items() if k != "seconds"} for r in d] \
        == [{k: v for k, v in d[0][1].items() if k != "seconds"}] * 2
    assert {k: d[0][1][k] for k in ("step", "ckpt_step", "mode", "signal")} \
        == {"step": 2, "ckpt_step": 2, "mode": "async",
            "signal": int(signal.SIGTERM)}
    assert [r[0] for r in d] == [r[0][:2] for r in s]
    assert ckpt._list_steps(drained) == [2]
    assert _files(drained, 2) == _files(sync, 2)

    # a new world resumes from the drained step: steps 3-4, bit for bit
    (resumed,) = zip(*tr.run_ranks(tr.run_cases, 2, [
        ("fit_supervised", ("tiny", dict(CFG, ckpt_dir=drained,
                                         ckpt_async=True),
                            strategy, batches, 4))], timeout=150.0))
    assert [r[0] for r in resumed] == [r[0][2:] for r in s]
    assert [r[1] for r in resumed] == [None, None]
    assert _files(drained, 4) == _files(sync, 4)
