"""The NMT trainer over 8 gloo ranks under the reference's placed
strategies, against the JAX package's run of the same strategy on its
8-device virtual CPU mesh and against the port's run in one process.

At ``tests/test_placement.py:_tiny_rnn``'s widths (batch 8, 2 layers,
seq 8 in chunks of 4, hidden and embed 16, vocab 64), 3 SGD steps at lr
1.0 from JAX's ``init(seed=0)`` tree, each rank keeping the blocks of
the ops it runs, under:

* ``default_global_config`` (the reference's ``nmt.cc:269-308``: source
  embeds on device 0 alone, target embeds on device 1, the rest data
  parallel), the strategy ``RnnModel`` takes by default;
* the wavefront of ``tests/test_placement.py:252``: LSTM chunk ops on
  alternating half-machine blocks along the DAG's antidiagonals;
* ``pipeline_stage_strategy`` with 2 stages (LSTM layer l on block l);
* ``examples/strategies/nmt_8dev.json`` as written: 12 of its 20 ops on
  subsets, the LSTMs of one shared key on (0), (0-3), (3), (2) and so
  on, ``lstm0_1`` on (0-3) overlapping ``lstm0_0`` on (0), the vocab
  projections split 8 and 4 ways over the vocab (unfused).

Each is held to the losses (rtol 2e-4 / atol 2e-5) and every final leaf
(within 1e-4 of the largest magnitude among its key's leaves), the ranks
holding one block holding the same bits; and to residency: each key on
exactly the ranks that run an op of it.  ``apps.nmt --pipeline-stages 2``
and ``--strategy nmt_8dev.json`` run as the ranks of a torchrun world,
their losses against the app's run without them in one process.  All
cases share one spawn of 8 processes (``tests/torch_ranks.py``).
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_ranks as tr

torch.set_num_threads(2)

STRATEGIES = Path(__file__).resolve().parents[1] / "examples" / "strategies"

CFG = dict(batch_size=8, num_layers=2, seq_length=8, hidden_size=16,
           embed_size=16, vocab_size=64, lstm_per_node_length=4,
           learning_rate=1.0)
APP = ["-b", "8", "-l", "2", "-s", "8", "-h", "16", "-e", "16", "--vocab",
       "64", "--chunk", "4", "-i", "3", "--lr", "1.0", "--device", "cpu"]


def _strategies():
    from flexflow_tpu_torch.machine import MachineModel
    from flexflow_tpu_torch.nmt.rnn_model import (RnnConfig,
                                                  default_global_config,
                                                  pipeline_stage_strategy)

    cfg, m = RnnConfig(**CFG), MachineModel("cpu", world_size=8)
    wave = default_global_config(cfg, m)
    for layer in range(2):
        for j in range(4):
            block = tuple(range(4)) if (layer + j) % 2 == 0 \
                else tuple(range(4, 8))
            wave[f"lstm{layer}_{j}"] = type(wave[f"lstm{layer}_{j}"])(
                (4,), block)
    return {"default": None, "wavefront": wave.to_json(),
            "pipeline": pipeline_stage_strategy(cfg, m, 2).to_json(),
            "nmt_8dev": (STRATEGIES / "nmt_8dev.json").read_text()}


def _expected_holders(strategy_json):
    """``{key: ranks}``: the union of the device lists of each key's ops
    (all 8 for an op on the whole machine)."""
    from flexflow_tpu_torch.machine import MachineModel
    from flexflow_tpu_torch.nmt.rnn_model import (RnnConfig,
                                                  default_global_config)
    from flexflow_tpu_torch.strategy import Strategy

    s = Strategy.from_json(strategy_json) if strategy_json \
        else default_global_config(RnnConfig(**CFG),
                                   MachineModel("cpu", world_size=8))
    out = {}
    for name, pc in s.items():
        kind = name.rstrip("0123456789_")
        if kind == "embed":
            key = "srcEmbed" if int(name[5:]) < 2 else "dstEmbed"
        elif kind == "lstm":
            layer, j = name[4:].split("_")
            key = ("encoder" if int(j) < 2 else "decoder") + layer
        elif kind == "linear":
            key = "linear"
        else:
            continue
        out.setdefault(key, set()).update(pc.devices)
    return {key: tuple(sorted(v)) for key, v in out.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("nmt")
    batches = tr.token_batches(3, 8, 8, 64)
    strategies = _strategies()
    want, cases = {}, []
    for name, text in strategies.items():
        full, losses, final = tr.jax_nmt(CFG, text, jax.devices()[:8],
                                         batches)
        path = str(tmp / f"{name}.npz")
        tr.save_trees(path, full, {})
        want[name] = (losses, final, path)
        cases.append(("nmt_train", (CFG, text, path, batches)))
    path = tmp / "nmt_8dev.json"
    path.write_text(strategies["nmt_8dev"])
    apps = [APP + ["--pipeline-stages", "2"], APP + ["--strategy", str(path)]]
    cases += [("app_main", (argv, "nmt")) for argv in apps]
    res = tr.run_ranks(tr.run_cases, 8, cases, timeout=240)
    return strategies, batches, want, res


@pytest.mark.parametrize("name", ["default", "wavefront", "pipeline",
                                  "nmt_8dev"])
def test_nmt_on_8_ranks_matches_jax_and_one_rank(runs, name):
    strategies, batches, want, res = runs
    i = list(strategies).index(name)
    per_rank = [r[i] for r in res]
    j_losses, j_params, path = want[name]
    losses = per_rank[0][0]
    assert all(r[0] == losses for r in per_rank)
    np.testing.assert_allclose(losses, j_losses, rtol=tr.LOSS_RTOL,
                               atol=tr.LOSS_ATOL)
    # the steps trained: the loss moves off its first value
    assert abs(losses[-1] - losses[0]) > 1e-3
    shapes = {k: {leaf: v.shape for leaf, v in d.items()}
              for k, d in j_params.items()}
    params = tr.assemble(shapes, [r[1] for r in per_rank])
    tr.close_trees(params, j_params, f"{name} params vs JAX")
    one_losses, one_params = tr.nmt_local(CFG, path, batches)
    np.testing.assert_allclose(losses, one_losses, rtol=tr.LOSS_RTOL,
                               atol=tr.LOSS_ATOL)
    tr.close_trees(params, one_params, f"{name} params vs one rank")
    assert tr.holders(per_rank) == _expected_holders(strategies[name])


def test_nmt_embeds_are_resident_where_pinned(runs):
    strategies, _, _, res = runs
    held = {name: tr.holders([r[i] for r in res])
            for i, name in enumerate(strategies)}
    assert held["default"]["srcEmbed"] == (0,)
    assert held["default"]["dstEmbed"] == (1,)
    assert held["pipeline"]["encoder1"] == (4, 5, 6, 7)
    assert held["nmt_8dev"]["srcEmbed"] == (0, 7)
    assert held["nmt_8dev"]["dstEmbed"] == (2, 4)
    assert held["nmt_8dev"]["encoder0"] == (0, 1, 2, 3)


def test_nmt_app_under_torchrun_matches_the_run_without_a_strategy(runs):
    from flexflow_tpu_torch.apps import nmt

    _, _, _, res = runs
    base = nmt.main(APP, log=lambda *a: None)["loss"]
    for i in (4, 5):
        got = res[0][i]
        assert all(r[i] is None for r in res[1:])
        np.testing.assert_allclose(got, base, rtol=tr.LOSS_RTOL,
                                   atol=tr.LOSS_ATOL)
    assert json.loads(runs[0]["nmt_8dev"])["lstm0_1"]["devices"] == \
        [0, 1, 2, 3]
