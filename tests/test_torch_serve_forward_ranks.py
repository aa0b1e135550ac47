"""The port's forward-only service over ranks and under a strategy file
(``ServeEngine.run_forward``, ``FFModel.gather_output``, ``apps.serve``'s
``-s`` for the CNNs and the NMT) against the JAX package's
``run_forward``, on two gloo CPU ranks in one world:

* the small CNN data parallel and under a strategy that splits its linear
  over c, the tiny NMT under ``default_global_config`` and a two-layer
  one under ``pipeline_stage_strategy`` (two stages): replies
  within 1e-5 of their largest magnitude, the summary and every record
  equal to JAX's on ``machine8.shrink([0, 1])`` under the same strategy;
* ``-s`` on one rank equals JAX's one-device run;
* a drain requested on rank 1 alone, before batch 2, stops admission on
  both ranks at that batch, the batch served before it JAX's;
* ``apps.serve -s`` of a strategy with an error finding exits 2 on both
  ranks;
* the output assembly is exact (bitwise) against the whole tensor on a
  2-D and a 3-D value, and so are the rows ``gather_rows`` reads.
"""

import json

import numpy as np
import pytest
import torch

import torch_ranks as tr
from flexflow_tpu import obs as j_obs
from flexflow_tpu.apps.serve import _forward_payloads as j_payloads
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.model import FFModel as JModel
from flexflow_tpu.serve.engine import ServeEngine as JEngine
from flexflow_tpu.serve.loadgen import synthetic_requests as j_requests
from flexflow_tpu.strategy import Strategy as JStrategy

torch.set_num_threads(2)

STEP = 0.02
CNN = dict(batch_size=4, input_height=16, input_width=16, num_classes=8)
NMT = dict(batch_size=4, num_layers=1, seq_length=4, hidden_size=16,
           embed_size=16, vocab_size=64, lstm_per_node_length=2)
#: the linear's channels over the two ranks (a regrid before it)
C_SPLIT = tr.strategy_json({"fc1": [2, 1]}, 2)
#: an executor that would normalize the softmax's devices (1, 0): an
#: error finding of the plan check
BAD = json.dumps({"softmax": {"dims": [2], "devices": [1, 0]}})
#: replies against JAX's, as a share of their largest magnitude
RTOL = 1e-5
#: the two-layer NMT with layer l on device block l % 2 (JAX's
#: ``pipeline_stage_strategy``, ``--pipeline-stages 2``)
NMT2 = dict(NMT, num_layers=2)


def _pipelined():
    from flexflow_tpu.machine import MachineModel
    from flexflow_tpu.nmt.rnn_model import RnnConfig, pipeline_stage_strategy

    return pipeline_stage_strategy(RnnConfig(**NMT2),
                                   MachineModel.virtual(2), 2).to_json()


#: (label, kind, config, strategy, requests, seed): the cases served on
#: both packages; "drain" is the CNN with rank 1's drain before batch 2
CASES = {"dp": ("cnn", CNN, None, 10, 3),
         "c_split": ("cnn", CNN, C_SPLIT, 10, 4),
         "nmt": ("nmt", NMT, None, 6, 5),
         "nmt_pipe": ("nmt", NMT2, _pipelined(), 6, 6),
         "drain": ("cnn", CNN, None, 10, 3)}
WALL = ("ts", "run", "wall_s")


def _jax_model(kind, cfg, strategy, machine):
    if kind == "nmt":
        from flexflow_tpu.nmt.rnn_model import RnnConfig, RnnModel

        return RnnModel(RnnConfig(**cfg), machine,
                        JStrategy.from_json(strategy) if strategy else None)
    c = JConfig(**cfg)
    if strategy:
        c.strategies = JStrategy.from_json(strategy)
    jm = JModel(c, machine)
    tr.verify_net(jm, jm.create_input((cfg["batch_size"], 16, 16, 3),
                                      name="image"))
    return jm


def _jax_run(tmp_path, tag, kind, cfg, strategy, n, seed, machine):
    """JAX's ``run_forward`` of the case: ``(summary, replies, stamps,
    records)`` in the rank bodies' form, and the trees' path."""
    jm = _jax_model(kind, cfg, strategy, machine)
    path = str(tmp_path / f"{tag}.jsonl")
    olog = j_obs.RunLog(path, run_id="r", surface="serve")
    eng = JEngine(jm, None, olog=olog, log=lambda *a: None,
                  step_time_s=STEP)
    full, state = tr.jax_logical(jm, eng.params, eng.state)
    trees = str(tmp_path / f"{tag}.npz")
    tr.save_trees(trees, full, state)
    reqs = j_requests(n, seed=seed, rate_qps=200.0, vocab_size=64,
                      prompt_len=4, max_new_tokens=0)
    j_payloads(jm, reqs, seed)
    summary = eng.run_forward(reqs)
    olog.close()
    summary.pop("wall_s")
    reqs = sorted(reqs, key=lambda r: r.rid)
    records = [{k: v for k, v in r.items() if k not in WALL}
               for r in j_obs.read_run(path)
               if r["kind"] not in ("run_start", "run_end")]
    return (summary, [np.asarray(r.reply) for r in reqs],
            [(r.rid, r.admit_v, r.done_v) for r in reqs], records), trees


@pytest.fixture(scope="module")
def world(machine8, tmp_path_factory):
    """Every case's JAX run on ``machine8.shrink([0, 1])``, and every
    port case in one two-rank world: ``(jax by label, port results per
    rank by label)``."""
    tmp = tmp_path_factory.mktemp("serve_forward_ranks")
    two = machine8.shrink([0, 1])
    want, cases = {}, []
    for label, (kind, cfg, strategy, n, seed) in CASES.items():
        want[label], trees = _jax_run(tmp, label, kind, cfg, strategy, n,
                                      seed, two)
        # rank 1 alone asks at its third check: before batch 2
        extra = (3, 1) if label == "drain" else (None, None)
        cases.append(("forward_serve", (kind, cfg, strategy, trees, n,
                                        seed, STEP) + extra
                      + (str(tmp / f"{label}.port.jsonl"),)))
    bad = tmp / "bad.json"
    bad.write_text(BAD)
    cases.append(("serve_exit", (["alexnet", "-n", "2", "--max-batch", "2",
                                  "--device", "cpu", "-s", str(bad)],)))
    for kind, cfg, strategy in (("cnn", CNN, None), ("cnn", CNN, C_SPLIT),
                                ("lm", None, None), ("nmt", NMT, None)):
        cases.append(("assembled", (kind, cfg, strategy)))
    ranks = tr.run_ranks(tr.run_cases, 2, cases, timeout=150)
    got = [dict(zip(list(CASES) + ["bad", "dp2", "c2", "lm3", "nmt3"],
                    res)) for res in ranks]
    return want, got


def _same(want, got, served=None):
    """The port's run against JAX's: the summary and the records (a whole
    run), the stamps and replies of the first ``served`` requests (all by
    default), the rest unserved; returns the worst reply difference as a
    share of the reply's largest magnitude."""
    jsum, jreplies, jstamps, jrecs = want
    tsum, treplies, tstamps, trecs = got
    whole = served is None
    served = len(jreplies) if whole else served
    for key in ("requests", "completed", "unserved", "dropped", "steps",
                "p50_s", "p99_s", "ttft_p50_s", "qps", "virtual_s",
                "devices") if whole else ():
        a, b = tsum[key], jsum[key]
        assert a == b or (a != a and b != b), (key, a, b)
    assert tstamps[:served] == jstamps[:served]
    worst = 0.0
    for a, b in zip(treplies[:served], jreplies[:served]):
        scale = float(np.abs(b).max())
        worst = max(worst, float(np.abs(a - b).max()) / scale)
    assert worst <= RTOL, worst
    assert all(r is None for r in treplies[served:])
    if trecs is not None and whole:
        assert trecs == jrecs
    return worst


@pytest.mark.parametrize("label", ["dp", "c_split", "nmt", "nmt_pipe"])
def test_forward_service_over_two_ranks_matches_jax(world, label):
    want, got = world
    for rank, res in enumerate(got):
        _same(want[label], res[label])
        assert res[label][0]["completed"] == CASES[label][3]
    # every rank assembles the same whole output
    for a, b in zip(got[0][label][1], got[1][label][1]):
        np.testing.assert_array_equal(a, b)
    if label.startswith("nmt"):
        assert got[0][label][1][0].shape == (2, 64)


def test_drain_on_one_rank_stops_both_at_the_same_batch(world):
    want, got = world
    for res in got:
        summary = res["drain"][0]
        assert (summary["completed"], summary["unserved"],
                summary["steps"], summary["drained"]) == (4, 6, 1, True)
        # the batch served before the drain is JAX's first
        _same(want["drain"], res["drain"], served=4)
    recs = got[0]["drain"][3]
    assert [r["kind"] for r in recs].count("serve_request") == 4


def test_strategy_with_an_error_finding_exits_2_on_every_rank(world):
    _, got = world
    assert [res["bad"] for res in got] == [2, 2]


@pytest.mark.parametrize("label", ["dp2", "c2", "lm3", "nmt3"])
def test_output_assembly_is_exact(world, label):
    _, got = world
    for res in got:
        whole, gathered, rows, got_rows = res[label]
        assert whole.ndim == (3 if label in ("lm3", "nmt3") else 2)
        np.testing.assert_array_equal(gathered, whole)
        np.testing.assert_array_equal(got_rows, rows)


def test_strategy_on_one_rank_matches_jax(machine1, tmp_path):
    """``-s`` on one device: the small CNN under a one-device strategy
    file (the app refused any ``-s`` before) against JAX's one-device
    run; then ``apps.serve alexnet -s`` serves in one process."""
    from flexflow_tpu_torch.apps import serve

    one = tr.strategy_json({"conv1": [1, 1, 1, 1]}, 1)
    want, trees = _jax_run(tmp_path, "one", "cnn", CNN, one, 6, 7,
                           machine1)
    got = tr.forward_serve(serve.machine_for(serve.parse_args(
        ["--device", "cpu"])), "cnn", CNN, one, trees, 6, 7, STEP,
        obs_path=str(tmp_path / "one.port.jsonl"))
    _same(want, got)
    path = tmp_path / "one.json"
    path.write_text(one)
    line = serve.serve_run(serve.parse_args(
        ["alexnet", "-n", "2", "--max-batch", "2", "--device", "cpu",
         "-s", str(path)]), log=lambda *a: None)
    assert (line["completed"], line["unserved"]) == (2, 0)
