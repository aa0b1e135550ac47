"""The GPT trainer over gloo ranks under per-op strategies, against the
JAX package's run of the same strategy on its 8-device virtual CPU mesh
and against the port's run in one process.

At ``tests/test_transformer.py:56-61``'s tiny widths (batch 8, seq 16,
d_model 32, 4 heads, d_ff 64, vocab 64), 2 layers, causal as ``apps.lm
--causal`` trains, 3 SGD steps at lr 0.1 from JAX's ``init(seed=0)``
tree, each rank keeping the blocks of the ops it runs, under:

* ``test_transformer_sop_invariance``'s strategy
  (``tests/test_transformer.py:104-112``) on 8 ranks: ring attention x
  data parallel in block 0, head parallel x data parallel in block 1,
  channel-split MLP linears, a sequence-split norm and the vocab-split
  head (c = 8, fused over the ranks);
* the same, not causal;
* ``tests/test_pallas.py:246``'s (4, 2) vocab-parallel head, the port's
  fused head against JAX's unfused loss and gradients (JAX fuses only at
  b*s >= 2048 tokens);
* the two-rank strategy of ``chip_smoke.py``'s LM phase on 2 ranks: ring
  attention in the even blocks, heads split in the odd, ``ff1`` (2, 1),
  ``ff2`` (1, 2), norms and residuals alternating (2, 1) and (1, 2),
  ``embed`` on rank 1 alone and the head at (2, 1).

Each is held to the losses (rtol 2e-4 / atol 2e-5) and every final leaf
(within 1e-4 of the largest magnitude among its key's leaves), the ranks
holding one block holding the same bits.  The 8-rank cases share one
spawn, the 2-rank case another (``tests/torch_ranks.py``).
"""

import json

import jax
import pytest
import torch

import torch_ranks as tr

torch.set_num_threads(2)

CFG = dict(batch_size=8, seq_length=16, num_layers=2, d_model=32,
           num_heads=4, d_ff=64, vocab_size=64, causal=True,
           learning_rate=0.1, seed=5)


def _dims(grids, ranks):
    return json.loads(tr.strategy_json(grids, ranks))


SOP = {"blk0_attn": (4, 1, 2), "blk1_attn": (1, 4, 2),
       "blk0_ff1": (4, 2), "blk0_ff2": (2, 4), "blk1_ln1": (4, 2),
       "lm_head": (8, 1)}
VOCAB_TP = {"lm_head": (4, 2)}


def two_rank_strategy(layers):
    """``chip_smoke.py``'s two-rank LM strategy over ``layers`` blocks."""
    grids = {"lm_head": (2, 1)}
    for i in range(layers):
        grids[f"blk{i}_attn"] = (2, 1, 1) if i % 2 == 0 else (1, 2, 1)
        grids[f"blk{i}_ff1"] = (2, 1)
        grids[f"blk{i}_ff2"] = (1, 2)
        for j, op in enumerate(("ln1", "res1", "ln2", "gelu", "res2")):
            grids[f"blk{i}_{op}"] = (2, 1) if (i + j) % 2 == 0 else (1, 2)
    obj = _dims(grids, 2)
    obj["embed"] = {"dims": [1], "devices": [1]}
    return json.dumps(obj)


CASES8 = {"sop": (CFG, tr.strategy_json(SOP, 8)),
          "sop_noncausal": (dict(CFG, causal=False),
                            tr.strategy_json(SOP, 8)),
          "vocab_tp": (CFG, tr.strategy_json(VOCAB_TP, 8))}


def _batches():
    return [tr.token_batches(1, 8, 16, 64, seed=7 + i)[0][0]
            for i in range(3)]


def _jax_case(tmp, name, cfg, text, devices, batches):
    full, losses, final = tr.jax_lm(cfg, text, jax.devices()[:devices],
                                    batches)
    path = str(tmp / f"{name}.npz")
    tr.save_trees(path, full, {})
    return (losses, final, path), ("lm_train", (cfg, text, path, batches))


@pytest.fixture(scope="module")
def runs8(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm8")
    batches = _batches()
    want, cases = {}, []
    for name, (cfg, text) in CASES8.items():
        want[name], case = _jax_case(tmp, name, cfg, text, 8, batches)
        cases.append(case)
    res = tr.run_ranks(tr.run_cases, 8, cases, timeout=240)
    return batches, want, res


@pytest.mark.parametrize("name", list(CASES8))
def test_lm_on_8_ranks_matches_jax_and_one_rank(runs8, name):
    batches, want, res = runs8
    i = list(CASES8).index(name)
    losses = tr.check_lm(want[name], [r[i] for r in res], CASES8[name][0],
                         batches)
    # the steps trained: the loss moves off its first value
    assert abs(losses[-1] - losses[0]) > 1e-3


def test_vocab_parallel_head_blocks(runs8):
    """Under the (4, 2) head each rank holds a quarter of the vocab
    columns of lm_head, and training fuses the head with the loss: the
    labels move to the head's batch rows, each counted on one c rank."""
    from flexflow_tpu_torch.machine import MachineModel

    _, _, res = runs8
    i = list(CASES8).index("vocab_tp")
    cols = sorted({r[i][1]["lm_head"]["kernel"][0][1] for r in res})
    assert cols == [(0, 16), (16, 32), (32, 48), (48, 64)]
    counted = []
    for pos in range(8):
        m = MachineModel("cpu", world_size=8, rank=pos)
        model = tr.lm_model(m, CFG, CASES8["vocab_tp"][1])
        model._setup_sharded()
        fusion = {model.layers[j].name: lin
                  for j, lin in model._lm_head_fusion().items()}
        assert fusion["lm_head"] is None
        assert fusion["softmax"].name == "lm_head"
        assert ("lm_head", "labels") in model._plan.edges
        counted.append(model.loss_counted(model.loss_op, True))
    # c = 4 is the fast axis: one rank of each 4 counts its n block
    assert counted == [True, False, False, False] * 2


@pytest.fixture(scope="module")
def runs2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm2")
    batches = _batches()
    text = two_rank_strategy(CFG["num_layers"])
    want, case = _jax_case(tmp, "two", CFG, text, 2, batches)
    res = tr.run_ranks(tr.run_cases, 2, [case], timeout=120)
    return batches, want, [r[0] for r in res]


def test_two_rank_chip_strategy_matches_jax_and_one_rank(runs2):
    batches, want, res = runs2
    tr.check_lm(want, res, CFG, batches)


def test_two_rank_residency(runs2):
    """embed on rank 1 alone; the ring's blocks whole on both ranks; the
    odd blocks' heads and ff1's channels split between the ranks."""
    _, _, res = runs2
    assert tr.holders(res)["embed"] == (1,)
    boxes = [r[1] for r in res]
    assert [b["blk0_attn"]["wq"][0] for b in boxes] == \
        [((0, 32), (0, 32))] * 2
    assert [b["blk1_attn"]["wq"][0][1] for b in boxes] == [(0, 16), (16, 32)]
    assert [b["blk1_attn"]["wo"][0][0] for b in boxes] == [(0, 16), (16, 32)]
    assert [b["blk0_ff1"]["kernel"][0][1] for b in boxes] == [(0, 32),
                                                               (32, 64)]
    assert [b["pos_embed"]["table"][0] for b in boxes] == \
        [((0, 16), (0, 32))] * 2
