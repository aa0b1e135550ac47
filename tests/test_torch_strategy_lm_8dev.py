"""The GPT trainer on 8 gloo ranks under the searched LM strategy
``examples/strategies/transformer_8dev.json`` as written, against the
JAX package's run of the same file on its 8-device virtual CPU mesh and
against the port's run in one process; ``apps.lm --strategy`` as the
ranks of a torchrun world; the refusals that remain.

The file puts every mechanism of the LM's grids on the path: ring
attention (s = 2) in ``blk4_attn`` and ``blk10_attn``, heads split 2 or
4 ways in seven attention ops, channel-split MLP linears, some on device
subsets (``blk11_ff2`` on 4-7, ``blk1_ff2`` on 0-1), sequence-split
norms and residuals, the token embedding pinned to device 1 and the
vocab-split head ``lm_head`` (8, 1), fused over the ranks.  At
``tests/test_transformer.py:56-61``'s tiny widths (batch 8, seq 16,
d_model 32, 4 heads, d_ff 64, vocab 64) with the file's 12 layers,
causal, 3 SGD steps at lr 0.1 from JAX's ``init(seed=0)`` tree: losses
within rtol 2e-4 / atol 2e-5, every final leaf within 1e-4 of the
largest magnitude among its key's leaves, each key held on exactly the
ranks its ops name.  One spawn of 8 processes (``tests/torch_ranks.py``)
runs the strategy and the app.
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

CFG = dict(batch_size=8, seq_length=16, num_layers=12, d_model=32,
           num_heads=4, d_ff=64, vocab_size=64, causal=True,
           learning_rate=0.1, seed=5)
APP = ["--causal", "-b", "8", "-s", "16", "-l", "2", "--d-model", "32",
       "--heads", "4", "--d-ff", "64", "--vocab", "64", "-i", "3",
       "--lr", "0.1", "--device", "cpu"]
#: a strategy for the app's 2 layers: ring x data parallel and head
#: parallel attention, a channel-split MLP and the vocab-split head
APP_GRIDS = {"blk0_attn": (2, 1, 4), "blk1_attn": (1, 2, 4),
             "blk0_ff1": (8, 1), "blk1_ff2": (2, 4), "blk0_ln2": (8, 1),
             "lm_head": (4, 2)}


def _expected_holders(text):
    """``{key: ranks}``: the union of the device lists of each key's ops
    (every op of the LM has a key of its own)."""
    from flexflow_tpu_torch.strategy import Strategy

    s = Strategy.from_json(text)
    out = {}
    for name in tr.lm_model(_shadow(), CFG, None).param_shapes():
        out[name] = tuple(sorted(s[name].devices)) if name in s \
            else tuple(range(8))
    return out


def _shadow():
    from flexflow_tpu_torch.machine import MachineModel

    return MachineModel("cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm8dev")
    text = (STRATEGIES / "transformer_8dev.json").read_text()
    batches = [np.random.RandomState(11 + i).randint(0, 64, (8, 16))
               .astype("int32") for i in range(3)]
    full, losses, final = tr.jax_lm(CFG, text, jax.devices()[:8], batches)
    path = str(tmp / "trees.npz")
    tr.save_trees(path, full, {})
    app_file = tmp / "app.json"
    app_file.write_text(tr.strategy_json(APP_GRIDS, 8))
    cases = [("lm_train", (CFG, text, path, batches)),
             ("app_main", (APP + ["--strategy", str(app_file)], "lm"))]
    res = tr.run_ranks(tr.run_cases, 8, cases, timeout=240)
    return text, batches, (losses, final, path), res


def test_transformer_8dev_matches_jax_and_one_rank(runs):
    text, batches, want, res = runs
    per_rank = [r[0] for r in res]
    losses = tr.check_lm(want, per_rank, CFG, batches)
    assert abs(losses[-1] - losses[0]) > 1e-3
    assert tr.holders(per_rank) == _expected_holders(text)


def test_transformer_8dev_residency(runs):
    """The token table on rank 1 alone, the subset MLPs on their ranks,
    the head's vocab in 8 blocks, ring blocks' projections whole."""
    _, _, _, res = runs
    per_rank = [r[0] for r in res]
    held = tr.holders(per_rank)
    assert held["embed"] == (1,)
    assert held["blk11_ff2"] == (4, 5, 6, 7)
    assert held["blk1_ff2"] == (0, 1)
    assert held["blk3_ff2"] == (6, 7)
    cols = [r[1]["lm_head"]["kernel"][0][1] for r in per_rank]
    assert cols == [(8 * i, 8 * i + 8) for i in range(8)]
    # blk4_attn (2, 1, 4): heads whole; blk1_attn (1, 4, 2): 4 head blocks
    assert {r[1]["blk4_attn"]["wq"][0] for r in per_rank} == \
        {((0, 32), (0, 32))}
    assert sorted({r[1]["blk1_attn"]["wq"][0][1] for r in per_rank}) == \
        [(0, 8), (8, 16), (16, 24), (24, 32)]


def test_lm_app_under_torchrun_matches_the_run_without_a_strategy(runs):
    from flexflow_tpu_torch.apps import lm

    _, _, _, res = runs
    base = lm.main(APP, log=lambda *a: None)["loss"]
    assert all(r[1] is None for r in res[1:])
    np.testing.assert_allclose(res[0][1], base, rtol=tr.LOSS_RTOL,
                               atol=tr.LOSS_ATOL)


def test_gpt_preset_plans_under_the_searched_strategy():
    """``build_gpt("0.1b")`` (the GPT-2-small widths the file was searched
    for) plans under the file on 8 positions without a process group:
    every grid divides its tensors, the head fuses over its 8 vocab
    blocks and each position holds its block of the head and its heads
    of the head-parallel attentions."""
    from flexflow_tpu_torch.machine import MachineModel
    from flexflow_tpu_torch.models.gpt import build_gpt
    from flexflow_tpu_torch.strategy import Strategy

    strategies = Strategy.load(str(STRATEGIES / "transformer_8dev.json"))
    for pos in (0, 5):
        model = build_gpt("0.1b", MachineModel("cpu", world_size=8,
                                               rank=pos), strategies)
        model._setup_sharded()
        fusion = {model.layers[i].name: lin
                  for i, lin in model._lm_head_fusion().items()}
        assert fusion["softmax"].name == "lm_head"
        boxes = model.param_boxes()
        assert boxes["lm_head"]["kernel"] == ((0, 768),
                                              (4096 * pos, 4096 * pos + 4096))
        # blk1_attn (1, 4, 2): heads split 4 ways, 3 of 12 a position,
        # grid point (0, p % 4, p // 4) at position p (dim 0 fastest)
        lo = 192 * (pos % 4)
        assert boxes["blk1_attn"]["wq"] == ((0, 768), (lo, lo + 192))
        assert ("embed" in boxes) == (pos == 1)


def test_lm_refusals_name_their_roadmap_items():
    from flexflow_tpu_torch.apps import lm
    from flexflow_tpu_torch.machine import MachineModel

    # a strategy file with a __pipeline__ block whose per-op entries name
    # eight devices: on one process the static plan check refuses it
    # (exit status 2, as the JAX driver on one device) before the block
    # is read, with --experts too; on the eight ranks it names the block
    # takes the pipelined path, which refuses --experts
    # (tests/test_torch_pipeline.py)
    for name in ("transformer_2x4.json", "moe_2x4_measured.json"):
        path = STRATEGIES / name
        assert "__pipeline__" in json.loads(path.read_text())
        for extra in ([], ["--experts", "4"]):
            with pytest.raises(SystemExit) as exited:
                lm.main(APP + ["--strategy", str(path)] + extra,
                        log=lambda *a: None)
            assert exited.value.code == 2
    # the MoE op over several ranks (3c-ii, done): the MoE LM inits on
    # every position of a data-parallel world
    moe = tr.lm_model(MachineModel("cpu", world_size=2),
                      dict(CFG, num_layers=1, num_experts=4), None)
    full, _ = moe._init_full(0)
    for pos in (0, 1):
        assert moe.shard_params(full, pos)["blk0_moe"]["w1"].shape == \
            full["blk0_moe"]["w1"].shape
