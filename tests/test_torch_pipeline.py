"""The GPipe pipelined LM (``flexflow_tpu_torch/parallel/pipeline.py``)
on 8 gloo ranks against the JAX package's ``parallel/pipeline.py``.

* ``spmd_pipeline`` of tests/test_pipeline.py's stage ``tanh(x @ w +
  b)`` (d 8, 4 microbatches of 4 rows) over 4 stages x 2 data-parallel
  ranks: its outputs, and the gradients of sum(out * gy) in every
  stage's w and b and in the microbatches, within 1e-5 of JAX's
  ``sequential_reference`` and its gradients; the port's
  ``sequential_reference`` within 1e-6 of JAX's.
* ``PipelinedLM`` at ``test_pipelined_lm_matches_sequential``'s widths
  (2 stages, 2 microbatches, 4 layers, d_model 16, 4 heads, d_ff 32,
  vocab 64, seq 16, batch 8, causal) with tp 1 (x 4 data parallel) and
  tp 2 (x 2), from JAX's ``init(0)`` tree with a random head: the first
  loss within 1e-5 of JAX's ``loss_fn`` and of the port's
  ``loss_reference``; three SGD steps at lr 0.1 within rtol 2e-4 / atol
  2e-5 of JAX's ``make_train_step``, every final leaf within 1e-4 of
  its largest magnitude, each rank holding its stage's slice at its tp
  columns.
* ``apps.lm`` by ``--pipeline-stages 2 --microbatches 2 --pipeline-tp
  2``, by a ``__pipeline__`` block with tp 2 and by a block without tp
  beside per-op attention entries that split the heads 2 ways
  (``test_pipeline_block_tp_from_file``): the same losses within 1e-6.
* The ``(stage, n, tp)`` rank map equals JAX's mesh, and the pipelined
  path refuses ``--experts`` (by flag on one rank, and
  ``moe_2x4_measured.json`` as written on the 8 ranks its entries name,
  past the static plan check) with JAX's ``SystemExit``.

One spawn of 8 processes (``tests/torch_ranks.py``) runs every case.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks as tr
from flexflow_tpu.parallel import pipeline as jpipe
from flexflow_tpu_torch.parallel import pipeline as tpipe

torch.set_num_threads(2)

STRATEGIES = Path(__file__).resolve().parents[1] / "examples" / "strategies"

STAGES, D, MB, M = 4, 8, 4, 4
LM = dict(num_stages=2, num_microbatches=2, num_layers=4, d_model=16,
          num_heads=4, d_ff=32, vocab_size=64, seq_length=16, batch_size=8,
          learning_rate=0.1)
APP = ["-b", "16", "-s", "16", "-l", "4", "--d-model", "64", "--heads",
       "4", "--d-ff", "128", "--vocab", "256", "--iters", "2", "--seed",
       "5", "--device", "cpu"]
APP_FLAGS = APP + ["--pipeline-stages", "2", "--microbatches", "2",
                   "--pipeline-tp", "2"]


def _stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _stage_case(tmp):
    """The simple stage's inputs and JAX's sequential outputs and
    gradients."""
    rng = np.random.RandomState(3)
    params = {"w": (rng.randn(STAGES, D, D) / np.sqrt(D)).astype("float32"),
              "b": (0.1 * rng.randn(STAGES, D)).astype("float32")}
    xs = rng.randn(M, MB, D).astype("float32")
    gy = rng.randn(M, MB, D).astype("float32")
    path = str(tmp / "stage.npz")
    np.savez(path, xs=xs, gy=gy, **params)

    def loss(p, x):
        out = jpipe.sequential_reference(_stage, p, x)
        return jnp.sum(out * gy), out

    (_, out), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(params, xs)
    return path, params, xs, (np.asarray(out), jax.tree.map(np.asarray, gp),
                              np.asarray(gx))


def _lm_case(tmp, tp, batches):
    """JAX's PipelinedLM on the 8-device mesh: (tree path, first loss,
    losses of 3 steps, final tree)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from flexflow_tpu.machine import MachineModel

    model = jpipe.PipelinedLM(MachineModel(), tp=tp, **LM)
    params = model.init(0)
    head = np.random.RandomState(7).randn(16, 64).astype("float32") * 0.1
    params["head_w"] = jax.device_put(head, NamedSharding(model.mesh, P()))
    tree = jax.tree.map(np.asarray, params)
    path = str(tmp / f"lm_tp{tp}.npz")
    tr.save_pipelined(path, tree)
    first = float(model.loss_fn(params, batches[0], batches[0]))
    step = model.make_train_step()
    losses = []
    for toks in batches:
        params, loss = step(params, toks, toks)
        losses.append(float(loss))
    return path, first, losses, jax.tree.map(np.asarray, params)


#: the pipelined path from ``moe_2x4_measured.json``'s block, with experts
EXPERTS_FROM_FILE = [
    "-b", "32", "-s", "16", "-l", "12", "--d-model", "32", "--heads", "4",
    "--d-ff", "64", "--vocab", "64", "-i", "1", "--experts", "4",
    "--strategy", str(STRATEGIES / "moe_2x4_measured.json")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    stage = _stage_case(tmp)
    batches = [np.random.RandomState(31 + i).randint(0, 64, (8, 16))
               .astype("int32") for i in range(3)]
    lms = {tp: _lm_case(tmp, tp, batches) for tp in (1, 2)}
    block = tmp / "block.json"
    block.write_text(json.dumps({"__pipeline__": {
        "stages": 2, "microbatches": 2, "tp": 2}}))
    per_op = tmp / "per_op.json"
    per_op.write_text(json.dumps(
        {"__pipeline__": {"stages": 2, "microbatches": 2},
         **{f"attn{i}": {"dims": [1, 2, 4], "devices": list(range(8))}
            for i in range(2)}}))
    cases = [("pipe_stage", (STAGES, stage[0])),
             ("pipe_lm", (dict(LM, tp=1), lms[1][0], batches)),
             ("pipe_lm", (dict(LM, tp=2), lms[2][0], batches)),
             ("app_main", (APP_FLAGS, "lm", True)),
             ("app_main", (APP + ["--strategy", str(block)], "lm", True)),
             ("app_main", (APP + ["--strategy", str(per_op)], "lm", True)),
             ("app_checked", (EXPERTS_FROM_FILE + ["--device", "cpu"],
                              "lm"))]
    res = tr.run_ranks(tr.run_cases, 8, cases, timeout=300)
    return stage, lms, batches, res


def test_spmd_pipeline_matches_sequential_reference(runs):
    (_, params, xs, (out, gp, gx)), _, _, res = runs
    got_dx = np.zeros_like(gx)
    seen = set()
    for (s, n), (lo, hi), o, dw, db, dx in (r[0] for r in res):
        seen.add((s, n))
        # every stage holds the last stage's outputs
        np.testing.assert_allclose(o, out[:, lo:hi], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(dw, gp["w"][s], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(db, gp["b"][s], rtol=1e-5, atol=1e-5)
        if s == 0:
            got_dx[:, lo:hi] = dx
        else:
            assert not dx.any()        # x is read on the first stage only
    assert seen == {(s, n) for s in range(STAGES) for n in range(2)}
    np.testing.assert_allclose(got_dx, gx, rtol=1e-5, atol=1e-5)
    ref = tpipe.sequential_reference(
        lambda p, x: torch.tanh(x @ p["w"] + p["b"]),
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(xs))
    np.testing.assert_allclose(ref.numpy(), out, rtol=1e-6, atol=1e-6)


def _held(res, i):
    return [r[i] for r in res]


@pytest.mark.parametrize("tp,case", [(1, 1), (2, 2)])
def test_pipelined_lm_loss_matches_jax(runs, tp, case):
    from flexflow_tpu_torch.interop import params_from_jax
    from flexflow_tpu_torch.machine import MachineModel

    _, lms, batches, res = runs
    path, j_first, _, _ = lms[tp]
    firsts = {r[0] for r in _held(res, case)}
    assert len(firsts) == 1        # the loss is the global batch's
    first = firsts.pop()
    assert first == pytest.approx(j_first, rel=1e-5)
    # the sequential reference in one process, on the whole tree
    model = tpipe.PipelinedLM(MachineModel("cpu", world_size=8), tp=tp,
                              **LM)
    full = params_from_jax(tr.load_pipelined(path), "cpu", model=model)
    ref = float(model.loss_reference(full, batches[0], batches[0]))
    assert ref == pytest.approx(j_first, rel=1e-5)


@pytest.mark.parametrize("tp,case", [(1, 1), (2, 2)])
def test_pipelined_lm_sgd_steps_match_jax(runs, tp, case):
    _, lms, _, res = runs
    _, _, j_losses, j_final = lms[tp]
    per_rank = _held(res, case)
    losses = per_rank[0][1]
    assert all(r[1] == losses for r in per_rank)
    np.testing.assert_allclose(losses, j_losses, rtol=tr.LOSS_RTOL,
                               atol=tr.LOSS_ATOL)
    assert losses[-1] < losses[0]
    blocks = {k: np.full(v.shape, np.nan, np.float32)
              for k, v in j_final["blocks"].items()}
    for _, _, held in per_rank:
        for k, (box, v) in held["blocks"].items():
            blocks[k][tuple(slice(a, b) for a, b in box)] = v
        for k in j_final:
            if k != "blocks":     # the same bits on every rank
                np.testing.assert_array_equal(held[k][1],
                                              per_rank[0][2][k][1])
    got = dict(blocks=blocks, **{k: v[1] for k, v in
                                 per_rank[0][2].items() if k != "blocks"})
    for name, want in list(j_final["blocks"].items()) + \
            [(k, v) for k, v in j_final.items() if k != "blocks"]:
        g = got["blocks"][name] if name in j_final["blocks"] else got[name]
        scale = float(np.abs(want).max()) or 1.0
        err = float(np.abs(g - want).max())
        assert err <= tr.LEAF_RTOL * scale, f"{name}: {err:.3e} / {scale}"


def test_pipelined_lm_residency(runs):
    """Rank s*dp*tp + n*tp + t holds stage s's slice of the blocks at its
    tp columns (w1's, wo's rows), the embeddings and head whole."""
    _, _, _, res = runs
    for r, (_, _, held) in enumerate(_held(res, 2)):
        s, t = r // 4, r % 2
        assert held["blocks"]["w1"][0] == ((s, s + 1), (0, 2), (0, 16),
                                           (16 * t, 16 * t + 16))
        assert held["blocks"]["wo"][0] == ((s, s + 1), (0, 2),
                                           (8 * t, 8 * t + 8), (0, 16))
        assert held["blocks"]["ln1"][0] == ((s, s + 1), (0, 2), (0, 2),
                                            (0, 16))
        assert held["embed"][0] == ((0, 64), (0, 16))


def test_app_by_flags_block_and_per_op_tp_agree(runs):
    _, _, _, res = runs
    (flags, _), (block, lines_b), (per_op, lines_p) = res[0][3:6]
    assert all(r[i] == (None, []) for r in res[1:] for i in (3, 4, 5))
    np.testing.assert_allclose(block, flags, rtol=1e-6)
    np.testing.assert_allclose(per_op, flags, rtol=1e-6)
    assert np.isfinite(flags).all() and len(flags) == 2
    assert any("x tp=2 (stage-internal TP" in line for line in lines_p)
    assert any("file-driven GPipe" in line for line in lines_b)
    assert any(line.startswith("LM pipeline: 4 layers over 2 stages x 2 dp "
                               "x 2 tp, 2 microbatches") for line in lines_b)


def test_pipeline_rank_map_equals_jax_mesh():
    from flexflow_tpu.machine import MachineModel as JMachine
    from flexflow_tpu_torch.machine import MachineModel

    j = jpipe.PipelinedLM(JMachine(), tp=2, **LM)
    ids = np.vectorize(lambda d: d.id)(j.mesh.devices)   # (stage, n, tp)
    for r in range(8):
        mesh = MachineModel("cpu", world_size=8, rank=r).pipeline_mesh(
            2, 2, 2)
        s, n, t = mesh.coords
        assert ids[s, n, t] == r
        assert mesh.stage.positions == tuple(ids[:, n, t])
        assert mesh.tp_group.positions == tuple(ids[s, n, :])
        assert mesh.data.positions == tuple(ids[s, :, t])
        assert mesh.block.positions == tuple(ids[s].reshape(-1))


@pytest.mark.parametrize("argv", [
    ["-b", "8", "-s", "16", "-l", "2", "--d-model", "32", "--heads", "4",
     "--d-ff", "64", "--vocab", "64", "-i", "1", "--experts", "4",
     "--pipeline-stages", "2"],
    EXPERTS_FROM_FILE,
], ids=["flags", "moe_2x4_measured"])
def test_pipelined_path_refuses_experts_as_jax(argv, request):
    from flexflow_tpu.apps import lm as j_lm
    from flexflow_tpu_torch.apps import lm as t_lm

    with pytest.raises(SystemExit) as want:
        j_lm.main(argv, log=lambda *a: None)
    if "--strategy" in argv:
        # the file names eight devices: the static plan check passes it
        # on JAX's 8-device mesh and on the port's world of 8 ranks (the
        # module's spawn), and on one rank exits 2 as JAX's on one device
        got = {r[6][0] for r in request.getfixturevalue("runs")[3]}
        assert got == {str(want.value)}
        got = got.pop()
    else:
        with pytest.raises(SystemExit) as exited:
            t_lm.main(argv + ["--device", "cpu"], log=lambda *a: None)
        got = str(exited.value)
        assert got == str(want.value)
    assert got.startswith("--pipeline-stages does not support: --experts")


def test_pipelined_tree_shapes_are_checked():
    from flexflow_tpu_torch.interop import params_from_jax
    from flexflow_tpu_torch.machine import MachineModel

    model = tpipe.PipelinedLM(MachineModel("cpu", world_size=2), **LM)
    full = model.init_full(0)
    assert {k: (v.shape if not isinstance(v, dict) else
                {kk: vv.shape for kk, vv in v.items()})
            for k, v in full.items()} == model.param_shapes()
    bad = {k: v for k, v in full.items()}
    bad["head_b"] = np.zeros((3,), "float32")
    with pytest.raises(ValueError, match="head_b"):
        params_from_jax(bad, "cpu", model=model)


def test_one_stage_block_is_ignored_and_per_op_entries_kept(tmp_path):
    """A ``__pipeline__`` block of one stage leaves the op-DAG path and
    the file's per-op entries in force, with JAX's warning."""
    from flexflow_tpu_torch.apps import lm as t_lm

    path = tmp_path / "one_stage.json"
    path.write_text(json.dumps(
        {"__pipeline__": {"stages": 1, "microbatches": 2},
         "blk0_attn": {"dims": [1, 1, 1], "devices": [0]}}))
    lines = []
    out = t_lm.main(["--causal", "-b", "2", "-s", "16", "-l", "1",
                     "--d-model", "16", "--heads", "2", "--d-ff", "32",
                     "--vocab", "64", "-i", "2", "--device", "cpu",
                     "--strategy", str(path)], log=lines.append)
    assert any("has stages=1 <= 1 — ignored; per-op entries kept" in line
               for line in lines)
    assert lines[1].startswith("LM: causal, 1 layers")
    assert len(out["loss"]) == 2 and np.isfinite(out["loss"]).all()
