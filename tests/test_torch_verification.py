"""The verification switches of SURVEY §4 in the PyTorch port, on the CPU,
case by case against ``tests/test_verification.py`` and the JAX package:

* ``params_init="ones"`` (PARAMETER_ALL_ONES): every parameter leaf 1.0
  whatever the seed, the state as drawn, the losses of three steps and
  the LM's first loss (ln V) equal to JAX's;
* ``dry_compile`` (DISABLE_COMPUTATION): no step runs, no launch, a
  ``dry=True`` ``compile`` record and the ``dry-compile ok`` line, the
  trees' and batch's bytes equal to JAX's argument bytes; a bad grid
  refused at build; the NMT driver takes the flag; on two gloo ranks
  the plan's hops are built and no ``torch.distributed`` call moves
  data;
* ``print_intermediates`` (PRINT_INTERMEDIATE_RESULT): every printed
  statistic within 1e-5 of JAX's (the small CNN, a 2-layer LM, the
  NMT), on one process and on two gloo ranks; ``print_tensor``;
* the drivers' parse of the three switches and the executor's and
  search's switches against JAX's, the refused values with their
  reasons.
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks as tr
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.data import synthetic_batches as j_batches
from flexflow_tpu.model import FFModel as JModel
from flexflow_tpu.strategy import ParallelConfig as JPC
from flexflow_tpu.strategy import Strategy as JStrategy
from flexflow_tpu_torch import obs
from flexflow_tpu_torch.config import FFConfig as TConfig
from flexflow_tpu_torch.interop import params_from_jax, state_from_jax
from flexflow_tpu_torch.model import FFModel as TModel
from flexflow_tpu_torch.ops import kernels
from flexflow_tpu_torch.strategy import ParallelConfig as TPC
from flexflow_tpu_torch.strategy import Strategy as TStrategy
from flexflow_tpu_torch.utils.debug import print_tensor

torch.set_num_threads(2)

CNN = dict(batch_size=8, input_height=16, input_width=16, num_iterations=2,
           print_freq=0, num_classes=8)
LM = dict(batch_size=2, seq_length=8, num_layers=2, d_model=16,
          num_heads=2, d_ff=32, vocab_size=64, causal=True)
NMT = dict(batch_size=4, num_layers=1, seq_length=4, hidden_size=16,
           embed_size=16, vocab_size=64, lstm_per_node_length=2)
#: the printed statistics carry six decimals: within 1e-5 relative, or
#: one unit of the last printed decimal where the value is small
RTOL, PRINT_ATOL = 1e-5, 1.5e-6
LINE = re.compile(r"^(\S+): shape=(\([^)]*\)) dtype=(\w+) mean=(\S+) "
                  r"std=(\S+) absmax=(\S+)$")


def _tiny(cls, cfg_cls, machine=None, **kw):
    cfg = cfg_cls(**CNN, **kw)
    ff = cls(cfg, machine) if machine is not None else cls(cfg,
                                                           device="cpu")
    tr.verify_net(ff, ff.create_input((8, 16, 16, 3), name="image"))
    return ff, cfg


def _to_port(jp, js=None):
    p = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    s = state_from_jax(jax.tree.map(np.asarray, js or {}), "cpu")
    return p, s


def _stats(text):
    """``{tag: (shape, dtype, mean, std, absmax)}`` of printed lines."""
    out = {}
    for line in text.splitlines():
        m = LINE.match(line.strip())
        if m:
            out[m.group(1)] = (m.group(2), m.group(3)) + tuple(
                float(v) for v in m.groups()[3:])
    return out


def _same_stats(got, want):
    assert got and set(got) == set(want), (sorted(got), sorted(want))
    for tag, w in want.items():
        g = got[tag]
        assert g[:2] == w[:2], tag
        np.testing.assert_allclose(g[2:], w[2:], rtol=RTOL, atol=PRINT_ATOL,
                                   err_msg=tag)


# ---------------------------------------------------------------------------
# PARAMETER_ALL_ONES


def test_params_all_ones(machine1):
    jm, _ = _tiny(JModel, JConfig, machine1, params_init="ones")
    tm, _ = _tiny(TModel, TConfig, params_init="ones")
    jp, _ = jm.init()
    tp, ts = tm.init()
    leaves = [v for sub in tp.values() for v in sub.values()]
    assert leaves and all(bool((v == 1.0).all()) for v in leaves)
    assert {k: set(v) for k, v in tp.items()} == \
        {k: set(v) for k, v in jp.items()}
    # all-ones weights and images: the forward is a function of the
    # shapes alone, whatever the seed
    img = np.ones((8, 16, 16, 3), "float32")
    lbl = np.ones((8,), "int32")
    l1, _ = tm.loss_fn(tp, ts, torch.from_numpy(img), torch.from_numpy(lbl))
    tm2, _ = _tiny(TModel, TConfig, params_init="ones")
    p2, s2 = tm2.init(seed=123)
    l2, _ = tm2.loss_fn(p2, s2, torch.from_numpy(img),
                        torch.from_numpy(lbl))
    jl, _ = jm.loss_fn(jp, {}, jnp.asarray(img), jnp.asarray(lbl))
    assert float(l1) == float(l2)
    np.testing.assert_allclose(float(l1), float(jl), rtol=1e-5)


def test_params_ones_leave_the_state_as_drawn(machine1):
    """The JAX package sets the parameters alone to ones
    (``flexflow_tpu/model.py:372-377``): BatchNorm's running statistics
    stay as drawn in both packages."""
    def net(ff):
        img = ff.create_input((8, 16, 16, 3), name="image")
        t = ff.conv2d("conv1", img, 8, 3, 3, 1, 1, 1, 1, relu=False)
        t = ff.batch_norm("bn1", t)
        t = ff.flat("flat", t)
        t = ff.linear("fc1", t, 8, relu=False)
        ff.softmax("softmax", t)
        return ff

    jm = net(JModel(JConfig(**CNN, params_init="ones"), machine1))
    tm = net(TModel(TConfig(**CNN, params_init="ones"), device="cpu"))
    jp, js = jm.init()
    tp, ts = tm.init()
    assert all(bool((v == 1).all()) for sub in tp.values()
               for v in sub.values())
    assert set(ts) == set(js) == {"bn1"}
    for leaf, want in js["bn1"].items():
        np.testing.assert_array_equal(ts["bn1"][leaf].numpy(),
                                      np.asarray(want))
    assert not all(bool((v == 1).all()) for v in ts["bn1"].values())


def test_params_ones_three_sgd_losses_match_jax(machine1):
    jm, _ = _tiny(JModel, JConfig, machine1, params_init="ones",
                  learning_rate=0.01, momentum=0.9)
    tm, _ = _tiny(TModel, TConfig, params_init="ones", learning_rate=0.01,
                  momentum=0.9)
    jp, js = jm.init(seed=5)
    tp, ts = tm.init(seed=9)
    np.testing.assert_array_equal(
        np.concatenate([np.ravel(v) for v in jax.tree.leaves(jp)]),
        np.concatenate([v.numpy().ravel() for sub in tp.values()
                        for v in sub.values()]))
    jo, to = jm.init_opt_state(jp), tm.init_opt_state(tp)
    jstep, tstep = jm.make_train_step(), tm.make_train_step()
    rng = np.random.RandomState(3)
    jl, tl = [], []
    for _ in range(3):
        img = rng.rand(8, 16, 16, 3).astype("float32")
        lbl = rng.randint(0, 8, (8,)).astype("int32")
        jp, js, jo, a = jstep(jp, js, jo, img, lbl)
        tp, ts, to, b = tstep(tp, ts, to, img, lbl)
        jl.append(float(a))
        tl.append(float(b))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


def test_lm_params_ones_first_loss_is_ln_vocab(machine1):
    """All-ones head weight and bias make every vocab column's logit the
    same: the first loss is ln V, in both packages."""
    from flexflow_tpu.models.transformer import TransformerConfig as JTC
    from flexflow_tpu.models.transformer import TransformerLM as JLM
    from flexflow_tpu_torch.models.transformer import TransformerConfig
    from flexflow_tpu_torch.models.transformer import TransformerLM

    jm = JLM(JTC(**LM, params_init="ones"), machine1)
    tm = TransformerLM(TransformerConfig(**LM, params_init="ones"),
                       device="cpu")
    jp, js = jm.init()
    tp, ts = tm.init()
    toks = np.random.RandomState(1).randint(0, 64, (2, 8)).astype("int32")
    jl, _ = jm.loss_fn(jp, js, toks, toks)
    tl, _ = tm.loss_fn(tp, ts, torch.from_numpy(toks),
                       torch.from_numpy(toks))
    np.testing.assert_allclose([float(tl), float(jl)], math.log(64),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# DISABLE_COMPUTATION


def test_dry_compile_runs_nothing(machine1, tmp_path, monkeypatch):
    jm, _ = _tiny(JModel, JConfig, machine1, dry_compile=True)
    jres = jm.fit(j_batches(machine1, 8, 16, 16, num_classes=8,
                            mode="random"), log=lambda *a: None)
    tm, cfg = _tiny(TModel, TConfig, dry_compile=True,
                    obs_dir=str(tmp_path), run_id="dry")

    def no_init(*a, **k):
        raise AssertionError("the dry run drew parameters")

    monkeypatch.setattr(tm, "init", no_init)
    kernels.reset_launches()
    logs = []
    batch = (torch.rand(8, 16, 16, 3), torch.randint(0, 8, (8,),
                                                     dtype=torch.int32))
    res = tm.fit(iter([batch]), log=logs.append)
    assert res["loss"] == [] and res["images_per_sec"] == 0.0
    assert res["params"] is res["state"] is res["opt_state"] is None
    assert not kernels.launches
    assert any(m.startswith("dry-compile ok: 5 layers, flops/step = ")
               for m in logs), logs
    compiled = res["compiled"]
    assert compiled["layers"] == 5 and compiled["step_flops"] > 0
    assert compiled["regrid_hops"] == 0
    # the trees' and the batch's bytes are JAX's argument bytes: params,
    # momentum buffers, no state, the image and labels
    assert compiled["argument_bytes"] == jres["compiled"] \
        .memory_analysis().argument_size_in_bytes == 59232
    assert f"argument bytes = {compiled['argument_bytes']}" in logs[-1]
    (rec,) = [r for r in obs.read_run(str(tmp_path / "dry.jsonl"))
              if r.get("kind") == "compile"]
    assert rec["dry"] is True and rec["flops"] == compiled["step_flops"]
    assert rec["seconds"] >= 0 and "bytes_accessed" not in rec


def test_dry_compile_validates_partitioning(machine8):
    """A grid that does not divide its op's tensor is refused when the
    model is built, in both packages; a good one traces."""
    good = JStrategy()
    good["conv1"] = JPC((2, 1, 1, 4), tuple(range(8)))
    good["fc1"] = JPC((4, 2), tuple(range(8)))
    jm, _ = _tiny(JModel, JConfig, machine8, dry_compile=True,
                  strategies=good)
    assert jm.fit(j_batches(machine8, 8, 16, 16, num_classes=8,
                            mode="random"),
                  log=lambda *a: None)["compiled"] is not None
    bad_j, bad_t = JStrategy(), TStrategy()
    bad_j["fc1"] = JPC((3, 1), (0, 1, 2))
    bad_t["fc1"] = TPC((3, 1), (0, 1, 2))
    with pytest.raises(ValueError, match="fc1"):
        jm, _ = _tiny(JModel, JConfig, machine8, dry_compile=True,
                      strategies=bad_j)
        jm.fit(j_batches(machine8, 8, 16, 16, num_classes=8,
                         mode="random"), log=lambda *a: None)
    # three ranks, a batch they divide: fc1's 3 vocab blocks do not
    # divide its 8 columns
    res = tr.run_ranks(tr.run_cases, 3, [
        ("dry_run", ("verify_net", dict(CNN, batch_size=6),
                     bad_t.to_json()))])
    assert all(r[0][0] == "error" and "fc1" in r[0][1] for r in res), res


def test_dry_compile_over_two_ranks_moves_nothing():
    s = TStrategy()
    s["conv1"] = TPC((1, 1, 1, 2), (0, 1))
    s["fc1"] = TPC((2, 1), (0, 1))
    res = tr.run_ranks(tr.run_cases, 2, [
        ("dry_run", ("verify_net", CNN, s.to_json())),
        ("ones_blocks", ("verify_net", CNN, s.to_json()))])
    # params_init="ones" over ranks: each rank's blocks all ones
    assert all(r[1][0] > 0 and r[1][1] for r in res), [r[1] for r in res]
    res = [r[:1] for r in res]
    for rank, ((out, lines, calls),) in enumerate(res):
        assert calls == [], (rank, calls)
        assert out["loss"] == [] and out["launches"] == {}
        assert out["trees"] == [None, None, None]
        assert out["compiled"]["regrid_hops"] > 0
        assert lines[-1].startswith("dry-compile ok: 5 layers")
    # each rank counts its own blocks
    assert res[0][0][0]["compiled"]["argument_bytes"] < 59232


def test_nmt_app_dry_compile():
    from flexflow_tpu_torch.apps import nmt

    logs = []
    out = nmt.main(["-b", "8", "-l", "1", "-s", "4", "-h", "16", "-e", "16",
                    "--vocab", "64", "--chunk", "2", "--dry-compile",
                    "--device", "cpu"], log=logs.append)
    assert out["loss"] == [] and out["sentences_per_sec"] == 0.0
    assert any("dry-compile ok" in line for line in logs), logs


def test_lm_app_dry_compile_and_ones():
    from flexflow_tpu_torch.apps import lm

    argv = ["--causal", "-b", "2", "-s", "8", "-l", "2", "--d-model", "16",
            "--heads", "2", "--d-ff", "32", "--vocab", "64", "-i", "2",
            "--device", "cpu"]
    logs = []
    kernels.reset_launches()
    out = lm.main(argv + ["--dry-compile"], log=logs.append)
    assert out["loss"] == [] and not kernels.launches
    assert any(line.startswith("dry-compile ok: ") for line in logs)
    a = lm.main(argv + ["--params-ones"], log=lambda *x: None)["loss"]
    b = lm.main(argv + ["--params-ones"], log=lambda *x: None)["loss"]
    assert a == b and a[0] == pytest.approx(math.log(64), rel=1e-5)
    with pytest.raises(SystemExit, match="--pipeline-stages does not "
                                         "support: --dry-compile"):
        lm.main(argv + ["--dry-compile", "--pipeline-stages", "2"],
                log=lambda *x: None)


# ---------------------------------------------------------------------------
# PRINT_INTERMEDIATE_RESULT


def _capture(fn, capfd):
    capfd.readouterr()
    fn()
    jax.effects_barrier()
    return capfd.readouterr().out


def test_print_intermediates(machine1, capfd):
    jm, _ = _tiny(JModel, JConfig, machine1, print_intermediates=True)
    tm, _ = _tiny(TModel, TConfig, print_intermediates=True)
    jp, js = jm.init()
    tp, ts = _to_port(jp, js)
    rng = np.random.RandomState(2)
    img = rng.rand(8, 16, 16, 3).astype("float32")
    lbl = rng.randint(0, 8, (8,)).astype("int32")
    want = _stats(_capture(lambda: float(jax.jit(
        jm.loss_fn, static_argnames="train")(jp, js, img, lbl,
                                             train=True)[0]), capfd))
    got = _stats(_capture(lambda: tm.loss_fn(
        tp, ts, torch.from_numpy(img), torch.from_numpy(lbl)), capfd))
    assert [tag.split("/")[0] for tag in sorted(got)] == \
        ["conv1", "fc1", "flat", "pool1", "softmax"]
    assert got["conv1/conv1"][0] == "(8, 16, 16, 8)"
    _same_stats(got, want)


def test_print_intermediates_lm_unfuses_the_head(machine1, capfd):
    from flexflow_tpu.models.transformer import TransformerConfig as JTC
    from flexflow_tpu.models.transformer import TransformerLM as JLM
    from flexflow_tpu_torch.models.transformer import TransformerConfig
    from flexflow_tpu_torch.models.transformer import TransformerLM

    jm = JLM(JTC(**LM, print_intermediates=True), machine1)
    tm = TransformerLM(TransformerConfig(**LM, print_intermediates=True),
                       device="cpu")
    assert tm._lm_head_fusion() and not tm._fusion_on(True)
    jp, js = jm.init()
    tp, ts = _to_port(jp, js)
    toks = np.random.RandomState(4).randint(0, 64, (2, 8)).astype("int32")
    want = _stats(_capture(lambda: float(jm.loss_fn(jp, js, toks, toks)[0]),
                           capfd))
    got = _stats(_capture(lambda: tm.loss_fn(
        tp, ts, torch.from_numpy(toks), torch.from_numpy(toks)), capfd))
    # the vocab projection's own output is printed: the fusion is off
    assert got["lm_head/lm_head"][0] == "(2, 8, 64)"
    assert len(got) == len(tm.layers)
    _same_stats(got, want)


def test_print_intermediates_nmt(machine1, capfd):
    from flexflow_tpu.nmt.rnn_model import RnnConfig as JRC
    from flexflow_tpu.nmt.rnn_model import RnnModel as JRM
    from flexflow_tpu_torch.nmt.rnn_model import RnnConfig, RnnModel

    jm = JRM(JRC(**NMT, print_intermediates=True), machine1)
    tm = RnnModel(RnnConfig(**NMT, print_intermediates=True), device="cpu")
    jp, js = jm.init(0)
    tp, ts = _to_port(jp, js)
    rng = np.random.RandomState(6)
    src, dst = (rng.randint(0, 64, (4, 4)).astype("int32") for _ in range(2))
    want = _stats(_capture(lambda: float(jm.loss_fn(jp, js, src, dst)[0]),
                           capfd))
    got = _stats(_capture(lambda: tm.loss_fn(
        tp, ts, torch.from_numpy(src), torch.from_numpy(dst)), capfd))
    assert len([t for t in got if t.startswith("lstm0_0/")]) == 3
    assert got["linear1/linear1"][0] == "(4, 2, 64)"
    _same_stats(got, want)


def test_print_intermediates_over_two_ranks(machine1, tmp_path, capfd):
    """Two gloo ranks print the whole tensors' statistics from rank 0,
    whatever block each holds: equal to one process's and to JAX's."""
    jm, _ = _tiny(JModel, JConfig, machine1, print_intermediates=True)
    jp, js = jm.init()
    rng = np.random.RandomState(8)
    img = rng.rand(8, 16, 16, 3).astype("float32")
    lbl = rng.randint(0, 8, (8,)).astype("int32")
    want = _stats(_capture(lambda: float(jm.loss_fn(
        jp, js, img, lbl, train=True)[0]), capfd))
    trees = str(tmp_path / "trees.npz")
    tr.save_trees(trees, jax.tree.map(np.asarray, jp),
                  jax.tree.map(np.asarray, js))
    s = TStrategy()
    s["conv1"] = TPC((1, 1, 1, 2), (0, 1))
    s["fc1"] = TPC((2, 1), (0, 1))
    res = tr.run_ranks(tr.run_cases, 2, [
        ("dump_lines", ("verify_net", CNN, s.to_json(), trees, img, lbl))])
    (lines0,), (lines1,) = res
    assert lines1 == []
    _same_stats(_stats("\n".join(lines0)), want)


def test_print_tensor_helper(capfd):
    from flexflow_tpu.utils.debug import print_tensor as j_print

    want = _capture(lambda: j_print("t", jnp.arange(6.0).reshape(2, 3)),
                    capfd)
    got = _capture(lambda: print_tensor(
        "t", torch.arange(6.0).reshape(2, 3)), capfd)
    assert "shape=(2, 3)" in got and "mean=2.5" in got
    assert got == want
    got = _capture(lambda: print_tensor(
        "b", torch.arange(6.0).to(torch.bfloat16)), capfd)
    assert "dtype=bfloat16" in got


# ---------------------------------------------------------------------------
# the drivers' parse


#: (driver, argv, JAX field) of the values the port runs: parsed as JAX
#: parses them
ACCEPTED = [
    (app, argv, field)
    for app in ("cnn", "lm", "nmt")
    for argv, field in (
        (["--params-ones"], "params_init"),
        (["--dry-compile"], "dry_compile"),
        (["--print-intermediates"], "print_intermediates"),
        (["-regrid-planner", "on"], "regrid_planner"),
        (["-placed-overlap", "on"], "placed_overlap"),
        (["-pallas", "on"], "pallas"))
] + [("cnn", ["-chains", "4"], "search_chains"),
     ("cnn", ["-delta", "check"], "search_delta"),
     ("cnn", ["--delta", "off"], "search_delta")]
#: (driver, argv) of the values the port does not run: refused with the
#: reason, where JAX takes them
REFUSED = [(app, [flag, value])
           for app in ("cnn", "lm", "nmt")
           for flag, value in (("-regrid-planner", "off"),
                               ("-placed-overlap", "off"),
                               ("--pallas", "auto"), ("-pallas", "off"))]


def _parse(app, argv):
    """``(port config, JAX config)`` of one driver's parse."""
    if app == "cnn":
        from flexflow_tpu_torch.apps import cnn

        return cnn.parse(["alexnet"] + argv)[1], JConfig.from_args(argv)
    from flexflow_tpu.apps import lm as j_lm
    from flexflow_tpu.apps import nmt as j_nmt
    from flexflow_tpu_torch.apps import lm, nmt

    port, ref = {"lm": (lm, j_lm), "nmt": (nmt, j_nmt)}[app]
    return port.parse_args(argv)[0], ref.parse_args(argv)


@pytest.mark.parametrize(
    "app,argv,field", ACCEPTED,
    ids=[f"{a}{''.join(v)}" for a, v, _ in ACCEPTED])
def test_debug_flags_parse_as_jax(app, argv, field):
    cfg, jcfg = _parse(app, argv)
    want = getattr(jcfg, field)
    if field in ("regrid_planner", "placed_overlap", "pallas"):
        # the one value the port runs: checked, not stored
        assert want == argv[-1] == "on"
        assert cfg == _parse(app, [])[0] and not hasattr(cfg, field)
        return
    assert want != getattr(type(jcfg)(), field)
    assert getattr(cfg, field) == want


@pytest.mark.parametrize("app,argv", REFUSED,
                         ids=[f"{a}{''.join(v)}" for a, v in REFUSED])
def test_debug_flags_refused_values(app, argv):
    from flexflow_tpu_torch.config import RESTRICTED_VALUES

    _, jcfg = _parse(app, [])
    with pytest.raises(SystemExit) as e:
        _parse(app, argv)
    field = {"-regrid-planner": "regrid_planner",
             "-placed-overlap": "placed_overlap"}.get(argv[0], "pallas")
    assert RESTRICTED_VALUES[field][1][argv[1]] in str(e.value)
    assert f"refused by flexflow_tpu_torch" in str(e.value)
    # the JAX drivers take the value
    if app == "cnn":
        assert getattr(JConfig.from_args(argv), field) == argv[1]


def test_switch_defaults_are_jax_but_pallas():
    """The stored switches' defaults are JAX's.  The port runs JAX's
    default regrid and overlap values and stores neither; it runs
    ``pallas`` "on" only, where JAX's default is "auto"."""
    from flexflow_tpu_torch.config import RESTRICTED_VALUES

    fields = ("params_init", "dry_compile", "print_intermediates",
              "search_chains", "search_delta")
    t, j = TConfig(), JConfig()
    assert [getattr(t, f) for f in fields] == [getattr(j, f) for f in fields]
    for field, jax_default in (("regrid_planner", "on"),
                               ("placed_overlap", "on"), ("pallas", "auto")):
        assert getattr(j, field) == jax_default and not hasattr(t, field)
        assert RESTRICTED_VALUES[field][0] == ("on",)
