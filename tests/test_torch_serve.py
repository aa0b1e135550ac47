"""The port's serving slice against the JAX package's, end to end at test
size: the tiny GPT (2 layers, d_model 32, 4 heads, vocab 64, seq 16,
batch 8) built in both packages on one device, the JAX ``FFModel.init()``
tree carried across with ``params_from_jax``, then

  * the predict step's log-probs and captured attention inputs agree at
    atol 1e-5 (float32, another summation order);
  * the same seeded requests give identical replies, virtual stamps and
    summaries through both ``ServeEngine``s, and the same KV-cache
    contents mid-run;
  * the copied host-side modules (loadgen, faultinject, strategy files)
    behave identically;
  * the port imports neither JAX nor the JAX package, and its entry
    points refuse to run without CUDA unless asked for the CPU.
"""

import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

from flexflow_tpu.apps.serve import _build_lm as j_build_lm
from flexflow_tpu.serve import loadgen as j_loadgen
from flexflow_tpu.serve.engine import ServeEngine as JEngine
from flexflow_tpu.strategy import ParallelConfig as JPC
from flexflow_tpu.strategy import Strategy as JStrategy
from flexflow_tpu.utils import faultinject as j_faultinject
from flexflow_tpu_torch.apps import serve as t_serve
from flexflow_tpu_torch.interop import params_from_jax
from flexflow_tpu_torch.serve import loadgen as t_loadgen
from flexflow_tpu_torch.serve.engine import ServeEngine as TEngine
from flexflow_tpu_torch.strategy import Strategy as TStrategy
from flexflow_tpu_torch.utils import faultinject as t_faultinject

torch.set_num_threads(2)

PORT_DIR = pathlib.Path(__file__).resolve().parents[1] / "flexflow_tpu_torch"


def _quiet(*a, **k):
    pass


@pytest.fixture(scope="module")
def pair(machine1):
    """(jax model, jax params tree as numpy, port model, port params)."""
    jm, _ = j_build_lm(machine1, batch=8, seed=0, tiny=True)
    jp, _ = jm.init(0)
    tree = jax.tree.map(np.asarray, jp)
    tm = t_serve.build_lm(batch=8, seed=0, tiny=True, device="cpu")
    return jm, tree, tm, params_from_jax(tree, device="cpu")


def _tokens(seed):
    rng = np.random.RandomState(seed)
    toks = rng.randint(2, 64, (8, 16)).astype("int32")
    toks[3:, 9:] = 0   # pad tails, as the engine's rectangle has
    return toks


def test_params_cross_unchanged(pair):
    jm, tree, tm, tp = pair
    assert set(tp) == set(tree)
    for key, leaves in tree.items():
        assert set(tp[key]) == set(leaves)
        for leaf, arr in leaves.items():
            got = tp[key][leaf]
            assert tuple(got.shape) == arr.shape
            np.testing.assert_array_equal(got.numpy(), arr)
    # the port's own init builds the same tree structure and shapes
    own, _ = tm.init(0)
    assert {k: {l: tuple(v.shape) for l, v in d.items()}
            for k, d in own.items()} == \
        {k: {l: v.shape for l, v in d.items()} for k, d in tree.items()}


def test_predict_step_logprobs_agree(pair):
    jm, tree, tm, tp = pair
    toks, labels = _tokens(0), np.zeros((8, 16), "int32")
    attn_j = [op.inputs[0].tid for op in jm.layers
              if type(op).__name__ == "MultiHeadAttention"]
    attn_t = [op.inputs[0].tid for op in tm.layers
              if type(op).__name__ == "MultiHeadAttention"]
    jout = jm.make_predict_step(
        output_tids=(jm._loss_op().output.tid, *attn_j))(
            jax.tree.map(jax.numpy.asarray, tree), {}, toks, labels)
    tout = tm.make_predict_step(
        output_tids=(tm._loss_op().output.tid, *attn_t))(
            tp, {}, toks, labels)
    assert len(jout) == len(tout) == 3
    assert tuple(tout[0].shape) == (8, 16, 64)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)


def _requests(mod, n=12):
    return mod.synthetic_requests(n, seed=3, rate_qps=400.0, vocab_size=64,
                                  prompt_len=4, max_new_tokens=3)


def test_served_replies_and_latencies_identical(pair):
    jm, tree, tm, tp = pair
    jreqs, treqs = _requests(j_loadgen), _requests(t_loadgen)
    jsum = JEngine(jm, None, log=_quiet).run(jreqs)
    tsum = TEngine(tm, params=tp, log=_quiet).run(treqs)
    assert [r.reply for r in treqs] == [r.reply for r in jreqs]
    for jr, tr in zip(jreqs, treqs):
        assert (tr.arrival_v, tr.admit_v, tr.first_token_v, tr.done_v) == \
            (jr.arrival_v, jr.admit_v, jr.first_token_v, jr.done_v)
    for key in ("requests", "completed", "unserved", "dropped", "qps",
                "p50_s", "p99_s", "ttft_p50_s", "ttft_p99_s", "tpot_p50_s",
                "tpot_p99_s", "steps", "resizes", "virtual_s", "drained",
                "devices"):
        assert tsum[key] == jsum[key], key
    assert tsum["completed"] == 12


def test_kv_cache_filled_alike(pair):
    jm, tree, tm, tp = pair
    je = JEngine(jm, None, log=_quiet)
    te = TEngine(tm, params=tp, log=_quiet)
    je.start(_requests(j_loadgen, 6))
    te.start(_requests(t_loadgen, 6))
    for _ in range(3):
        assert je.step_once() == te.step_once()
    assert te.kv_layout == type(te.kv_layout)(**{
        f: getattr(je.kv_layout, f) for f in je.kv_layout.__dataclass_fields__})
    np.testing.assert_array_equal(te.kv_cache.lengths, je.kv_cache.lengths)
    assert te.kv_cache.lengths.sum() > 0
    np.testing.assert_allclose(te.kv_cache.k, je.kv_cache.k, atol=1e-5)
    np.testing.assert_allclose(te.kv_cache.v, je.kv_cache.v, atol=1e-5)


class _DrainAfter(dict):
    """A drain flag that reads as requested from its ``after``-th check
    on (one check per scheduling boundary)."""

    def __init__(self, after):
        super().__init__()
        self.after, self.checks = after, 0

    def get(self, key, default=None):
        if key == "requested":
            self.checks += 1
            return self.checks > self.after
        return super().get(key, default)


def test_drain_leaves_the_same_requests_unserved(pair):
    jm, tree, tm, tp = pair
    jreqs, treqs = _requests(j_loadgen), _requests(t_loadgen)
    jsum = JEngine(jm, None, log=_quiet).run(jreqs, drain=_DrainAfter(3))
    tsum = TEngine(tm, params=tp, log=_quiet).run(treqs,
                                                  drain=_DrainAfter(3))
    assert tsum["drained"] and jsum["drained"]
    assert (tsum["completed"], tsum["unserved"]) == \
        (jsum["completed"], jsum["unserved"])
    assert 0 < tsum["unserved"] < 12
    assert [r.reply for r in treqs] == [r.reply for r in jreqs]


def test_kv_ring_reads_newest_rows_in_order():
    from flexflow_tpu_torch.serve.kv_cache import KVCache, KVCacheLayout

    cache = KVCache(KVCacheLayout(num_layers=1, num_heads=2, head_dim=3,
                                  max_batch=2, max_seq=4))
    rows = np.arange(6 * 2 * 3, dtype="float32").reshape(6, 2, 3)
    cache.write_span(0, 1, 0, rows, -rows)
    k, v = cache.read(0, 1)
    np.testing.assert_array_equal(k, rows[2:])
    np.testing.assert_array_equal(v, -rows[2:])
    assert cache.layout.total_bytes() == 2 * 1 * 2 * 2 * 4 * 3 * 4
    cache.reclaim(1)
    assert cache.read(0, 1)[0].shape == (0, 2, 3)


def test_unported_engine_modes_raise(pair):
    _, _, tm, tp = pair
    for kw in ({"phase": "decode"}, {"queue_hi": 4},
               {"idle_boundaries": 2}):
        with pytest.raises(NotImplementedError):
            TEngine(tm, params=tp, log=_quiet, **kw)


def test_driver_line_and_obs_records_on_cpu(capsys, tmp_path):
    import json

    from flexflow_tpu_torch import obs

    assert t_serve.main(["gpt", "--tiny", "--device", "cpu", "-n", "6",
                         "-obs-dir", str(tmp_path), "--run-id", "r1"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(rec) == ["run_id", "qps", "p50_s", "p99_s", "resizes",
                         "requests", "completed", "unserved", "dropped",
                         "devices", "drained"]
    assert rec["completed"] == 6 and rec["devices"] == 1
    assert rec["run_id"] == "r1"
    kinds = [e["kind"] for e in obs.read_run(str(tmp_path / "r1.jsonl"))]
    assert kinds[0] == "run_start" and kinds[-1] == "serve_summary"
    assert kinds.count("serve_request") == 6
    assert "serve_batch" in kinds


@pytest.mark.parametrize("pattern", ["poisson", "bursty+heavy_tail",
                                     "session"])
def test_loadgen_copy_identical(pattern):
    kw = dict(seed=5, rate_qps=30.0, pattern=pattern, vocab_size=50,
              prompt_len=5, max_new_tokens=2)
    a = j_loadgen.patterned_requests(20, **kw)
    b = t_loadgen.patterned_requests(20, **kw)
    assert [(r.rid, r.arrival_v, r.session, r.tokens.tolist()) for r in a] \
        == [(r.rid, r.arrival_v, r.session, r.tokens.tolist()) for r in b]


def test_faultinject_copy_identical():
    spec = "replica_crash@3,handoff_drop@5x2,slow_replica@1"
    assert t_faultinject.parse_fault_spec(spec) == \
        j_faultinject.parse_fault_spec(spec)
    with pytest.raises(t_faultinject.FaultSpecError):
        t_faultinject.parse_fault_spec("nonsense@1")
    inj = t_faultinject.FaultInjector(spec)
    assert [inj.fire("handoff_drop") for _ in range(7)] == \
        [False, False, False, False, True, True, False]


@pytest.mark.parametrize("suffix", [".json", ".pb"])
def test_strategy_file_loads_in_both(tmp_path, suffix):
    s = JStrategy({"blk0_attn": JPC((1, 2, 4), tuple(range(8))),
                   "lm_head": JPC((2, 1), (3, 5))})
    path = str(tmp_path / f"s{suffix}")
    s.save(path)
    got = TStrategy.load(path)
    assert {k: (v.dims, v.devices) for k, v in got.items()} == \
        {k: (v.dims, v.devices) for k, v in s.items()}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted(PORT_DIR.rglob("*.py"))
    files.append(PORT_DIR.parent / "chip_smoke.py")
    assert len(files) > 20
    bad = [(str(p), m) for p in files for m in _imports(p)
           if m.split(".")[0] in ("jax", "jaxlib", "flexflow_tpu")]
    assert not bad, bad


def test_entry_points_refuse_cpu_fallback(pair):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here; the refusal needs a machine "
                    "without it")
    from flexflow_tpu_torch.machine import MachineModel
    from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                       TransformerLM)

    _, tree, _, _ = pair
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MachineModel()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TransformerLM(TransformerConfig(num_layers=1, d_model=8,
                                        num_heads=2, d_ff=16,
                                        vocab_size=16, seq_length=4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax(tree)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_serve.main(["gpt", "--tiny"])
    from flexflow_tpu_torch.apps import cnn as t_cnn
    from flexflow_tpu_torch.data import synthetic_batches
    from flexflow_tpu_torch.models.inception import build_inception_v3

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_cnn.main(["alexnet", "-b", "2", "-i", "1"], log=lambda *a: None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_inception_v3()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        synthetic_batches(2, 4, 4)
    from flexflow_tpu_torch.apps import lm as t_lm
    from flexflow_tpu_torch.data import synthetic_token_stream

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_lm.main(["--causal", "-b", "2", "-s", "4", "-l", "1", "--d-model",
                   "8", "--heads", "2", "--d-ff", "16", "--vocab", "16",
                   "-i", "1"], log=lambda *a: None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        synthetic_token_stream(2, 4, 16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(t_lm.synthetic_lm_batches(2, 4, 16))
    from flexflow_tpu_torch.interop import state_from_jax
    from flexflow_tpu_torch.models.densenet import build_densenet121

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_densenet121()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_cnn.main(["densenet", "-b", "2", "-i", "1"], log=lambda *a: None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        state_from_jax({"bn1": {"mean": np.zeros(4, "float32")}})
