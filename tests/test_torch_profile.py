"""The port's profile and fusion account (``utils/hlo_profile.py``,
``obs/fusions.py``, ``apps/profile.py``, ``report fusions``) against the
JAX package's:

  * ``fusion_account``, ``check_account`` and ``render_account`` on the
    JAX package's committed roofline profiles, with JAX's constants
    handed in (``torch_sim_parity.jax_perf`` and JAX's Pallas/XLA pool
    ratio), equal JAX's key for key and text for text; the rows of XLA's
    ``select_and_scatter`` differ only in the port's wording of the
    floor's source and note;
  * ``device_op_times``, ``classify_ops`` and ``kernel_launches`` on a
    Chrome trace the test writes (torch.profiler's event layout);
  * ``apps.profile alexnet -b 8 --device cpu`` (at 67x67) runs, its
    report carries JAX's keys, its account holds, and ``report fusions``
    renders it.
"""

import json
import os

import pytest

from flexflow_tpu.obs import fusions as j_fusions
from flexflow_tpu_torch.obs import fusions as t_fusions

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILES = ("inception_v3_roofline.json", "alexnet_roofline.json")
JAX_RATIO = 2.9 / 5.0


def _profile(name):
    with open(os.path.join(ROOT, "examples", "profiles", name)) as f:
        return json.load(f)


@pytest.mark.parametrize("name", PROFILES)
@pytest.mark.parametrize("top_n", [10, 25])
def test_fusion_account_equals_jax(name, top_n):
    import torch_sim_parity as sp

    profile = _profile(name)
    t = t_fusions.fusion_account(profile, perf=sp.jax_perf(), top_n=top_n,
                                 kernel_ratio=JAX_RATIO,
                                 kernel_name="pallas_maxpool_bwd")
    j = j_fusions.fusion_account(profile, top_n=top_n)
    assert set(t) == set(j)
    for key in j:
        if key != "rows":
            assert t[key] == j[key], key
    assert len(t["rows"]) == len(j["rows"])
    for tr, jr in zip(t["rows"], j["rows"]):
        assert set(tr) == set(jr)
        for key in jr:
            if jr["name"].startswith("select_and_scatter") \
                    and key in ("floor_source", "note"):
                continue
            assert tr[key] == jr[key], (jr["name"], key)
    assert t_fusions.check_account(t) == j_fusions.check_account(j) == []
    assert t_fusions.render_account(t) == j_fusions.render_account(j)
    assert t_fusions.residual_top_frac(
        profile, perf=sp.jax_perf(), kernel_ratio=JAX_RATIO,
        kernel_name="pallas_maxpool_bwd") == \
        j_fusions.residual_top_frac(profile)


def test_fusion_account_on_the_card_names_the_kernel():
    """The port's own constants: ``HopperChipPerf`` and kernel 7's ratio
    against the library's max-pool backward; a library pool-backward row
    names kernel 7, a ``csrc/`` row its kernel."""
    profile = {"seconds_per_step": 0.1, "step_floor_seconds": 0.05,
               "mxu_eff_during_matmul": 0.5, "model": "inception",
               "bound": "mxu", "top_ops": [
                   {"ms": 8.0, "class": "vpu",
                    "name": "aten::max_pool2d_with_indices_backward"
                            "[256x147x147x64]", "root": ""},
                   {"ms": 1.0, "class": "raw", "name": "maxpool_bwd",
                    "root": "maxpool_bwd()", "kernel": "maxpool_bwd"},
                   {"ms": 3.0, "class": "vpu", "name": "aten::add[1x2]",
                    "root": "bf16[256,35,35,288] add([256, 35, 35, 288])"},
               ]}
    acct = t_fusions.fusion_account(profile)
    rows = {r["name"]: r for r in acct["rows"]}
    pool = rows["aten::max_pool2d_with_indices_backward[256x147x147x64]"]
    assert pool["kernel"] == "maxpool_bwd"
    assert pool["floor_ms"] == round(8.0 * t_fusions.KERNEL_RATIO, 3)
    assert pool["verdict"] == "pallas_worthy"
    own = rows["maxpool_bwd"]
    assert own["kernel"] == "maxpool_bwd" and own["verdict"] == "irreducible"
    add = rows["aten::add[1x2]"]
    assert add["floor_source"] == "root_bytes"
    assert t_fusions.check_account(acct) == []
    assert "maxpool_bwd" in t_fusions.render_account(acct)


def _trace(path, steps=2):
    """A torch.profiler-shaped Chrome trace of ``steps`` steps: a cuDNN
    convolution and an elementwise add launched by aten operators, the
    port's max-pool kernels launched outside any operator."""
    events = [{"ph": "M", "name": "process_name", "pid": 0,
               "args": {"name": "python"}}]
    ext = 1
    for s in range(steps):
        t0 = s * 1000.0
        for op, dims, types, kernel, dur in (
                ("aten::cudnn_convolution", [[8, 3, 32, 32], [16, 3, 3, 3]],
                 ["c10::BFloat16", "c10::BFloat16"],
                 "sm90_xmma_fprop_implicit_gemm_bf16", 300.0),
                ("aten::add", [[8, 16, 32, 32], [8, 16, 32, 32]],
                 ["float", "float"],
                 "void at::native::vectorized_elementwise_kernel", 50.0),
                ("aten::cat", [[[8, 16], [8, 16]], []],
                 ["TensorList", "Scalar"], "void at::native::CatArrayBatchedCopy",
                 10.0)):
            events.append({"ph": "X", "cat": "cpu_op", "name": op,
                           "pid": 1, "tid": 1, "ts": t0, "dur": 10.0,
                           "args": {"External id": ext, "Input Dims": dims,
                                    "Input type": types}})
            events.append({"ph": "X", "cat": "kernel", "name": kernel,
                           "pid": 0, "tid": 7, "ts": t0 + 20, "dur": dur,
                           "args": {"External id": ext, "device": 0}})
            ext += 1
        for kernel, dur in (
                ("void maxpool_bwd_kernel<__nv_bfloat16, 8>(Params)", 40.0),
                ("void maxpool_fwd_kernel<__nv_bfloat16, 8>(Params)", 20.0),
                ("void maxpool_bwd_kernel<__nv_bfloat16, 8>(Params)", 40.0)):
            events.append({"ph": "X", "cat": "kernel", "name": kernel,
                           "pid": 0, "tid": 7, "ts": t0 + 500, "dur": dur,
                           "args": {"External id": 9999, "device": 0}})
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


def test_device_op_times_and_classes(tmp_path):
    from flexflow_tpu_torch.utils import hlo_profile as hp

    _trace(str(tmp_path / "trace_1.json"))
    times = hp.device_op_times(str(tmp_path), steps=2)
    conv = "aten::cudnn_convolution[8x3x32x32,16x3x3x3]"
    add = "aten::add[8x16x32x32,8x16x32x32]"
    cat = "aten::cat[(8x16,8x16)]"
    assert times == pytest.approx({conv: 0.3, add: 0.05,
                                   "maxpool_bwd": 0.08,
                                   "maxpool_fwd": 0.02, cat: 0.01})
    rows, totals = hp.classify_ops(hp.device_ops(str(tmp_path), 2))
    assert [(c, n) for _, c, n, _ in rows] == [
        ("mxu", conv), ("raw", "maxpool_bwd"), ("vpu", add),
        ("raw", "maxpool_fwd"), ("vpu", cat)]
    assert rows[-1][3] == "cat()"
    assert totals == pytest.approx({"mxu": 0.3, "raw": 0.1, "vpu": 0.06})
    assert rows[2][3] == "f32[8,16,32,32] add([8, 16, 32, 32], " \
                         "[8, 16, 32, 32])"
    assert hp.kernel_launches(str(tmp_path), 2) == {"maxpool_bwd": 2.0,
                                                    "maxpool_fwd": 1.0}
    top = hp.top_rows(hp.device_ops(str(tmp_path), 2), 2)
    assert top[1] == {"ms": 0.08, "class": "raw", "name": "maxpool_bwd",
                      "root": "maxpool_bwd()", "kernel": "maxpool_bwd"}
    # the account prices the elementwise row from its root's bytes
    acct = t_fusions.fusion_account({
        "seconds_per_step": 1e-3, "step_floor_seconds": 1e-4,
        "top_ops": hp.top_rows(hp.device_ops(str(tmp_path), 2), 4)})
    by = {r["name"]: r for r in acct["rows"]}
    assert by[add]["floor_source"] == "root_bytes"
    assert t_fusions.check_account(acct) == []


def test_profile_app_on_the_cpu(tmp_path, monkeypatch):
    from flexflow_tpu.utils import hlo_profile as j_hp

    from flexflow_tpu_torch.apps import profile, report

    # AlexNet at 67x67, the smallest input its pools take: a 224x224
    # step takes seconds on a CPU
    monkeypatch.setitem(profile.SIZES, "alexnet", 67)
    out = str(tmp_path / "p.json")
    rep = profile.main(["alexnet", "-b", "8", "--device", "cpu", "-i", "1",
                        "--dtype", "float32", "-o", out],
                       log=lambda *a: None)
    import inspect

    src = inspect.getsource(j_hp.roofline_report)
    for key in ("seconds_per_step", "flops_per_step", "bytes_per_step",
                "arithmetic_intensity_flop_per_byte",
                "chip_balance_flop_per_byte", "bound",
                "step_floor_seconds", "mfu", "mfu_ceiling",
                "hbm_utilization", "of_ceiling"):
        assert f'"{key}"' in src and key in rep, key
    assert rep["bytes_source"] == "modeled"
    assert rep["model"] == "alexnet" and rep["batch_size"] == 8
    assert rep["flops_per_step"] > 0 and rep["seconds_per_step"] > 0
    assert rep["top_ops"] == [] and rep["kernel_launches"] == {}
    acct = t_fusions.fusion_account(rep)
    assert t_fusions.check_account(acct) == []
    said = []
    assert report.fusions_main([out], log=said.append) == 0
    assert "fusion residual account — alexnet" in said[0]
    said = []
    assert report.fusions_main([out, "--json"], log=said.append) == 0
    assert json.loads(said[0])["violations"] == []
