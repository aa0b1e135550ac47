"""The drivers' static plan check (``apps.cnn``, ``apps.lm``, ``apps.nmt``
with ``verify.plan.check_plan``) against the JAX drivers'
(``flexflow_tpu/apps/cnn.py:100-116``, ``lm.py:225-235``,
``nmt.py:146-148``), on two gloo CPU ranks in one world:

* each driver exits with status 2 on a strategy that the JAX driver
  rejects on two devices, with the findings JAX's check finds there: an
  op the executor would run with its device list normalized (AlexNet's
  softmax, the LM's first norm, the NMT's first softmax on devices (1,
  0)), and for the LM ``examples/strategies/transformer_2x4.json``,
  whose entries name eight devices;
* with ``--allow-degraded`` each driver runs on past the degradation
  (the finding a warning), to finite losses; ``transformer_2x4.json``
  still exits 2, its findings not degradations.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_ranks as tr

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TRANSFORMER_2X4 = ROOT / "examples" / "strategies" / "transformer_2x4.json"

CNN = ["alexnet", "-b", "4", "--height", "67", "--width", "67", "-i", "2",
       "--lr", "0.001", "--device", "cpu"]
LM = ["--causal", "-b", "4", "-s", "8", "-l", "1", "--d-model", "16",
      "--heads", "2", "--d-ff", "32", "--vocab", "64", "-i", "2",
      "--device", "cpu"]
NMT = ["-b", "4", "-l", "2", "-s", "6", "-h", "16", "-e", "12", "--vocab",
       "64", "--chunk", "3", "-i", "2", "--device", "cpu"]

#: driver -> (argv, strategy flag, op whose devices (1, 0) the executor
#: would normalize, its grid's rank)
DEGRADED = {"cnn": (CNN, "-s", "softmax", 1),
            "lm": (LM, "--strategy", "blk0_ln1", 2),
            "nmt": (NMT, "--strategy", "softmax0", 1)}


def _jax_findings(app, strategy_path):
    """The findings of the JAX driver's check on two devices."""
    from flexflow_tpu.machine import MachineModel
    from flexflow_tpu.strategy import Strategy
    from flexflow_tpu.verify.plan import plan_findings

    machine = MachineModel(devices=jax.devices()[:2])
    if app == "cnn":
        from flexflow_tpu.config import FFConfig
        from flexflow_tpu.models.alexnet import build_alexnet

        model = build_alexnet(FFConfig(batch_size=4, input_height=67,
                                       input_width=67), machine)
    elif app == "lm":
        from flexflow_tpu.apps.lm import parse_args
        from flexflow_tpu.models.transformer import TransformerLM

        model = TransformerLM(parse_args(LM[:-2]), machine, None)
    else:
        from flexflow_tpu.apps.nmt import parse_args
        from flexflow_tpu.nmt.rnn_model import RnnModel

        model = RnnModel(parse_args(NMT[:-2]), machine, None)
    findings, _ = plan_findings(model, Strategy.load(str(strategy_path)),
                                machine)
    return [f.to_dict() for f in findings]


def _degraded_file(tmp_path, app):
    _, _, op, ndims = DEGRADED[app]
    path = tmp_path / f"{app}_degraded.json"
    path.write_text(json.dumps({op: {"dims": [1] * (ndims - 1) + [2],
                                     "devices": [1, 0]}}))
    return path


def test_drivers_refuse_what_jax_refuses(tmp_path):
    cases, expect = [], []
    for app, (argv, flag, _, _) in DEGRADED.items():
        path = _degraded_file(tmp_path, app)
        cases.append(("app_checked", (argv + [flag, str(path)], app)))
        cases.append(("app_checked", (argv + [flag, str(path),
                                              "--allow-degraded"], app)))
        expect += [(app, path, 2), (app, path, 0)]
    cases.append(("app_checked", (LM + ["--strategy", str(TRANSFORMER_2X4),
                                        "--allow-degraded"], "lm")))
    expect.append(("lm", TRANSFORMER_2X4, 2))
    ranks = tr.run_ranks(tr.run_cases, 2, cases, timeout=240)
    for i, (app, path, code) in enumerate(expect):
        want = _jax_findings(app, path)
        for rank, res in enumerate(ranks):
            got_code, found, loss = res[i]
            assert got_code == code, (app, path.name, rank)
            if code == 2:
                assert any(f["severity"] == "error" for f in found)
            else:
                assert loss is None or (
                    len(loss) == 2 and np.isfinite(loss).all())
                assert all(f["severity"] != "error" for f in found)
            if "--allow-degraded" not in cases[i][1][0]:
                assert found == want, (app, path.name)
            else:
                assert [f["code"] for f in found] == \
                    [f["code"] for f in want]
        if code == 0:
            assert ranks[0][i][2] is not None
    # the degradations are the normalized device lists; the 2x4 file's
    # are its devices beyond the two ranks and its pipeline block
    assert {f["code"] for f in ranks[0][0][1]} == {"degraded_normalized"}
    assert "degraded_normalized" not in {f["code"] for f in ranks[0][-1][1]}


def test_transformer_2x4_refused_on_two_ranks_as_in_jax(tmp_path):
    res = tr.run_ranks(tr.run_cases, 2, [
        ("app_checked", (LM + ["--strategy", str(TRANSFORMER_2X4)],
                         "lm"))], timeout=120)
    want = _jax_findings("lm", TRANSFORMER_2X4)
    for (code, found, loss), in res:
        assert (code, loss) == (2, None)
        assert found == want
    assert any(f["code"] == "device_range" for f in want)


@pytest.mark.parametrize("app", sorted(DEGRADED))
def test_allow_degraded_parses(app):
    from flexflow_tpu_torch.apps import cnn, lm, nmt

    argv = DEGRADED[app][0] + ["--allow-degraded"]
    if app == "cnn":
        assert cnn.parse(argv)[1].allow_degraded
    elif app == "lm":
        assert lm.parse_args(argv)[0].allow_degraded
    else:
        assert nmt.parse_args(argv)[0].allow_degraded
