"""The step budget's and the live metrics' smoke (PyTorch port of
``flexflow_tpu/apps/budget_smoke.py``), on the card unless ``--device
cpu`` is given.

One tiny CNN trains with sampled op timing (``op_time_every``) and live
metrics (``metrics_path``), then the checks:

  1. the obs stream carries one ``step_budget`` record that holds the
     bucket invariant (every bucket non-negative, the buckets summing to
     at most the step's wall time: ``obs.budget.check_budget``);
  2. the MFU waterfall renders from the fresh stream.  The JAX smoke
     runs ``report budget <obs_dir>`` here; the port has no ``report``
     app yet (ROADMAP Queue A item 7), so this smoke calls the two
     functions that command calls, ``obs.budget.mfu_waterfall`` and
     ``render_waterfall`` (``flexflow_tpu/apps/report.py:246-267``);
  3. the Prometheus textfile parses and carries finite ``mfu`` and
     throughput gauges, and the JSON snapshot exists;
  4. the fit trace's counter lanes (imgs/s, MFU, HBM bytes) pass
     ``validate_trace``.

Failed checks exit non-zero::

    python -m flexflow_tpu_torch.apps.budget_smoke [--device cpu]
"""

from __future__ import annotations

import math
import os
import shutil
import sys
import tempfile

ITERS = 6


def _build(cfg, machine):
    from flexflow_tpu_torch.model import FFModel

    ff = FFModel(cfg, machine)
    img = ff.create_input((cfg.batch_size, 16, 16, 3), name="image")
    t = ff.conv2d("conv1", img, 8, 3, 3, 1, 1, 1, 1, relu=True)
    t = ff.flat("flat", t)
    t = ff.linear("fc", t, 8, relu=False)
    ff.softmax("softmax", t)
    return ff


def main(argv=None, log=print) -> int:
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.data import synthetic_batches
    from flexflow_tpu_torch.machine import MachineModel
    from flexflow_tpu_torch.obs import read_run
    from flexflow_tpu_torch.obs.budget import (check_budget, mfu_waterfall,
                                               render_waterfall)
    from flexflow_tpu_torch.obs.metrics import read_textfile
    from flexflow_tpu_torch.obs.trace import (chrome_trace, fit_trace_events,
                                              validate_trace)

    argv = list(sys.argv[1:] if argv is None else argv)
    device = argv[argv.index("--device") + 1] if "--device" in argv \
        else "cuda"
    machine = MachineModel(device)
    tmp = tempfile.mkdtemp(prefix="budget-smoke-")
    try:
        obs_dir = os.path.join(tmp, "obs")
        metrics_path = os.path.join(tmp, "metrics.prom")
        cfg = FFConfig(batch_size=8, input_height=16, input_width=16,
                       num_iterations=ITERS, print_freq=3, num_classes=8,
                       obs_dir=obs_dir, run_id="budget-smoke",
                       op_time_every=2, metrics_path=metrics_path)
        ff = _build(cfg, machine)
        data = synthetic_batches(cfg.batch_size, 16, 16, num_classes=8,
                                 mode="random", seed=0, machine=machine)
        out = ff.fit(data, log=lambda *a: print(*a, file=sys.stderr))

        evs = list(read_run(out["obs_path"]))
        budgets = [e for e in evs if e.get("kind") == "step_budget"]
        assert len(budgets) == 1, f"expected 1 step_budget, got {budgets}"
        violations = check_budget(budgets[0])
        assert not violations, violations
        buckets = budgets[0]["buckets"]
        assert sum(buckets.values()) \
            <= budgets[0]["step_wall_s"] * (1 + 1e-6)

        # the waterfall from the fresh stream, as `report budget` makes it
        wf = mfu_waterfall(sorted(evs, key=lambda e: e.get("ts", 0.0)))
        assert wf is not None and wf["mfu"] is not None, wf
        assert not check_budget({"step_wall_s": wf["step_wall_s"],
                                 "buckets": wf["buckets"]})
        text = "\n".join(render_waterfall(wf))
        assert "MFU waterfall" in text and "remove bucket" in text, text
        print(text, file=sys.stderr)

        vals = read_textfile(metrics_path)
        for key in ("mfu", "throughput_items_per_sec", "images_per_sec",
                    "steps_total"):
            assert key in vals and math.isfinite(vals[key]), (key, vals)
        assert vals["steps_total"] == ITERS, vals
        if machine.device.type == "cuda":
            assert math.isfinite(vals.get("hbm_peak_bytes", math.nan)), vals
        assert os.path.exists(metrics_path + ".json")

        trace = chrome_trace(fit_trace_events(evs))
        errors = validate_trace(trace)
        assert not errors, errors
        counters = [e for e in trace["traceEvents"] if e.get("ph") == "C"]
        names = {e["name"] for e in counters}
        assert "imgs/s" in names and "MFU" in names, names
        if machine.device.type == "cuda":
            assert "HBM bytes" in names, names
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    log(f"budget-smoke OK: step {budgets[0]['step_wall_s'] * 1e3:.2f} ms "
        f"decomposed into {len(buckets)} buckets (residual "
        f"{buckets['residual'] * 1e3:.2f} ms), mfu gauge {vals['mfu']:.2e}, "
        f"{len(counters)} counter samples across {sorted(names)}, on "
        f"{machine.device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
