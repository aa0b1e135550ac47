"""Rank bodies for the fleet and collective-audit tests
(``tests/test_torch_fleet.py``, ``tests/test_torch_audit.py``), run in
spawned gloo CPU worlds by ``torch_ranks.run_ranks``.  Like
``torch_ranks``, this module imports neither torch nor JAX at import
time, so that each child starts quickly."""

from __future__ import annotations

import numpy as np


def save_models(path, trees) -> None:
    """``{model: {key: {leaf: array}}}`` to one ``.npz``."""
    np.savez(path, **{f"{m}/{key}/{leaf}": np.asarray(v)
                      for m, tree in trees.items()
                      for key, sub in tree.items()
                      for leaf, v in sub.items()})


def load_models(path):
    out = {}
    with np.load(path) as z:
        for name in z.files:
            m, key, leaf = name.split("/")
            out.setdefault(m, {}).setdefault(key, {})[leaf] = z[name]
    return out


def _init_from(trees):
    """``FFModel.init`` replaced by the JAX package's initial trees: the
    fleet's CNN (``conv1``) takes ``trees["cnn"]``, the tiny GPT
    ``trees["gpt"]``, each rank its blocks.  Returns the original."""
    import torch

    from flexflow_tpu_torch.model import FFModel

    orig = FFModel.init

    def init(self, seed=None):
        name = "cnn" if any(op.name == "conv1" for op in self.layers) \
            else "gpt"
        full = {k: {leaf: torch.from_numpy(np.array(v))
                    for leaf, v in sub.items()}
                for k, sub in trees[name].items()}
        params, state, _ = self.place_state(full, {}, None)
        return params, state

    FFModel.init = init
    return orig


def fleet_smoke(machine, trees_path, obs_dir, iterations):
    """``apps.fleet``'s smoke on this world from the JAX package's
    initial weights: rank 0 checks it (``check_smoke``) and returns the
    facts and the summary; every rank returns the replies of the serving
    job's requests it served."""
    from flexflow_tpu_torch.apps import fleet
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.model import FFModel

    orig = _init_from(load_models(trees_path))
    try:
        cfg = FFConfig.from_args([])
        cfg.num_iterations = iterations
        cfg.obs_dir = obs_dir
        log = fleet._err if machine.rank == 0 else fleet._quiet
        summary, coord = fleet.fleet_run(cfg, machine, log=log)
        serve = next(j for j in coord.jobs if j.spec.job_id == "serve-b")
        out = {"replies": {r.rid: list(r.reply) for r in serve.served}}
        if machine.rank == 0:
            out["facts"] = fleet.check_smoke(cfg, summary, coord,
                                             log=fleet._quiet)
            out["summary"] = summary
        return out
    finally:
        FFModel.init = orig


def fleet_abort(machine):
    """A resize whose leg fails on every rank: the job resumes running
    on the slice it holds (the exception propagates), keeps stepping,
    and its records show the abort edge (JAX's
    ``test_resize_failure_aborts_back_to_running``)."""
    import os
    import tempfile

    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.apps import fleet
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.fleet import Job, JobSpec
    from flexflow_tpu_torch.utils import elastic

    cfg = FFConfig(batch_size=24, input_height=16, input_width=16,
                   num_iterations=6, print_freq=0, num_classes=8, seed=3)
    spec = JobSpec(job_id="a", kind="train", build=fleet._train_build,
                   config=cfg, payload=fleet._host_batches,
                   min_devices=1, max_devices=4)
    td = tempfile.mkdtemp(prefix="ff-fleet-abort-")
    path = os.path.join(td, f"job{machine.rank}.jsonl")
    olog = obs.RunLog(path, surface="fit") if machine.rank == 0 \
        else obs.NULL
    job = Job(spec, olog=olog, log=fleet._quiet)
    job.place(machine, [0, 1, 2, 3])

    def boom(*a, **kw):
        raise RuntimeError("injected rebuild failure")

    orig = elastic.slice_move
    elastic.slice_move = boom
    try:
        job.resize(machine, [0, 1])
        raised = False
    except RuntimeError as e:
        raised = "injected rebuild failure" in str(e)
    finally:
        elastic.slice_move = orig
    out = {"raised": raised, "state": job.state,
           "ordinals": list(job.ordinals),
           "stepping": job.step_quantum(1, pool=machine),
           "losses": job.losses()}
    if machine.rank == 0:
        olog.close()
        recs = list(obs.read_run(path))
        out["states"] = [(r["state"], r["from_state"]) for r in recs
                         if r["kind"] == "fleet_job" and "from_state" in r]
        out["aborts"] = sum(1 for r in recs if r["kind"] == "fleet_job"
                            and r.get("resize_failed"))
    return out


def audit_dry_and_live(machine, strategy_json, batch, size, ici_group):
    """One training step of AlexNet (``size`` x ``size``, batch
    ``batch``) under ``strategy_json`` on this world, its collectives
    recorded twice: traced on ``meta`` tensors (the audit's dry run) and
    run for real; both lists joined over the world."""
    import os
    import tempfile

    from flexflow_tpu_torch.utils import hlo_audit

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with open(path, "w") as f:
            f.write(strategy_json)
        over = {"input_height": size, "input_width": size}
        model, b = hlo_audit._build_model("alexnet", machine, batch, path,
                                          overrides=over)
        dry = hlo_audit.step_collectives(model, b)
        params, state = model.init()
        opt = model.init_opt_state(params)
        live = hlo_audit.step_collectives(
            model, b, live=True, step=model.make_train_step(),
            trees=(params, state, opt))
    finally:
        os.unlink(path)
    join = hlo_audit.join_records
    return (hlo_audit.collective_summary(join(dry, machine), ici_group),
            hlo_audit.collective_summary(join(live, machine), ici_group))
