"""Run the port on several CPU ranks for the strategy tests.

``run_ranks(body, world, *args)`` spawns ``world`` processes (the
``spawn`` start method: the test process has JAX initialized), joins
them in one gloo process group, and calls ``body(machine, *args)`` in
each, returning the bodies' results in rank order.  A run that does not
end within ``timeout`` seconds is killed and fails its test alone.  The
bodies live here, a module whose import pulls in neither torch nor JAX,
so that each child starts quickly; :func:`jax_train`, the reference run
on the JAX package's virtual CPU mesh, imports JAX when the test process
calls it.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import socket
import traceback

import numpy as np


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, body, args, out):
    import torch

    from flexflow_tpu_torch import distributed

    torch.set_num_threads(1)
    try:
        machine = distributed.initialize(
            "cpu", rank=rank, world_size=world,
            init_method=f"tcp://127.0.0.1:{port}")
        out.put((rank, "ok", body(machine, *args)))
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))
    finally:
        distributed.shutdown()


def run_ranks(body, world: int, *args, timeout: float = 120.0):
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_entry,
                         args=(r, world, port, body, args, out), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(world):
            try:
                rank, status, value = out.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    f"{world} ranks did not finish within {timeout} s") \
                    from None
            if status == "ok":
                results[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
    finally:
        for p in procs:
            p.join(timeout=5 if not errors else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return [results[r] for r in range(world)]


# ---------------------------------------------------------------------------
# rank bodies


def build(machine, layers, cfg_kwargs, strategy_json=None):
    """A port FFModel on ``machine`` with ``layers(ff, image)`` (one of
    :data:`MODELS`, named by string)."""
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.model import FFModel
    from flexflow_tpu_torch.strategy import Strategy

    cfg = FFConfig(**cfg_kwargs)
    if strategy_json:
        cfg.strategies = Strategy.from_json(strategy_json)
    ff = FFModel(cfg, machine)
    image = ff.create_input((cfg.batch_size, cfg.input_height,
                             cfg.input_width, CHANNELS.get(layers, 3)),
                            name="image")
    MODELS[layers](ff, image)
    return ff


def save_trees(path, params, state) -> None:
    """Write numpy param and state trees to one ``.npz`` (a file, not the
    spawn pipe, carries them to the ranks)."""
    np.savez(path, **{f"{kind}/{key}/{leaf}": np.asarray(v, np.float32)
                      for kind, tree in (("params", params),
                                         ("state", state))
                      for key, sub in tree.items()
                      for leaf, v in sub.items()})


def load_trees(path):
    trees = {"params": {}, "state": {}}
    with np.load(path) as z:
        for name in z.files:
            kind, key, leaf = name.split("/")
            trees[kind].setdefault(key, {})[leaf] = z[name]
    return trees["params"], trees["state"]


def train(machine, layers, cfg_kwargs, strategy_json, trees_path, batches,
          all_to_all=True):
    """Momentum-SGD steps of the model from the full trees in
    ``trees_path`` on the global numpy ``batches``: ``(losses, params,
    state)``, the losses followed by the eval step's loss and accuracy
    on the last batch, the trees as ``{key: {leaf: (box, block)}}``, each
    final block beside its box in the full leaf.  ``all_to_all`` False moves
    axes as a backend without an all-to-all does."""
    machine.all_to_all = all_to_all
    import torch

    from flexflow_tpu_torch.interop import (params_from_jax, shard_params,
                                            shard_state, state_from_jax)

    ff = build(machine, layers, cfg_kwargs, strategy_json)
    params, state = load_trees(trees_path)
    p = shard_params(params_from_jax(params, "cpu", model=ff), ff)
    s = shard_state(state_from_jax(state, "cpu"), ff)
    opt = ff.init_opt_state(p)
    step = ff.make_train_step()
    losses = []
    for image, labels in batches:
        img, lbl = ff.local_batch(torch.from_numpy(image),
                                  torch.from_numpy(labels))
        p, s, opt, loss = step(p, s, opt, img, lbl)
        losses.append(float(loss))
    evaluated = [float(v) for v in ff.make_eval_step()(p, s, img, lbl)]
    return (losses + evaluated, _blocks(ff.param_boxes(), p),
            _blocks(ff.state_boxes(), s))


def train_halo(machine, *args):
    """:func:`train`, with the bytes this rank's halo exchanges moved."""
    from flexflow_tpu_torch.parallel import collectives

    collectives.reset_halo_bytes()
    return train(machine, *args) + (collectives.halo_bytes(),)


def train_halo_host(machine, *args):
    """:func:`train_halo` with the halo staged through host copies, the
    transport of a backend without point-to-point for the device's
    tensors."""
    machine.send_recv = False
    return train_halo(machine, *args)


def run_cases(machine, cases):
    """Several bodies of this module in one world: each case is
    ``(body name, args)``; a list of their results in case order."""
    return [globals()[name](machine, *args) for name, args in cases]


def _blocks(boxes, tree):
    return {key: {leaf: (boxes[key][leaf], v.float().numpy())
                  for leaf, v in sub.items()} for key, sub in tree.items()}


def app_main(machine, argv, app="cnn", keep_log=False):
    """``apps.<app>.main(argv)`` (``cnn``, ``nmt`` or ``lm``) as one rank
    of a torchrun world (the environment torchrun would set, the process
    group already made): the losses (None on ranks other than 0), with
    ``keep_log`` beside the lines it logged."""
    import importlib
    import os

    os.environ.update(RANK=str(machine.rank),
                      WORLD_SIZE=str(machine.num_devices),
                      LOCAL_RANK=str(machine.rank))
    main = importlib.import_module(f"flexflow_tpu_torch.apps.{app}").main
    lines = []
    out = main(argv, log=lambda *a: lines.append(" ".join(map(str, a))))
    loss = out if out is None else out["loss"]
    return (loss, lines) if keep_log else loss


def app_checked(machine, argv, app):
    """``apps.<app>.main(argv)`` as one rank of a torchrun world, with the
    findings of its static plan check: ``(exit code, [finding dicts],
    losses)``, the exit code 0 and the losses rank 0's when the run went
    on (None on other ranks), else the code it exited with and None."""
    from flexflow_tpu_torch.verify import plan

    found = []
    plan_findings = plan.plan_findings

    def recorded(*args, **kwargs):
        findings, summary = plan_findings(*args, **kwargs)
        found.extend(f.to_dict() for f in findings)
        return findings, summary

    plan.plan_findings = recorded
    try:
        return 0, found, app_main(machine, argv, app)
    except SystemExit as e:
        return e.code, found, None
    finally:
        plan.plan_findings = plan_findings


def fit_obs(machine, layers, cfg_kwargs, batches):
    """``FFModel.fit`` of ``layers`` on this rank's rows of the global
    numpy ``batches``: ``(losses, obs_path)``, the path None on a rank
    that writes no records."""
    import torch

    ff = build(machine, layers, cfg_kwargs)
    data = (ff.local_batch(torch.from_numpy(image), torch.from_numpy(lbl))
            for image, lbl in batches)
    out = ff.fit(data, num_iterations=len(batches), log=lambda *a: None)
    return out["loss"], out["obs_path"]


def fit_ckpt(machine, layers, cfg_kwargs, strategy_json, batches,
             iters):
    """``FFModel.fit`` of ``layers`` under the strategy for ``iters``
    steps on this rank's rows of the global numpy ``batches`` (a resumed
    run skips the steps its checkpoint holds): ``(losses, params, state,
    opt_state, rollbacks)``, the trees as :func:`train` returns them."""
    import torch

    ff = build(machine, layers, cfg_kwargs, strategy_json)
    data = (ff.local_batch(torch.from_numpy(image), torch.from_numpy(lbl))
            for image, lbl in batches)
    out = ff.fit(data, num_iterations=iters, log=lambda *a: None)
    boxes = ff.param_boxes()
    opt_boxes = {key: {leaf: boxes[key][ff._param_leaf(leaf)]
                       for leaf in sub}
                 for key, sub in out["opt_state"].items()}
    return (out["loss"], _blocks(boxes, out["params"]),
            _blocks(ff.state_boxes(), out["state"]),
            _blocks(opt_boxes, out["opt_state"]), out["rollbacks"])


def fit_supervised(machine, layers, cfg_kwargs, strategy_json, batches,
                   iters, rank0=None):
    """:func:`fit_ckpt`'s run with ``rank0``'s config entries on rank 0
    alone (a fault only one rank sees): ``(losses, drain record or None,
    completed steps, async saves)``."""
    import torch

    kw = dict(cfg_kwargs, **(rank0 or {})) if machine.rank == 0 \
        else cfg_kwargs
    ff = build(machine, layers, kw, strategy_json)
    data = (ff.local_batch(torch.from_numpy(image), torch.from_numpy(lbl))
            for image, lbl in batches)
    out = ff.fit(data, num_iterations=iters, log=lambda *a: None)
    return (out["loss"], out.get("drain"), out["completed_steps"],
            out["ckpt_async_saves"])


def restored_blocks(machine, layers, cfg_kwargs, strategy_json, ckpt_dir):
    """The blocks this rank keeps of the newest checkpoint under
    ``ckpt_dir``: ``(step, params, state)`` as :func:`train` returns
    them."""
    ff = build(machine, layers, cfg_kwargs, strategy_json)
    step, params, state, _ = ff._restore(ckpt_dir)
    return (step, _blocks(ff.param_boxes(), params),
            _blocks(ff.state_boxes(), state))


def assemble(full_shapes, rank_blocks):
    """Full numpy leaves from every rank's (box, block) pairs: every
    element must be written by some rank, and the ranks that hold one
    block must hold the same bits (a rank that runs no op of a key holds
    none of it)."""
    out = {}
    for key, leaves in full_shapes.items():
        out[key] = {}
        for leaf, shape in leaves.items():
            a = np.full(shape, np.nan, np.float32)
            for blocks in rank_blocks:
                if key not in blocks:
                    continue
                box, v = blocks[key][leaf]
                sl = tuple(slice(lo, hi) for lo, hi in box)
                held = ~np.isnan(a[sl])
                assert np.array_equal(a[sl][held], v[held]), \
                    f"{key}.{leaf}: replicas differ"
                a[sl] = v
            assert not np.isnan(a).any(), f"{key}.{leaf} not covered"
            out[key][leaf] = a
    return out


def local_train(layers, cfg_kwargs, trees_path, batches):
    """The same steps in this process on one device, no process group:
    ``(losses and eval, {key: {leaf: full final leaf}})``."""
    import torch

    from flexflow_tpu_torch.interop import params_from_jax, state_from_jax
    from flexflow_tpu_torch.machine import MachineModel

    ff = build(MachineModel("cpu"), layers, cfg_kwargs)
    params, state = load_trees(trees_path)
    p = params_from_jax(params, "cpu", model=ff)
    s = state_from_jax(state, "cpu")
    opt = ff.init_opt_state(p)
    step = ff.make_train_step()
    losses = []
    for image, labels in batches:
        image, labels = torch.from_numpy(image), torch.from_numpy(labels)
        p, s, opt, loss = step(p, s, opt, image, labels)
        losses.append(float(loss))
    evaluated = [float(v) for v in ff.make_eval_step()(p, s, image, labels)]
    return losses + evaluated, {key: {leaf: v.numpy()
                                      for leaf, v in sub.items()}
                                for key, sub in p.items()}


def jax_train(layers, cfg_kwargs, strategy_json, devices, batches):
    """The reference: the JAX package's model under the same strategy on
    ``devices`` of its virtual CPU mesh.  Returns ``(params, state,
    losses, final params, final state)`` as numpy trees; a param key
    that the JAX model keeps as stacked per-device rows (a one-point
    grid on one device, ``FFModel._block_params``) is read from its live
    row."""
    import jax

    from flexflow_tpu.config import FFConfig
    from flexflow_tpu.machine import MachineModel
    from flexflow_tpu.model import FFModel
    from flexflow_tpu.strategy import Strategy

    cfg = FFConfig(**cfg_kwargs)
    if strategy_json:
        cfg.strategies = Strategy.from_json(strategy_json)
    ff = FFModel(cfg, MachineModel(devices))
    image = ff.create_input((cfg.batch_size, cfg.input_height,
                             cfg.input_width, CHANNELS.get(layers, 3)),
                            name="image")
    MODELS[layers](ff, image)
    params, state = ff.init(0)
    full, full_state = jax_logical(ff, params, state)
    opt = ff.init_opt_state(params)
    step = ff.make_train_step()
    losses = []
    for image, labels in batches:
        params, state, opt, loss = step(params, state, opt, image, labels)
        losses.append(float(loss))
    return (full, full_state, losses) + jax_logical(ff, params, state)


def jax_logical(ff, params, state):
    """The JAX model's param and state trees as each op's code sees them,
    numpy: a key it stores block-resident (stacked per block or per
    device, ``FFModel._block_params``) reassembled by its member view."""
    import jax

    by_key = {op.param_key: op for op in ff.layers}
    by_name = {op.name: op for op in ff.layers}
    p = {key: ff._member_params(params, by_key[key]) for key in params}
    s = {name: ff._member_state(state, by_name[name]) for name in state}
    return jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s)


#: losses against the JAX run and the port's one-rank run
LOSS_RTOL, LOSS_ATOL = 2e-4, 2e-5
#: final leaves, as a share of the largest magnitude among an op's leaves
LEAF_RTOL = 1e-4


def close_trees(got, want, what):
    for key, leaves in want.items():
        scale = max(float(np.abs(v).max()) for v in leaves.values()) or 1.0
        for leaf, w in leaves.items():
            err = float(np.abs(np.asarray(got[key][leaf]) - w).max())
            assert err <= LEAF_RTOL * scale, \
                f"{what} {key}.{leaf}: max err {err:.3e} > " \
                f"{LEAF_RTOL} x {scale:.3e}"


def check_strategy(tmp_path, layers, cfg_kwargs, strategy_json, ranks,
                   batches, timeout=150.0, all_to_all=True):
    """Train ``layers`` under the strategy on ``ranks`` gloo ranks and on
    the JAX package's ``ranks`` virtual devices from one parameter tree;
    hold the losses, the final params and the final state against JAX's
    and against the port's run in one process; returns the losses."""
    case, want = jax_case(tmp_path, layers, cfg_kwargs, strategy_json,
                          ranks, batches, all_to_all)
    res = run_ranks(train, ranks, *case, timeout=timeout)
    return check_case(case, want, res)


def jax_case(tmp_path, layers, cfg_kwargs, strategy_json, ranks, batches,
             all_to_all=True, tag="trees"):
    """The JAX run of one case and the arguments of its port run:
    ``(case, (j_losses, j_params, j_state))``."""
    import jax

    full, state, j_losses, j_params, j_state = jax_train(
        layers, cfg_kwargs, strategy_json, jax.devices()[:ranks], batches)
    path = str(tmp_path / f"{tag}.npz")
    save_trees(path, full, state)
    return ((layers, cfg_kwargs, strategy_json, path, batches, all_to_all),
            (j_losses, j_params, j_state))


def check_case(case, want, res, one_rank=True):
    """Hold one case's rank results against the JAX run and, with
    ``one_rank``, the port's run in one process; returns the losses."""
    layers, cfg_kwargs, strategy_json, path, batches, _ = case
    j_losses, j_params, j_state = want
    losses = res[0][0]
    # the loss (and the eval step's loss and accuracy) is the global
    # batch's on every rank
    assert all(r[0] == losses for r in res)
    np.testing.assert_allclose(losses[:-2], j_losses, rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    shapes = {k: {leaf: v.shape for leaf, v in d.items()}
              for k, d in j_params.items()}
    params = assemble(shapes, [r[1] for r in res])
    close_trees(params, j_params, "params vs JAX")
    if j_state:
        got = assemble({k: {leaf: v.shape for leaf, v in d.items()}
                        for k, d in j_state.items()}, [r[2] for r in res])
        close_trees(got, j_state, "state vs JAX")
    if one_rank:
        one_losses, one_params = local_train(layers, cfg_kwargs, path,
                                             batches)
        np.testing.assert_allclose(losses, one_losses, rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL)
        close_trees(params, one_params, "params vs one rank")
    return losses[:-2]


def holders(res, kind=1):
    """``{key: (rank, ...)}``: the ranks whose final tree (``kind`` 1:
    params, 2: state) holds each key."""
    out = {}
    for rank, r in enumerate(res):
        for key in r[kind]:
            out.setdefault(key, []).append(rank)
    return {key: tuple(v) for key, v in out.items()}


def random_batches(steps, batch, size, classes, seed=13):
    rng = np.random.RandomState(seed)
    return [(rng.randn(batch, size, size, 3).astype("float32"),
             rng.randint(0, classes, size=batch).astype("int32"))
            for _ in range(steps)]


def strategy_json(grids, ranks) -> str:
    """A strategy file's text: ``{op: dims}`` over all ``ranks``."""
    import json

    return json.dumps({name: {"dims": list(dims),
                              "devices": list(range(ranks))}
                       for name, dims in grids.items()})


# ---------------------------------------------------------------------------
# the NMT trainer


def nmt_model(machine, cfg_kwargs, strategy_json):
    """The port's RnnModel on ``machine``: its default strategy unless
    ``strategy_json`` gives one."""
    from flexflow_tpu_torch.nmt.rnn_model import RnnConfig, RnnModel
    from flexflow_tpu_torch.strategy import Strategy

    strategies = Strategy.from_json(strategy_json) if strategy_json \
        else None
    return RnnModel(RnnConfig(**cfg_kwargs), machine, strategies)


def nmt_train(machine, cfg_kwargs, strategy_json, trees_path, batches):
    """SGD steps of the NMT from the full params in ``trees_path`` on the
    global (src, dst) ``batches``: ``(losses, params, {})``, the params as
    :func:`train` returns them."""
    import torch

    from flexflow_tpu_torch.interop import params_from_jax, shard_params

    model = nmt_model(machine, cfg_kwargs, strategy_json)
    params, _ = load_trees(trees_path)
    p = shard_params(params_from_jax(params, "cpu", model=model), model)
    opt = model.init_opt_state(p)
    step = model.make_train_step()
    losses = []
    for src, dst in batches:
        s, d = model.local_batch(torch.from_numpy(src), torch.from_numpy(dst))
        p, _, opt, loss = step(p, {}, opt, s, d)
        losses.append(float(loss))
    return losses, _blocks(model.param_boxes(), p), {}


def jax_nmt(cfg_kwargs, strategy_json, devices, batches):
    """The reference NMT run on ``devices`` of the JAX virtual mesh:
    ``(params, losses, final params)`` as numpy trees (member views)."""
    from flexflow_tpu.machine import MachineModel
    from flexflow_tpu.nmt.rnn_model import RnnConfig, RnnModel
    from flexflow_tpu.strategy import Strategy

    strategies = Strategy.from_json(strategy_json) if strategy_json \
        else None
    model = RnnModel(RnnConfig(**cfg_kwargs), MachineModel(devices),
                     strategies)
    params, state = model.init(seed=0)
    full, _ = jax_logical(model, params, state)
    step = model.make_train_step()
    losses = []
    for src, dst in batches:
        params, state, _, loss = step(params, state, None, src, dst)
        losses.append(float(loss))
    return full, losses, jax_logical(model, params, state)[0]


def nmt_local(cfg_kwargs, trees_path, batches):
    """The port's NMT in this process on one device, no process group:
    ``(losses, final params)``."""
    import torch

    from flexflow_tpu_torch.interop import params_from_jax
    from flexflow_tpu_torch.machine import MachineModel

    model = nmt_model(MachineModel("cpu"), cfg_kwargs, None)
    params, _ = load_trees(trees_path)
    p = params_from_jax(params, "cpu", model=model)
    opt = model.init_opt_state(p)
    step = model.make_train_step()
    losses = []
    for src, dst in batches:
        p, _, opt, loss = step(p, {}, opt, torch.from_numpy(src),
                               torch.from_numpy(dst))
        losses.append(float(loss))
    return losses, {key: {leaf: v.numpy() for leaf, v in sub.items()}
                    for key, sub in p.items()}


def token_batches(steps, batch, seq, vocab, seed=5):
    rng = np.random.RandomState(seed)
    return [tuple(rng.randint(0, vocab, (batch, seq)).astype("int32")
                  for _ in range(2)) for _ in range(steps)]


# ---------------------------------------------------------------------------
# the transformer LM trainer


def lm_model(machine, cfg_kwargs, strategy_json):
    """The port's TransformerLM on ``machine`` under ``strategy_json``
    (data parallel where None)."""
    from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                       TransformerLM)
    from flexflow_tpu_torch.strategy import Strategy

    strategies = Strategy.from_json(strategy_json) if strategy_json \
        else None
    return TransformerLM(TransformerConfig(**cfg_kwargs), machine,
                         strategies)


def lm_train(machine, cfg_kwargs, strategy_json, trees_path, batches):
    """SGD steps of the LM from the full params in ``trees_path`` on the
    global token ``batches`` (each its own labels, as ``apps.lm`` feeds
    them): ``(losses, params, {})``, the params as :func:`train` returns
    them."""
    import torch

    from flexflow_tpu_torch.interop import params_from_jax, shard_params

    model = lm_model(machine, cfg_kwargs, strategy_json)
    params, _ = load_trees(trees_path)
    p = shard_params(params_from_jax(params, "cpu", model=model), model)
    opt = model.init_opt_state(p)
    step = model.make_train_step()
    losses = []
    for toks in batches:
        (t,) = model.local_batch(torch.from_numpy(toks))
        p, _, opt, loss = step(p, {}, opt, t, t)
        losses.append(float(loss))
    return losses, _blocks(model.param_boxes(), p), {}


def jax_lm(cfg_kwargs, strategy_json, devices, batches):
    """The reference LM run on ``devices`` of the JAX virtual mesh:
    ``(params, losses, final params)`` as numpy trees (member views)."""
    from flexflow_tpu.machine import MachineModel
    from flexflow_tpu.models.transformer import (TransformerConfig,
                                                 TransformerLM)
    from flexflow_tpu.strategy import Strategy

    strategies = Strategy.from_json(strategy_json) if strategy_json \
        else None
    model = TransformerLM(TransformerConfig(**cfg_kwargs),
                          MachineModel(devices), strategies)
    params, state = model.init(seed=0)
    full, _ = jax_logical(model, params, state)
    step = model.make_train_step()
    losses = []
    for toks in batches:
        params, state, _, loss = step(params, state, None, toks, toks)
        losses.append(float(loss))
    return full, losses, jax_logical(model, params, state)[0]


def lm_local(cfg_kwargs, trees_path, batches):
    """The port's LM in this process on one device, no process group:
    ``(losses, final params)``."""
    import torch

    from flexflow_tpu_torch.interop import params_from_jax
    from flexflow_tpu_torch.machine import MachineModel

    model = lm_model(MachineModel("cpu"), cfg_kwargs, None)
    params, _ = load_trees(trees_path)
    p = params_from_jax(params, "cpu", model=model)
    opt = model.init_opt_state(p)
    step = model.make_train_step()
    losses = []
    for toks in batches:
        t = torch.from_numpy(toks)
        p, _, opt, loss = step(p, {}, opt, t, t)
        losses.append(float(loss))
    return losses, {key: {leaf: v.numpy() for leaf, v in sub.items()}
                    for key, sub in p.items()}


def check_lm(want, per_rank, cfg_kwargs, batches):
    """Hold one LM case's rank results (``lm_train``'s, rank order) to the
    JAX run ``want`` (``(losses, final params, trees path)``) and to the
    port's run in one process: losses within rtol 2e-4 / atol 2e-5,
    every final leaf within 1e-4 of its key's largest magnitude, the
    ranks holding one block holding the same bits.  Returns the losses."""
    j_losses, j_params, path = want
    losses = per_rank[0][0]
    assert all(r[0] == losses for r in per_rank)
    np.testing.assert_allclose(losses, j_losses, rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    shapes = {k: {leaf: v.shape for leaf, v in d.items()}
              for k, d in j_params.items()}
    params = assemble(shapes, [r[1] for r in per_rank])
    close_trees(params, j_params, "params vs JAX")
    one_losses, one_params = lm_local(cfg_kwargs, path, batches)
    np.testing.assert_allclose(losses, one_losses, rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    close_trees(params, one_params, "params vs one rank")
    return losses


def moe_op(machine, dims, path, k, cap):
    """The MoE op alone on ``machine`` under grid ``dims`` (its first
    ``prod(dims)`` devices) from the JAX op's params and the global x
    and cotangent g in the ``.npz`` at ``path``: this rank's ``(rows,
    slots, src, y, aux, leaf gradients {leaf: (box, block)}, x rows, x
    gradient)`` for ``sum(y * g) + 0.5 aux``, the gradients summed over
    each leaf's holders as a training step sums them."""
    import math

    import torch

    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.model import FFModel
    from flexflow_tpu_torch.parallel import collectives
    from flexflow_tpu_torch.strategy import ParallelConfig, Strategy

    with np.load(path) as z:
        x, g = torch.from_numpy(z["x"]), torch.from_numpy(z["g"])
        full = {leaf: torch.from_numpy(z[f"p/{leaf}"])
                for leaf in ("wg", "w1", "b1", "w2", "b2")}
    b, s, d = x.shape
    e, f = full["w1"].shape[0], full["w1"].shape[2]
    cfg = FFConfig(batch_size=b)
    cfg.strategies = Strategy()
    cfg.strategies["moe"] = ParallelConfig(
        tuple(dims), tuple(range(math.prod(dims))))
    ff = FFModel(cfg, machine)
    t = ff.create_input((b, s, d), name="x")
    ff.moe("moe", t, e, f, k, cap)
    op = ff.layers[-1]
    ff._setup_sharded()
    p = {leaf: v.clone().requires_grad_(True)
         for leaf, v in ff.shard_params({"moe": full})["moe"].items()}
    (xl,) = ff.local_batch(x)
    xl = xl.clone().requires_grad_(True)
    lo, hi = ff._boxes_of(op, op.output_spec(), x.shape)[
        machine.position][0]
    first = ff._first_holder(op, op.output_spec(), x.shape)
    with collectives.token_chain("cpu") as chain:
        values, _ = ff.apply({"moe": p}, {}, {t.tid: xl}, True)
        y, aux = values[op.output.tid], values[op.aux.tid]
        part = (y * g[lo:hi]).sum() * float(first)
        loss = collectives.global_sum(part, machine.world_group()) \
            + 0.5 * (aux if ff.aux_counted(op) else aux.detach())
        keys = sorted(p)
        grads = torch.autograd.grad(loss + chain.token,
                                    [p[kk] for kk in keys]
                                    + [xl, chain.first])[:-1]
    synced = ff._sync_grads([("moe", kk) for kk in keys], list(grads[:-1]))
    boxes = ff.param_boxes()["moe"]
    src, _, slots, _, _ = op.route(p, x[lo:hi])
    return ((lo, hi), slots.numpy(), src.numpy(), y.detach().numpy(),
            float(aux), {kk: (boxes[kk], gg.numpy())
                         for kk, gg in zip(keys, synced)},
            machine.batch_block(b), grads[-1].numpy())


# ---------------------------------------------------------------------------
# the GPipe pipeline


def save_pipelined(path, tree) -> None:
    """A ``PipelinedLM`` params tree of numpy arrays to one ``.npz``."""
    flat = {f"blocks/{k}": np.asarray(v, np.float32)
            for k, v in tree["blocks"].items()}
    flat.update({k: np.asarray(v, np.float32) for k, v in tree.items()
                 if k != "blocks"})
    np.savez(path, **flat)


def load_pipelined(path):
    out = {"blocks": {}}
    with np.load(path) as z:
        for name in z.files:
            if name.startswith("blocks/"):
                out["blocks"][name[len("blocks/"):]] = z[name]
            else:
                out[name] = z[name]
    return out


def pipe_stage(machine, stages, path, transport="p2p"):
    """``spmd_pipeline`` of the stage ``tanh(x @ w + b)`` over a (stages,
    world / stages) mesh, each n rank taking its rows of every
    microbatch, from the stacked params, microbatches and output
    cotangent in the ``.npz`` at ``path``, rotating by ``transport``:
    this rank's ``((stage, n), rows, outputs, dw, db, dx)`` for
    ``sum(out * gy)`` (counted on the last stage), dw and db summed over
    the stage's n ranks and dx the first stage's (zeros elsewhere)."""
    import torch

    from flexflow_tpu_torch.parallel import collectives
    from flexflow_tpu_torch.parallel.pipeline import spmd_pipeline

    with np.load(path) as z:
        w, b, xs, gy = (torch.from_numpy(z[k]) for k in ("w", "b", "xs",
                                                         "gy"))
    dp = machine.num_devices // stages
    mesh = machine.pipeline_mesh(stages, dp, 1)
    s, n, _ = mesh.coords
    mbl = xs.shape[1] // dp
    rows = (n * mbl, (n + 1) * mbl)
    p = {"w": w[s].clone().requires_grad_(True),
         "b": b[s].clone().requires_grad_(True)}
    x = xs[:, rows[0]:rows[1]].clone().requires_grad_(True)

    def stage(q, v):
        return torch.tanh(v @ q["w"] + q["b"])

    with collectives.token_chain("cpu") as chain:
        out = spmd_pipeline(stage, p, x, mesh.stage, s, transport)
        part = (out * gy[:, rows[0]:rows[1]]).sum() \
            * float(s == stages - 1)
        loss = collectives.global_sum(part, mesh.world)
        dw, db, dx = torch.autograd.grad(
            loss + chain.token, [p["w"], p["b"], x, chain.first],
            allow_unused=True)[:-1]
    dx = torch.zeros_like(x) if dx is None else dx
    grads = torch.cat([dw.reshape(-1), db.reshape(-1)])
    collectives.all_reduce_(grads, mesh.data)
    dw, db = grads.split([dw.numel(), db.numel()])
    return ((s, n), rows, out.detach().numpy(), dw.view_as(w[s]).numpy(),
            db.numpy(), dx.numpy())


def pipe_lm(machine, kwargs, path, batches):
    """``PipelinedLM`` on ``machine`` from the full tree at ``path``:
    ``(first loss by loss_fn, losses of SGD steps on the global
    ``batches``, {"blocks": {leaf: (box, block)}, leaf: (box, value)})``."""
    import torch

    from flexflow_tpu_torch.interop import params_from_jax, shard_params
    from flexflow_tpu_torch.parallel.pipeline import PipelinedLM

    model = PipelinedLM(machine, **kwargs)
    p = shard_params(params_from_jax(load_pipelined(path), "cpu",
                                     model=model), model)
    with torch.no_grad():
        first = float(model.loss_fn(p, batches[0], batches[0]))
    step = model.make_train_step()
    losses = []
    for toks in batches:
        p, loss = step(p, torch.from_numpy(toks), torch.from_numpy(toks))
        losses.append(float(loss))
    boxes = model.param_boxes()
    held = {"blocks": {k: (boxes["blocks"][k], v.numpy())
                       for k, v in p["blocks"].items()}}
    held.update({k: (boxes[k], v.numpy()) for k, v in p.items()
                 if k != "blocks"})
    return first, losses, held


def ring_case(machine, shape, s_axes, causal, transport, seed=1):
    """``ring_attention`` of seeded global q, k, v (B, H, S, d) over the
    groups along global axes ``s_axes`` (the sequence split over them,
    batch over the rest): this rank's ``(box, o, dq, dk, dv)`` for a
    weighted sum of o, the box its (batch, sequence) block."""
    import torch

    from flexflow_tpu_torch.parallel import collectives
    from flexflow_tpu_torch.parallel.ring_attention import ring_attention

    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype("float32"))
               for _ in range(3))
    axes = tuple(a for a, _ in machine.global_factors())
    n_axes = tuple(a for a in axes if a not in s_axes)
    entries = (n_axes, (), tuple(s_axes), ())
    box = machine.block(entries, shape)
    sl = tuple(slice(lo, hi) for lo, hi in box)
    ql, kl, vl = (t[sl].clone().requires_grad_(True) for t in (q, k, v))
    machine.create_groups([tuple(s_axes)])
    group = machine.group(tuple(s_axes))
    index = group.positions.index(machine.position)
    weight = torch.from_numpy(rng.randn(*shape).astype("float32"))[sl]
    with collectives.token_chain("cpu") as chain:
        o = ring_attention(ql, kl, vl, group, index, causal, transport)
        grads = torch.autograd.grad((o * weight).sum() + chain.token,
                                    [ql, kl, vl, chain.first])[:-1]
    return box, o.detach().numpy(), [g.numpy() for g in grads]


# ---------------------------------------------------------------------------
# the models, built alike in both packages


def tiny(ff, image):
    """tests/test_model.py's tiny net."""
    t = ff.conv2d("conv1", image, 8, 3, 3, 1, 1, 1, 1, relu=True)
    t = ff.pool2d("pool1", t, 2, 2, 2, 2, 0, 0)
    t = ff.conv2d("conv2", t, 16, 3, 3, 2, 2, 1, 1, relu=True)
    t = ff.flat("flat", t)
    t = ff.linear("linear1", t, 32)
    t = ff.linear("linear2", t, 10, relu=False)
    return ff.softmax("softmax", t)


def alexnet(ff, image):
    from flexflow_tpu_torch.models.alexnet import add_alexnet_layers

    return add_alexnet_layers(ff, image)


def vgg_style(ff, image):
    """Convolutions with BatchNorm, a 2x2 max pool, a pad-1 3x3/2 max pool
    and a channel concat."""
    t = ff.conv2d("conv1", image, 8, 3, 3, 1, 1, 1, 1)
    t = ff.batch_norm("bn1", t)
    t = ff.pool2d("pool1", t, 2, 2, 2, 2, 0, 0)
    a = ff.conv2d("conv2a", t, 8, 3, 3, 1, 1, 1, 1, relu=True)
    b = ff.conv2d("conv2b", t, 4, 1, 1, 1, 1, 0, 0, relu=True)
    t = ff.concat("cat", [a, b])
    t = ff.batch_norm("bn2", t)
    t = ff.pool2d("pool2", t, 3, 3, 2, 2, 1, 1)
    t = ff.flat("flat", t)
    t = ff.linear("linear1", t, 16)
    t = ff.linear("linear2", t, 10, relu=False)
    return ff.softmax("softmax", t)


def resnet_style(ff, image):
    """A residual block (BatchNorm, Add with ReLU), an in-block 3x3/1
    pad-1 average pool and the global average pool."""
    t = ff.conv2d("conv1", image, 8, 3, 3, 1, 1, 1, 1)
    t = ff.batch_norm("bn1", t)
    r = ff.conv2d("res_conv1", t, 8, 3, 3, 1, 1, 1, 1)
    r = ff.batch_norm("res_bn1", r)
    r = ff.conv2d("res_conv2", r, 8, 3, 3, 1, 1, 1, 1)
    r = ff.batch_norm("res_bn2", r, relu=False)
    t = ff.add("res_add", t, r, relu=True)
    t = ff.pool2d("pool1", t, 3, 3, 1, 1, 1, 1, pool_type="avg",
                  relu=False)
    t = ff.conv2d("conv2", t, 16, 3, 3, 2, 2, 1, 1, relu=True)
    _, h, w, _ = t.shape
    t = ff.pool2d("gpool", t, h, w, 1, 1, 0, 0, pool_type="avg",
                  relu=False)
    t = ff.flat("flat", t)
    t = ff.linear("linear1", t, 10, relu=False)
    return ff.softmax("softmax", t)


def vgg16(ff, image):
    from flexflow_tpu_torch.models.vgg import add_vgg16_layers

    return add_vgg16_layers(ff, image)


def placed_bn(ff, image):
    """tests/test_placement.py's placed-BatchNorm net (8 input channels)."""
    t = ff.conv2d("conv1", image, 16, 3, 3, 1, 1, 1, 1, relu=False)
    t = ff.batch_norm("bn1", t, relu=True)
    t = ff.flat("flat", t)
    return ff.softmax("softmax", ff.linear("fc1", t, 32, relu=False))


def set_family(ff, image):
    """tests/test_set_family.py's spatial conv and max pool (8 input
    channels), one net."""
    t = ff.conv2d("conv1", image, 16, 3, 3, 1, 1, 1, 1, relu=True)
    t = ff.pool2d("pool1", t, 3, 3, 1, 1, 1, 1)
    t = ff.flat("flat", t)
    return ff.softmax("softmax", ff.linear("fc1", t, 64, relu=False))


def trace_cnn(ff, image):
    """tests/test_trace.py's op-timing net."""
    t = ff.conv2d("conv1", image, 8, 3, 3, 1, 1, 1, 1, relu=True)
    t = ff.flat("flat", t)
    t = ff.linear("fc", t, 8, relu=False)
    return ff.softmax("softmax", t)


def halo_net(ff, image):
    """Windows whose halos the h and w splits exchange: a 3x3/1 pad-1
    convolution, a 3x3/2 max pool, a 5x5/2 pad-2 convolution (a halo of
    two rows on one side, one or none on the other) and a 3x3/1 pad-1
    average pool, over a 17x17 image (blocks of 9 and 8 on two ranks,
    5, 5, 5 and 2 on four)."""
    t = ff.conv2d("conv1", image, 8, 3, 3, 1, 1, 1, 1, relu=True)
    t = ff.pool2d("pool1", t, 3, 3, 2, 2, 0, 0)
    t = ff.conv2d("conv2", t, 8, 5, 5, 2, 2, 2, 2, relu=True)
    t = ff.pool2d("pool2", t, 3, 3, 1, 1, 1, 1, pool_type="avg",
                  relu=False)
    t = ff.flat("flat", t)
    t = ff.linear("linear1", t, 10, relu=False)
    return ff.softmax("softmax", t)


MODELS = {"tiny": tiny, "alexnet": alexnet, "vgg_style": vgg_style,
          "resnet_style": resnet_style, "vgg16": vgg16,
          "placed_bn": placed_bn, "set_family": set_family,
          "trace_cnn": trace_cnn, "halo_net": halo_net}

#: input channels of the models that do not take RGB images
CHANNELS = {"placed_bn": 8, "set_family": 8}
