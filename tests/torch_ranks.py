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

import contextlib
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import traceback

import numpy as np


@contextlib.contextmanager
def _rendezvous():
    """A ``file://`` init method in a fresh temporary directory, removed
    afterwards: the ranks meet in a file store no other world can take,
    where a TCP port picked free and released before the ranks bind it
    can be taken by another test's world in between."""
    d = tempfile.mkdtemp(prefix="ff-ranks-")
    try:
        yield "file://" + os.path.join(d, "store")
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _entry(rank, world, init_method, body, args, out):
    import torch

    from flexflow_tpu_torch import distributed

    torch.set_num_threads(1)
    try:
        machine = distributed.initialize(
            "cpu", rank=rank, world_size=world, init_method=init_method)
        out.put((rank, "ok", body(machine, *args)))
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))
    finally:
        distributed.shutdown()


def run_ranks(body, world: int, *args, timeout: float = 120.0):
    with _rendezvous() as init_method:
        return _run(_entry, world, (body, args), init_method, timeout,
                    f"{world} ranks did not finish within {timeout} s")


def _run(target, world, args, init_method, timeout, late):
    """``target(rank, world, init_method, *args, queue)`` in ``world``
    spawned processes; their results in rank order."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=target,
                         args=(r, world, init_method) + tuple(args) + (out,),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(world):
            try:
                rank, status, value = out.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(late) from None
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


#: the torch.distributed calls that move data, which the dry run must
#: not make
DIST_CALLS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
              "broadcast", "batch_isend_irecv", "send", "recv", "isend",
              "irecv", "all_gather_object", "barrier")


def dry_run(machine, layers, cfg_kwargs, strategy_json):
    """``FFModel.fit`` under ``dry_compile`` with every data-moving
    ``torch.distributed`` call counted: ``(result without trees, log
    lines, calls)``, or ``("error", message)`` when the build refuses the
    strategy."""
    import torch.distributed as dist

    from flexflow_tpu_torch.ops import kernels

    calls = []
    saved = {name: getattr(dist, name) for name in DIST_CALLS}

    def counted(name):
        def call(*args, **kwargs):
            calls.append(name)
            return saved[name](*args, **kwargs)
        return call

    try:
        ff = build(machine, layers, dict(cfg_kwargs, dry_compile=True),
                   strategy_json)
        # this rank's rows, as the data sources over ranks yield them
        data = iter([ff.local_batch(
            np.zeros((cfg_kwargs["batch_size"], cfg_kwargs["input_height"],
                      cfg_kwargs["input_width"], 3), "float32"),
            np.zeros((cfg_kwargs["batch_size"],), "int32"))])
        kernels.reset_launches()
        for name in DIST_CALLS:
            setattr(dist, name, counted(name))
        lines = []
        out = ff.fit(data, log=lines.append)
    except ValueError as e:
        return "error", str(e)
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)
    res = {k: v for k, v in out.items()
           if k not in ("params", "state", "opt_state")}
    res["trees"] = [out[k] for k in ("params", "state", "opt_state")]
    res["launches"] = dict(kernels.launches)
    return res, lines, calls


def ones_blocks(machine, layers, cfg_kwargs, strategy_json):
    """``params_init="ones"`` on this rank: ``(leaves held, all 1.0)``."""
    ff = build(machine, layers, dict(cfg_kwargs, params_init="ones"),
               strategy_json)
    params, _ = ff.init(seed=machine.rank + 7)
    leaves = [v for sub in params.values() for v in sub.values()]
    return len(leaves), all(bool((v == 1).all()) for v in leaves)


def dump_lines(machine, layers, cfg_kwargs, strategy_json, trees_path,
               image, labels):
    """The dump mode's lines of one training forward (``loss_fn``) of the
    global batch from the whole trees in ``trees_path``: what this rank
    printed (rank 0 alone prints)."""
    import contextlib
    import io

    import torch

    from flexflow_tpu_torch.interop import (params_from_jax, shard_params,
                                            shard_state, state_from_jax)

    ff = build(machine, layers, dict(cfg_kwargs, print_intermediates=True),
               strategy_json)
    params, state = load_trees(trees_path)
    p = shard_params(params_from_jax(params, "cpu", model=ff), ff)
    s = shard_state(state_from_jax(state, "cpu"), ff)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ff.loss_fn(p, s, *ff.local_batch(torch.from_numpy(image),
                                         torch.from_numpy(labels)),
                   train=True)
    return buf.getvalue().splitlines()


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
# elastic training (tests/test_torch_elastic_ranks.py)

#: the JAX elastic tests' batch (tests/test_elastic.py): divisible by the
#: worlds of 8, 6, 4 and 2
ELASTIC_BATCH = 24
#: the kinds of the elastic lifecycle's records
ELASTIC_KINDS = ("device_loss", "elastic_resize", "device_probe",
                 "device_return", "elastic_fallback", "elastic_refused")
#: the fields of an elastic record both packages set alike
ELASTIC_FIELDS = ("kind", "step", "direction", "from_devices",
                  "to_devices", "migration", "resume_step", "steps_lost",
                  "dead", "returned", "classification", "outcome",
                  "healthy_streak", "needed", "probe", "fault",
                  "occurrence", "source")


def elastic_host_batches(seed=3, n=4):
    """The JAX elastic tests' ring of global host batches."""
    rng = np.random.RandomState(seed)
    return [(rng.randn(ELASTIC_BATCH, 16, 16, 3).astype("float32"),
             rng.randint(0, 8, (ELASTIC_BATCH,)).astype("int32"))
            for _ in range(n)]


def elastic_build(cfg, machine):
    """tests/test_elastic.py's ``_build`` on a port config."""
    from flexflow_tpu_torch.model import FFModel

    ff = FFModel(cfg, machine)
    img = ff.create_input((cfg.batch_size, 16, 16, 3), name="image")
    t = ff.conv2d("conv1", img, 8, 3, 3, 1, 1, 1, 1, relu=True)
    t = ff.flat("flat", t)
    t = ff.linear("fc", t, 8, relu=False)
    ff.softmax("softmax", t)
    return ff


def elastic_records(path):
    """The elastic records of a run, each cut to the fields both packages
    set alike (``fault`` records of the elastic kinds only)."""
    from flexflow_tpu_torch import obs

    return [{k: r[k] for k in ELASTIC_FIELDS if k in r}
            for r in obs.read_run(path)
            if r["kind"] in ELASTIC_KINDS or (
                r["kind"] == "fault"
                and r.get("fault") in ("device_loss", "device_return"))]


def elastic_fit(machine, cfg_kwargs, trees_path, refuse_gather=False,
                dead_probe=()):
    """``FFModel.fit`` of :func:`elastic_build` from the full trees in
    ``trees_path`` (JAX's initial ones) on a ``data.BlockStream`` of
    :func:`elastic_host_batches`, with the rebuild factory; with
    ``refuse_gather`` every rank's in-memory gather fails (the checkpoint
    fallback), and the ranks in ``dead_probe`` find their card dead when
    probed.  Returns ``(losses, resizes, devices, out_of_service,
    records)``, the records rank 0's (None elsewhere)."""
    import torch

    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.data import BlockStream
    from flexflow_tpu_torch.interop import params_from_jax
    from flexflow_tpu_torch.utils import elastic

    saved = elastic.gather_state, elastic._default_probe
    if refuse_gather:
        def refuse(*args, **kwargs):
            raise RuntimeError("in-memory migration refused (test)")

        elastic.gather_state = refuse
    if machine.rank in dead_probe:
        def dead(device):
            raise RuntimeError("dead forever (test)")

        elastic._default_probe = dead
    ff = elastic_build(FFConfig(**cfg_kwargs), machine)
    params, _ = load_trees(trees_path)
    p = ff.shard_params(params_from_jax(params, "cpu", model=ff))
    ff.init = lambda seed=None: (p, {})
    data = BlockStream(elastic_host_batches(), "cpu", machine)
    try:
        out = ff.fit(data, log=lambda *a: None, rebuild=elastic_build)
    finally:
        elastic.gather_state, elastic._default_probe = saved
    records = elastic_records(out["obs_path"]) if out["obs_path"] \
        else None
    return ([float(v) for v in out["loss"]], out["elastic_resizes"],
            out["devices"], out.get("out_of_service", False), records)


def jax_elastic(cfg_kwargs, devices, probe_dead=None, refuse_gather=False):
    """The reference: the JAX elastic tests' model fit on the first
    ``devices`` of the virtual CPU mesh with the same config (its
    ``obs_dir`` a sibling's), the JAX tests' injected probe and refusal
    when asked.  Returns ``(initial params, losses, resizes, devices,
    records)``."""
    import jax

    from flexflow_tpu import obs
    from flexflow_tpu.config import FFConfig
    from flexflow_tpu.machine import MachineModel
    from flexflow_tpu.model import FFModel
    from flexflow_tpu.utils import elastic

    def build(cfg, machine):
        ff = FFModel(cfg, machine)
        img = ff.create_input((cfg.batch_size, 16, 16, 3), name="image")
        t = ff.conv2d("conv1", img, 8, 3, 3, 1, 1, 1, 1, relu=True)
        t = ff.flat("flat", t)
        t = ff.linear("fc", t, 8, relu=False)
        ff.softmax("softmax", t)
        return ff

    def batches():
        ring = elastic_host_batches()
        i = 0
        while True:
            yield ring[i % len(ring)]
            i += 1

    saved = elastic.probe_devices, elastic.gather_state
    if probe_dead is not None:
        def probe(machine, olog=None, **kw):
            if machine.num_devices == devices:
                live = [i for i in range(devices) if i not in probe_dead]
                return live, list(probe_dead), []
            return saved[0](machine, olog=olog, **kw)

        elastic.probe_devices = probe
    if refuse_gather:
        def refuse(*args, **kwargs):
            raise RuntimeError("in-memory migration refused (test)")

        elastic.gather_state = refuse
    try:
        ff = build(FFConfig(**cfg_kwargs), MachineModel(
            jax.devices()[:devices]))
        params, _ = ff.init()
        full, _ = jax_logical(ff, params, {})
        out = ff.fit(batches(), log=lambda *a: None, rebuild=build)
    finally:
        elastic.probe_devices, elastic.gather_state = saved
    records = [{k: r[k] for k in ELASTIC_FIELDS if k in r}
               for r in obs.read_run(out["obs_path"])
               if r["kind"] in ELASTIC_KINDS or (
                   r["kind"] == "fault"
                   and r.get("fault") in ("device_loss", "device_return"))]
    return (full, [float(v) for v in out["loss"]], out["elastic_resizes"],
            out["devices"], records)


def rejoin_step(rank, world, init_method, ckpt_dir, out):
    """A FRESH process whose first act is ``distributed.elastic_rejoin``
    of a world of ``world`` (the tiny elastic CNN with ``fc`` split over
    the ranks, its factory): restore the newest checkpoint, take one step
    on the first global batch, put ``(rank, step, ranks, loss)`` on
    ``out``."""
    import torch

    from flexflow_tpu_torch import distributed
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.strategy import ParallelConfig, Strategy

    torch.set_num_threads(1)

    def factory(machine):
        cfg = FFConfig(batch_size=ELASTIC_BATCH, input_height=16,
                       input_width=16, num_classes=8, seed=3)
        cfg.strategies = Strategy()
        cfg.strategies["fc"] = ParallelConfig((1, world),
                                              tuple(range(world)))
        return elastic_build(cfg, machine)

    try:
        machine, step, params, state, opt = distributed.elastic_rejoin(
            ckpt_dir, device="cpu", backend="gloo", rank=rank,
            world_size=world, init_method=init_method,
            model=factory, log=lambda *a: None)
        ff = factory(machine)
        image, labels = elastic_host_batches()[0]
        batch = ff.local_batch(torch.from_numpy(image),
                               torch.from_numpy(labels))
        loss = ff.make_train_step()(params, state, opt, *batch)[3]
        out.put((rank, "ok", (step, machine.num_devices, float(loss))))
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))
    finally:
        distributed.shutdown()


def run_fresh(target, world: int, *args, timeout: float = 120.0):
    """``target(rank, world, init_method, *args, queue)`` in ``world``
    fresh spawned processes that make their world themselves (through
    ``init_method``, a file store); the results in rank order."""
    with _rendezvous() as init_method:
        return _run(target, world, args, init_method, timeout,
                    f"{world} processes did not finish within {timeout} s")


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


def verify_net(ff, image):
    """tests/test_verification.py's net: a convolution, a max pool, a
    linear and the softmax (16x16 images, 8 classes)."""
    t = ff.conv2d("conv1", image, 8, 3, 3, 1, 1, 1, 1, relu=True)
    t = ff.pool2d("pool1", t, 2, 2, 2, 2, 0, 0)
    t = ff.flat("flat", t)
    t = ff.linear("fc1", t, 8, relu=False)
    return ff.softmax("softmax", t)


MODELS = {"tiny": tiny, "alexnet": alexnet, "vgg_style": vgg_style,
          "resnet_style": resnet_style, "vgg16": vgg16,
          "placed_bn": placed_bn, "set_family": set_family,
          "trace_cnn": trace_cnn, "halo_net": halo_net,
          "verify_net": verify_net}

#: input channels of the models that do not take RGB images
CHANNELS = {"placed_bn": 8, "set_family": 8}


# ---------------------------------------------------------------------------
# serving over ranks (tests/test_torch_serve_scale.py)


def scale_requests():
    """``tests/test_serve.py``'s gap-then-burst load: 3 early requests at
    500 qps, then 30 virtual seconds later 12 at 2000 qps."""
    from flexflow_tpu_torch.serve.loadgen import synthetic_requests

    early = synthetic_requests(3, seed=0, rate_qps=500.0, vocab_size=64,
                               prompt_len=4, max_new_tokens=2)
    burst = synthetic_requests(12, seed=1, rate_qps=2000.0, vocab_size=64,
                               prompt_len=4, max_new_tokens=2,
                               start_v=early[-1].arrival_v + 30.0)
    for i, r in enumerate(burst):
        r.rid = 100 + i
    return early + burst


def serve_scale(machine, perf, trees_path, lm_kw, eng_kw, obs_path=None):
    """The tiny GPT served over this world by an autoscaling
    ``ServeEngine`` from the full params in ``trees_path`` under
    :func:`scale_requests`, the search priced on ``perf`` (a dict of
    ``HopperChipPerf`` fields; the JAX package's constants).  Returns
    ``(summary, replies, stamps, resizes, strategies, out_of_service)``
    from this rank's session (a rank called back at a grow holds rank 0's
    from then on): the replies by rid, the strategies each re-search
    chose (JSON, rank 0's), whether this rank ended parked."""
    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.apps import serve
    from flexflow_tpu_torch.interop import params_from_jax
    from flexflow_tpu_torch.serve.engine import ServeEngine
    from flexflow_tpu_torch.sim import cost_model
    from flexflow_tpu_torch.utils import elastic

    hopper = cost_model.HopperChipPerf(**perf)
    saved = cost_model.HopperChipPerf, elastic.research_strategy
    chosen = []

    def research(*args, **kwargs):
        strategy, info = saved[1](*args, **kwargs)
        chosen.append(strategy.to_json())
        return strategy, info

    cost_model.HopperChipPerf = lambda: hopper
    elastic.research_strategy = research
    try:
        model, rebuild = serve.build_lm(batch=8, seed=0, tiny=True,
                                        machine=machine, **lm_kw)
        params, _ = load_trees(trees_path)
        p = model.shard_params(params_from_jax(params, "cpu", model=model))
        olog = obs.RunLog(obs_path, surface="serve") \
            if obs_path and machine.rank == 0 else obs.NULL
        eng = ServeEngine(model, rebuild, params=p, olog=olog,
                          log=lambda *a: None, **eng_kw)
        eng.start(scale_requests())
        while eng.step_once():
            pass
        done = sorted(eng.session_completed(), key=lambda r: r.rid)
        summary = eng.finish()
        olog.close()
        if eng._parked and machine.rank == 0:
            elastic.release_standbys(eng._parked, {})
    finally:
        cost_model.HopperChipPerf, elastic.research_strategy = saved
    summary.pop("wall_s")
    stamps = [(r.rid, r.arrival_v, r.admit_v, r.first_token_v, r.done_v)
              for r in done]
    resizes = [{k: v for k, v in r.items()
                if k not in ("research_s", "research", "total_s")}
               for r in eng.resizes]
    return (summary, {r.rid: list(r.reply) for r in done}, stamps, resizes,
            chosen, eng.out_of_service)


def serve_app(machine, argv):
    """``apps.serve.main(argv)`` as one rank of a torchrun world (the
    environment torchrun would set, the process group already made)."""
    import os

    from flexflow_tpu_torch.apps import serve

    os.environ.update(RANK=str(machine.rank),
                      WORLD_SIZE=str(machine.num_devices),
                      LOCAL_RANK=str(machine.rank))
    return serve.main(argv, log=lambda *a: None)


def serve_smoke(machine, obs_dir):
    """``apps.serve --smoke`` over this world (the tiny GPT, its
    equivalence on rank 0, its autoscaling lifecycle): ``(summary
    without wall_s, resizes without timing, record counts by kind)`` of
    this rank's session."""
    import collections

    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.apps import serve

    opts = serve.parse_args(["--smoke", "--device", "cpu", "-obs-dir",
                             obs_dir])
    summary = serve.smoke(opts, log=lambda *a: None, machine=machine)
    olog = summary.pop("_olog")
    resizes = summary.pop("_resizes")
    summary.pop("_rank")
    summary.pop("wall_s")
    kinds = collections.Counter(r["kind"] for r in obs.read_run(olog.path)) \
        if olog.enabled else {}
    return (summary, [{k: v for k, v in r.items()
                       if k not in ("research_s", "research", "total_s")}
                      for r in resizes], dict(kinds))


# ---------------------------------------------------------------------------
# the forward-only service over ranks (tests/test_torch_serve_forward_ranks.py)


def forward_model(machine, kind, cfg_kwargs, strategy_json=None):
    """The small CNN (:func:`verify_net`, ``kind`` "cnn") or the tiny NMT
    ("nmt", its default strategy unless one is given) on ``machine``."""
    if kind == "nmt":
        return nmt_model(machine, cfg_kwargs, strategy_json)
    return build(machine, "verify_net", cfg_kwargs, strategy_json)


def forward_serve(machine, kind, cfg_kwargs, strategy_json, trees_path,
                  n, seed, step, drain_at=None, drain_rank=None,
                  obs_path=None):
    """``ServeEngine.run_forward`` of ``n`` seeded requests on this world
    from the full trees in ``trees_path`` (each rank its blocks); with
    ``drain_at``, rank ``drain_rank`` alone requests a drain from that
    check on (``run_forward`` checks once before the run and once before
    each batch).  Returns ``(summary without wall_s, replies (n, ...) in rid
    order with None rows unserved, [(rid, admit_v, done_v)], records)``,
    the records rank 0's (read back from ``obs_path``)."""
    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.apps import serve
    from flexflow_tpu_torch.interop import (params_from_jax, shard_params,
                                            shard_state, state_from_jax)
    from flexflow_tpu_torch.serve.engine import ServeEngine
    from flexflow_tpu_torch.serve.loadgen import synthetic_requests

    model = forward_model(machine, kind, cfg_kwargs, strategy_json)
    params, state = load_trees(trees_path)
    p = params_from_jax(params, "cpu", model=model)
    s = state_from_jax(state, "cpu")
    if model.sharded:
        p, s = shard_params(p, model), shard_state(s, model)
    olog = obs.RunLog(obs_path, surface="serve") \
        if obs_path and machine.rank == 0 else obs.NULL
    eng = ServeEngine(model, params=p, olog=olog, log=lambda *a: None,
                      step_time_s=step)
    eng.state = s
    reqs = synthetic_requests(n, seed=seed, rate_qps=200.0, vocab_size=64,
                              prompt_len=4, max_new_tokens=0)
    serve._forward_payloads(model, reqs, seed)
    drain = None
    if drain_at is not None:
        drain = serve._DrainAfter(drain_at - 1) \
            if machine.rank == drain_rank else {}
    summary = eng.run_forward(reqs, drain=drain)
    olog.close()
    summary.pop("wall_s")
    reqs = sorted(reqs, key=lambda r: r.rid)
    records = [{k: v for k, v in r.items() if k not in ("ts", "run",
                                                        "wall_s")}
               for r in obs.read_run(obs_path)
               if r["kind"] not in ("run_start", "run_end")] \
        if olog.enabled else None
    return (summary, [None if r.reply is None else np.asarray(r.reply)
                      for r in reqs],
            [(r.rid, r.admit_v, r.done_v) for r in reqs], records)


def assembled(machine, kind, cfg_kwargs, strategy_json, seed=3):
    """``FFModel.gather_output`` and ``gather_rows`` of a seeded whole
    value of the model's loss output, each rank handing in the block its
    layout gives it: ``(whole, gathered, rows, gathered rows)``."""
    import torch

    from flexflow_tpu_torch.apps.serve import build_lm

    if kind == "lm":
        model, _ = build_lm(batch=4, tiny=True, machine=machine,
                            device="cpu")
    else:
        model = forward_model(machine, kind, cfg_kwargs, strategy_json)
    model._setup_sharded()
    op = model._loss_op()
    tid = op.output.tid
    whole = torch.from_numpy(np.random.RandomState(seed).randn(
        *op.output.shape).astype(np.float32))
    boxes = model._boxes_of(op, op.output_spec(), op.output.shape)
    box = boxes[machine.position]
    block = None if box is None else \
        whole[tuple(slice(lo, hi) for lo, hi in box)].clone()
    got = model.gather_output({tid: block}, tid)
    rng = np.random.RandomState(seed + 1)
    rows = [tuple(int(rng.randint(d)) for d in op.output.shape[:-1])
            for _ in range(5)]
    (got_rows,) = model.gather_rows({tid: block}, [(tid, rows)])
    want_rows = torch.stack([whole[r] for r in rows])
    return (whole.numpy(), got.numpy(), want_rows.numpy(),
            got_rows.numpy())


def serve_exit(machine, argv):
    """``apps.serve.main(argv)`` as one rank of a torchrun world: its exit
    code (0 when it returns)."""
    try:
        return serve_app(machine, argv)
    except SystemExit as e:
        return e.code


# ---------------------------------------------------------------------------
# routed replicas over ranks (tests/test_torch_disagg_ranks.py)


def slice_collectives(machine):
    """Two running slices of a 4-rank world, ranks [0, 1] and [2, 3], each
    with a small CNN under a strategy whose linear splits over c (a
    regrid before it), every group made on every rank in slice order;
    then each slice's ranks run their own work, slice [0, 1] three
    all-reduces and a forward, slice [2, 3] one of each, neither waiting
    for the other.  Returns ``(slice ranks, all-reduce sums, the forward's
    assembled output)`` of this rank's slice."""
    import torch

    from flexflow_tpu_torch.parallel import collectives

    cfg = dict(batch_size=4, input_height=16, input_width=16,
               num_classes=8)
    strat = strategy_json({"fc1": [2, 1]}, 2)
    slices, models = [], []
    for ranks in ((0, 1), (2, 3)):
        m = machine.running_slice(ranks)
        model = forward_model(m, "cnn", cfg, strat)
        model._setup_sharded()
        slices.append((ranks, m))
        models.append(model)
    mine = 0 if machine.rank < 2 else 1
    ranks, m = slices[mine]
    model = models[mine]
    assert not m.bystander and slices[1 - mine][1].bystander
    sums = []
    for i in range(3 if mine == 0 else 1):
        t = torch.tensor([float(machine.rank + 10 * i)])
        sums.append(float(collectives.all_reduce_(t, m.world_group())[0]))
    params, state = model.init(0)
    x = np.random.RandomState(5).uniform(-1, 1, (4, 16, 16, 3)).astype(
        np.float32)
    tid = model._loss_op().output.tid
    out = model.make_predict_step()(params, state, *model.local_batch(x))
    whole = model.gather_output({tid: out[0]}, tid)
    return ranks, sums, whole.numpy()


def routed_case(machine, trees_path, prefill, decode, decode_step,
                perf, spec=None, obs_path=None, drain_at=None,
                drain_rank=None, hedge=False):
    """The tiny GPT's routed pools on this world through
    ``apps.serve._replica_pools``: ``prefill`` / ``decode`` name the
    prefill ranks and the replicas of each pool (``(ranks, replicas)``),
    each replica from the full params in ``trees_path``, the decode step
    ``decode_step`` (JAX's), the session load under fault spec ``spec``;
    with ``drain_at``, rank ``drain_rank`` alone requests a drain at that
    router iteration; ``hedge`` races hedged decodes.  Returns ``(replies, stamps, summary without
    wall_s, records (rank 0's, from ``obs_path``), fired faults, the
    decode replica's decode_step_ratio on ``perf``, ``[(rid, decode
    replica, digest of the moved rows)]`` on the ranks of each move)``."""
    import hashlib

    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.apps import serve
    from flexflow_tpu_torch.interop import params_from_jax
    from flexflow_tpu_torch.serve.router import ServeRouter
    from flexflow_tpu_torch.sim.cost_model import HopperChipPerf
    from flexflow_tpu_torch.sim.search import decode_step_ratio
    from flexflow_tpu_torch.utils import faultinject

    opts = serve.parse_args([
        "gpt", "--tiny", "--device", "cpu", "-b", "2",
        "--serve-prefill-devices", str(prefill[0]),
        "--serve-prefill-replicas", str(prefill[1]),
        "--serve-decode-replicas", str(decode)])
    olog = obs.RunLog(obs_path, surface="serve") \
        if obs_path and machine.rank == 0 else obs.NULL
    pre, dec, seats, _ = serve._replica_pools(opts, None, olog, None,
                                              lambda *a: None, machine)
    params, _ = load_trees(trees_path)
    for eng in pre + dec:
        if eng.runs:
            p = params_from_jax(params, "cpu", model=eng.model)
            eng.params = eng.model.shard_params(p) if eng.model.sharded \
                else p
        eng._compile()
    for eng in dec:
        eng.step_time_s = decode_step
    ratio = decode_step_ratio(dec[0].model, perf=HopperChipPerf(**perf))
    # each KV move's rows as the ranks that send and receive them hold
    # them afterwards
    moved, move = [], seats.move

    def record(req, layout, dst):
        move(req, layout, dst)
        p = req.kv_payload
        if p is not None and machine.rank in \
                seats._pairs[(p["holder"], dst)][0]:
            moved.append((req.rid, dst, hashlib.sha1(
                np.ascontiguousarray(p["k"]).tobytes()
                + np.ascontiguousarray(p["v"]).tobytes()).hexdigest()))

    seats.move = record
    router = ServeRouter(pre, dec, log=lambda *a: None, olog=olog,
                         world=seats, hedge=hedge)
    inj, restore = None, (lambda: None)
    if spec is not None:
        inj = faultinject.FaultInjector(spec, olog=olog)
        restore = faultinject.install_scoped(inj)
    drain = None
    if drain_at is not None:
        drain = serve._DrainAfter(drain_at) if machine.rank == drain_rank \
            else {}
    try:
        reqs = serve._session_load()
        summary = router.run(reqs, drain=drain)
    finally:
        restore()
    olog.close()
    summary.pop("wall_s")
    records = [{k: v for k, v in r.items()
                if k not in ("ts", "run", "wall_s", "t_wall", "pid")}
               for r in obs.read_run(obs_path)
               if r["kind"] not in ("run_start", "run_end")] \
        if olog.enabled else None
    return ({r.rid: (list(r.reply) if r.reply is not None else None)
             for r in reqs},
            {r.rid: (r.arrival_v, r.admit_v, r.first_token_v, r.done_v)
             for r in reqs}, summary, records,
            inj.fired() if inj is not None else None, ratio, moved)
