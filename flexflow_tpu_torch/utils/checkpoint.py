"""Checkpoint / resume (the port's own copy of
``flexflow_tpu/utils/checkpoint.py``, in the same on-disk format, so that
a checkpoint written by either package resumes in the other).

  * A checkpoint is ``(step, params, state, opt_state)`` plus the model's
    Strategy: ``<dir>/step_<N>/arrays.npz`` holds every leaf under its
    ``params/``, ``state/`` or ``opt/``-prefixed ``a/b/c`` path, and
    ``meta.json`` the step, each leaf's dtype and a SHA-256 digest of
    every file.
  * The commit is atomic: written to ``<dir>/tmp.<N>``, fsync'd, renamed
    to ``step_<N>``; leftovers of a crash mid-save are swept on the next
    save or restore.
  * A finiteness gate: :func:`save_checkpoint` refuses to commit NaN or
    Inf float leaves (:class:`NonFiniteCheckpointError`), and pruning
    never deletes the newest step that still verifies.
  * :func:`verify_checkpoint` re-checks the digests, and
    :func:`restore_checkpoint` without an explicit step falls back from
    the newest step to older ones past truncated, missing or corrupt
    steps.

bfloat16 leaves are stored as their raw bits, a ``uint16`` array with
``"bfloat16"`` in ``meta.json``; the JAX package views those bytes back
as ``ml_dtypes.bfloat16`` (``_restore_dtype``), and it writes bfloat16 as
2-byte void records, which this module views as ``torch.bfloat16``.
Neither direction needs ``ml_dtypes`` here.

Over several ranks ``FFModel`` gathers the leaves whole to rank 0,
which writes them here, and shards what it restores (``gather_trees``,
``_restore``), where the JAX module places each restored leaf on its
op's sharding.  The JAX module's asynchronous writer is not ported
(ROADMAP Queue A item 5).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.interop import check_param_shapes
from flexflow_tpu_torch.machine import resolve_device
from flexflow_tpu_torch.utils import faultinject

_SEP = "/"
#: committed steps a save keeps (besides the newest verified one)
KEEP = 3


class CheckpointError(RuntimeError):
    """Base of the checkpoint module's own failures."""


class CheckpointCorruptError(CheckpointError):
    """A requested checkpoint failed verification (or every candidate
    did, when falling back)."""


class NonFiniteCheckpointError(CheckpointError):
    """:func:`save_checkpoint` refused to commit non-finite float
    state."""


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for k, v in tree.items():
        if _SEP in k:
            raise ValueError(f"checkpoint key {k!r} may not contain {_SEP!r}")
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, path + _SEP))
        else:
            flat[path] = v
    return flat


def _unflatten(flat: Dict[str, Any]) -> Dict:
    tree: Dict = {}
    for path, v in flat.items():
        keys = path.split(_SEP)
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return tree


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _list_steps(ckpt_dir: str) -> list:
    """Sorted committed steps in ``ckpt_dir``."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".old"):
            try:
                steps.append(int(name[5:]))
            except ValueError:
                continue
    return sorted(steps)


def _sweep_stale(ckpt_dir: str) -> None:
    """Remove what a crash mid-save leaves: ``tmp.<step>`` staging
    directories and ``step_*.old`` aside copies."""
    if not os.path.isdir(ckpt_dir):
        return
    for name in os.listdir(ckpt_dir):
        if name.startswith("tmp.") or (name.startswith("step_")
                                       and name.endswith(".old")):
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The highest committed step in ``ckpt_dir``, or None."""
    steps = _list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _host_leaf(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu()
    return torch.as_tensor(np.asarray(leaf))


def _stored(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host tensor as the array ``arrays.npz`` holds and its dtype's
    name; bfloat16 as its raw bits."""
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16), \
            "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _loaded(arr: np.ndarray, stored: Optional[str]) -> torch.Tensor:
    """A loaded array as a host tensor of its recorded dtype: bfloat16
    from 2-byte void records (the JAX package) or ``uint16`` bits (this
    module)."""
    if stored == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    if arr.dtype.kind == "V":
        raise CheckpointError(f"cannot load a leaf stored as {stored!r}")
    return torch.from_numpy(np.array(arr))


def verify_checkpoint(ckpt_dir: str, step: int) -> Tuple[bool, str]:
    """Integrity check of one committed step: the directory and a
    parseable ``meta.json`` naming this step, every payload file present
    with its recorded SHA-256.  Returns ``(ok, reason)``; a checkpoint
    without digests passes as ``"unverified (no digests)"``."""
    d = _step_dir(ckpt_dir, step)
    if not os.path.isdir(d):
        return False, "missing directory"
    try:
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return False, f"meta.json unreadable: {e}"
    if int(meta.get("step", -1)) != int(step):
        return False, (f"meta.json names step {meta.get('step')!r}, "
                       f"directory says {step}")
    if not os.path.exists(os.path.join(d, "arrays.npz")):
        return False, "arrays.npz missing"
    digests = meta.get("digests")
    if not digests:
        return True, "unverified (no digests; pre-digest format)"
    for name, want in digests.items():
        p = os.path.join(d, name)
        if not os.path.exists(p):
            return False, f"{name} missing"
        got = _file_sha256(p)
        if got != want:
            return False, f"{name} digest mismatch ({got[:12]} != {want[:12]})"
    return True, "ok"


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_checkpoint(ckpt_dir: str, step: int, params: Dict, state: Dict,
                    opt_state: Optional[Dict], strategy=None) -> str:
    """Write a checkpoint atomically, then prune to the newest ``KEEP``
    steps (never deleting the newest step that still verifies).  A
    non-finite float leaf aborts the save before anything touches the
    disk.  Returns the committed directory."""
    host: Dict[str, torch.Tensor] = {}
    for tree_name, tree in (("params", params), ("state", state or {}),
                            ("opt", opt_state or {})):
        for path, leaf in _flatten(tree, tree_name + _SEP).items():
            host[path] = _host_leaf(leaf)
    bad = [p for p, t in host.items()
           if t.is_floating_point() and not bool(torch.isfinite(t).all())]
    if bad:
        raise NonFiniteCheckpointError(
            f"refusing to checkpoint non-finite state at step {step}: "
            f"{len(bad)} leaves, e.g. {bad[:3]}")
    arrays, dtypes = {}, {}
    for path, t in host.items():
        arrays[path], dtypes[path] = _stored(t)

    os.makedirs(ckpt_dir, exist_ok=True)
    _sweep_stale(ckpt_dir)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = _step_dir(ckpt_dir, step)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    if strategy is not None and len(strategy):
        strategy.save(os.path.join(tmp, "strategy.json"))
    digests = {name: _file_sha256(os.path.join(tmp, name))
               for name in sorted(os.listdir(tmp))}
    meta = {"step": int(step), "format": 2, "dtypes": dtypes,
            "digests": digests}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    # durable commit: the files, the staging directory, the rename, and
    # the parent; the old committed directory is moved aside, never
    # deleted before the new one is in place
    for name in os.listdir(tmp):
        _fsync(os.path.join(tmp, name))
    _fsync(tmp)
    aside = None
    if os.path.exists(final):
        aside = final + ".old"
        if os.path.exists(aside):
            shutil.rmtree(aside)
        os.rename(final, aside)
    os.rename(tmp, final)
    _fsync(ckpt_dir)
    if aside:
        shutil.rmtree(aside, ignore_errors=True)

    # deterministic fault injection: damage the committed copy, a torn
    # write or a flipped bit that the digests must catch
    inj = faultinject.get()
    if inj.enabled:
        ap = os.path.join(final, "arrays.npz")
        if inj.fire("ckpt_truncate", site=final):
            with open(ap, "r+b") as f:
                f.truncate(max(os.path.getsize(ap) // 2, 1))
        if inj.fire("ckpt_corrupt", site=final):
            with open(ap, "r+b") as f:
                f.seek(os.path.getsize(ap) // 2)
                b = f.read(1)
                f.seek(-1, os.SEEK_CUR)
                f.write(bytes([b[0] ^ 0xFF]))

    steps = _list_steps(ckpt_dir)
    protect = set(steps[-KEEP:])
    for s in reversed(steps):
        if verify_checkpoint(ckpt_dir, s)[0]:
            protect.add(s)   # the newest verified step survives
            break
    for s in steps:
        if s not in protect:
            shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)
    return final


def _load_step(ckpt_dir: str, step: int, model=None, device="cuda"
               ) -> Tuple[int, Dict, Dict, Dict]:
    """Load one committed step (no verification, no fallback) onto
    ``model.device`` (else ``device``); with ``model``, every param leaf
    must have the shape the model's ``init`` gives it."""
    d = _step_dir(ckpt_dir, step)
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    stored = meta.get("dtypes", {})
    dev = model.device if model is not None else resolve_device(device)
    trees = {"params": {}, "state": {}, "opt": {}}
    with np.load(os.path.join(d, "arrays.npz")) as z:
        for path in z.files:
            tree_name, rest = path.split(_SEP, 1)
            trees[tree_name][rest] = _loaded(z[path],
                                             stored.get(path)).to(dev)
    params = _unflatten(trees["params"])
    if model is not None:
        check_param_shapes(params, model.param_shapes())
    return step, params, _unflatten(trees["state"]), \
        _unflatten(trees["opt"])


def restore_checkpoint(ckpt_dir: str, model=None,
                       step: Optional[int] = None,
                       device="cuda") -> Tuple[int, Dict, Dict, Dict]:
    """``(step, params, state, opt_state)`` as tensors on ``model.device``
    (else ``device``).

    Without ``step`` the restore falls back: the newest step is verified
    and loaded; on any failure the next older one is tried, with a
    ``RuntimeWarning`` naming what was skipped, and only when every
    committed step fails does this raise
    :class:`CheckpointCorruptError`.  An explicit ``step`` is verified but
    never falls back."""
    _sweep_stale(ckpt_dir)
    if step is not None:
        ok, why = verify_checkpoint(ckpt_dir, step)
        if not ok:
            raise CheckpointCorruptError(
                f"checkpoint step {step} under {ckpt_dir!r} failed "
                f"verification: {why}")
        return _load_step(ckpt_dir, step, model, device)
    steps = _list_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir!r}")
    newest = steps[-1]
    failures = []
    for s in reversed(steps):
        ok, why = verify_checkpoint(ckpt_dir, s)
        if not ok:
            failures.append((s, why))
            continue
        try:
            out = _load_step(ckpt_dir, s, model, device)
        except Exception as e:  # torn npz, bad json, wrong model
            failures.append((s, f"load failed: {e}"))
            continue
        if s != newest:
            warnings.warn(
                f"checkpoint fallback: step {newest} -> {s} under "
                f"{ckpt_dir!r} ("
                + "; ".join(f"step {fs}: {fw}" for fs, fw in failures)
                + ")", RuntimeWarning)
        return out
    raise CheckpointCorruptError(
        f"every checkpoint under {ckpt_dir!r} failed verification/load: "
        + "; ".join(f"step {fs}: {fw}" for fs, fw in failures))


def load_strategy(ckpt_dir: str, step: Optional[int] = None):
    """The Strategy a checkpoint was trained under, or None."""
    from flexflow_tpu_torch.strategy import Strategy

    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            return None
    path = os.path.join(_step_dir(ckpt_dir, step), "strategy.json")
    return Strategy.load(path) if os.path.exists(path) else None
