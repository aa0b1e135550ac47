"""Run telemetry: one JSONL event stream per run (the port's own copy of
the ``RunLog`` / ``NULL`` sinks and readers of ``flexflow_tpu/obs/``, so
that both packages write records the JAX package's ``report`` reads).

Every record is one JSON object per line, stamped with the run id and a
host wall-clock timestamp: ``{"run": <id>, "ts": <epoch s>, "kind": <str>,
...}``.  :class:`RunLog` is the thread-safe sink; ``NULL`` is the disabled
sink whose every method is a no-op, so instrumented code pays one
attribute check when telemetry is off.  When the current file reaches
``max_bytes`` the stream rolls over to ``run.jsonl.1``, ``.2``, ...
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Iterator, Optional

SCHEMA_VERSION = 1

# default size cap of one event file before rollover (64 MB); 0 disables
DEFAULT_MAX_BYTES = 64 * 1024 * 1024


def new_run_id() -> str:
    """Sortable, collision-resistant run id: wall time + pid + 2 random
    bytes."""
    return "%s-%x-%s" % (time.strftime("%Y%m%d-%H%M%S"), os.getpid(),
                         os.urandom(2).hex())


class NullRunLog:
    """The disabled sink: every method is a no-op and ``enabled`` is
    False."""

    enabled = False
    path = None
    run_id = None

    def event(self, kind: str, **fields) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self) -> bool:
        return False


NULL = NullRunLog()


class RunLog:
    """Thread-safe JSONL event sink; writes are line-buffered and
    serialized under a lock."""

    enabled = True

    def __init__(self, path: str, run_id: Optional[str] = None,
                 surface: str = "", meta: Optional[Dict[str, Any]] = None,
                 max_bytes: int = DEFAULT_MAX_BYTES):
        self.path = path
        self.run_id = run_id or new_run_id()
        self.surface = surface
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._lock = threading.Lock()
        self._max_bytes = max(int(max_bytes or 0), 0)
        self._seq = 0
        while os.path.exists(f"{path}.{self._seq + 1}"):
            self._seq += 1
        self._f = open(self._part_path(), "a")
        self.event("run_start", schema=SCHEMA_VERSION,
                   **(dict(meta) if meta else {}))

    def _part_path(self) -> str:
        return self.path if self._seq == 0 else f"{self.path}.{self._seq}"

    def event(self, kind: str, **fields) -> None:
        rec = {"run": self.run_id, "ts": time.time(), "kind": kind}
        if self.surface:
            rec["surface"] = self.surface
        rec.update(fields)
        line = json.dumps(rec, default=_jsonable)
        with self._lock:
            if self._f.closed:
                return
            self._f.write(line + "\n")
            self._f.flush()
            if self._max_bytes and self._f.tell() >= self._max_bytes:
                self._f.close()
                self._seq += 1
                self._f = open(self._part_path(), "a")

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _jsonable(o):
    """Last-resort encoder: numpy/torch scalars -> python numbers, sets ->
    sorted lists, everything else -> repr (a telemetry write must never
    raise into the instrumented surface)."""
    try:
        return o.item()
    except (AttributeError, ValueError, RuntimeError):
        pass
    if isinstance(o, (set, frozenset)):
        return sorted(o)
    return repr(o)


def run_files(path: str) -> list:
    """A run stream's files in write order: ``path`` plus its rotated
    parts ``path.1``, ``path.2``, ..."""
    out = [path] if os.path.exists(path) else []
    i = 1
    while os.path.exists(f"{path}.{i}"):
        out.append(f"{path}.{i}")
        i += 1
    return out


def read_run(path: str) -> Iterator[Dict[str, Any]]:
    """All records of a possibly-rotated run stream, in write order."""
    for p in run_files(path):
        yield from read_events(p)


def read_events(path: str) -> Iterator[Dict[str, Any]]:
    """The records of one JSONL file in order; a torn tail line is
    skipped, not raised."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict):
                yield rec


def from_config(config, surface: str = "",
                meta: Optional[Dict[str, Any]] = None):
    """A live :class:`RunLog` when ``config.obs_dir`` is set (file
    ``<obs_dir>/<run_id>.jsonl``, ``config.run_id`` or a fresh id), else
    the shared ``NULL`` sink (``flexflow_tpu/obs/__init__.py:217``)."""
    obs_dir = getattr(config, "obs_dir", "") or ""
    if not obs_dir:
        return NULL
    run_id = getattr(config, "run_id", "") or new_run_id()
    return RunLog(os.path.join(obs_dir, f"{run_id}.jsonl"),
                  run_id=run_id, surface=surface, meta=meta,
                  max_bytes=getattr(config, "obs_max_bytes",
                                    DEFAULT_MAX_BYTES))
