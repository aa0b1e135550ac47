"""ctypes binding of the native simulator (PyTorch port of
``flexflow_tpu/sim/native.py``).

The library is built from this package's own copy of the C++ source,
``flexflow_tpu_torch/native/simulator.cc``, at first use, with
``g++ -O2 -std=c++17 -fPIC -pthread -shared`` into
``flexflow_tpu_torch/build/``.  Its file name carries a digest of the
source and the flags; each build writes a per-process temporary and
renames it into place, so several processes may build at once."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Sequence

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "native" / "simulator.cc"
BUILD_DIR = PACKAGE_DIR / "build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread", "-shared")

_lib = None


def library_path() -> Path:
    """Where the library lives: the name carries a digest of the source
    and of the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libffsim_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Build the library unless it exists; returns its path."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.ffsim_create.restype = ctypes.c_void_p
    lib.ffsim_create.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
    lib.ffsim_destroy.argtypes = [ctypes.c_void_p]
    lib.ffsim_simulate.restype = ctypes.c_double
    lib.ffsim_simulate.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_int32)]
    lib.ffsim_simulate_trace.restype = ctypes.c_int64
    lib.ffsim_simulate_trace.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_int32),
                                         ctypes.POINTER(ctypes.c_double),
                                         ctypes.c_int64,
                                         ctypes.POINTER(ctypes.c_double)]
    lib.ffsim_mcmc.restype = ctypes.c_double
    lib.ffsim_mcmc.argtypes = [ctypes.c_void_p,
                               ctypes.POINTER(ctypes.c_int32),
                               ctypes.c_int64, ctypes.c_double,
                               ctypes.c_uint64]
    lib.ffsim_mcmc_run.restype = ctypes.c_double
    lib.ffsim_mcmc_run.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_int32),
                                   ctypes.POINTER(ctypes.c_int32),
                                   ctypes.POINTER(ctypes.c_double),
                                   ctypes.c_int64, ctypes.c_double,
                                   ctypes.c_uint64,
                                   ctypes.POINTER(ctypes.c_int64)]
    lib.ffsim_set_delta.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.ffsim_set_crosscheck.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.ffsim_state_create.restype = ctypes.c_void_p
    lib.ffsim_state_create.argtypes = [ctypes.c_void_p]
    lib.ffsim_state_destroy.argtypes = [ctypes.c_void_p]
    lib.ffsim_state_init.restype = ctypes.c_double
    lib.ffsim_state_init.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int32)]
    lib.ffsim_state_propose.restype = ctypes.c_double
    lib.ffsim_state_propose.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int32, ctypes.c_int32]
    lib.ffsim_state_commit.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ffsim_mcmc_chains.restype = ctypes.c_double
    lib.ffsim_mcmc_chains.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int32),
                                      ctypes.c_int64, ctypes.c_double,
                                      ctypes.c_uint64, ctypes.c_int32,
                                      ctypes.c_int64,
                                      ctypes.POINTER(ctypes.c_int64)]
    lib.ffsim_mcmc_chains_run.restype = ctypes.c_double
    lib.ffsim_mcmc_chains_run.argtypes = [ctypes.c_void_p,
                                          ctypes.POINTER(ctypes.c_int32),
                                          ctypes.POINTER(ctypes.c_int32),
                                          ctypes.POINTER(ctypes.c_double),
                                          ctypes.c_int64, ctypes.c_double,
                                          ctypes.c_uint64, ctypes.c_int32,
                                          ctypes.POINTER(ctypes.c_int64)]
    _lib = lib
    return lib


def _i32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _i64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


class DeltaState:
    """Caller-driven delta re-simulation: a cached schedule for one
    assignment plus propose/commit of single-op config changes, each
    proposal costing ~O(affected ops) instead of a full re-simulation.
    Results are bit-identical to ``NativeSimulator.simulate`` (the native
    cross-check mode enforces this)."""

    def __init__(self, sim: "NativeSimulator"):
        self._sim = sim
        self._handle = _load().ffsim_state_create(sim._handle)

    def init(self, assignment: Sequence[int]) -> float:
        """Full simulation that (re)anchors the cached schedule; returns
        the assignment's simulated raw time."""
        a = np.ascontiguousarray(assignment, dtype=np.int32)
        assert len(a) == self._sim.n_ops
        return _load().ffsim_state_init(self._sim._handle, self._handle,
                                        _i32(a))

    def propose(self, op: int, cfg: int) -> float:
        """Simulated raw time of changing ``op`` to config ``cfg`` (delta
        re-propagation; the cached schedule is untouched until commit)."""
        return _load().ffsim_state_propose(self._sim._handle, self._handle,
                                           op, cfg)

    def commit(self) -> None:
        """Adopt the last propose() into the cached schedule."""
        _load().ffsim_state_commit(self._sim._handle, self._handle)

    def __del__(self):
        if getattr(self, "_handle", None):
            try:
                _load().ffsim_state_destroy(self._handle)
            except Exception:
                pass
            self._handle = None


class NativeSimulator:
    """Owns one ffsim instance built from serialized buffers."""

    def __init__(self, ints: Sequence[int], dbls: Sequence[float],
                 n_ops: int):
        lib = _load()
        self._ints = np.ascontiguousarray(ints, dtype=np.int64)
        self._dbls = np.ascontiguousarray(dbls, dtype=np.float64)
        self.n_ops = n_ops
        self._handle = lib.ffsim_create(
            self._ints.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(self._ints),
            self._dbls.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            len(self._dbls))
        if not self._handle:
            raise RuntimeError("ffsim_create failed")

    def simulate(self, assignment: Sequence[int]) -> float:
        lib = _load()
        a = np.ascontiguousarray(assignment, dtype=np.int32)
        assert len(a) == self.n_ops
        return lib.ffsim_simulate(
            self._handle, a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))

    # one exported timeline record is TRACE_STRIDE doubles (simulator.cc
    # Simulator::TRACE_STRIDE); kinds match the TRACE_* enum there
    TRACE_STRIDE = 8
    TRACE_KINDS = ("compute", "transfer", "sync")

    def simulate_trace(self, assignment: Sequence[int]):
        """Full simulation of ``assignment`` exporting the schedule as
        interval records (the Perfetto trace source).  Returns
        ``(records, total_s)`` where ``total_s`` equals
        :meth:`simulate` on the same assignment and each record is
        ``{"kind": "compute"|"transfer"|"sync", "op": int, "cfg": int,
        "start": s, "dur": s, ...}`` — compute records carry
        ``point``/``device``, transfer records ``src_device``/
        ``dst_device``/``bytes``."""
        lib = _load()
        a = np.ascontiguousarray(assignment, dtype=np.int32)
        assert len(a) == self.n_ops
        total = np.zeros(1, dtype=np.float64)
        null = ctypes.POINTER(ctypes.c_double)()
        n = lib.ffsim_simulate_trace(self._handle, _i32(a), null, 0,
                                     _f64(total))
        buf = np.zeros((max(int(n), 1), self.TRACE_STRIDE),
                       dtype=np.float64)
        lib.ffsim_simulate_trace(self._handle, _i32(a), _f64(buf), n,
                                 _f64(total))
        records = []
        for row in buf[:n]:
            kind = self.TRACE_KINDS[int(row[0])]
            rec = {"kind": kind, "op": int(row[1]), "cfg": int(row[7]),
                   "start": float(row[4]), "dur": float(row[5])}
            if kind == "compute":
                rec["point"] = int(row[2])
                rec["device"] = int(row[3])
            elif kind == "transfer":
                rec["src_device"] = int(row[2])
                rec["dst_device"] = int(row[3])
                rec["bytes"] = float(row[6])
            records.append(rec)
        return records, float(total[0])

    def mcmc(self, assignment: Sequence[int], iters: int = 250_000,
             beta: float = 5e3, seed: int = 0):
        """Returns (best_assignment, best_time). beta is per-second cost
        delta (the reference uses exp(-5 * delta_ms), i.e. 5e3 / s)."""
        lib = _load()
        a = np.ascontiguousarray(assignment, dtype=np.int32).copy()
        assert len(a) == self.n_ops
        t = lib.ffsim_mcmc(
            self._handle, a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            iters, beta, seed)
        return a.tolist(), t

    def mcmc_chunk(self, cur, best, cur_t, best_t, iters: int,
                   beta: float = 5e3, seed: int = 0):
        """Advance a caller-owned MCMC chain by ``iters`` proposals (the
        chunk-resumable path behind the obs trajectory records).  Pass
        ``cur_t < 0`` on the first chunk to have the native side compute
        it.  Returns (cur, best, cur_t, best_t, accepted, proposed,
        delta_evals, full_evals)."""
        lib = _load()
        c = np.ascontiguousarray(cur, dtype=np.int32).copy()
        b = np.ascontiguousarray(best, dtype=np.int32).copy()
        assert len(c) == self.n_ops and len(b) == self.n_ops
        times = np.array([cur_t, best_t], dtype=np.float64)
        stats = np.zeros(4, dtype=np.int64)
        lib.ffsim_mcmc_run(self._handle, _i32(c), _i32(b), _f64(times),
                           iters, beta, seed, _i64(stats))
        return (c.tolist(), b.tolist(), float(times[0]), float(times[1]),
                int(stats[0]), int(stats[1]), int(stats[2]), int(stats[3]))

    def set_delta(self, on: bool) -> None:
        """Delta re-simulation inside the native MCMC loops (default on;
        off = every proposal pays a full re-simulation)."""
        _load().ffsim_set_delta(self._handle, 1 if on else 0)

    def set_crosscheck(self, on: bool) -> None:
        """Debug mode: every delta evaluation is cross-checked against a
        full re-simulation; divergence > 1e-9 aborts the process."""
        _load().ffsim_set_crosscheck(self._handle, 1 if on else 0)

    def delta_state(self) -> DeltaState:
        return DeltaState(self)

    def masked_mcmc(self, assignment: Sequence[int], free_ops,
                    n_cands, iters: int, beta: float = 5e3, seed: int = 0,
                    deadline: float = None):
        """Metropolis chain restricted to ``free_ops`` on the FULL graph:
        every op outside the mask keeps its config in ``assignment``, so
        boundary edges into/out of the masked block are priced by the same
        delta re-simulation as interior edges (no separate boundary cost
        model can drift from the simulator).  This is the block sub-search
        primitive of the decomposed search — a caller-driven
        loop over :class:`DeltaState` rather than a new native entry
        point, deterministic under ``seed`` via numpy's RandomState.

        ``n_cands`` maps op index -> candidate count (list or dict);
        ``deadline`` is an absolute ``time.perf_counter()`` cutoff checked
        every 64 proposals (None = run all ``iters`` — the bit-reproducible
        mode; a shared deadline lets one wall budget cap the TOTAL across
        sub-searches).

        Returns ``(best, best_t, cur, cur_t, stats)`` with stats keyed
        like the native chains (accepted/proposed/delta_evals/full_evals).
        """
        import math as _math
        import time as _time

        rng = np.random.RandomState(int(seed) & 0xFFFFFFFF)
        cur = np.ascontiguousarray(assignment, dtype=np.int32).copy()
        assert len(cur) == self.n_ops
        free = [int(i) for i in free_ops if int(n_cands[int(i)]) > 1]
        ds = self.delta_state()
        cur_t = float(ds.init(cur))
        best, best_t = cur.copy(), cur_t
        stats = {"accepted": 0, "proposed": 0, "delta_evals": 0,
                 "full_evals": 1}
        if free:
            for it in range(int(iters)):
                if deadline is not None and (it & 63) == 0 \
                        and _time.perf_counter() >= deadline:
                    break
                op = free[int(rng.randint(len(free)))]
                k = int(n_cands[op])
                cfg = int(rng.randint(k - 1))
                if cfg >= int(cur[op]):
                    cfg += 1   # uniform over the k-1 OTHER configs
                t = float(ds.propose(op, cfg))
                stats["proposed"] += 1
                stats["delta_evals"] += 1
                if t <= cur_t or float(rng.random_sample()) \
                        < _math.exp(-beta * (t - cur_t)):
                    ds.commit()
                    cur[op] = cfg
                    cur_t = t
                    stats["accepted"] += 1
                    if t < best_t:
                        best, best_t = cur.copy(), t
        return (best.tolist(), float(best_t), cur.tolist(), float(cur_t),
                stats)

    def mcmc_chains(self, assignment: Sequence[int], iters: int = 250_000,
                    beta: float = 5e3, seed: int = 0, chains: int = 4,
                    exchange_every: int = 0):
        """N independent chains on native threads with deterministic
        best-state exchange every ``exchange_every`` proposals (0 = no
        exchange).  Chain 0 uses ``seed`` verbatim, so ``chains=1``
        reproduces :meth:`mcmc` exactly.  Returns (best_assignment,
        best_time, per_chain_stats) where each stats entry is
        {accepted, proposed, delta_evals, full_evals}."""
        lib = _load()
        a = np.ascontiguousarray(assignment, dtype=np.int32).copy()
        assert len(a) == self.n_ops
        stats = np.zeros(max(1, chains) * 4, dtype=np.int64)
        t = lib.ffsim_mcmc_chains(self._handle, _i32(a), iters, beta, seed,
                                  chains, exchange_every, _i64(stats))
        per_chain = [
            {"accepted": int(stats[i * 4]), "proposed": int(stats[i * 4 + 1]),
             "delta_evals": int(stats[i * 4 + 2]),
             "full_evals": int(stats[i * 4 + 3])}
            for i in range(max(1, chains))]
        return a.tolist(), t, per_chain

    def mcmc_chains_chunk(self, curs, bests, times, iters: int,
                          beta: float = 5e3, seed: int = 0):
        """One chunk of every chain, concurrently (no internal exchange —
        the caller exchanges best states between chunks and emits the
        per-chain obs records).  ``curs``/``bests`` are per-chain
        assignment lists, ``times`` per-chain [cur_t, best_t] (cur_t < 0
        on the first chunk).  Returns (curs, bests, times, per_chain_stats)
        with stats entries as in :meth:`mcmc_chains`."""
        lib = _load()
        chains = len(curs)
        c = np.ascontiguousarray(curs, dtype=np.int32).copy()
        b = np.ascontiguousarray(bests, dtype=np.int32).copy()
        assert c.shape == (chains, self.n_ops) == b.shape
        t = np.ascontiguousarray(times, dtype=np.float64).copy()
        assert t.shape == (chains, 2)
        stats = np.zeros(chains * 4, dtype=np.int64)
        lib.ffsim_mcmc_chains_run(self._handle, _i32(c), _i32(b), _f64(t),
                                  iters, beta, seed, chains, _i64(stats))
        per_chain = [
            {"accepted": int(stats[i * 4]), "proposed": int(stats[i * 4 + 1]),
             "delta_evals": int(stats[i * 4 + 2]),
             "full_evals": int(stats[i * 4 + 3])}
            for i in range(chains)]
        return (c.tolist(), b.tolist(), t.tolist(), per_chain)

    def __del__(self):
        if getattr(self, "_handle", None):
            try:
                _load().ffsim_destroy(self._handle)
            except Exception:
                pass
            self._handle = None
