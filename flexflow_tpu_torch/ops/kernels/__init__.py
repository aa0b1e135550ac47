"""The port's hand-written CUDA kernels and what they share.

Each kernel's source lives in ``flexflow_tpu_torch/csrc/`` and has a plain
C interface.  :func:`build` compiles sources with ``nvcc`` for Hopper
(``sm_90a``) into shared libraries under ``flexflow_tpu_torch/build/``,
all missing sources at once, each in its own ``nvcc`` process;
:func:`load` opens one with ``ctypes``.  Nothing is built or loaded when
a module is imported: the first launch builds.  A library's file name
carries a digest of its source, of every header in ``csrc/`` and of the
flags, so an edited source or header is rebuilt.

On tensors of the ``meta`` device (the dry run, ``--dry-compile``) a
wrapper returns empty outputs of its kernel's shapes and dtypes: no
arithmetic, no launch, nothing counted (:func:`on_meta`).

``launches`` counts kernel launches by kernel name.  A wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
path went through the kernels.  A launch made for a partial form
(``flash_attention_partial``, ``fused_linear_ce_partial``: inside
:func:`counted_as`) counts under ``<name>.partial`` instead.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: launches per kernel name since the last :func:`reset_launches`
launches: collections.Counter = collections.Counter()

_loaded: Dict[str, ctypes.CDLL] = {}


#: the suffix of the form whose launches are being counted ("" or
#: ".partial")
_form: contextvars.ContextVar = contextvars.ContextVar("kernel_form",
                                                      default="")


def reset_launches() -> None:
    launches.clear()


def count(name: str) -> None:
    """One launch of kernel ``name``, under the form being counted."""
    launches[name + _form.get()] += 1


@contextlib.contextmanager
def counted_as(form: str):
    """Count the launches made inside the block as ``<name>.<form>``."""
    reset = _form.set(f".{form}")
    try:
        yield
    finally:
        _form.reset(reset)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``: the kernels'
    grids are sized to fill them."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def on_meta(what: str, *tensors) -> bool:
    """True when every operand lies on the ``meta`` device, where a
    wrapper only gives its outputs' shapes; raises when only some do."""
    metas = [t.device.type == "meta" for t in tensors if t is not None]
    if not any(metas):
        return False
    if not all(metas):
        raise ValueError(f"{what}: operands on different devices")
    return True


def vec_width(c: int, itemsize: int, strides: Sequence[int] = (),
              pointers: Sequence[tuple] = ()) -> int:
    """Channels a pool kernel's thread reads and writes as one access:
    16 bytes of them (8 bf16, 4 float32) where C, every stride (in
    elements) and every ``(address, itemsize)`` pointer allow it, else 1.
    A pointer allows it where its address is a multiple of the vector's
    bytes in its own type (16 for the data, 8 or 4 for a uint8 plane)."""
    vec = 16 // itemsize
    if c % vec == 0 and all(s % vec == 0 for s in strides) \
            and all(a % (vec * size) == 0 for a, size in pointers):
        return vec
    return 1


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH) — the CUDA kernels are built at first use")
    return found


def library_path(source: str, csrc: Path = CSRC_DIR) -> Path:
    """Where the library built from ``<csrc>/<source>`` lives: the name
    carries a digest of the source, of every ``*.cuh`` header beside it
    (by name and content) and of the flags."""
    src = csrc / source
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:12]}.so"


def build(sources: Sequence[str]) -> Dict[str, Dict]:
    """Build every source whose library is missing, one ``nvcc`` each, all
    started together.  Returns ``{source: {"path", "seconds", "log"}}``;
    ``log`` holds the compiler's output (ptxas register and shared-memory
    report) and ``seconds`` is 0 for a library that was already built.
    Raises when a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, Dict] = {}
    running = []
    for source in sources:
        lib = library_path(source)
        log = lib.with_suffix(".log")
        if lib.exists():
            out[source] = {"path": lib, "seconds": 0.0,
                           "log": log.read_text() if log.exists() else ""}
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((source, lib, tmp, proc, time.perf_counter()))
    failed = []
    for source, lib, tmp, proc, t0 in running:
        text, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{source}:\n{text}")
            continue
        os.replace(tmp, lib)
        lib.with_suffix(".log").write_text(text)
        out[source] = {"path": lib, "seconds": secs, "log": text}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(source: str) -> ctypes.CDLL:
    """The library built from ``csrc/<source>``, built first if missing."""
    lib = _loaded.get(source)
    if lib is None:
        path = build([source])[source]["path"]
        lib = ctypes.CDLL(str(path))
        lib.ff_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ff_cuda_error_string.restype = ctypes.c_char_p
        _loaded[source] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a C entry point returned a non-zero CUDA error code."""
    if code != 0:
        msg = lib.ff_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
