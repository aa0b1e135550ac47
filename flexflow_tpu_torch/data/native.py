"""ctypes binding of the native data loader (PyTorch port of
``flexflow_tpu/data/native.py``): threaded JPEG decode, nearest-neighbor
resize and ImageNet normalization in C++.

The library is built from this package's own copy of the source,
``flexflow_tpu_torch/native/dataloader.cc``, at first use, with ``g++ -O2
-std=c++17 -fPIC -shared ... -ljpeg -lpthread`` into
``flexflow_tpu_torch/build/`` (its file name carries a digest of the
source and the flags; each build writes a per-process temporary and
renames it into place).  Where it cannot be built or loaded (no libjpeg
headers or library), :func:`load_lib` returns None, :func:`last_error`
says why, and the image stream decodes with PIL instead
(``data/imagenet.py``), naming the decoder it took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "native" / "dataloader.cc"
BUILD_DIR = PACKAGE_DIR / "build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")
LIBS = ("-ljpeg", "-lpthread")

_lib = None
_error: Optional[str] = None


def library_path() -> Path:
    """Where the library lives: the name carries a digest of the source
    and of the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libffdata_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Build the library unless it exists; returns its path.  Raises
    RuntimeError with the compiler's output when the build fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp),
                               *LIBS], capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"building {SOURCE.name} failed: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load_lib():
    """Build and load the library once; None when it is unavailable
    (:func:`last_error` then holds the reason)."""
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError) as e:
        _error = str(e).strip().splitlines()[-1] if str(e).strip() \
            else type(e).__name__
        return None
    lib.ffdata_create.restype = ctypes.c_void_p
    lib.ffdata_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.ffdata_destroy.argtypes = [ctypes.c_void_p]
    lib.ffdata_submit.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
    lib.ffdata_next.restype = ctypes.c_int
    lib.ffdata_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32)]
    lib.ffdata_decode.restype = ctypes.c_int
    lib.ffdata_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float)]
    _lib = lib
    return lib


def last_error() -> Optional[str]:
    """Why :func:`load_lib` found no library (None before a failure)."""
    return _error


def decode_image(path: str, height: int, width: int) -> Optional[np.ndarray]:
    """Decode one JPEG to normalized float32 HWC synchronously.  None when
    the library is unavailable; raises OSError on a bad file."""
    lib = load_lib()
    if lib is None:
        return None
    out = np.empty((height, width, 3), dtype=np.float32)
    rc = lib.ffdata_decode(
        path.encode(), height, width,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise OSError(f"ffdata_decode({path!r}) failed with code {rc}")
    return out


class NativeLoader:
    """Asynchronous batch pipeline over the native thread pool.

    ``submit`` enqueues a (files, labels) batch without blocking; ``next``
    blocks for the oldest one (FIFO) and returns (images NHWC float32,
    labels int32) as numpy arrays.  Keep two or more batches in flight so
    that decode overlaps the training step."""

    def __init__(self, height: int, width: int, num_threads: int = 4):
        lib = load_lib()
        if lib is None:
            raise RuntimeError(f"native data loader unavailable: "
                               f"{last_error()}")
        self._lib = lib
        self.height, self.width = height, width
        self._handle = lib.ffdata_create(height, width, num_threads)
        if not self._handle:
            raise RuntimeError("ffdata_create failed")
        self._pending: List[int] = []

    @property
    def pending(self) -> int:
        """Batches submitted and not yet taken."""
        return len(self._pending)

    def submit(self, files: Sequence[str], labels: Sequence[int]) -> None:
        n = len(files)
        if n != len(labels):
            raise ValueError(f"{n} files but {len(labels)} labels")
        # the C++ side copies the paths and labels before submit returns
        arr = (ctypes.c_char_p * n)(*[f.encode() for f in files])
        lbl = np.ascontiguousarray(labels, dtype=np.int32)
        self._lib.ffdata_submit(
            self._handle, arr,
            lbl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n)
        self._pending.append(n)

    def next(self) -> Tuple[np.ndarray, np.ndarray]:
        if not self._pending:
            raise RuntimeError("next() with no submitted batch")
        n = self._pending.pop(0)
        img = np.empty((n, self.height, self.width, 3), dtype=np.float32)
        lbl = np.empty((n,), dtype=np.int32)
        rc = self._lib.ffdata_next(
            self._handle,
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            lbl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if rc != n:
            raise RuntimeError(f"ffdata_next returned {rc}, expected {n}")
        return img, lbl

    def close(self) -> None:
        """Join the worker threads (they finish the batches in flight)."""
        if getattr(self, "_handle", None):
            self._lib.ffdata_destroy(self._handle)
            self._handle = None
            self._pending = []

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
