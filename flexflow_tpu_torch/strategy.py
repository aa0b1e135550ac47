"""Per-operator parallelization strategies (PyTorch port).

The same ``ParallelConfig`` / ``Strategy`` pair as
``flexflow_tpu/strategy.py``, kept as this package's own copy so that it
imports nothing of the JAX package.  One strategy file, JSON or the
proto2 wire format, loads in both packages.

Dimension-order convention (Legion's innermost-first ordering):

  * 4-D CNN ops (conv2d / pool2d / batch_norm): ``dims = (w, h, c, n)``
  * 2-D linear: ``dims = (c, n)``
  * 1-D ops (softmax, embed): ``dims = (n,)``

``devices`` is linearized with dim 0 varying fastest.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Mapping, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """One operator's parallelization: partition grid + device assignment.
    ``devices[i]`` is the device ordinal executing grid point ``i`` (dim 0
    fastest)."""

    dims: Tuple[int, ...]
    devices: Tuple[int, ...]

    def __post_init__(self):
        if len(self.dims) == 0:
            raise ValueError("ParallelConfig needs at least one grid dim")
        for d in self.dims:
            if d < 1:
                raise ValueError(f"grid dims must be >= 1, got {self.dims}")
        n = math.prod(self.dims)
        if len(self.devices) != n:
            raise ValueError(
                f"devices list has {len(self.devices)} entries but grid "
                f"{self.dims} has {n} points"
            )

    @property
    def ndims(self) -> int:
        return len(self.dims)

    @property
    def num_parts(self) -> int:
        return math.prod(self.dims)

    @staticmethod
    def data_parallel(ndims: int, num_devices: int,
                      devices: Sequence[int] | None = None) -> "ParallelConfig":
        """Pure data parallelism: partition only the batch (last grid dim),
        one part per device."""
        dims = (1,) * (ndims - 1) + (num_devices,)
        devs = tuple(devices) if devices is not None else tuple(range(num_devices))
        return ParallelConfig(dims=dims, devices=devs)


def uneven_spatial_ok(extent: int, parts: int) -> bool:
    """May a spatial extent split ``parts`` ways unevenly?  Every
    ceil-sized block must be non-empty (``flexflow_tpu/strategy.py:85``)."""
    return parts <= extent and (parts - 1) * -(-extent // parts) < extent


class Strategy(dict):
    """Mapping of op name -> ParallelConfig for a whole model, with the
    JSON and proto2 file formats of the JAX package."""

    #: optional pipeline block: {"stages": S, "microbatches": M, "tp": T}
    pipeline = None

    #: optional simulator prediction carried on the artifact; the serve
    #: engine reads ``predicted["serve"]["forward_step_s"]`` as its
    #: virtual step time
    predicted = None

    # ---------- JSON ----------

    def to_json(self) -> str:
        obj = {
            name: {"dims": list(pc.dims), "devices": list(pc.devices)}
            for name, pc in self.items()
        }
        if self.pipeline:
            obj["__pipeline__"] = {
                "stages": int(self.pipeline["stages"]),
                "microbatches": int(self.pipeline["microbatches"]),
                "tp": int(self.pipeline.get("tp", 1))}
        if self.predicted:
            obj["__predicted__"] = dict(self.predicted)
        return json.dumps(obj, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Strategy":
        obj = json.loads(text)
        s = cls()
        pp = obj.pop("__pipeline__", None)
        if pp:
            s.pipeline = {"stages": int(pp["stages"]),
                          "microbatches": int(pp["microbatches"]),
                          "tp": int(pp.get("tp", 1))}
        pred = obj.pop("__predicted__", None)
        if pred:
            s.predicted = dict(pred)
        for name, d in obj.items():
            s[name] = ParallelConfig(tuple(d["dims"]), tuple(d["devices"]))
        return s

    # ---------- proto2 wire format ----------
    #
    # message Op { required string name = 1; required int32 nDims = 2;
    #              repeated int32 dims = 3; repeated int32 devices = 4; }
    # message Strategy { repeated Op ops = 1; }

    def to_proto_bytes(self) -> bytes:
        out = bytearray()
        for name in sorted(self.keys()):
            pc = self[name]
            op = bytearray()
            name_b = name.encode("utf-8")
            op += b"\x0a" + _varint(len(name_b)) + name_b          # field 1
            op += b"\x10" + _varint(pc.ndims)                      # field 2
            for d in pc.dims:                                      # field 3
                op += b"\x18" + _varint(d)
            for g in pc.devices:                                   # field 4
                op += b"\x20" + _varint(g)
            out += b"\x0a" + _varint(len(op)) + op                 # ops = 1
        return bytes(out)

    @classmethod
    def from_proto_bytes(cls, data: bytes) -> "Strategy":
        s = cls()
        pos = 0
        while pos < len(data):
            tag, pos = _read_varint(data, pos)
            if tag >> 3 != 1 or tag & 7 != 2:
                raise ValueError(f"unexpected tag {tag:#x} in Strategy message")
            ln, pos = _read_varint(data, pos)
            name, ndims, dims, devices = _parse_op(data[pos:pos + ln])
            pos += ln
            if ndims != len(dims):
                raise ValueError(
                    f"op {name!r}: nDims={ndims} but {len(dims)} dims entries"
                )
            s[name] = ParallelConfig(tuple(dims), tuple(devices))
        return s

    # ---------- file I/O ----------

    def save(self, path: str) -> None:
        if path.endswith(".json"):
            with open(path, "w") as f:
                f.write(self.to_json())
        else:
            with open(path, "wb") as f:
                f.write(self.to_proto_bytes())

    @classmethod
    def load(cls, path: str) -> "Strategy":
        with open(path, "rb") as f:
            raw = f.read()
        if raw.lstrip().startswith(b"{"):
            return cls.from_json(raw.decode("utf-8"))
        return cls.from_proto_bytes(raw)


# ---------------------------------------------------------------------------
# proto2 wire helpers


def _varint(v: int) -> bytes:
    if v < 0:  # proto int32 negatives: 10-byte two's-complement varint
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            if result >= 1 << 63:  # negative int32/int64
                result -= 1 << 64
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _parse_op(data: bytes):
    name = None
    ndims = None
    dims = []
    devices = []
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:
            ln, pos = _read_varint(data, pos)
            name = data[pos:pos + ln].decode("utf-8")
            pos += ln
        elif field == 2 and wire == 0:
            ndims, pos = _read_varint(data, pos)
        elif field in (3, 4) and wire == 0:
            v, pos = _read_varint(data, pos)
            (dims if field == 3 else devices).append(v)
        elif field in (3, 4) and wire == 2:  # packed repeated
            ln, pos = _read_varint(data, pos)
            end = pos + ln
            while pos < end:
                v, pos = _read_varint(data, pos)
                (dims if field == 3 else devices).append(v)
        else:
            raise ValueError(f"unexpected field {field} wire {wire} in Op")
    if name is None or ndims is None:
        raise ValueError("Op message missing required fields")
    return name, ndims, dims, devices


def validate_strategy(strategy: Mapping[str, ParallelConfig],
                      num_devices: int) -> None:
    """Every named device ordinal must exist on the machine: a rank of the
    world (``flexflow_tpu/strategy.py:288``)."""
    for name, pc in strategy.items():
        for dev in pc.devices:
            if not 0 <= dev < num_devices:
                raise ValueError(
                    f"op {name!r}: device {dev} out of range "
                    f"[0, {num_devices})"
                )
