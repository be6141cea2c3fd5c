"""TensorBoard event-file writer — dependency-free.

The port's copy of ``kubeflow_tpu/utils/tbevents.py``, byte for byte the
same records (tests/test_torch_metrics.py holds the two writers equal).

The platform deploys TensorBoard (the reference's kubeflow/tensorboard
package → manifests/serving.py tensorboard component) but the trainer only
streamed JSONL, which TensorBoard cannot read. This writes the event wire
format directly so the worker needs neither tensorflow nor tensorboard
(seconds of import and huge deps for what is ~100 lines of framing):

- records: TFRecord framing — u64-LE length, masked crc32c(length),
  payload, masked crc32c(payload);
- payload: an ``Event`` protobuf — wall_time(1, double), step(2, int64),
  file_version(3, string) or summary(5) of ``Summary.Value``
  (tag(1, string), simple_value(2, float)) — hand-encoded (proto wire
  format is stable and tiny for this subset).

The JAX package's copy is verified round-trip against the real
TensorBoard reader in tests/test_support.py.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

__all__ = ["EventWriter"]

# -- crc32c (Castagnoli, reflected poly 0x82F63B78) --------------------------

_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- minimal proto wire encoding ---------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _scalar_event(wall_time: float, step: int,
                  scalars: dict[str, float]) -> bytes:
    summary = b"".join(
        _len_delim(1, _len_delim(1, tag.encode()) + _float(2, float(v)))
        for tag, v in scalars.items())
    return _double(1, wall_time) + _int64(2, step) + _len_delim(5, summary)


def _version_event(wall_time: float) -> bytes:
    return _double(1, wall_time) + _len_delim(3, b"brain.Event:2")


# -- the writer ---------------------------------------------------------------

class EventWriter:
    """Append scalar events to an ``events.out.tfevents.*`` file that
    TensorBoard tails. One writer per run directory."""

    def __init__(self, logdir: str, clock=time.time):
        os.makedirs(logdir, exist_ok=True)
        self._clock = clock
        host = socket.gethostname() or "local"
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(clock())}.{host}")
        self._fh = open(self.path, "ab")
        self._write(_version_event(clock()))

    def _write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._fh.write(header)
        self._fh.write(struct.pack("<I", _masked_crc(header)))
        self._fh.write(payload)
        self._fh.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None) -> None:
        self.add_scalars({tag: value}, step, wall_time)

    def add_scalars(self, scalars: dict[str, float], step: int,
                    wall_time: Optional[float] = None) -> None:
        """One Event carrying every scalar (one point per tag per step)."""
        if not scalars:
            return
        self._write(_scalar_event(
            self._clock() if wall_time is None else wall_time,
            int(step), scalars))
        self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
