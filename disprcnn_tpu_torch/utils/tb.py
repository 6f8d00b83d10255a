"""Dependency-free TensorBoard scalar writer (a copy of
disprcnn_tpu/utils/tb.py).

The reference trainer logs scalar losses / lr / batch_time / uncertainty
weights to tensorboardX every PRINT_INTERVAL (reference
disprcnn/engine/trainer.py:132-144, writer constructed at :66-67). This
module reproduces that observability surface without the tensorboardX /
protobuf dependency: it hand-encodes the tiny subset of the
`tensorflow.Event` protobuf that scalar summaries need and frames records
in the TFRecord format TensorBoard reads (length + masked-CRC32C framing).
Files are named `events.out.tfevents.<ts>.<host>` like the real writer, so
`tensorboard --logdir` picks them up unchanged.
"""
from __future__ import annotations

import os
import socket
import struct
import time

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven — TFRecord framing checksums.

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf wire encoding (only what Event/Summary/Value need).


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _field_double(num: int, v: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", v)


def _field_float(num: int, v: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", v)


def _field_varint(num: int, v: int) -> bytes:
    return _varint(num << 3) + _varint(v)


def _event(wall_time: float, step: int, *, file_version: str | None = None,
           scalars: dict[str, float] | None = None) -> bytes:
    # Event: 1=wall_time double, 2=step int64, 3=file_version string, 5=summary
    ev = _field_double(1, wall_time) + _field_varint(2, step)
    if file_version is not None:
        ev += _field_bytes(3, file_version.encode())
    if scalars:
        summary = b""
        for tag, value in scalars.items():
            # Summary.Value: 1=tag string, 2=simple_value float
            val = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
            summary += _field_bytes(1, val)  # Summary: 1=repeated value
        ev += _field_bytes(5, summary)
    return ev


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header)) + payload
            + struct.pack("<I", _masked_crc(payload)))


class SummaryWriter:
    """Scalar-only stand-in for tensorboardX.SummaryWriter.

    `add_scalar(tag, value, step)` matches the call sites the reference
    trainer uses (engine/trainer.py:134-144). Values are flushed on every
    add (training steps are seconds long; write amplification is nil).
    """

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self._path = os.path.join(logdir, name)
        self._f = open(self._path, "wb")
        self._f.write(_record(_event(time.time(), 0, file_version="brain.Event:2")))
        self._f.flush()

    @property
    def path(self) -> str:
        return self._path

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self.add_scalars({tag: value}, step)

    def add_scalars(self, scalars: dict[str, float], step: int) -> None:
        if self._f.closed:
            return
        self._f.write(_record(_event(time.time(), int(step), scalars=scalars)))
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def read_scalars(path: str) -> list[tuple[int, dict[str, float]]]:
    """Parse an event file written by SummaryWriter (tests / offline reads).

    Returns [(step, {tag: value})] for records carrying scalar summaries.
    Verifies TFRecord CRCs; raises ValueError on corruption.
    """
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (hcrc,) = struct.unpack_from("<I", data, pos + 8)
        if _masked_crc(header) != hcrc:
            raise ValueError(f"bad header crc @ {pos}")
        (n,) = struct.unpack("<Q", header)
        payload = data[pos + 12:pos + 12 + n]
        (pcrc,) = struct.unpack_from("<I", data, pos + 12 + n)
        if _masked_crc(payload) != pcrc:
            raise ValueError(f"bad payload crc @ {pos}")
        pos += 16 + n
        step, scalars = 0, {}
        i = 0
        while i < len(payload):
            key, i = _read_varint(payload, i)
            num, wire = key >> 3, key & 7
            if wire == 1:
                i += 8
            elif wire == 5:
                i += 4
            elif wire == 0:
                v, i = _read_varint(payload, i)
                if num == 2:
                    step = v
            elif wire == 2:
                ln, i = _read_varint(payload, i)
                if num == 5:
                    scalars.update(_read_summary(payload[i:i + ln]))
                i += ln
            else:
                raise ValueError(f"wire type {wire}")
        if scalars:
            out.append((step, scalars))
    return out


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = v = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7


def _read_summary(buf: bytes) -> dict[str, float]:
    scalars = {}
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        ln, i = _read_varint(buf, i)
        if key >> 3 == 1:
            val = buf[i:i + ln]
            j, tag, sv = 0, None, None
            while j < len(val):
                k, j = _read_varint(val, j)
                if k >> 3 == 1 and k & 7 == 2:
                    n, j = _read_varint(val, j)
                    tag = val[j:j + n].decode()
                    j += n
                elif k >> 3 == 2 and k & 7 == 5:
                    (sv,) = struct.unpack_from("<f", val, j)
                    j += 4
                else:
                    break
            if tag is not None and sv is not None:
                scalars[tag] = sv
        i += ln
    return scalars
