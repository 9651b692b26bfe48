"""Minimal TensorBoard event-file writer (no TF dependency), a copy of
cmtcoop_tpu/utils/tb_writer.py: pure Python, so the port keeps its own.

The reference logs through mmcv's TensorboardLoggerHook (config
log_config:395-398). This writes the same `events.out.tfevents.*` format:
TFRecord framing (length + masked-crc32c) around hand-encoded Event/Summary
protobufs with `simple_value` scalars — loadable by TensorBoard.
"""
from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Optional

# ---------------------------------------------------------------- crc32c

_CRC_TABLE = []
_POLY = 0x82F63B78  # Castagnoli, reflected


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ _POLY if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _pb_int(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _summary_value(tag: str, value: float) -> bytes:
    # Summary.Value: tag = field 1 (string), simple_value = field 2 (float)
    return _pb_bytes(1, tag.encode()) + _pb_float(2, float(value))


def _event(wall_time: float, step: Optional[int] = None,
           file_version: Optional[str] = None,
           scalars: Optional[Dict[str, float]] = None) -> bytes:
    # Event: wall_time = 1 (double), step = 2 (int64),
    #        file_version = 3 (string), summary = 5 (message)
    out = _pb_double(1, wall_time)
    if step is not None:
        out += _pb_int(2, step)
    if file_version is not None:
        out += _pb_bytes(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _pb_bytes(1, _summary_value(t, v)) for t, v in scalars.items())
        out += _pb_bytes(5, summary)
    return out


def _record(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", _masked_crc(header))
            + data + struct.pack("<I", _masked_crc(data)))


class TensorBoardWriter:
    """Scalar-only event writer: `add_scalars(step, {tag: value})`."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}")
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "wb")
        self._f.write(_record(_event(time.time(),
                                     file_version="brain.Event:2")))
        self._f.flush()

    def add_scalars(self, step: int, scalars: Dict[str, float],
                    wall_time: Optional[float] = None) -> None:
        clean = {t: float(v) for t, v in scalars.items()
                 if isinstance(v, (int, float)) or hasattr(v, "item")}
        if not clean:
            return
        self._f.write(_record(_event(
            wall_time if wall_time is not None else time.time(),
            step=step, scalars=clean)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()
