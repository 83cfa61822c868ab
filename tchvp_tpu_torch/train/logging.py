"""Scalar logging: TensorBoard-compatible event files + JSONL, no deps.

A copy of ``tchvp_tpu/train/logging.py`` in pure Python: for the same
scalars and wall times it writes the same event bytes.

The reference logs scalars through tensorboardX (``FCT.py:21,309,356``,
``Model.py:9,160,176-178,188``). That package is not a dependency, so this
module writes genuine TensorBoard event files directly — hand-encoded
protobuf (Event/Summary wire format) in TFRecord framing with masked
CRC32C — loadable by any stock TensorBoard. A JSONL mirror keeps metrics
greppable without TensorBoard.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time
from typing import Optional

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven — required by TFRecord framing.
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    _CRC_TABLE = table
    return table


def _crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf wire encoding for Event / Summary.
# ---------------------------------------------------------------------------


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


def _encode_scalar_event(wall_time: float, step: int, tag: str, value: float) -> bytes:
    value_msg = (
        _field_bytes(1, tag.encode())
        + bytes([(2 << 3) | 5])  # simple_value, wire type 5 (32-bit)
        + struct.pack("<f", value)
    )
    summary = _field_bytes(1, value_msg)
    event = (
        struct.pack("<B", (1 << 3) | 1)
        + struct.pack("<d", wall_time)
        + _varint((2 << 3) | 0)
        + _varint(step)
        + _field_bytes(5, summary)
    )
    return event


def _encode_version_event(wall_time: float) -> bytes:
    return (
        struct.pack("<B", (1 << 3) | 1)
        + struct.pack("<d", wall_time)
        + _field_bytes(3, b"brain.Event:2")
    )


def _tfrecord(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + payload
        + struct.pack("<I", _masked_crc(payload))
    )


class SummaryWriter:
    """Drop-in for the reference's tensorboardX ``SummaryWriter`` usage:
    ``add_scalar(tag, value, step)`` + ``flush``/``close``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self._path = os.path.join(log_dir, fname)
        self._file = open(self._path, "wb")
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._file.write(_tfrecord(_encode_version_event(time.time())))

    def add_scalar(self, tag: str, value: float, step: Optional[int] = None) -> None:
        now = time.time()
        step = int(step) if step is not None else 0
        self._file.write(_tfrecord(_encode_scalar_event(now, step, tag, float(value))))
        self._jsonl.write(
            json.dumps({"tag": tag, "value": float(value), "step": step, "time": now})
            + "\n"
        )

    def flush(self) -> None:
        self._file.flush()
        self._jsonl.flush()

    def close(self) -> None:
        self.flush()
        self._file.close()
        self._jsonl.close()
