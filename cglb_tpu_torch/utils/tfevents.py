"""TensorBoard event-file writer, standard library only.

A copy of ``cglb_tpu/utils/tfevents.py`` (the port imports nothing of the
JAX package).  It writes the event-file format directly:

  TFRecord framing:   uint64 length | masked crc32c(length) |
                      payload       | masked crc32c(payload)
  payload:            a serialized `tensorflow.Event` protobuf; scalars are
                      Event{wall_time, step, summary{value{tag, simple_value}}}

Only varint/fixed32/fixed64/length-delimited encodings are needed, so the
protos are hand-encoded below (field numbers from tensorboard's event.proto /
summary.proto).  ``tests/test_torch_tfevents.py`` holds its bytes to the
JAX package's writer and its CRC to the RFC 3720 vectors.
"""

from __future__ import annotations

import os
import socket
import struct
import time

__all__ = ["EventFileWriter"]

# ---- crc32c (Castagnoli), slicing-by-8 table-driven ----

# 8 tables of 256 entries: table[0] is the classic byte-at-a-time table;
# table[k][b] is the CRC of byte b followed by k zero bytes, letting the hot
# loop fold 8 input bytes per iteration (about 8x fewer Python-level
# iterations than one byte at a time).
_CRC_TABLES = []


def _build_tables():
    poly = 0x82F63B78
    t0 = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        t0.append(crc)
    _CRC_TABLES.append(t0)
    for k in range(1, 8):
        prev = _CRC_TABLES[k - 1]
        _CRC_TABLES.append([(prev[i] >> 8) ^ t0[prev[i] & 0xFF]
                            for i in range(256)])


_build_tables()


def _crc32c(data: bytes) -> int:
    t = _CRC_TABLES
    crc = 0xFFFFFFFF
    n8 = len(data) - (len(data) % 8)
    for i in range(0, n8, 8):
        crc ^= int.from_bytes(data[i : i + 4], "little")
        hi = int.from_bytes(data[i + 4 : i + 8], "little")
        crc = (
            t[7][crc & 0xFF]
            ^ t[6][(crc >> 8) & 0xFF]
            ^ t[5][(crc >> 16) & 0xFF]
            ^ t[4][(crc >> 24) & 0xFF]
            ^ t[3][hi & 0xFF]
            ^ t[2][(hi >> 8) & 0xFF]
            ^ t[1][(hi >> 16) & 0xFF]
            ^ t[0][(hi >> 24) & 0xFF]
        )
    for b in data[n8:]:
        crc = (crc >> 8) ^ t[0][(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---- minimal protobuf encoding ----


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


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _field_double(num: int, value: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", value)


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    # Summary.Value{ tag=1: string, simple_value=2: float }
    sval = _field_bytes(1, tag.encode("utf-8")) + _field_float(2, value)
    # Summary{ value=1: repeated Value }
    summary = _field_bytes(1, sval)
    # Event{ wall_time=1: double, step=2: int64, summary=5: Summary }
    return (
        _field_double(1, wall_time)
        + _field_varint(2, step)
        + _field_bytes(5, summary)
    )


def _version_event(wall_time: float) -> bytes:
    # Event{ wall_time=1, file_version=3: "brain.Event:2" }
    return _field_double(1, wall_time) + _field_bytes(3, b"brain.Event:2")


class EventFileWriter:
    """Append-only TensorBoard scalar writer.

    API-compatible (for the subset the Logger uses) with
    torch.utils.tensorboard.SummaryWriter: add_scalar / flush / close.
    """

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = "events.out.tfevents.%010d.%s.%d" % (
            int(time.time()), socket.gethostname(), os.getpid()
        )
        self._path = os.path.join(log_dir, fname)
        self._f = open(self._path, "ab")
        self._write_record(_version_event(time.time()))

    def _write_record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int):
        self._write_record(_scalar_event(tag, float(value), int(step),
                                         time.time()))

    def flush(self):
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __del__(self):
        f = getattr(self, "_f", None)  # absent if __init__ failed to open
        if f is not None and not f.closed:
            f.close()
