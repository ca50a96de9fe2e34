"""Minimal pure-Python TensorBoard event-file writer (no TF dependency).

Equivalent capability of the reference's `TensorBoardOutputFormat`
(guided_diffusion/logger.py:150-189, which imports tensorflow) and the
Lightning TensorBoardLogger used by train_openai.py:70 — here implemented
from the wire formats directly so scalars are viewable in TensorBoard:

  * TFRecord framing: u64 length (LE) + masked CRC32C(length) + payload +
    masked CRC32C(payload), mask(c) = ((c >> 15 | c << 17) + 0xa282ead8).
  * `Event` protobuf (tensorflow/core/util/event.proto): wall_time (field 1,
    double), step (field 2, int64), file_version (field 3, string),
    summary (field 5, message). `Summary.Value`: tag (field 1, string),
    simple_value (field 2, float).
"""

from __future__ import annotations

import os
import socket
import struct
import time

# CRC32C (Castagnoli) table, poly 0x82F63B78 (reflected)
_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 * (_c & 1))
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (_CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)) & 0xFFFFFFFF
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


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


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double_field(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def _float_field(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _int_field(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _bytes_field(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(value)) + value


def _event_proto(wall_time: float, step: int | None = None,
                 file_version: str | None = None,
                 summary: bytes | None = None) -> bytes:
    msg = _double_field(1, wall_time)
    if step is not None:
        msg += _int_field(2, step)
    if file_version is not None:
        msg += _bytes_field(3, file_version.encode())
    if summary is not None:
        msg += _bytes_field(5, summary)
    return msg


def _scalar_summary(tag_values) -> bytes:
    out = b""
    for tag_name, value in tag_values:
        val_msg = (_bytes_field(1, tag_name.encode())
                   + _float_field(2, float(value)))
        out += _bytes_field(1, val_msg)
    return out


class EventFileWriter:
    """Appends Event records to an events.out.tfevents.* file."""

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}{filename_suffix}")
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._write_event(_event_proto(time.time(),
                                       file_version="brain.Event:2"))

    def _write_event(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))
        self._f.flush()

    def add_scalars(self, step: int, tag_values):
        """tag_values: iterable of (tag, float)."""
        tag_values = [(t, v) for t, v in tag_values
                      if isinstance(v, (int, float))]
        if not tag_values:
            return
        self._write_event(_event_proto(time.time(), step=int(step),
                                       summary=_scalar_summary(tag_values)))

    def add_scalar(self, step: int, tag_name: str, value: float):
        self.add_scalars(step, [(tag_name, value)])

    def close(self):
        self._f.close()


def read_events(path: str):
    """Parses an events file back into [(wall_time, step, {tag: value})]
    (for tests and offline inspection; TensorBoard reads the same bytes)."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        header = data[pos:pos + 8]
        (hcrc,) = struct.unpack_from("<I", data, pos + 8)
        assert hcrc == _masked_crc(header), "corrupt length crc"
        payload = data[pos + 12:pos + 12 + length]
        (pcrc,) = struct.unpack_from("<I", data, pos + 12 + length)
        assert pcrc == _masked_crc(payload), "corrupt payload crc"
        pos += 12 + length + 4
        out.append(_parse_event(payload))
    return out


def _read_varint(buf, pos):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _parse_fields(buf):
    pos = 0
    fields = []
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = struct.unpack_from("<d", buf, pos)[0]
            pos += 8
        elif wire == 5:
            val = struct.unpack_from("<f", buf, pos)[0]
            pos += 4
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.append((field, wire, val))
    return fields


def _parse_event(payload: bytes):
    wall_time, step, scalars = None, 0, {}
    for field, wire, val in _parse_fields(payload):
        if field == 1 and wire == 1:
            wall_time = val
        elif field == 2 and wire == 0:
            step = val
        elif field == 5 and wire == 2:
            for f2, w2, v2 in _parse_fields(val):
                if f2 == 1 and w2 == 2:  # Summary.Value
                    tag_name, simple = None, None
                    for f3, w3, v3 in _parse_fields(v2):
                        if f3 == 1 and w3 == 2:
                            tag_name = v3.decode()
                        elif f3 == 2 and w3 == 5:
                            simple = v3
                    if tag_name is not None and simple is not None:
                        scalars[tag_name] = simple
    return wall_time, step, scalars
