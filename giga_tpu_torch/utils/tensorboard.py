"""Dependency-free TensorBoard event-file writer.

The reference logs training curves with torch.utils.tensorboard
(reference scripts/train_giga.py:238-245: train/val scalars via
``SummaryWriter.add_scalar``); users point TensorBoard at the log
directory. This module writes the same on-disk format — TFRecord-framed
``Event`` protobufs with scalar summaries — by hand-encoding the two tiny
protobuf messages involved, so no tensorflow/tensorboard package is needed
at write time. Files are readable by any standard TensorBoard install.

Format notes (stable, public):
  * record framing: u64 length | masked crc32c(length) | payload |
    masked crc32c(payload); masked(c) = ((c>>15 | c<<17) + 0xa282ead8) % 2^32
  * Event:   1=wall_time(double) 2=step(int64) 3=file_version(string)
             5=summary(Summary)
  * Summary: repeated 1=Value{1=tag(string) 2=simple_value(float)}
"""

from __future__ import annotations

import os
import socket
import struct
import time
from pathlib import Path

_CRC_TABLE = []


def _crc32c_table():
    # Castagnoli polynomial, reflected form 0x82F63B78
    if not _CRC_TABLE:
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc32c_table()
    c = 0xFFFFFFFF
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # protobuf int64 two's complement
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _encode_value(tag: str, value: float) -> bytes:
    return (
        _field_bytes(1, tag.encode())
        + bytes([2 << 3 | 5])  # field 2, fixed32
        + struct.pack("<f", float(value))
    )


def _encode_event(wall_time: float, step: int | None = None,
                  file_version: str | None = None,
                  scalars: dict | None = None) -> bytes:
    msg = bytes([1 << 3 | 1]) + struct.pack("<d", wall_time)
    if step is not None:
        msg += bytes([2 << 3 | 0]) + _varint(int(step))
    if file_version is not None:
        msg += _field_bytes(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _field_bytes(1, _encode_value(tag, v)) for tag, v in scalars.items()
        )
        msg += _field_bytes(5, summary)
    return msg


class SummaryWriter:
    """Minimal drop-in for torch.utils.tensorboard.SummaryWriter (scalars).

    >>> w = SummaryWriter(logdir)
    >>> w.add_scalar("train/loss", 0.3, step)
    >>> w.close()
    """

    def __init__(self, logdir):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        host = socket.gethostname()
        name = f"events.out.tfevents.{int(time.time())}.{host}.{os.getpid()}"
        self._f = (self.logdir / name).open("wb")
        self._write(_encode_event(time.time(), file_version="brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_encode_event(time.time(), step=step, scalars={tag: value}))

    def add_scalars(self, scalars: dict, step: int) -> None:
        """One event carrying several tags (fewer records than add_scalar)."""
        self._write(_encode_event(time.time(), step=step, scalars=scalars))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_events(path):
    """Parse an event file back into [(step, {tag: value})] — used by tests
    and available for quick inspection without tensorboard installed."""
    out = []
    data = Path(path).read_bytes()
    off = 0
    while off + 12 <= len(data):
        (n,) = struct.unpack_from("<Q", data, off)
        (hcrc,) = struct.unpack_from("<I", data, off + 8)
        if hcrc != _masked_crc(data[off : off + 8]):
            raise ValueError(f"bad length crc at offset {off}")
        payload = data[off + 12 : off + 12 + n]
        (pcrc,) = struct.unpack_from("<I", data, off + 12 + n)
        if pcrc != _masked_crc(payload):
            raise ValueError(f"bad payload crc at offset {off}")
        off += 12 + n + 4
        out.append(_decode_event(payload))
    return [e for e in out if e is not None]


def _read_varint(buf, pos):
    n = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7


def _decode_event(buf):
    step, scalars = 0, {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 1:
            pos += 8
        elif wire == 5:
            pos += 4
        elif wire == 0:
            val, pos = _read_varint(buf, pos)
            if num == 2:
                step = val
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            if num == 5:
                scalars.update(_decode_summary(buf[pos : pos + n]))
            pos += n
    return (step, scalars) if scalars else None


def _decode_summary(buf):
    scalars = {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        n, pos = _read_varint(buf, pos)
        if key >> 3 == 1:
            scalars.update(_decode_value(buf[pos : pos + n]))
        pos += n
    return scalars


def _decode_value(buf):
    tag, val = None, None
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 2:
            n, pos = _read_varint(buf, pos)
            if num == 1:
                tag = buf[pos : pos + n].decode()
            pos += n
        elif wire == 5:
            if num == 2:
                (val,) = struct.unpack_from("<f", buf, pos)
            pos += 4
        elif wire == 0:
            _, pos = _read_varint(buf, pos)
        elif wire == 1:
            pos += 8
    return {tag: val} if tag is not None else {}
