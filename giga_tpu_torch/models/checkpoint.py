"""Pure-Python reader and writer for flax ``msgpack`` parameter files.

The machine that serves the port has neither ``msgpack`` nor ``flax``, so
this module decodes the subset of msgpack that ``flax.serialization``
writes: maps, str, int, float, bool, nil, bin, arrays, and the extension
types flax registers for numpy data; ``msgpack_serialize`` writes a tree of
dicts and numpy arrays in the bytes ``flax.serialization.msgpack_serialize``
gives it (dict keys sorted, msgpack's shortest encodings, an ndarray as ext 1):

    ext 1 (ndarray): payload is the msgpack tuple (shape, dtype name, C-order bytes)
    ext 3 (numpy scalar): same payload, unpacked to a 0-d value

Anything else raises ``ValueError``.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {  # code -> (length format, kind)
            0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map"),
            0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(self.unpack(">b"), n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(self.unpack(">b"), fixext[b])
        scalars = {
            0xCA: ">f", 0xCB: ">d",
            0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if b in scalars:
            return self.unpack(scalars[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code: int, n: int):
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack extension type {code}")
        shape, dtype_name, buf = _Reader(payload).value()
        if isinstance(dtype_name, bytes):
            dtype_name = dtype_name.decode()
        if dtype_name == "bfloat16":
            raise ValueError("bfloat16 arrays are not supported by this reader")
        arr = np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape, order="C")
        return arr[()] if code == _EXT_NPSCALAR else arr


def msgpack_restore(data: bytes):
    """Decode flax msgpack bytes into nested dicts of numpy arrays."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after msgpack object")
    return out


def load_params(path):
    """Read a flax ``.msgpack`` parameter file -> nested dict of numpy arrays."""
    return msgpack_restore(Path(path).read_bytes())


class _Writer:
    def __init__(self):
        self.parts = []

    def head(self, n: int, fix: int | None, fix_max: int, codes) -> None:
        """A length header: the fix form below ``fix_max``, else the
        smallest of ``codes`` ((code, struct format, limit), ...)."""
        if fix is not None and n <= fix_max:
            self.parts.append(bytes([fix | n]))
            return
        for code, fmt, limit in codes:
            if n <= limit:
                self.parts.append(bytes([code]) + struct.pack(fmt, n))
                return
        raise ValueError(f"msgpack object of length {n} is too long")

    def value(self, v) -> None:
        if isinstance(v, dict):
            self.head(len(v), 0x80, 15, ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF)))
            for k in sorted(v):  # flax's tree copy sorts every dict's keys
                self.value(k)
                self.value(v[k])
        elif isinstance(v, (list, tuple)):
            self.head(len(v), 0x90, 15, ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF)))
            for x in v:
                self.value(x)
        elif isinstance(v, str):
            b = v.encode("utf-8")
            self.head(len(b), 0xA0, 31, ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF),
                                         (0xDB, ">I", 0xFFFFFFFF)))
            self.parts.append(b)
        elif isinstance(v, bytes):
            self.head(len(v), None, 0, ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF),
                                        (0xC6, ">I", 0xFFFFFFFF)))
            self.parts.append(v)
        elif isinstance(v, (bool, np.bool_)) or v is None:
            self.parts.append(bytes([{None: 0xC0, False: 0xC2, True: 0xC3}[None if v is None
                                                                           else bool(v)]]))
        elif isinstance(v, int):
            self.integer(v)
        elif isinstance(v, float):
            self.parts.append(b"\xcb" + struct.pack(">d", v))
        elif isinstance(v, (np.ndarray, np.generic)):
            self.ext(_EXT_NDARRAY if isinstance(v, np.ndarray) else _EXT_NPSCALAR,
                     _ndarray_bytes(np.asarray(v)))
        else:
            raise ValueError(f"cannot write {type(v).__name__} as msgpack")

    def integer(self, v: int) -> None:
        if 0 <= v <= 0x7F or -32 <= v < 0:
            self.parts.append(struct.pack(">b" if v < 0 else ">B", v))
            return
        forms = (((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF), (0xCE, ">I", 0xFFFFFFFF),
                  (0xCF, ">Q", 2 ** 64 - 1)) if v > 0 else
                 ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000), (0xD2, ">i", -2 ** 31),
                  (0xD3, ">q", -2 ** 63)))
        for code, fmt, limit in forms:
            if (v <= limit) if v > 0 else (v >= limit):
                self.parts.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise ValueError(f"integer {v} does not fit msgpack")

    def ext(self, code: int, payload: bytes) -> None:
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            self.parts.append(bytes([fixext[n]]))
        else:
            self.head(n, None, 0, ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF),
                                   (0xC9, ">I", 0xFFFFFFFF)))
        self.parts.append(struct.pack(">b", code) + payload)


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's ndarray payload: the msgpack tuple (shape, dtype name, C-order bytes)."""
    w = _Writer()
    w.value((tuple(int(d) for d in arr.shape), arr.dtype.name, arr.tobytes("C")))
    return b"".join(w.parts)


def msgpack_serialize(tree) -> bytes:
    """Encode nested dicts of numpy arrays as flax msgpack bytes."""
    w = _Writer()
    w.value(tree)
    return b"".join(w.parts)


def save_params(params, path) -> None:
    """Write a parameter tree (nested dicts of numpy arrays) as a flax
    ``.msgpack`` file, creating its directory."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(msgpack_serialize(params))
