"""The subset of msgpack that the checkpoint format uses, in `struct`.

The reference writes its checkpoints with the `msgpack` package
(`repro/checkpoint/checkpoint.py`); the port must read and write the same
bytes where that package is not installed, so it keeps this copy.

`packb(obj)` gives the bytes of ``msgpack.packb(obj, use_bin_type=True)``
for None, bool, int (-2**63 .. 2**64 - 1, each in the smallest format
that holds it), float (float64), str, bytes, list / tuple (arrays) and
dict (maps, in insertion order).  `unpackb(data)` reads anything
``msgpack.packb`` writes of those types, float32 too, as
``msgpack.unpackb(data, raw=False, strict_map_key=False)`` does; it
raises `ValueError` on an ext type, on an unhashable map key, on a
truncated buffer, on invalid UTF-8 and on bytes left over after the
object.
"""
from __future__ import annotations

import struct
from typing import Any, List, Optional

__all__ = ["packb", "unpackb"]


def _pack_int(v: int, out: List[bytes]) -> None:
    if 0 <= v:
        if v < 0x80:
            out.append(struct.pack("B", v))
        elif v < 1 << 8:
            out.append(struct.pack(">BB", 0xCC, v))
        elif v < 1 << 16:
            out.append(struct.pack(">BH", 0xCD, v))
        elif v < 1 << 32:
            out.append(struct.pack(">BI", 0xCE, v))
        elif v < 1 << 64:
            out.append(struct.pack(">BQ", 0xCF, v))
        else:
            raise OverflowError(f"int {v} too large for msgpack")
    elif v >= -32:
        out.append(struct.pack("b", v))
    elif v >= -(1 << 7):
        out.append(struct.pack(">Bb", 0xD0, v))
    elif v >= -(1 << 15):
        out.append(struct.pack(">Bh", 0xD1, v))
    elif v >= -(1 << 31):
        out.append(struct.pack(">Bi", 0xD2, v))
    elif v >= -(1 << 63):
        out.append(struct.pack(">Bq", 0xD3, v))
    else:
        raise OverflowError(f"int {v} too small for msgpack")


def _header(n: int, fix: Optional[int], fix_max: int, c8: Optional[int],
            c16: int, c32: int, out: List[bytes]) -> None:
    """A str / bin / array / map header: ``fix | n`` below ``fix_max``
    (``fix`` None: no fix form), else the 8- (``c8`` None: none), 16- or
    32-bit length form."""
    if fix is not None and n < fix_max:
        out.append(struct.pack("B", fix | n))
    elif c8 is not None and n < 1 << 8:
        out.append(struct.pack(">BB", c8, n))
    elif n < 1 << 16:
        out.append(struct.pack(">BH", c16, n))
    elif n < 1 << 32:
        out.append(struct.pack(">BI", c32, n))
    else:
        raise ValueError(f"{n} entries: too long for msgpack")


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _header(len(raw), 0xA0, 32, 0xD9, 0xDA, 0xDB, out)
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _header(len(raw), None, 0, 0xC4, 0xC5, 0xC6, out)
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        _header(len(obj), 0x90, 16, None, 0xDC, 0xDD, out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _header(len(obj), 0x80, 16, None, 0xDE, 0xDF, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` on the types above."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


# fixed-width formats: code -> (struct format, byte count)
_FIXED = {0xCA: (">f", 4), 0xCB: (">d", 8),
          0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
          0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8)}
# length-prefixed formats: code -> (kind, struct format of the length)
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
_EXT = {0xC7, 0xC8, 0xC9, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("truncated msgpack data")
        view = self.data[self.pos:end]
        self.pos = end
        return view

    def unpack(self, fmt: str, n: int) -> Any:
        return struct.unpack(fmt, self.take(n))[0]

    def read(self) -> Any:
        code = self.unpack("B", 1)
        if code < 0x80:                       # positive fixint
            return code
        if code >= 0xE0:                      # negative fixint
            return code - 0x100
        if code < 0x90:
            return self._map(code & 0x0F)
        if code < 0xA0:
            return self._array(code & 0x0F)
        if code < 0xC0:
            return str(self.take(code & 0x1F), "utf-8")
        if code == 0xC0:
            return None
        if code in (0xC2, 0xC3):
            return code == 0xC3
        if code in _FIXED:
            fmt, n = _FIXED[code]
            return self.unpack(fmt, n)
        if code in _SIZED:
            kind, fmt = _SIZED[code]
            n = self.unpack(fmt, struct.calcsize(fmt))
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            return self._array(n) if kind == "array" else self._map(n)
        if code in _EXT:
            raise ValueError(f"msgpack ext type (0x{code:02x}) is not part "
                             "of the checkpoint format")
        raise ValueError(f"invalid msgpack code 0x{code:02x}")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            if isinstance(k, (list, dict)):
                raise ValueError(f"unhashable map key of type "
                                 f"{type(k).__name__}")
            out[k] = self.read()
        return out


def unpackb(data: bytes) -> Any:
    """``msgpack.unpackb(data, raw=False, strict_map_key=False)``."""
    r = _Reader(data)
    obj = r.read()
    if r.pos != len(r.data):
        raise ValueError(f"extra data: {len(r.data) - r.pos} bytes after "
                         "the object")
    return obj
