"""A msgpack codec for the value types a checkpoint shard holds.

The checkpoint format (``repro_torch.distributed.checkpoint``) is a msgpack
array of maps. This module writes and reads that subset of msgpack in pure
Python, so that a machine without the ``msgpack`` package reads and writes
the same files:

* maps with str keys, arrays (lists or tuples), str, bin (bytes,
  bytearray, memoryview) and ints from -2**63 to 2**64 - 1.

``packb(obj)`` gives the bytes of ``msgpack.packb(obj, use_bin_type=True)``:
the shortest encoding at every size. ``unpackb(data)`` reads what
``msgpack.packb`` writes for the subset (str as str, bin as bytes, arrays
as lists) and raises ``ValueError`` on any other type byte, on truncated
input and on trailing bytes.
"""
from __future__ import annotations

import struct
from typing import Any, Callable, Dict, List, Tuple

_U8, _U16, _U32, _U64 = (struct.Struct(f) for f in (">B", ">H", ">I", ">Q"))
_I8, _I16, _I32, _I64 = (struct.Struct(f) for f in (">b", ">h", ">i", ">q"))


def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes((n,))
    if -0x20 <= n < 0:
        return _I8.pack(n)
    if 0 < n <= 0xFF:
        return b"\xcc" + _U8.pack(n)
    if -0x80 <= n < 0:
        return b"\xd0" + _I8.pack(n)
    if 0 < n <= 0xFFFF:
        return b"\xcd" + _U16.pack(n)
    if -0x8000 <= n < 0:
        return b"\xd1" + _I16.pack(n)
    if 0 < n <= 0xFFFFFFFF:
        return b"\xce" + _U32.pack(n)
    if -0x80000000 <= n < 0:
        return b"\xd2" + _I32.pack(n)
    if 0 < n <= 0xFFFFFFFFFFFFFFFF:
        return b"\xcf" + _U64.pack(n)
    if -0x8000000000000000 <= n < 0:
        return b"\xd3" + _I64.pack(n)
    raise OverflowError(f"int {n} does not fit 64 bits")


def _header(n: int, fix: int, fix_max: int, tags: Tuple[int, ...]) -> bytes:
    """The type byte and length of a str, bin, array or map of size n:
    ``fix | n`` below ``fix_max`` (fix 0 for none), else the first of the
    8-, 16- and 32-bit forms in ``tags`` (None where the form is absent)
    whose length field holds n."""
    if fix and n < fix_max:
        return bytes((fix | n,))
    for tag, fmt in zip(tags, (_U8, _U16, _U32)):
        if tag is not None and n < (1 << (8 * fmt.size)):
            return bytes((tag,)) + fmt.pack(n)
    raise ValueError(f"length {n} does not fit 32 bits")


_STR = (0xA0, 32, (0xD9, 0xDA, 0xDB))
_BIN = (0, 0, (0xC4, 0xC5, 0xC6))
_ARRAY = (0x90, 16, (None, 0xDC, 0xDD))
_MAP = (0x80, 16, (None, 0xDE, 0xDF))


def _pack(obj: Any, out: List) -> None:
    # bool is an int subclass: msgpack has its own type for it, outside
    # the subset
    if isinstance(obj, int) and not isinstance(obj, bool):
        out.append(_int(obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(_header(len(b), *_STR))
        out.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = memoryview(obj).nbytes
        out.append(_header(n, *_BIN))
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), *_ARRAY))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_header(len(obj), *_MAP))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"map key {k!r} is not a str")
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the subset."""
    out: List = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack data is truncated")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def num(self, fmt: struct.Struct) -> int:
        return fmt.unpack(self.take(fmt.size))[0]


def _str(r: _Reader, n: int) -> str:
    return str(r.take(n), "utf-8")


def _array(r: _Reader, n: int) -> list:
    return [_unpack(r) for _ in range(n)]


def _map(r: _Reader, n: int) -> dict:
    out: Dict = {}
    for _ in range(n):
        k = _unpack(r)
        out[k] = _unpack(r)
    return out


# type byte -> (length field or None for the value itself, reader)
_SIZED: Dict[int, Tuple[struct.Struct, Callable]] = {
    0xD9: (_U8, _str), 0xDA: (_U16, _str), 0xDB: (_U32, _str),
    0xC4: (_U8, lambda r, n: bytes(r.take(n))),
    0xC5: (_U16, lambda r, n: bytes(r.take(n))),
    0xC6: (_U32, lambda r, n: bytes(r.take(n))),
    0xDC: (_U16, _array), 0xDD: (_U32, _array),
    0xDE: (_U16, _map), 0xDF: (_U32, _map),
}
_INTS = {0xCC: _U8, 0xCD: _U16, 0xCE: _U32, 0xCF: _U64,
         0xD0: _I8, 0xD1: _I16, 0xD2: _I32, 0xD3: _I64}


def _unpack(r: _Reader) -> Any:
    t = r.num(_U8)
    if t < 0x80:
        return t
    if t >= 0xE0:
        return t - 0x100
    if 0xA0 <= t < 0xC0:
        return _str(r, t & 0x1F)
    if 0x90 <= t < 0xA0:
        return _array(r, t & 0x0F)
    if 0x80 <= t < 0x90:
        return _map(r, t & 0x0F)
    if t in _INTS:
        return r.num(_INTS[t])
    if t in _SIZED:
        fmt, read = _SIZED[t]
        return read(r, r.num(fmt))
    raise ValueError(f"msgpack type byte 0x{t:02x} is outside the "
                     "checkpoint's subset")


def unpackb(data) -> Any:
    """The object ``data`` encodes (``msgpack.unpackb(data, raw=False)``)."""
    r = _Reader(data)
    obj = _unpack(r)
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack object")
    return obj
