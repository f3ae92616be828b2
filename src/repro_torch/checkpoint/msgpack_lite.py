"""The subset of MessagePack that checkpoints use, written and read
without the ``msgpack`` package (which the card's machine lacks): maps,
arrays, UTF-8 strings, binary blobs, integers, floats, ``None`` and
booleans.  ``packb`` picks the shortest encoding of every value, as
``msgpack.packb(..., use_bin_type=True)`` does, so both write the same
bytes for the same map."""
from __future__ import annotations

import struct


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        n = len(data)
        if n < 32:
            out.append(bytes([0xa0 | n]))
        elif n < 1 << 8:
            out.append(b"\xd9" + struct.pack(">B", n))
        elif n < 1 << 16:
            out.append(b"\xda" + struct.pack(">H", n))
        else:
            out.append(b"\xdb" + struct.pack(">I", n))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = len(obj)
        if n < 1 << 8:
            out.append(b"\xc4" + struct.pack(">B", n))
        elif n < 1 << 16:
            out.append(b"\xc5" + struct.pack(">H", n))
        else:
            out.append(b"\xc6" + struct.pack(">I", n))
        out.append(bytes(obj))
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(bytes([0x90 | n]))
        elif n < 1 << 16:
            out.append(b"\xdc" + struct.pack(">H", n))
        else:
            out.append(b"\xdd" + struct.pack(">I", n))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(bytes([0x80 | n]))
        elif n < 1 << 16:
            out.append(b"\xde" + struct.pack(">H", n))
        else:
            out.append(b"\xdf" + struct.pack(">I", n))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def _pack_int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    for lo, hi, tag, fmt in ((0, 1 << 8, 0xcc, ">B"), (0, 1 << 16, 0xcd, ">H"),
                             (0, 1 << 32, 0xce, ">I"), (0, 1 << 64, 0xcf, ">Q"),
                             (-(1 << 7), 0, 0xd0, ">b"),
                             (-(1 << 15), 0, 0xd1, ">h"),
                             (-(1 << 31), 0, 0xd2, ">i"),
                             (-(1 << 63), 0, 0xd3, ">q")):
        if lo <= v < hi:
            return bytes([tag]) + struct.pack(fmt, v)
    raise OverflowError(f"integer {v} does not fit in 64 bits")


def packb(obj) -> bytes:
    out: list = []
    _pack(obj, out)
    return b"".join(out)


_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
          0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
_LEN = {0xd9: ">B", 0xda: ">H", 0xdb: ">I",      # str
        0xc4: ">B", 0xc5: ">H", 0xc6: ">I",      # bin
        0xdc: ">H", 0xdd: ">I",                  # array
        0xde: ">H", 0xdf: ">I"}                  # map


class _Reader:
    def __init__(self, data):
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
        tag = self.take(1)[0]
        if tag < 0x80:
            return tag
        if tag >= 0xe0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8f:
            return self.map(tag & 0x0f)
        if 0x90 <= tag <= 0x9f:
            return [self.value() for _ in range(tag & 0x0f)]
        if 0xa0 <= tag <= 0xbf:
            return str(self.take(tag & 0x1f), "utf-8")
        if tag == 0xc0:
            return None
        if tag in (0xc2, 0xc3):
            return tag == 0xc3
        if tag in _FIXED:
            return self.unpack(_FIXED[tag])
        if tag in _LEN:
            n = self.unpack(_LEN[tag])
            if tag in (0xd9, 0xda, 0xdb):
                return str(self.take(n), "utf-8")
            if tag in (0xc4, 0xc5, 0xc6):
                return self.take(n).tobytes()
            if tag in (0xdc, 0xdd):
                return [self.value() for _ in range(n)]
            return self.map(n)
        raise ValueError(f"msgpack type 0x{tag:02x} is not supported")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def unpackb(data) -> object:
    reader = _Reader(data)
    obj = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("extra bytes after the msgpack value")
    return obj
