"""Typed binary buffers (Catalyst ``BufferInput``/``BufferOutput`` equivalent).

Fixed-width big-endian primitives plus varints and length-prefixed UTF-8/bytes.
The serializer (serializer.py) writes object graphs through these primitives so
the wire format is deterministic and transport-independent.
"""

from __future__ import annotations

import struct

_I16 = struct.Struct(">h")
_I32 = struct.Struct(">i")
_I64 = struct.Struct(">q")
_F64 = struct.Struct(">d")
# single-byte interning: most wire integers (type tags, small ids, field
# counts) zigzag-encode to one byte — skip the per-byte encode loop
_ONE = [bytes((v,)) for v in range(256)]


class BufferOutput:
    """Append-only binary writer."""

    def __init__(self) -> None:
        self._parts: list[bytes] = []

    def write_u8(self, value: int) -> "BufferOutput":
        self._parts.append(_ONE[value & 0xFF])
        return self

    def write_bool(self, value: bool) -> "BufferOutput":
        return self.write_u8(1 if value else 0)

    def write_i16(self, value: int) -> "BufferOutput":
        self._parts.append(_I16.pack(value))
        return self

    def write_i32(self, value: int) -> "BufferOutput":
        self._parts.append(_I32.pack(value))
        return self

    def write_i64(self, value: int) -> "BufferOutput":
        self._parts.append(_I64.pack(value))
        return self

    def write_f64(self, value: float) -> "BufferOutput":
        self._parts.append(_F64.pack(value))
        return self

    def write_varint(self, value: int) -> "BufferOutput":
        """ZigZag-encoded LEB128 varint (handles negatives compactly)."""
        zz = ((-value) << 1) - 1 if value < 0 else (value << 1)
        if zz < 0x80:  # one-byte fast path (the overwhelmingly common case)
            self._parts.append(_ONE[zz])
            return self
        out = bytearray()
        while True:
            byte = zz & 0x7F
            zz >>= 7
            if zz:
                out.append(byte | 0x80)
            else:
                out.append(byte)
                break
        self._parts.append(bytes(out))
        return self

    def write_bytes(self, value: bytes) -> "BufferOutput":
        self.write_varint(len(value))
        self._parts.append(value)
        return self

    def write_raw(self, value: bytes) -> "BufferOutput":
        """Append pre-encoded bytes verbatim (no length prefix)."""
        self._parts.append(value)
        return self

    def write_utf8(self, value: str) -> "BufferOutput":
        return self.write_bytes(value.encode("utf-8"))

    def to_bytes(self) -> bytes:
        return b"".join(self._parts)

    def __len__(self) -> int:
        return sum(len(p) for p in self._parts)


class BufferInput:
    """Sequential binary reader over bytes produced by :class:`BufferOutput`."""

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0

    def _take(self, n: int) -> bytes:
        if n < 0:
            raise EOFError(f"negative length {n} at {self._pos}")
        if self._pos + n > len(self._data):
            raise EOFError(f"buffer underflow: need {n} bytes at {self._pos}/{len(self._data)}")
        chunk = self._data[self._pos : self._pos + n]
        self._pos += n
        return chunk

    def read_u8(self) -> int:
        return self._take(1)[0]

    def read_bool(self) -> bool:
        return self.read_u8() != 0

    def read_i16(self) -> int:
        return _I16.unpack(self._take(2))[0]

    def read_i32(self) -> int:
        return _I32.unpack(self._take(4))[0]

    def read_i64(self) -> int:
        return _I64.unpack(self._take(8))[0]

    def read_f64(self) -> float:
        return _F64.unpack(self._take(8))[0]

    def read_varint(self) -> int:
        first = self._take(1)[0]
        if not first & 0x80:  # one-byte fast path
            return -((first + 1) >> 1) if first & 1 else first >> 1
        zz = first & 0x7F
        shift = 7
        while True:
            byte = self._take(1)[0]
            zz |= (byte & 0x7F) << shift
            if not byte & 0x80:
                break
            shift += 7
        if zz & 1:
            return -((zz + 1) >> 1)
        return zz >> 1

    def read_bytes(self) -> bytes:
        return self._take(self.read_varint())

    def read_utf8(self) -> str:
        return self.read_bytes().decode("utf-8")

    @property
    def remaining(self) -> int:
        return len(self._data) - self._pos
