"""The five messages of solver/service.proto in the protobuf wire format,
without protobuf.

The solver host's frames carry SolveRequest / SolveResponse bytes, and the
host is the process entry's default primary, so it must run where neither
`grpc` nor `google.protobuf` is installed.
These classes serialize byte for byte as the generated `service_pb2` does
(proto3: fields in field-number order, default scalars and empty repeated
fields omitted, `shape` packed) and parse what it writes; the parser also
takes an unpacked `shape` and skips unknown fields, as protobuf does.

Each class has the generated API the service and the host use: keyword
construction, the fields as attributes, `SerializeToString()` and
`FromString(data)`.
"""
from __future__ import annotations

from typing import List, Tuple

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5
_MASK64 = (1 << 64) - 1


def _varint(value: int) -> bytes:
    value &= _MASK64  # a negative int64 is ten bytes of two's complement
    out = bytearray()
    while value > 0x7F:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _read_varint(buf, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")


def _int64(value: int) -> int:
    value &= _MASK64
    return value - (1 << 64) if value >> 63 else value


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _key(field, _LEN) + _varint(len(payload)) + payload


def _fields(buf):
    """(field number, wire type, value) over a message's bytes: an int for
    varints and fixed-width fields, a memoryview for length-delimited
    ones."""
    mv = memoryview(buf)
    pos, end = 0, len(mv)
    while pos < end:
        key, pos = _read_varint(mv, pos)
        field, wire = key >> 3, key & 7
        if wire == _VARINT:
            value, pos = _read_varint(mv, pos)
        elif wire == _LEN:
            n, pos = _read_varint(mv, pos)
            if pos + n > end:
                raise ValueError("truncated length-delimited field")
            value, pos = mv[pos:pos + n], pos + n
        elif wire == _I64:
            value, pos = int.from_bytes(mv[pos:pos + 8], "little"), pos + 8
        elif wire == _I32:
            value, pos = int.from_bytes(mv[pos:pos + 4], "little"), pos + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        if pos > end:
            raise ValueError("truncated field")
        yield field, wire, value


def _text(value) -> str:
    return bytes(value).decode("utf-8")


class _Message:
    __slots__ = ()

    def __eq__(self, other):
        return type(other) is type(self) and all(
            getattr(self, f) == getattr(other, f) for f in self.__slots__)

    def __repr__(self):
        return f"{type(self).__name__}({', '.join(f'{f}={getattr(self, f)!r}' for f in self.__slots__)})"

    @classmethod
    def FromString(cls, data):  # noqa: N802 — the generated API's name
        msg = cls()
        msg._parse(data)
        return msg


class Tensor(_Message):
    __slots__ = ("name", "dtype", "shape", "data")

    def __init__(self, name: str = "", dtype: str = "", shape=(), data: bytes = b""):
        self.name, self.dtype, self.shape, self.data = name, dtype, list(shape), data

    def SerializeToString(self) -> bytes:  # noqa: N802
        parts = []
        if self.name:
            parts.append(_len_field(1, self.name.encode()))
        if self.dtype:
            parts.append(_len_field(2, self.dtype.encode()))
        if self.shape:
            parts.append(_len_field(3, b"".join(_varint(int(d)) for d in self.shape)))
        if self.data:
            parts.append(_key(4, _LEN) + _varint(len(self.data)))
            parts.append(bytes(self.data))
        return b"".join(parts)

    def _parse(self, data) -> None:
        for field, wire, value in _fields(data):
            if field == 1 and wire == _LEN:
                self.name = _text(value)
            elif field == 2 and wire == _LEN:
                self.dtype = _text(value)
            elif field == 3 and wire == _LEN:
                pos = 0
                while pos < len(value):
                    d, pos = _read_varint(value, pos)
                    self.shape.append(_int64(d))
            elif field == 3 and wire == _VARINT:
                self.shape.append(_int64(value))
            elif field == 4 and wire == _LEN:
                self.data = bytes(value)


def _tensors_field(field: int, tensors: List[Tensor]) -> List[bytes]:
    parts = []
    for t in tensors:
        body = t.SerializeToString()
        parts.append(_key(field, _LEN) + _varint(len(body)))
        parts.append(body)
    return parts


class SolveRequest(_Message):
    __slots__ = ("geometry", "tensors")

    def __init__(self, geometry: str = "", tensors=()):
        self.geometry, self.tensors = geometry, list(tensors)

    def SerializeToString(self) -> bytes:  # noqa: N802
        parts = [_len_field(1, self.geometry.encode())] if self.geometry else []
        parts.extend(_tensors_field(2, self.tensors))
        return b"".join(parts)

    def _parse(self, data) -> None:
        for field, wire, value in _fields(data):
            if field == 1 and wire == _LEN:
                self.geometry = _text(value)
            elif field == 2 and wire == _LEN:
                self.tensors.append(Tensor.FromString(value))


class SolveResponse(_Message):
    __slots__ = ("tensors", "error")

    def __init__(self, tensors=(), error: str = ""):
        self.tensors, self.error = list(tensors), error

    def SerializeToString(self) -> bytes:  # noqa: N802
        parts = _tensors_field(1, self.tensors)
        if self.error:
            parts.append(_len_field(2, self.error.encode()))
        return b"".join(parts)

    def _parse(self, data) -> None:
        for field, wire, value in _fields(data):
            if field == 1 and wire == _LEN:
                self.tensors.append(Tensor.FromString(value))
            elif field == 2 and wire == _LEN:
                self.error = _text(value)


class HealthRequest(_Message):
    __slots__ = ()

    def SerializeToString(self) -> bytes:  # noqa: N802
        return b""

    def _parse(self, data) -> None:
        for _ in _fields(data):
            pass


class HealthResponse(_Message):
    __slots__ = ("status", "device", "solves")

    def __init__(self, status: str = "", device: str = "", solves: int = 0):
        self.status, self.device, self.solves = status, device, int(solves)

    def SerializeToString(self) -> bytes:  # noqa: N802
        parts = []
        if self.status:
            parts.append(_len_field(1, self.status.encode()))
        if self.device:
            parts.append(_len_field(2, self.device.encode()))
        if self.solves:
            parts.append(_key(3, _VARINT) + _varint(self.solves))
        return b"".join(parts)

    def _parse(self, data) -> None:
        for field, wire, value in _fields(data):
            if field == 1 and wire == _LEN:
                self.status = _text(value)
            elif field == 2 and wire == _LEN:
                self.device = _text(value)
            elif field == 3 and wire == _VARINT:
                self.solves = _int64(value)
