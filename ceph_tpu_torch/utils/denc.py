"""denc — data-only, versioned binary encoding for wire and disk.

The analog of the reference's encode/decode discipline
(src/include/encoding.h and the per-struct
``encode(..., bufferlist&)`` + ``DECODE_START(v, bl)`` idiom): every
frame is explicit, versioned, and decoding hostile bytes can only ever
produce plain data or a registered struct type — never code execution
(unlike pickle, which this replaces).

Model:
  * primitives: None, bool, int (zigzag varint), float, bytes, str,
    list, tuple, dict, set, numpy ndarray (dtype+shape+raw bytes);
  * struct types opt in via ``@denc_type`` and are encoded as
    (type name, version, field dict). Decode looks the name up in the
    registry — unknown names and bad tags raise ``DencError``;
  * versioning: a class bumps ``DENC_VERSION`` when its fields change;
    decode of a *newer* version than the running code raises (same
    contract as DECODE_START's compat check); decode of an *older*
    version calls ``_denc_upgrade(fields, version)`` — which must be a
    ``@staticmethod`` (or classmethod): it runs before any instance
    exists.

Corrupt or truncated input raises ``DencError`` — never an arbitrary
exception from deep inside, and never attribute access on untrusted
objects.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np


class DencError(ValueError):
    pass


# one-byte tags
T_NONE = 0x00
T_TRUE = 0x01
T_FALSE = 0x02
T_INT = 0x03
T_FLOAT = 0x04
T_BYTES = 0x05
T_STR = 0x06
T_LIST = 0x07
T_TUPLE = 0x08
T_DICT = 0x09
T_SET = 0x0A
T_NDARRAY = 0x0B
T_OBJ = 0x0C

_F64 = struct.Struct("<d")

_registry: dict[str, type] = {}


def denc_type(klass: type) -> type:
    """Class decorator: make a struct type encodable/decodable.

    Encodes the instance ``__dict__`` (minus keys starting with "_").
    Override points: ``DENC_VERSION`` (int, default 1),
    ``_denc_fields()`` -> dict, ``_denc_upgrade(fields, version)``.
    """
    name = klass.__name__
    existing = _registry.get(name)
    if existing is not None and existing is not klass:
        raise ValueError(f"denc type name collision: {name}")
    _registry[name] = klass
    return klass


def _uvarint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _big(n: int) -> int:
    # arbitrary-precision zigzag: non-negatives even, negatives odd
    return (n << 1) if n >= 0 else ((-n) << 1) - 1


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _encode(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(T_NONE)
    elif obj is True:
        out.append(T_TRUE)
    elif obj is False:
        out.append(T_FALSE)
    elif type(obj) is int:
        out.append(T_INT)
        out += _uvarint(_big(obj))
    elif type(obj) is float:
        out.append(T_FLOAT)
        out += _F64.pack(obj)
    elif type(obj) is bytes or type(obj) is bytearray or \
            type(obj) is memoryview:
        b = bytes(obj)
        out.append(T_BYTES)
        out += _uvarint(len(b))
        out += b
    elif type(obj) is str:
        b = obj.encode("utf-8")
        out.append(T_STR)
        out += _uvarint(len(b))
        out += b
    elif type(obj) is list:
        out.append(T_LIST)
        out += _uvarint(len(obj))
        for v in obj:
            _encode(v, out)
    elif type(obj) is tuple:
        out.append(T_TUPLE)
        out += _uvarint(len(obj))
        for v in obj:
            _encode(v, out)
    elif type(obj) is dict:
        out.append(T_DICT)
        out += _uvarint(len(obj))
        for k, v in obj.items():
            _encode(k, out)
            _encode(v, out)
    elif type(obj) is set or type(obj) is frozenset:
        out.append(T_SET)
        out += _uvarint(len(obj))
        for v in obj:
            _encode(v, out)
    elif isinstance(obj, np.integer):
        out.append(T_INT)
        out += _uvarint(_big(int(obj)))
    elif isinstance(obj, np.floating):
        out.append(T_FLOAT)
        out += _F64.pack(float(obj))
    elif isinstance(obj, np.ndarray):
        dt = obj.dtype.str.encode()
        raw = np.ascontiguousarray(obj).tobytes()
        out.append(T_NDARRAY)
        out += _uvarint(len(dt))
        out += dt
        out += _uvarint(obj.ndim)
        for d in obj.shape:
            out += _uvarint(d)
        out += _uvarint(len(raw))
        out += raw
    else:
        klass = type(obj)
        if _registry.get(klass.__name__) is not klass:
            raise DencError(
                f"type {klass.__name__} is not denc-encodable "
                f"(register with @denc_type)")
        if hasattr(obj, "_denc_fields"):
            fields = obj._denc_fields()
        elif isinstance(obj, tuple) and hasattr(klass, "_fields"):
            fields = dict(zip(klass._fields, obj))   # NamedTuple
        else:
            fields = {k: v for k, v in obj.__dict__.items()
                      if not k.startswith("_")}
        name = klass.__name__.encode()
        out.append(T_OBJ)
        out += _uvarint(len(name))
        out += name
        out += _uvarint(getattr(klass, "DENC_VERSION", 1))
        _encode(fields, out)


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise DencError("truncated input")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def byte(self) -> int:
        if self.pos >= len(self.buf):
            raise DencError("truncated input")
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def uvarint(self) -> int:
        shift = 0
        n = 0
        while True:
            b = self.byte()
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                return n
            shift += 7
            if shift > 600:
                raise DencError("varint too long")


def _decode(r: _Reader, depth: int = 0) -> Any:
    if depth > 100:
        raise DencError("nesting too deep")
    tag = r.byte()
    if tag == T_NONE:
        return None
    if tag == T_TRUE:
        return True
    if tag == T_FALSE:
        return False
    if tag == T_INT:
        return _unzigzag(r.uvarint())
    if tag == T_FLOAT:
        return _F64.unpack(r.take(8))[0]
    if tag == T_BYTES:
        return r.take(r.uvarint())
    if tag == T_STR:
        try:
            return r.take(r.uvarint()).decode("utf-8")
        except UnicodeDecodeError as e:
            raise DencError(f"bad utf-8: {e}") from None
    if tag == T_LIST:
        return [_decode(r, depth + 1) for _ in range(r.uvarint())]
    if tag == T_TUPLE:
        return tuple(_decode(r, depth + 1) for _ in range(r.uvarint()))
    if tag == T_DICT:
        n = r.uvarint()
        d = {}
        for _ in range(n):
            k = _decode(r, depth + 1)
            try:
                d[k] = _decode(r, depth + 1)
            except TypeError as e:
                raise DencError(f"unhashable dict key: {e}") from None
        return d
    if tag == T_SET:
        try:
            return {_decode(r, depth + 1) for _ in range(r.uvarint())}
        except TypeError as e:
            raise DencError(f"unhashable set member: {e}") from None
    if tag == T_NDARRAY:
        dt = r.take(r.uvarint()).decode("ascii", "replace")
        try:
            dtype = np.dtype(dt)
        except TypeError as e:
            raise DencError(f"bad dtype {dt!r}: {e}") from None
        if dtype.hasobject:
            raise DencError("object dtypes are not decodable")
        ndim = r.uvarint()
        if ndim > 32:
            raise DencError("too many dimensions")
        shape = tuple(r.uvarint() for _ in range(ndim))
        raw = r.take(r.uvarint())
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if dtype.itemsize * count != len(raw):
            raise DencError("ndarray payload size mismatch")
        return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
    if tag == T_OBJ:
        name = r.take(r.uvarint()).decode("utf-8", "replace")
        version = r.uvarint()
        klass = _registry.get(name)
        if klass is None:
            raise DencError(f"unknown denc type {name!r}")
        fields = _decode(r, depth + 1)
        if not isinstance(fields, dict):
            raise DencError(f"bad field container for {name}")
        code_version = getattr(klass, "DENC_VERSION", 1)
        if version > code_version:
            raise DencError(
                f"{name} v{version} is newer than supported v{code_version}")
        if version < code_version:
            upgrade = getattr(klass, "_denc_upgrade", None)
            if upgrade is None:
                raise DencError(
                    f"{name} v{version} has no upgrade path to "
                    f"v{code_version}")
            try:
                fields = upgrade(fields, version)
            except TypeError as e:
                raise DencError(
                    f"{name}._denc_upgrade must be a "
                    f"staticmethod/classmethod taking (fields, version): "
                    f"{e}") from None
            if not isinstance(fields, dict):
                raise DencError(f"{name}._denc_upgrade returned non-dict")
        if isinstance(klass, type) and issubclass(klass, tuple) and \
                hasattr(klass, "_fields"):
            try:
                return klass(**fields)               # NamedTuple
            except TypeError as e:
                raise DencError(f"bad fields for {name}: {e}") from None
        obj = klass.__new__(klass)
        obj.__dict__.update(fields)
        if hasattr(obj, "_denc_finish"):
            obj._denc_finish()
        return obj
    raise DencError(f"bad tag 0x{tag:02x}")


def dumps(obj: Any) -> bytes:
    out = bytearray()
    _encode(obj, out)
    return bytes(out)


def loads(buf: bytes) -> Any:
    r = _Reader(bytes(buf))
    obj = _decode(r)
    if r.pos != len(r.buf):
        raise DencError(f"{len(r.buf) - r.pos} trailing bytes")
    return obj
