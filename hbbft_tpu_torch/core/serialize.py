"""Canonical deterministic serialization.

The port's own copy of ``hbbft_tpu/core/serialize.py``: the ``@wire``
registry, ``dumps`` and ``loads``, with the reference's tag bytes and
byte layout, so a contribution, a ciphertext or a point encodes to the
same bytes in both packages (the epoch ships contributions ``dumps``-ed
inside ciphertexts and RBC payloads, and cache keys of the batching
layer are built from these bytes).

- fixed tag byte per type;
- integers as sign byte + big-endian magnitude with minimal length;
- maps sorted by encoded key bytes (canonical ordering);
- registered classes encode as ``tag || field values``.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Callable, Dict, Tuple

_TAG_NONE = b"\x00"
_TAG_FALSE = b"\x01"
_TAG_TRUE = b"\x02"
_TAG_INT_POS = b"\x03"
_TAG_INT_NEG = b"\x04"
_TAG_BYTES = b"\x05"
_TAG_STR = b"\x06"
_TAG_LIST = b"\x07"
_TAG_DICT = b"\x08"
_TAG_OBJ = b"\x09"
_TAG_TUPLE = b"\x0a"


class SerializationError(Exception):
    pass


# Maximum nesting depth accepted by the decoder: honest payloads are a
# handful of levels deep, a crafted frame of nested list headers would
# otherwise recurse until the interpreter dies.
_MAX_DECODE_DEPTH = 64

# registry: class -> (name, to_fields, from_fields); filled at import time
_BY_CLASS: Dict[type, Tuple[str, Callable[[Any], tuple], Callable[..., Any]]] = {}
_BY_NAME: Dict[str, Tuple[type, Callable[..., Any]]] = {}


def wire(name: str):
    """Class decorator registering a type for canonical serialization.

    For dataclasses the fields are used directly; other classes must
    provide ``_wire_fields(self) -> tuple`` and ``_from_wire(cls, *fields)``."""

    def deco(cls):
        if dataclasses.is_dataclass(cls):
            names = tuple(f.name for f in dataclasses.fields(cls))

            def to_fields(obj, _names=names):
                return tuple(getattr(obj, n) for n in _names)

            def from_fields(*vals):
                return cls(*vals)

        elif hasattr(cls, "_wire_fields") and hasattr(cls, "_from_wire"):

            def to_fields(obj):
                return obj._wire_fields()

            def from_fields(*vals):
                return cls._from_wire(*vals)

        else:
            raise TypeError(
                f"{cls.__name__} must be a dataclass or define _wire_fields/_from_wire"
            )
        if name in _BY_NAME and _BY_NAME[name][0] is not cls:
            raise SerializationError(
                f"wire tag {name!r} already registered to "
                f"{_BY_NAME[name][0].__name__}"
            )
        if cls in _BY_CLASS and _BY_CLASS[cls][0] != name:
            raise SerializationError(
                f"{cls.__name__} already registered as wire tag {_BY_CLASS[cls][0]!r}"
            )
        _BY_CLASS[cls] = (name, to_fields, from_fields)
        _BY_NAME[name] = (cls, from_fields)
        return cls

    return deco


def _enc_len(n: int) -> bytes:
    if n < 0xFF:
        return bytes([n])
    return b"\xff" + struct.pack(">Q", n)


def _dec_len(buf: bytes, pos: int) -> Tuple[int, int]:
    b0 = buf[pos]
    if b0 < 0xFF:
        return b0, pos + 1
    return struct.unpack_from(">Q", buf, pos + 1)[0], pos + 9


def _encode(obj: Any, out: list) -> None:
    if obj is None:
        out.append(_TAG_NONE)
    elif obj is True:
        out.append(_TAG_TRUE)
    elif obj is False:
        out.append(_TAG_FALSE)
    elif isinstance(obj, int):
        tag, m = (_TAG_INT_POS, obj) if obj >= 0 else (_TAG_INT_NEG, -obj)
        mag = m.to_bytes((m.bit_length() + 7) // 8 or 1, "big")
        out.append(tag + _enc_len(len(mag)) + mag)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        out.append(_TAG_BYTES + _enc_len(len(b)) + b)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(_TAG_STR + _enc_len(len(b)) + b)
    elif isinstance(obj, (list, tuple)):
        tag = _TAG_LIST if isinstance(obj, list) else _TAG_TUPLE
        out.append(tag + _enc_len(len(obj)))
        for item in obj:
            _encode(item, out)
    elif isinstance(obj, dict):
        items = sorted(
            ((dumps(k), v) for k, v in obj.items()), key=lambda kv: kv[0]
        )
        out.append(_TAG_DICT + _enc_len(len(items)))
        for kb, v in items:
            out.append(kb)
            _encode(v, out)
    else:
        reg = _BY_CLASS.get(type(obj))
        if reg is None:
            raise SerializationError(f"unserializable type: {type(obj).__name__}")
        name, to_fields, _ = reg
        nb = name.encode("ascii")
        fields = to_fields(obj)
        out.append(_TAG_OBJ + _enc_len(len(nb)) + nb + _enc_len(len(fields)))
        for f in fields:
            _encode(f, out)


def dumps(obj: Any) -> bytes:
    """Serialize ``obj`` to canonical bytes (equal objects always yield
    equal bytes — safe to sign and to key caches by)."""
    out: list = []
    _encode(obj, out)
    return b"".join(out)


def _decode(buf: bytes, pos: int, depth: int = 0) -> Tuple[Any, int]:
    if depth > _MAX_DECODE_DEPTH:
        raise SerializationError("nesting too deep")
    tag = buf[pos : pos + 1]
    pos += 1
    if tag == _TAG_NONE:
        return None, pos
    if tag == _TAG_TRUE:
        return True, pos
    if tag == _TAG_FALSE:
        return False, pos
    if tag in (_TAG_INT_POS, _TAG_INT_NEG):
        n, pos = _dec_len(buf, pos)
        mag = int.from_bytes(buf[pos : pos + n], "big")
        return (mag if tag == _TAG_INT_POS else -mag), pos + n
    if tag == _TAG_BYTES:
        n, pos = _dec_len(buf, pos)
        return bytes(buf[pos : pos + n]), pos + n
    if tag == _TAG_STR:
        n, pos = _dec_len(buf, pos)
        return buf[pos : pos + n].decode("utf-8"), pos + n
    if tag in (_TAG_LIST, _TAG_TUPLE):
        n, pos = _dec_len(buf, pos)
        items = []
        for _ in range(n):
            item, pos = _decode(buf, pos, depth + 1)
            items.append(item)
        return (items if tag == _TAG_LIST else tuple(items)), pos
    if tag == _TAG_DICT:
        n, pos = _dec_len(buf, pos)
        d = {}
        for _ in range(n):
            k, pos = _decode(buf, pos, depth + 1)
            v, pos = _decode(buf, pos, depth + 1)
            d[k] = v
        return d, pos
    if tag == _TAG_OBJ:
        n, pos = _dec_len(buf, pos)
        name = buf[pos : pos + n].decode("ascii")
        pos += n
        nf, pos = _dec_len(buf, pos)
        reg = _BY_NAME.get(name)
        if reg is None:
            raise SerializationError(f"unknown wire tag {name!r}")
        fields = []
        for _ in range(nf):
            f, pos = _decode(buf, pos, depth + 1)
            fields.append(f)
        return reg[1](*fields), pos
    raise SerializationError(f"bad tag byte {tag!r} at {pos - 1}")


def loads(buf: bytes) -> Any:
    """Decode canonical bytes.  Any malformed input — truncation, bad
    UTF-8/ASCII, a wrong-arity object frame, a constructor rejecting a
    field, excessive nesting, trailing bytes — raises
    :class:`SerializationError`."""
    try:
        obj, pos = _decode(buf, 0)
    except SerializationError:
        raise
    except Exception as exc:
        raise SerializationError(
            f"malformed input ({type(exc).__name__}: {exc})"
        ) from exc
    if pos != len(buf):
        raise SerializationError(f"trailing bytes after position {pos}")
    return obj
