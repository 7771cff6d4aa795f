"""Canonical deterministic serialization — the encoding subset.

The port's own copy of the ``wire``/``dumps`` half of
``hbbft_tpu/core/serialize.py``: enough to encode points and
``Ciphertext.to_bytes`` byte-identically to the reference (cache keys of
the batching layer are built from these bytes).  Decoding is not part
of this slice.

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


# registry: class -> (name, to_fields); filled at import time only
_BY_CLASS: Dict[type, Tuple[str, Callable[[Any], tuple]]] = {}
_BY_NAME: Dict[str, type] = {}


def wire(name: str):
    """Class decorator registering a type for canonical serialization.

    For dataclasses the fields are used directly; other classes must
    provide ``_wire_fields(self) -> tuple``."""

    def deco(cls):
        if dataclasses.is_dataclass(cls):
            names = tuple(f.name for f in dataclasses.fields(cls))

            def to_fields(obj, _names=names):
                return tuple(getattr(obj, n) for n in _names)

        elif hasattr(cls, "_wire_fields"):

            def to_fields(obj):
                return obj._wire_fields()

        else:
            raise TypeError(
                f"{cls.__name__} must be a dataclass or define _wire_fields"
            )
        if name in _BY_NAME and _BY_NAME[name] is not cls:
            raise SerializationError(
                f"wire tag {name!r} already registered to "
                f"{_BY_NAME[name].__name__}"
            )
        _BY_CLASS[cls] = (name, to_fields)
        _BY_NAME[name] = cls
        return cls

    return deco


def _enc_len(n: int) -> bytes:
    if n < 0xFF:
        return bytes([n])
    return b"\xff" + struct.pack(">Q", n)


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
        name, to_fields = reg
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
