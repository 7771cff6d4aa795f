"""ctypes binding of the repo's C++ host library for the port.

``native/libhbbft_native.so`` (built from ``native/bls12_381.cpp`` and
``native/hbbft_native.cpp`` by ``make -C native``) is repo source
outside the JAX package.  This is the port's own binding of the calls
the share-verification flush and the DKG need — G1/G2 products, the
shared-base G1/G2 combs, the G1 and G2 MSMs, the Fr matrix product, the
product pairing check and hash-to-G1 — and of the raw wire format:

- G1: 96 bytes ``x || y`` big-endian affine, all-zero = infinity;
- G2: 192 bytes ``x.c0 || x.c1 || y.c0 || y.c1``, all-zero = infinity;
- scalars: 32 bytes big-endian (callers reduce mod r first).

The library is built with ``make`` on first use when it is missing
(an ``fcntl`` lock serialises concurrent builders).  Without a library
:func:`backend` returns ``None`` and the crypto modules take their
pure-Python host paths; nothing here touches the device.
"""

from __future__ import annotations

import ctypes
import fcntl
import pathlib
import subprocess
import sys
import threading
from typing import List, Optional, Sequence

import numpy as np

NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent / "native"
SO_PATH = NATIVE_DIR / "libhbbft_native.so"

_lib: Optional[ctypes.CDLL] = None
_tried = False
_LOAD_LOCK = threading.Lock()


def build() -> bool:
    """Run ``make -C native`` (a no-op when up to date).  Returns True
    when the shared library exists afterwards."""
    if not (NATIVE_DIR / "Makefile").exists():
        return SO_PATH.exists()
    with open(NATIVE_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run(
            ["make", "-C", str(NATIVE_DIR)],
            check=True,
            capture_output=True,
            timeout=600,
        )
    return SO_PATH.exists()


def _bind(cdll: ctypes.CDLL) -> ctypes.CDLL:
    b = ctypes.c_char_p
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64 = ctypes.c_uint64
    sigs = {
        "hb_g1_mul": ([b, b, u8p], None),
        "hb_g2_mul": ([b, b, u8p], None),
        "hb_g1_mul_many": ([u64, b, b, u8p], None),
        "hb_g2_mul_many": ([u64, b, u8p, u8p], None),
        "hb_fr_matmul": ([u64, u64, u64, u8p, u8p, u8p], None),
        "hb_g1_msm": ([u64, b, b, u8p], None),
        "hb_g2_msm": ([u64, b, b, u8p], None),
        "hb_pairing_check": ([u64, b, b], ctypes.c_int),
        "hb_hash_to_g1": ([b, u64, b, u64, u8p], None),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(cdll, name)
        fn.argtypes = args
        fn.restype = res
    return cdll


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _LOAD_LOCK:
        if not _tried:
            _tried = True
            try:
                ok = SO_PATH.exists() or build()
            except (OSError, subprocess.SubprocessError) as exc:
                print(f"native: build failed ({exc})", file=sys.stderr)
                ok = False
            if ok:
                _lib = _bind(ctypes.CDLL(str(SO_PATH)))
    return _lib


def available() -> bool:
    return _load() is not None


def backend():
    """This module when the native library is usable, else None — the
    single dispatch gate for the host crypto fast paths."""
    return sys.modules[__name__] if available() else None


def _u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


# ---------------------------------------------------------------------------
# Wire helpers
# ---------------------------------------------------------------------------

G1_INF = bytes(96)
G2_INF = bytes(192)


def g1_wire(pt) -> bytes:
    w = getattr(pt, "_wire", None)
    if w is not None and len(w) == 96:  # a cached G2 wire must not pass
        return w
    a = pt.affine()
    w = G1_INF if a is None else a[0].to_bytes(48, "big") + a[1].to_bytes(48, "big")
    try:
        pt._wire = w
    except AttributeError:  # assignment-restricted stand-ins
        pass
    return w


def g1_unwire(raw: bytes, cls):
    if raw == G1_INF:
        return cls.infinity()
    return cls((int.from_bytes(raw[:48], "big"), int.from_bytes(raw[48:96], "big"), 1))


def g2_wire(pt) -> bytes:
    w = getattr(pt, "_wire", None)
    if w is not None and len(w) == 192:
        return w
    a = pt.affine()
    if a is None:
        w = G2_INF
    else:
        (x0, x1), (y0, y1) = a
        w = b"".join(v.to_bytes(48, "big") for v in (x0, x1, y0, y1))
    try:
        pt._wire = w
    except AttributeError:
        pass
    return w


def g2_unwire(raw: bytes, cls):
    if raw == G2_INF:
        return cls.infinity()
    v = [int.from_bytes(raw[i * 48 : (i + 1) * 48], "big") for i in range(4)]
    return cls(((v[0], v[1]), (v[2], v[3]), (1, 0)))


# ---------------------------------------------------------------------------
# BLS12-381 calls (native/bls12_381.cpp)
# ---------------------------------------------------------------------------


def g1_mul(pt_wire: bytes, k: int) -> bytes:
    out = np.empty(96, dtype=np.uint8)
    _load().hb_g1_mul(pt_wire, int(k).to_bytes(32, "big"), _u8p(out))
    return out.tobytes()


def g2_mul(pt_wire: bytes, k: int) -> bytes:
    out = np.empty(192, dtype=np.uint8)
    _load().hb_g2_mul(pt_wire, int(k).to_bytes(32, "big"), _u8p(out))
    return out.tobytes()


def g1_mul_many(pt_wire: bytes, ks: Sequence[int]) -> List[bytes]:
    """[k₀·P, k₁·P, …] for ONE shared base in one native call."""
    n = len(ks)
    out = np.empty(n * 96, dtype=np.uint8)
    kbuf = b"".join(int(k).to_bytes(32, "big") for k in ks)
    _load().hb_g1_mul_many(n, pt_wire, kbuf, _u8p(out))
    raw = out.tobytes()
    return [raw[i * 96 : (i + 1) * 96] for i in range(n)]


def g2_mul_many_raw(pt_wire: bytes, ks_be: np.ndarray) -> np.ndarray:
    """[k₀·P, k₁·P, …] for ONE shared G2 base via the fixed-base comb.
    ``ks_be``: uint8 array of n×32 big-endian scalars; returns the raw
    n×192 wire buffer."""
    ks_be = np.ascontiguousarray(ks_be, dtype=np.uint8).reshape(-1)
    n = len(ks_be) // 32
    out = np.empty(n * 192, dtype=np.uint8)
    _load().hb_g2_mul_many(n, pt_wire, _u8p(ks_be), _u8p(out))
    return out


def fr_matmul(a: np.ndarray, b_: np.ndarray, n: int, k: int, m: int) -> np.ndarray:
    """[n×k]·[k×m] over the scalar field Fr — entries are 32-byte
    big-endian scalars in flat uint8 buffers."""
    a = np.ascontiguousarray(a, dtype=np.uint8).reshape(-1)
    b_ = np.ascontiguousarray(b_, dtype=np.uint8).reshape(-1)
    if len(a) != n * k * 32 or len(b_) != k * m * 32:
        raise ValueError("fr_matmul buffer shape mismatch")
    out = np.empty(n * m * 32, dtype=np.uint8)
    _load().hb_fr_matmul(n, k, m, _u8p(a), _u8p(b_), _u8p(out))
    return out


def _msm(fn, width: int, pts_wire: Sequence[bytes], scalars: Sequence[int]) -> bytes:
    if len(pts_wire) != len(scalars):
        raise ValueError(
            f"msm length mismatch: {len(pts_wire)} points, {len(scalars)} scalars"
        )
    out = np.empty(width, dtype=np.uint8)
    fn(
        len(pts_wire),
        b"".join(pts_wire),
        b"".join(int(k).to_bytes(32, "big") for k in scalars),
        _u8p(out),
    )
    return out.tobytes()


def g1_msm(pts_wire: Sequence[bytes], scalars: Sequence[int]) -> bytes:
    return _msm(_load().hb_g1_msm, 96, pts_wire, scalars)


def g2_msm(pts_wire: Sequence[bytes], scalars: Sequence[int]) -> bytes:
    return _msm(_load().hb_g2_msm, 192, pts_wire, scalars)


def pairing_check(g1s_wire: Sequence[bytes], g2s_wire: Sequence[bytes]) -> bool:
    return bool(
        _load().hb_pairing_check(
            len(g1s_wire), b"".join(g1s_wire), b"".join(g2s_wire)
        )
    )


def hash_to_g1_bytes(msg: bytes, dst: bytes) -> bytes:
    if len(dst) > 255:
        raise OverflowError("domain separation tag longer than 255 bytes")
    out = np.empty(96, dtype=np.uint8)
    _load().hb_hash_to_g1(msg, len(msg), dst, len(dst), _u8p(out))
    return out.tobytes()
