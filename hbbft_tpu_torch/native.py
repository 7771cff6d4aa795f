"""ctypes binding of the repo's C++ host library for the port.

``native/libhbbft_native.so`` (built from ``native/bls12_381.cpp`` and
``native/hbbft_native.cpp`` by ``make -C native``) is repo source
outside the JAX package.  This is the port's own binding of the calls
the share-verification flush, the DKG and the HoneyBadger epoch need —
G1/G2 products, the shared-base G1/G2 combs and the epoch's staging
matrix (``g1_mul_outer_raw``), the G1 and G2 MSMs and the many-MSM of
the Lagrange combines (``g1_msm_many_raw``), the G2 polynomial range
evaluation, the Fr matrix product, the product pairing check and
hash-to-G1; batched SHA-256 and Merkle levels; and the GF(2^8) and
GF(2^16) matrix products and inverses of the Reed–Solomon codecs — and
of the raw wire format:

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
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i32 = ctypes.c_int
    sigs = {
        "hb_sha256_many": ([u8p, u64p, u64, u8p], None),
        "hb_merkle_total_hashes": ([u64], u64),
        "hb_merkle_build": ([u8p, u64p, u64, u8p], None),
        "hb_gf_matmul": ([u8p, u8p, u8p, i32, i32, i32], None),
        "hb_gf_mat_inv": ([u8p, u8p, i32], i32),
        "hb_gf16_matmul": ([u16p, u16p, u16p, i32, i32, i32], None),
        "hb_gf16_mat_inv": ([u16p, u16p, i32], i32),
        "hb_g1_mul_outer": ([u64, u64, b, u8p, u8p], None),
        "hb_g1_msm_many": ([u64, u64, u8p, u8p, u8p], None),
        "hb_g2_poly_eval_range": ([u64, b, u64, b, u8p], None),
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


def _u16p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))


def _u64p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


# ---------------------------------------------------------------------------
# Hashing and erasure coding (native/hbbft_native.cpp)
# ---------------------------------------------------------------------------


def _concat_with_offsets(items: Sequence[bytes]):
    offsets = np.zeros(len(items) + 1, dtype=np.uint64)
    total = 0
    for i, it in enumerate(items):
        total += len(it)
        offsets[i + 1] = total
    data = (
        np.frombuffer(b"".join(items), dtype=np.uint8)
        if total
        else np.zeros(1, dtype=np.uint8)
    )
    return np.ascontiguousarray(data), offsets


def sha256_many(items: Sequence[bytes]) -> List[bytes]:
    """SHA-256 of every item in one native call."""
    data, offsets = _concat_with_offsets(items)
    out = np.empty(32 * len(items), dtype=np.uint8)
    _load().hb_sha256_many(_u8p(data), _u64p(offsets), len(items), _u8p(out))
    raw = out.tobytes()
    return [raw[32 * i : 32 * i + 32] for i in range(len(items))]


def merkle_levels(values: Sequence[bytes]) -> List[List[bytes]]:
    """Every level of the Merkle tree over ``values``, bottom first, odd
    levels already padded by their last hash (the ``levels`` of
    ``crypto.merkle.MerkleTree``)."""
    n = len(values)
    data, offsets = _concat_with_offsets(values)
    lib = _load()
    total = int(lib.hb_merkle_total_hashes(n))
    out = np.empty(32 * total, dtype=np.uint8)
    lib.hb_merkle_build(_u8p(data), _u64p(offsets), n, _u8p(out))
    raw = out.tobytes()
    levels: List[List[bytes]] = []
    pos = 0
    length = n
    while True:
        if length > 1 and (length & 1):
            length += 1
        levels.append([raw[32 * (pos + i) : 32 * (pos + i + 1)] for i in range(length)])
        pos += length
        if length <= 1:
            break
        length //= 2
    return levels


def _gf_operands(a: np.ndarray, b_: np.ndarray, dtype):
    a = np.ascontiguousarray(a, dtype=dtype)
    b_ = np.ascontiguousarray(b_, dtype=dtype)
    m, k = a.shape
    k2, n = b_.shape
    if k != k2:
        raise ValueError(f"shape mismatch: ({m},{k}) @ ({k2},{n})")
    return a, b_, np.empty((m, n), dtype=dtype)


def gf_matmul(a: np.ndarray, b_: np.ndarray) -> np.ndarray:
    """(m,k)·(k,n) GF(2^8) product."""
    a, b_, out = _gf_operands(a, b_, np.uint8)
    _load().hb_gf_matmul(_u8p(a), _u8p(b_), _u8p(out), *a.shape, b_.shape[1])
    return out


def gf_mat_inv(m: np.ndarray) -> np.ndarray:
    m = np.ascontiguousarray(m, dtype=np.uint8)
    out = np.empty_like(m)
    if _load().hb_gf_mat_inv(_u8p(m), _u8p(out), m.shape[0]) != 0:
        raise ValueError("matrix not invertible over GF(256)")
    return out


def gf16_matmul(a: np.ndarray, b_: np.ndarray) -> np.ndarray:
    """(m,k)·(k,n) GF(2^16) product."""
    a, b_, out = _gf_operands(a, b_, np.uint16)
    _load().hb_gf16_matmul(_u16p(a), _u16p(b_), _u16p(out), *a.shape, b_.shape[1])
    return out


def gf16_mat_inv(m: np.ndarray) -> np.ndarray:
    m = np.ascontiguousarray(m, dtype=np.uint16)
    out = np.empty_like(m)
    if _load().hb_gf16_mat_inv(_u16p(m), _u16p(out), m.shape[0]) != 0:
        raise ValueError("matrix not invertible over GF(2^16)")
    return out


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


def g1_mul_outer_raw(bases_wire: bytes, ks_be: np.ndarray) -> np.ndarray:
    """out[b][s] = ks[s]·base_b for every (base, scalar) pair in one
    native call (a fixed-base comb a base, one shared scalar buffer).
    ``bases_wire``: n_bases×96 B; ``ks_be``: uint8 n_scalars×32
    big-endian.  Returns the raw n_bases×n_scalars×96 wire buffer,
    base-major."""
    ks_be = np.ascontiguousarray(ks_be, dtype=np.uint8).reshape(-1)
    n_scalars = len(ks_be) // 32
    n_bases = len(bases_wire) // 96
    out = np.empty(n_bases * n_scalars * 96, dtype=np.uint8)
    _load().hb_g1_mul_outer(n_bases, n_scalars, bases_wire, _u8p(ks_be), _u8p(out))
    return out


def g1_msm_many_raw(
    n_msms: int, n_pts: int, pts_buf: np.ndarray, ks_be: np.ndarray
) -> np.ndarray:
    """Many G1 MSMs over ONE shared scalar vector (the Lagrange-combine
    shape).  ``pts_buf``: uint8 n_msms×n_pts×96 row-major; ``ks_be``:
    n_pts×32 big-endian.  Returns the raw n_msms×96 result buffer."""
    pts_buf = np.ascontiguousarray(pts_buf, dtype=np.uint8).reshape(-1)
    ks_be = np.ascontiguousarray(ks_be, dtype=np.uint8).reshape(-1)
    if len(pts_buf) != n_msms * n_pts * 96 or len(ks_be) != n_pts * 32:
        raise ValueError("g1_msm_many buffer shape mismatch")
    out = np.empty(n_msms * 96, dtype=np.uint8)
    _load().hb_g1_msm_many(n_msms, n_pts, _u8p(pts_buf), _u8p(ks_be), _u8p(out))
    return out


def g2_poly_eval_range(coeff_wires: Sequence[bytes], n: int, order: int) -> List[bytes]:
    """A G2-coefficient polynomial at x = 1..n (wires): direct MSMs for
    the first min(ncoeffs, n) points (scalar power rows mod ``order``
    computed here), the rest by native forward differences."""
    ncoeffs = len(coeff_wires)
    rows = []
    for i in range(min(ncoeffs, n)):
        x, acc = i + 1, 1
        for _ in range(ncoeffs):
            rows.append(acc.to_bytes(32, "big"))
            acc = acc * x % order
    out = np.empty(n * 192, dtype=np.uint8)
    _load().hb_g2_poly_eval_range(
        ncoeffs, b"".join(coeff_wires), n, b"".join(rows), _u8p(out)
    )
    raw = out.tobytes()
    return [raw[i * 192 : (i + 1) * 192] for i in range(n)]


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
