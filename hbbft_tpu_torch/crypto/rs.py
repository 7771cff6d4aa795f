"""Systematic Reed-Solomon erasure coding over GF(2^8) and GF(2^16).

The port's own copy of ``hbbft_tpu/crypto/rs.py``: the same systematic
matrices, so shards are byte-identical to the reference's.  The
reference replaces the ``reed-solomon-erasure`` crate
(``Cargo.toml:26``; encode at ``broadcast.rs:365-367``, reconstruct at
``broadcast.rs:643-656``).

Encoding is a GF(2^w) matrix multiply on the host (the native
library's ``gf_matmul``/``gf16_matmul`` when it is built, NumPy
otherwise).  The systematic generator matrix is a Vandermonde matrix
normalised so the top k×k block is the identity (Backblaze/Plank
construction, matching the reference crate's family).

The reference crate is GF(2^8)-only, capping reliable broadcast at 256
shards = 256 validators; :class:`ReedSolomon16` lifts the north-star
1024-validator configuration past that cap with 16-bit symbols (up to
65536 shards) under the identical construction.  :func:`make_codec`
picks the narrowest field that fits.

The f = 0 edge case (single data shard per node, no parity) mirrors the
reference's ``Coding::Trivial`` fallback (``broadcast.rs:596-658``).
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np

# --- GF(2^8) tables, primitive polynomial 0x11d, generator 3 ----------------

_EXP = np.zeros(512, dtype=np.uint8)
_LOG = np.zeros(256, dtype=np.int32)


def _build_tables() -> None:
    x = 1
    for i in range(255):
        _EXP[i] = x
        _LOG[x] = i
        x <<= 1
        if x & 0x100:
            x ^= 0x11D
    for i in range(255, 512):
        _EXP[i] = _EXP[i - 255]


_build_tables()


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_EXP[int(_LOG[a]) + int(_LOG[b])])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(256) inverse of 0")
    return int(_EXP[255 - int(_LOG[a])])


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(m,k)·(k,n) GF(2^8) matrix product, fully vectorised."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    la = _LOG[a]  # (m, k)
    lb = _LOG[b]  # (k, n)
    prod = _EXP[(la[:, :, None] + lb[None, :, :])]
    prod = np.where((a[:, :, None] == 0) | (b[None, :, :] == 0), 0, prod)
    return np.bitwise_xor.reduce(prod, axis=1).astype(np.uint8)


def _gf_mat_inv(m: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inversion over GF(2^8)."""
    n = m.shape[0]
    aug = np.concatenate([m.astype(np.uint8), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivot = None
        for row in range(col, n):
            if aug[row, col] != 0:
                pivot = row
                break
        if pivot is None:
            raise ValueError("matrix not invertible over GF(256)")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        inv_p = gf_inv(int(aug[col, col]))
        # scale pivot row
        row_vals = aug[col]
        scaled = np.where(
            row_vals == 0, 0, _EXP[_LOG[row_vals] + _LOG[inv_p]]
        ).astype(np.uint8)
        aug[col] = scaled
        for row in range(n):
            if row != col and aug[row, col] != 0:
                factor = int(aug[row, col])
                mult = np.where(
                    aug[col] == 0, 0, _EXP[_LOG[aug[col]] + _LOG[factor]]
                ).astype(np.uint8)
                aug[row] ^= mult
    return aug[:, n:]


def _matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(2^8) matmul via the C++ native library when loaded, else the
    vectorised NumPy path (the semantics oracle)."""
    from .. import native as _native

    if _native.available():
        return _native.gf_matmul(a, b)
    return gf_matmul(a, b)


def _mat_inv(m: np.ndarray) -> np.ndarray:
    from .. import native as _native

    if _native.available():
        return _native.gf_mat_inv(m)
    return _gf_mat_inv(m)


_MATRIX_CACHE: dict = {}


def _systematic_matrix(k: int, n: int) -> np.ndarray:
    """n×k systematic generator matrix (top k×k = identity)."""
    key = (k, n)
    cached = _MATRIX_CACHE.get(key)
    if cached is not None:
        return cached
    # Vandermonde rows: row i = [1, aᵢ, aᵢ², …] with distinct aᵢ = i.
    # Any k rows are linearly independent, so after normalisation any k
    # shards suffice for reconstruction.
    vand = np.zeros((n, k), dtype=np.uint8)
    for i in range(n):
        v = 1
        for j in range(k):
            vand[i, j] = v
            v = gf_mul(v, i)
    # normalise: M = V · (top k×k)^-1  → systematic
    top_inv = _gf_mat_inv(vand[:k, :k].copy())
    mat = gf_matmul(vand, top_inv)
    _MATRIX_CACHE[key] = mat
    return mat


class ReedSolomon:
    """Systematic RS codec: k data shards, n total (n−k parity).

    Same interface shape as the reference's ``Coding`` wrapper
    (``broadcast.rs:596-658``): ``encode`` fills parity from data,
    ``reconstruct`` recovers all shards from any k of them.
    """

    symbol = 1  # bytes per code symbol (shard lengths must be multiples)

    def __init__(self, data_shards: int, parity_shards: int):
        if data_shards < 1:
            raise ValueError("need at least one data shard")
        if data_shards + parity_shards > 256:
            raise ValueError("GF(256) supports at most 256 shards")
        self.k = data_shards
        self.m = parity_shards
        self.n = data_shards + parity_shards
        self.matrix = (
            _systematic_matrix(self.k, self.n) if parity_shards > 0 else None
        )
        self._dec_cache: dict = {}  # present-subset → inverted submatrix

    def decode_matrix(self, use: Sequence[int]) -> np.ndarray:
        key = tuple(use)
        dec = self._dec_cache.get(key)
        if dec is None:
            dec = _mat_inv(self.matrix[list(use), :].copy())
            if len(self._dec_cache) >= 16:
                self._dec_cache.pop(next(iter(self._dec_cache)))
            self._dec_cache[key] = dec
        return dec

    def encode(self, data: Sequence[bytes]) -> List[bytes]:
        """data: k equal-length shards → n shards (data ++ parity)."""
        if len(data) != self.k:
            raise ValueError(f"expected {self.k} data shards")
        if self.m == 0:
            return list(data)
        arr = np.frombuffer(b"".join(data), dtype=np.uint8).reshape(
            self.k, -1
        )
        parity = _matmul(self.matrix[self.k :], arr)
        return list(data) + [p.tobytes() for p in parity]

    def reconstruct(self, shards: List[Optional[bytes]]) -> List[bytes]:
        """Recover all n shards; ``shards[i] is None`` marks an erasure.
        Raises ValueError with fewer than k present."""
        if len(shards) != self.n:
            raise ValueError(f"expected {self.n} shard slots")
        present = [i for i, s in enumerate(shards) if s is not None]
        if len(present) < self.k:
            raise ValueError("not enough shards to reconstruct")
        if self.m == 0:
            return [s for s in shards]  # type: ignore[misc]
        use = present[: self.k]
        dec = self.decode_matrix(use)
        avail = np.stack(
            [np.frombuffer(shards[i], dtype=np.uint8) for i in use]
        )
        data = _matmul(dec, avail)
        # recompute only the erased rows (matches the GF(2^16) codec and
        # the device codecs; present shards pass through untouched)
        missing = [i for i, s in enumerate(shards) if s is None]
        out: List[Optional[bytes]] = list(shards)
        if missing:
            rec = _matmul(self.matrix[missing, :], data)
            for j, i in enumerate(missing):
                out[i] = rec[j].tobytes()
        return out  # type: ignore[return-value]


# --- GF(2^16), primitive polynomial 0x1100B, generator 3 ---------------------
# Same log/antilog construction as GF(2^8) above, with 16-bit symbols;
# tables are built lazily (65535 iterations) on first use of a >256-shard
# codec so the common reference-parity path pays nothing.

_EXP16: Optional[np.ndarray] = None
_LOG16: Optional[np.ndarray] = None
# the epoch driver's stage worker runs RS encodes concurrently with
# the main thread's decodes — the lazy build must not be torn
_TABLE16_LOCK = threading.Lock()


def _build_tables16() -> None:
    global _EXP16, _LOG16
    if _EXP16 is not None:
        return
    with _TABLE16_LOCK:
        if _EXP16 is not None:
            return
        exp = np.zeros(2 * 65535, dtype=np.uint16)
        log = np.zeros(65536, dtype=np.int32)
        x = 1
        for i in range(65535):
            exp[i] = x
            log[x] = i
            x <<= 1
            if x & 0x10000:
                x ^= 0x1100B
        exp[65535:] = exp[:65535]
        # publish LOG16 first: readers gate on _EXP16 being non-None
        _LOG16 = log
        _EXP16 = exp


def gf16_mul(a: int, b: int) -> int:
    _build_tables16()
    if a == 0 or b == 0:
        return 0
    return int(_EXP16[int(_LOG16[a]) + int(_LOG16[b])])


def gf16_inv(a: int) -> int:
    _build_tables16()
    if a == 0:
        raise ZeroDivisionError("GF(2^16) inverse of 0")
    return int(_EXP16[65535 - int(_LOG16[a])])


def gf16_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(m,k)·(k,n) GF(2^16) matrix product, chunked over rows so the
    (rows, k, n) log-sum intermediate stays within a fixed memory
    budget at bench shapes (e.g. 682×342 times 342×500k symbols for a
    1 MB broadcast at n=1024)."""
    _build_tables16()
    a = np.asarray(a, dtype=np.uint16)
    b = np.asarray(b, dtype=np.uint16)
    m, k = a.shape
    n = b.shape[1]
    out = np.zeros((m, n), dtype=np.uint16)
    lb = _LOG16[b]  # (k, n)
    bz = b == 0  # (k, n)
    # ~32M int32 intermediate elements per chunk
    rows = max(1, (32 << 20) // max(1, k * n))
    for r0 in range(0, m, rows):
        sl = slice(r0, min(r0 + rows, m))
        la = _LOG16[a[sl]]  # (r, k)
        prod = _EXP16[(la[:, :, None] + lb[None, :, :])]
        prod = np.where((a[sl][:, :, None] == 0) | bz[None, :, :], 0, prod)
        out[sl] = np.bitwise_xor.reduce(prod, axis=1)
    return out


def _gf16_mat_inv(m: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inversion over GF(2^16)."""
    _build_tables16()
    n = m.shape[0]
    aug = np.concatenate(
        [m.astype(np.uint16), np.eye(n, dtype=np.uint16)], axis=1
    )
    for col in range(n):
        pivot = None
        for row in range(col, n):
            if aug[row, col] != 0:
                pivot = row
                break
        if pivot is None:
            raise ValueError("matrix not invertible over GF(2^16)")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        inv_p = gf16_inv(int(aug[col, col]))
        row_vals = aug[col]
        scaled = np.where(
            row_vals == 0, 0, _EXP16[_LOG16[row_vals] + _LOG16[inv_p]]
        ).astype(np.uint16)
        aug[col] = scaled
        for row in range(n):
            if row != col and aug[row, col] != 0:
                factor = int(aug[row, col])
                mult = np.where(
                    aug[col] == 0, 0, _EXP16[_LOG16[aug[col]] + _LOG16[factor]]
                ).astype(np.uint16)
                aug[row] ^= mult
    return aug[:, n:]


def _matmul16(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(2^16) matmul via the C++ native library (AVX2 nibble-table
    row kernel) when loaded, else the chunked NumPy oracle."""
    from .. import native as _native

    if _native.available():
        return _native.gf16_matmul(a, b)
    return gf16_matmul(a, b)


def _mat_inv16(m: np.ndarray) -> np.ndarray:
    from .. import native as _native

    if _native.available():
        return _native.gf16_mat_inv(m)
    return _gf16_mat_inv(m)


_MATRIX16_CACHE: dict = {}


def _systematic_matrix16(k: int, n: int) -> np.ndarray:
    """n×k systematic generator matrix over GF(2^16)."""
    key = (k, n)
    cached = _MATRIX16_CACHE.get(key)
    if cached is not None:
        return cached
    _build_tables16()
    vand = np.zeros((n, k), dtype=np.uint16)
    for i in range(n):
        v = 1
        for j in range(k):
            vand[i, j] = v
            v = gf16_mul(v, i)
    top_inv = _gf16_mat_inv(vand[:k, :k].copy())
    mat = gf16_matmul(vand, top_inv)
    _MATRIX16_CACHE[key] = mat
    return mat


class ReedSolomon16:
    """Systematic RS codec over GF(2^16): up to 65536 shards.

    Interface-identical to :class:`ReedSolomon`; shard byte lengths must
    be multiples of ``symbol`` = 2 (the broadcast framing rounds shard
    sizes up to the codec's symbol, ``protocols/broadcast.py``).
    """

    symbol = 2

    def __init__(self, data_shards: int, parity_shards: int):
        if data_shards < 1:
            raise ValueError("need at least one data shard")
        if data_shards + parity_shards > 65536:
            raise ValueError("GF(2^16) supports at most 65536 shards")
        self.k = data_shards
        self.m = parity_shards
        self.n = data_shards + parity_shards
        self.matrix = (
            _systematic_matrix16(self.k, self.n) if parity_shards > 0 else None
        )
        # decode matrices keyed by the present-shard subset: a co-simulated
        # epoch decodes N broadcasts against one erasure pattern, and the
        # O(k³) Gauss-Jordan dominated the profile without this
        self._dec_cache: dict = {}

    def decode_matrix(self, use: Sequence[int]) -> np.ndarray:
        key = tuple(use)
        dec = self._dec_cache.get(key)
        if dec is None:
            dec = _mat_inv16(self.matrix[list(use), :].copy())
            if len(self._dec_cache) >= 16:
                self._dec_cache.pop(next(iter(self._dec_cache)))
            self._dec_cache[key] = dec
        return dec

    def _to_syms(self, shard: bytes) -> np.ndarray:
        if len(shard) % 2:
            raise ValueError(
                "GF(2^16) shards must have even byte length "
                f"(got {len(shard)})"
            )
        return np.frombuffer(shard, dtype="<u2")

    def encode(self, data: Sequence[bytes]) -> List[bytes]:
        """data: k equal-length shards → n shards (data ++ parity)."""
        if len(data) != self.k:
            raise ValueError(f"expected {self.k} data shards")
        if self.m == 0:
            return list(data)
        arr = np.stack([self._to_syms(s) for s in data])
        parity = _matmul16(self.matrix[self.k :], arr)
        return list(data) + [
            p.astype("<u2").tobytes() for p in parity
        ]

    def reconstruct(self, shards: List[Optional[bytes]]) -> List[bytes]:
        """Recover all n shards; ``shards[i] is None`` marks an erasure."""
        if len(shards) != self.n:
            raise ValueError(f"expected {self.n} shard slots")
        present = [i for i, s in enumerate(shards) if s is not None]
        if len(present) < self.k:
            raise ValueError("not enough shards to reconstruct")
        if self.m == 0:
            return [s for s in shards]  # type: ignore[misc]
        use = present[: self.k]
        dec = self.decode_matrix(use)
        avail = np.stack([self._to_syms(shards[i]) for i in use])
        data = _matmul16(dec, avail)
        missing = [i for i, s in enumerate(shards) if s is None]
        out: List[Optional[bytes]] = list(shards)
        if missing:
            rec = _matmul16(self.matrix[missing, :], data)
            for j, i in enumerate(missing):
                out[i] = rec[j].astype("<u2").tobytes()
        return out  # type: ignore[return-value]


def make_codec(data_shards: int, parity_shards: int):
    """The narrowest field that fits ``data+parity`` shards: GF(2^8)
    (byte-compatible with the reference crate) up to 256, GF(2^16)
    beyond — the north-star N=1024 broadcast path."""
    if data_shards + parity_shards <= 256:
        return ReedSolomon(data_shards, parity_shards)
    return ReedSolomon16(data_shards, parity_shards)
