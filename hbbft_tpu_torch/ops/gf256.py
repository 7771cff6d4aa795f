"""GF(2^8) and GF(2^16) Reed–Solomon products on the device: the
``gf_matmul`` kernel, its plain PyTorch version and the device codecs.

The port of ``hbbft_tpu/ops/gf256_jax.py`` (XLA programs, not Pallas
kernels), the device side of ``crypto/rs.py`` (encode at
``broadcast.rs:365-367``, reconstruct at ``:643-656``).  Multiplication
by a constant GF(2^W) matrix is GF(2)-linear in the input bits, so an
``[m, k]`` product lowers to a binary ``[W·m, W·k]`` matrix
(:func:`_binary_matrix`, :func:`_binary_matrix16`) times the unpacked
input bits, with the parity of each sum as the output's bits.

- :func:`gf_matmul_plain` is the reference's bit-sliced product in
  torch: unpack, matmul, ``& 1``, pack.  PyTorch has no integer matmul
  on the card, so the sums (at most W·k) are taken in float64, exact.
- :func:`gf_matmul` is the kernel's wrapper (``csrc/gf_matmul.cu``,
  ``W`` = 8 or 16 from the matrix's dtype): the same product on the int8
  tensor cores, the binary expansion as u8 bytes of 0 or 1 built on the
  card from the W constants ``M[i, j]·2^b`` of each entry (the columns of
  the binary block, from the port's ``crypto/rs.py`` tables) and kept
  there per matrix in the kernel's operand order (:func:`abin_tiles`),
  the data's bits made inside the kernel.  On a CUDA tensor it launches
  (or raises — never a fallback) and counts
  ``cuda_ec.LAUNCHES["gf_matmul"]``; on a CPU tensor it runs the plain
  version.

Symbols: GF(2^8) data is uint8; GF(2^16) data is uint16 symbols carried
in int16 tensors (their bit patterns; torch's uint16 has few
operations), as the native codec's little-endian ``<u2`` shards.
Shard payloads ride the second axis ``[shards, shard_len]``.

The device codecs (:class:`ReedSolomonDevice`, :class:`ReedSolomonDevice16`)
keep the host codec's matrix algebra (systematic matrix, decode matrices
by :func:`_delegate_decode_matrix`) and run the shard products through
:meth:`matmul`, which asks its ``rule`` — the backend's size rule, by
``m·k·columns`` — whether a product goes to the device or to the native
host product.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..crypto import rs as _host_rs
from ..device import DeviceLike, resolve_device
from . import kernels
from .cuda_ec import LAUNCHES

# (m, k, columns) → True where the product belongs on the device
Rule = Callable[[int, int, int], bool]

# ---------------------------------------------------------------------------
# Binary expansion of a constant GF(2^8) matrix (the plain version's operand)
# ---------------------------------------------------------------------------


def _gf_mul_table_bits(c: int) -> np.ndarray:
    """8×8 GF(2) matrix M with bits(c·x) = M @ bits(x) (poly 0x11d)."""
    cols = []
    for bit in range(8):
        prod = _host_rs.gf_mul(c, 1 << bit)
        cols.append([(prod >> r) & 1 for r in range(8)])
    return np.array(cols, dtype=np.int8).T  # [out_bit, in_bit]


@functools.lru_cache(maxsize=256)  # decode matrices vary per erasure pattern
def _binary_matrix(key: Tuple[int, int, bytes]) -> np.ndarray:
    """GF(256) matrix (m, k) → binary matrix (8m, 8k) int8."""
    m, k, raw = key
    mat = np.frombuffer(raw, dtype=np.uint8).reshape(m, k)
    out = np.zeros((8 * m, 8 * k), dtype=np.int8)
    for i in range(m):
        for j in range(k):
            out[8 * i : 8 * i + 8, 8 * j : 8 * j + 8] = _gf_mul_table_bits(int(mat[i, j]))
    return out


# ---------------------------------------------------------------------------
# GF(2^16): the same with 16-bit symbols
# ---------------------------------------------------------------------------

_BITS16: Optional[np.ndarray] = None  # [65536, 16, 16] uint8
_BITS16_LOCK = threading.Lock()  # stage worker + main thread both decode


def _bits16_table() -> np.ndarray:
    """M[c] with bits16(c·x) = M[c] @ bits16(x), for every constant c
    (built vectorised from the host log/antilog tables, ~16 MB)."""
    global _BITS16
    if _BITS16 is None:
        with _BITS16_LOCK:
            if _BITS16 is None:
                _host_rs._build_tables16()
                exp, log = _host_rs._EXP16, _host_rs._LOG16
                cs = np.arange(65536, dtype=np.int64)
                table = np.zeros((65536, 16, 16), dtype=np.uint8)
                for bit in range(16):
                    prod = np.where(cs == 0, 0, exp[log[cs] + int(log[1 << bit])])
                    for r in range(16):
                        table[:, r, bit] = (prod >> r) & 1
                _BITS16 = table
    return _BITS16


@functools.lru_cache(maxsize=8)  # ~30-60 MB each; decode patterns vary
def _binary_matrix16(key: Tuple[int, int, bytes]) -> np.ndarray:
    """GF(2^16) matrix (m, k) → binary matrix (16m, 16k) int8."""
    m, k, raw = key
    mat = np.frombuffer(raw, dtype=np.uint16).reshape(m, k)
    blocks = _bits16_table()[mat]  # [m, k, 16, 16]
    return blocks.transpose(0, 2, 1, 3).reshape(16 * m, 16 * k).astype(np.int8)


# ---------------------------------------------------------------------------
# The kernel's constants: M[i, j]·2^b, the columns of each binary block
# ---------------------------------------------------------------------------


def _width(mat: np.ndarray) -> int:
    if mat.dtype == np.uint8:
        return 8
    if mat.dtype == np.uint16:
        return 16
    raise TypeError(f"a GF(2^8) matrix is uint8 and a GF(2^16) one uint16, not {mat.dtype}")


def _key(mat: np.ndarray) -> Tuple[int, int, bytes]:
    m, k = mat.shape
    return (m, k, np.ascontiguousarray(mat).tobytes())


def const_table(mat: np.ndarray) -> np.ndarray:
    """[m, k] GF(2^W) matrix → [m, k, W] symbols M[i, j]·2^b (uint8 or
    uint16), from the port's log/antilog tables."""
    W = _width(mat)
    if W == 8:
        exp, log = _host_rs._EXP, _host_rs._LOG
    else:
        _host_rs._build_tables16()
        exp, log = _host_rs._EXP16, _host_rs._LOG16
    m = mat.astype(np.int64)
    prod = exp[log[m][..., None] + log[1 << np.arange(W)]]
    return np.where(m[..., None] == 0, 0, prod).astype(mat.dtype)


# the kernel's tile: 256 rows of the binary expansion, 32 bits of k a step
TILE_ROWS, TILE_K = 256, 32


def abin_tiles(table: torch.Tensor, W: int) -> torch.Tensor:
    """The binary expansion ``A_bin`` of a constant matrix as the kernel
    reads it, from its ``[m, k, W]`` constants ``M[i, j]·2^b``
    (:func:`const_table`, uint8 or int16 words) on their device: row
    W·i + r, column W·j + b holds bit r of ``M[i, j]·2^b`` (a 0 or 1 byte),
    zero padded to whole tiles and laid out [row tile][k-step][row / 8]
    [k / 16][row % 8][k % 16] — ``[⌈W·m/256⌉, ⌈W·k/32⌉, 8192]`` uint8, one
    k-step of a tile 8 KB of wgmma's K-major core matrices."""
    m, k, _ = table.shape
    t = table.to(torch.int32) & ((1 << W) - 1)
    MT, KS = -(-W * m // TILE_ROWS), -(-W * k // TILE_K)
    a = torch.zeros((MT * TILE_ROWS, KS * TILE_K), dtype=torch.uint8, device=table.device)
    blocks = a[: W * m, : W * k].view(m, W, k, W)  # [i, r, j, b]
    for r in range(W):
        blocks[:, r] = ((t >> r) & 1).to(torch.uint8)
    tiles = a.view(MT, TILE_ROWS // 8, 8, KS, 2, 16).permute(0, 3, 1, 4, 2, 5)
    return tiles.contiguous().view(MT, KS, TILE_ROWS * TILE_K)


def _device_abin(key: Tuple[int, int, bytes], W: int, device: str) -> torch.Tensor:
    dtype = np.uint8 if W == 8 else np.uint16
    mat = np.frombuffer(key[2], dtype=dtype).reshape(key[0], key[1])
    table = const_table(mat)
    table = torch.from_numpy(table if W == 8 else table.view(np.int16)).to(device)
    return abin_tiles(table, W)


# decode matrices vary per erasure pattern; the N = 1024 parity's expansion
# is 60 MB
_abin8 = functools.lru_cache(maxsize=256)(functools.partial(_device_abin, W=8))
_abin16 = functools.lru_cache(maxsize=8)(functools.partial(_device_abin, W=16))


# ---------------------------------------------------------------------------
# The plain PyTorch version
# ---------------------------------------------------------------------------

_UINT16 = getattr(torch, "uint16", None)


def _symbols(data: torch.Tensor, W: int) -> torch.Tensor:
    """Check the data's dtype for the width: uint8, or int16 (uint16 viewed)."""
    if W == 16 and _UINT16 is not None and data.dtype == _UINT16:
        data = data.view(torch.int16)
    want = torch.uint8 if W == 8 else torch.int16
    if data.dtype != want:
        raise TypeError(f"GF(2^{W}) data is {want}, got {data.dtype}")
    if data.dim() != 2:
        raise ValueError(f"data must be [k, n], got {tuple(data.shape)}")
    return data


def gf_matmul_plain(mat: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of ``gf_matmul``: the reference's
    bit-sliced product (unpack, matmul, parity, pack) on ``data``'s
    device."""
    W = _width(mat)
    data = _symbols(data, W)
    m, k = mat.shape
    n = data.shape[1]
    binary = _binary_matrix(_key(mat)) if W == 8 else _binary_matrix16(_key(mat))
    binmat = torch.from_numpy(binary).to(data.device).to(torch.float64)
    shifts = torch.arange(W, device=data.device)
    x = data.to(torch.int64) & ((1 << W) - 1)
    bits = ((x[:, None, :] >> shifts[None, :, None]) & 1).reshape(W * k, n)
    acc = (binmat @ bits.to(torch.float64)).to(torch.int64) & 1  # [W·m, n]
    out = (acc.reshape(m, W, n) << shifts[None, :, None]).sum(dim=1)
    if W == 8:
        return out.to(torch.uint8)
    return torch.where(out >= 1 << 15, out - (1 << 16), out).to(torch.int16)


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = kernels.load("gf_matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gf_matmul_launch.argtypes = [i, p, p, i, p, i, i, i, p]
    lib.gf_matmul_launch.restype = ctypes.c_int
    lib.gf_matmul_error_string.argtypes = [ctypes.c_int]
    lib.gf_matmul_error_string.restype = ctypes.c_char_p
    return lib


def gf_matmul(mat: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """Constant GF(2^W) matrix (host numpy ``[m, k]``, uint8 for W = 8,
    uint16 for W = 16) × symbol matrix ``data`` ``[k, n]`` (uint8, or
    int16 words) → ``[m, n]`` of the same dtype on ``data``'s device."""
    W = _width(mat)
    data = _symbols(data, W)
    if mat.ndim != 2 or mat.shape[1] != data.shape[0]:
        raise ValueError(f"a [m, k] matrix times [k, n] data, got {mat.shape} and {tuple(data.shape)}")
    if data.device.type == "cpu":
        return gf_matmul_plain(mat, data)
    if data.device.type != "cuda":
        raise ValueError(f"gf_matmul runs on cuda or cpu tensors, not {data.device}")
    m, k = mat.shape
    n = data.shape[1]
    if m == 0 or k == 0 or n == 0:
        return torch.zeros((m, n), dtype=data.dtype, device=data.device)
    key = _key(mat)
    dev = str(data.device)
    abin = _abin8(key, device=dev) if W == 8 else _abin16(key, device=dev)
    # the kernel copies each row's slice of a step with the bulk copy engine:
    # rows 16-byte aligned, their stride a multiple of 16 bytes (the device
    # codecs' host arrays arrive so, _on); other data is padded here
    row_bytes = n * W // 8
    xs = data.stride(0) * (W // 8)
    x = data
    if data.stride(1) != 1 or xs % 16 or xs < row_bytes or data.data_ptr() % 16:
        xs = -(-row_bytes // 16) * 16
        x = torch.nn.functional.pad(data.contiguous().view(torch.uint8), (0, xs - row_bytes))
    y = torch.empty((m, n), dtype=data.dtype, device=data.device)
    lib = _lib()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = lib.gf_matmul_launch(W, abin.data_ptr(), x.data_ptr(), xs, y.data_ptr(), m, k, n,
                                  stream)
    if rc != 0:
        raise RuntimeError(f"gf_matmul launch failed: {lib.gf_matmul_error_string(rc).decode()} ({rc})")
    LAUNCHES["gf_matmul"] += 1
    return y


# ---------------------------------------------------------------------------
# Entry points (the reference's names)
# ---------------------------------------------------------------------------


def _on(data, dtype, device: DeviceLike) -> torch.Tensor:
    """``data`` as a tensor on ``device``: a host array goes over as a
    view of rows padded to 16 bytes, as ``gf_matmul`` takes them."""
    if isinstance(data, torch.Tensor):
        return data
    arr = np.asarray(data, dtype=dtype)
    k, n = arr.shape
    width = -(-n * arr.itemsize // 16) * 16 // arr.itemsize
    buf = np.zeros((k, width), dtype=dtype)
    buf[:, :n] = arr
    if dtype == np.uint16:
        buf = buf.view(np.int16)
    return torch.from_numpy(buf).to(resolve_device(device))[:, :n]


def gf_matmul_device(mat: np.ndarray, data, device: DeviceLike = None) -> torch.Tensor:
    """Constant GF(256) matrix × byte matrix on the device.

    mat: host-side (m, k) uint8; data: [k, n] uint8, a tensor (on the
    device that runs it) or a host array (sent to ``device``, the card
    by default)."""
    return gf_matmul(np.asarray(mat, dtype=np.uint8), _on(data, np.uint8, device))


def gf16_matmul_device(mat: np.ndarray, data, device: DeviceLike = None) -> torch.Tensor:
    """Constant GF(2^16) matrix × uint16 symbol matrix on the device
    (int16 words in and out)."""
    return gf_matmul(np.asarray(mat, dtype=np.uint16), _on(data, np.uint16, device))


# ---------------------------------------------------------------------------
# Reed-Solomon codecs (device products, host orchestration)
# ---------------------------------------------------------------------------


class ReedSolomonDevice:
    """Same semantics as ``crypto.rs.ReedSolomon`` with the shard-payload
    products on the device.  Matrix algebra over the (tiny) shard-index
    dimension — systematic-matrix construction, submatrix inversion on
    reconstruct — stays on the host where it is O(k³) on k ≤ 256 bytes.

    ``device``: where the products run (the card by default); ``rule``:
    ``(m, k, columns) → bool``, True where a product belongs on the device
    (the backend's size rule; None sends every product there)."""

    symbol = 1
    _host_cls = _host_rs.ReedSolomon
    _dtype = np.uint8

    def __init__(self, data_shards: int, parity_shards: int, device: DeviceLike = None,
                 rule: Optional[Rule] = None):
        self._host = self._host_cls(data_shards, parity_shards)
        self.k = self._host.k
        self.m = self._host.m
        self.n = self._host.n
        self.device = resolve_device(device)
        self.rule = rule

    def _host_matmul(self, rows: np.ndarray, data: np.ndarray) -> np.ndarray:
        return _host_rs._matmul(rows, data)

    def _device_matmul(self, rows: np.ndarray, data: np.ndarray) -> np.ndarray:
        return gf_matmul_device(rows, data, self.device).cpu().numpy()

    def matmul(self, rows: np.ndarray, data: np.ndarray) -> np.ndarray:
        """``rows`` [m, k] × ``data`` [k, n] symbols in the codec's field,
        on the device unless the rule sends it to the native host."""
        rows = np.ascontiguousarray(rows, dtype=self._dtype)
        if self.rule is None or self.rule(rows.shape[0], rows.shape[1], data.shape[1]):
            return self._device_matmul(rows, data)
        return self._host_matmul(rows, data)

    def _to_syms(self, shard: bytes) -> np.ndarray:
        return np.frombuffer(shard, dtype=np.uint8)

    def _to_bytes(self, row: np.ndarray) -> bytes:
        return row.tobytes()

    def encode(self, data: Sequence[bytes]) -> List[bytes]:
        if len(data) != self.k:
            raise ValueError(f"expected {self.k} data shards")
        if self.m == 0:
            return list(data)
        arr = np.stack([self._to_syms(s) for s in data])
        parity = self.matmul(self._host.matrix[self.k :], arr)
        return list(data) + [self._to_bytes(p) for p in parity]

    def reconstruct(self, shards: List[Optional[bytes]]) -> List[bytes]:
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
        data = self.matmul(dec, avail)
        # only the missing shards are recomputed; present ones pass through
        missing = [i for i, s in enumerate(shards) if s is None]
        out: List[Optional[bytes]] = list(shards)
        if missing:
            rec = self.matmul(self._host.matrix[missing, :], data)
            for j, i in enumerate(missing):
                out[i] = self._to_bytes(rec[j])
        return out  # type: ignore[return-value]


class ReedSolomonDevice16(ReedSolomonDevice):
    """Device GF(2^16) codec (semantics of ``crypto.rs.ReedSolomon16``):
    lifts the reference crate's 256-shard cap
    (``broadcast.rs:310-312``) to 65536 with the payload products on the
    device."""

    symbol = 2
    _host_cls = _host_rs.ReedSolomon16
    _dtype = np.uint16

    def _host_matmul(self, rows: np.ndarray, data: np.ndarray) -> np.ndarray:
        return _host_rs._matmul16(rows, data)

    def _device_matmul(self, rows: np.ndarray, data: np.ndarray) -> np.ndarray:
        return gf16_matmul_device(rows, data, self.device).cpu().numpy().view(np.uint16)

    def _to_syms(self, shard: bytes) -> np.ndarray:
        return self._host._to_syms(shard)

    def _to_bytes(self, row: np.ndarray) -> bytes:
        return row.astype("<u2").tobytes()


def _delegate_decode_matrix(cls):
    """Device codecs delegate decode-matrix construction (tiny O(k³)
    host algebra, cached per erasure pattern) to their host twin so
    batched callers (``harness/epoch.py``) treat host and device codecs
    uniformly."""

    def decode_matrix(self, use):
        return self._host.decode_matrix(use)

    cls.decode_matrix = decode_matrix


_delegate_decode_matrix(ReedSolomonDevice)
_delegate_decode_matrix(ReedSolomonDevice16)
