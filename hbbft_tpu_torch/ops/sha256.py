"""Batched SHA-256 and Merkle forests: the ``sha256`` and ``merkle_forest``
kernels and their plain PyTorch versions.

The port of ``hbbft_tpu/ops/sha256_jax.py`` (an XLA program, not a
Pallas kernel): hashing every shard of a reliable-broadcast instance,
and every level of its Merkle tree, is a uniform batch of digests
(``broadcast.rs:161``, tree build ``:381``, re-root ``:683``).  SHA-256
is sequential within a message, so the parallelism is across messages.

- :func:`sha256` — ``[B, nblocks, 16]`` big-endian words (padded by
  :func:`pad_messages`) → ``[B, 8]`` digests, and :func:`sha256_bytes` —
  ``[B, len]`` raw uint8 rows → ``[B, 8]`` digests, the card padding them;
  ``csrc/sha256.cu``'s ``sha256_kernel`` (one template, a flag for words
  padded already) runs one thread a message, block after block, the next
  block's loads issued ahead of each compression;
- :func:`merkle_forest` — the raw leaf values of T trees, ``[T, n, len]``
  bytes, → every tree's levels ``[T, R, 8]`` (R = Σ :func:`level_sizes`)
  or only its root ``[T, 8]``; ``csrc/merkle.cu``'s
  ``merkle_forest_kernel`` builds each tree in one block (leaf messages
  and padding made in registers, the levels in shared memory), the whole
  forest in one launch.  Both kernels share the compression of
  ``csrc/sha256.cuh``.

Tensors hold the 32-bit words as int32 (their bit patterns; torch's
uint32 has few operations) and :func:`sha256_device` also takes and
gives uint32.  Each wrapper, on a CUDA tensor, launches its kernel on
the current stream (or raises — never a fallback) and counts it in
``cuda_ec.LAUNCHES``; on a CPU tensor it runs the plain version, the
reference's compression as torch ops on int64 lanes masked to 32 bits
(:func:`sha256_bytes_plain` and :func:`merkle_forest_plain` pad their
messages as torch ops, the latter builds each level with
:func:`merkle_level_plain`).  :func:`sha256_many` sends the joined
messages to the card as one uint8 tensor and pads nothing on the host.

Hashing matches ``crypto.merkle.MerkleTree`` byte for byte: leaf =
SHA-256(0x00 ‖ index₈ ‖ value), node = SHA-256(0x01 ‖ l ‖ r), and an odd
level repeats its last hash, which lands in that level's list.  The
reference copies each level back and forth; here a forest's rows come
back to the host in one copy (:func:`merkle_forest_device`), and
:func:`merkle_levels_device`, the reference's name, is a one-tree forest.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from . import kernels
from .cuda_ec import LAUNCHES

_K = np.array(
    [
        0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
        0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
        0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
        0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
        0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
        0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
        0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
        0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
        0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
        0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
        0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
    ],
    dtype=np.uint32,
)

_H0 = np.array(
    [
        0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
        0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
    ],
    dtype=np.uint32,
)

_M32 = 0xFFFFFFFF
_UINT32 = getattr(torch, "uint32", None)


# ---------------------------------------------------------------------------
# Host padding and digests
# ---------------------------------------------------------------------------


def _be_words(buf: np.ndarray) -> np.ndarray:
    """[..., 64·nblocks] uint8 → [..., nblocks, 16] uint32 big-endian words."""
    words = buf.view(">u4").astype(np.uint32)
    return words.reshape(*buf.shape[:-1], -1, 16)


def _padded(n_msgs: int, n: int) -> np.ndarray:
    """A zero buffer of ``n_msgs`` padded messages of ``n`` bytes with the
    0x80 byte and the 64-bit bit length in place."""
    nblocks = (n + 1 + 8 + 63) // 64
    buf = np.zeros((n_msgs, nblocks * 64), dtype=np.uint8)
    buf[:, n] = 0x80
    buf[:, -8:] = np.frombuffer((8 * n).to_bytes(8, "big"), dtype=np.uint8)
    return buf


def pad_messages(msgs: Sequence[bytes]) -> np.ndarray:
    """Uniform-length messages → [batch, nblocks, 16] padded word array
    (standard SHA-256 padding: 0x80, zeros, 64-bit bit length)."""
    if not msgs:
        return np.zeros((0, 1, 16), dtype=np.uint32)
    n = len(msgs[0])
    assert all(len(m) == n for m in msgs), "pad_messages needs uniform length"
    buf = _padded(len(msgs), n)
    buf[:, :n] = np.frombuffer(b"".join(msgs), dtype=np.uint8).reshape(len(msgs), n)
    return _be_words(buf)


def _words_np(digests) -> np.ndarray:
    if isinstance(digests, torch.Tensor):
        d = digests.detach().cpu()
        if _UINT32 is not None and d.dtype == _UINT32:
            d = d.view(torch.int32)
        return d.numpy().view(np.uint32)
    return np.asarray(digests).astype(np.uint32, copy=False)


def digests_to_bytes(digests) -> List[bytes]:
    """[batch, 8] uint32 (numpy, or a tensor of uint32 or int32 words) →
    list of 32-byte digests."""
    raw = _words_np(digests).astype(">u4").tobytes()
    return [raw[i : i + 32] for i in range(0, len(raw), 32)]


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & _M32


def _compress_plain(state: List[torch.Tensor], w: List[torch.Tensor]) -> List[torch.Tensor]:
    """One compression over a batch: ``state`` 8 and ``w`` 16 int64 lanes
    in [0, 2^32), as the reference's ``_compress``."""
    w = list(w)
    for t in range(16, 64):
        w15, w2 = w[t - 15], w[t - 2]
        s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
        s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M32)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + s1 + ch + int(_K[t]) + w[t]
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _M32, c, b, a, (t1 + s0 + maj) & _M32
    return [(x + y) & _M32 for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def _lanes(words: torch.Tensor) -> torch.Tensor:
    """int32 or uint32 words → int64 lanes in [0, 2^32)."""
    if _UINT32 is not None and words.dtype == _UINT32:
        words = words.view(torch.int32)
    return words.to(torch.int64) & _M32


def _to_int32(lanes: torch.Tensor) -> torch.Tensor:
    return torch.where(lanes >= 1 << 31, lanes - (1 << 32), lanes).to(torch.int32)


def sha256_plain(blocks: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of ``sha256``: [B, nblocks, 16] int32
    words → [B, 8] int32 digest words."""
    x = _lanes(blocks)
    B = x.shape[0]
    state = [torch.full((B,), int(h), dtype=torch.int64, device=x.device) for h in _H0]
    for blk in range(x.shape[1]):
        state = _compress_plain(state, [x[:, blk, i] for i in range(16)])
    return _to_int32(torch.stack(state, dim=1))


def _node_words(level: torch.Tensor) -> torch.Tensor:
    """[2p, 8] digest words → [p, 2, 16] padded words of 0x01 ‖ l ‖ r
    (65 bytes: the first block, then r's last byte, 0x80 and the bit
    length 520)."""
    d = _lanes(level).reshape(-1, 16)  # l ‖ r words
    prev = torch.cat([torch.full_like(d[:, :1], 0x01), d[:, :15]], dim=1)
    first = ((prev << 24) | (d >> 8)) & _M32
    second = torch.zeros_like(first)
    second[:, 0] = ((d[:, 15] << 24) | 0x800000) & _M32
    second[:, 15] = 65 * 8
    return torch.stack([first, second], dim=1)


def merkle_level_plain(level: torch.Tensor) -> torch.Tensor:
    """One Merkle level on torch ops, the building block of
    :func:`merkle_forest_plain`: [2p, 8] int32 digest words (an odd
    level's last hash already repeated) → [p, 8] parents,
    SHA-256(0x01 ‖ l ‖ r)."""
    return sha256_plain(_to_int32(_node_words(level)))


def _message_words(rows: torch.Tensor, index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, len] uint8 rows → [B, nblocks, 16] int32 padded words of their
    messages (the reference's padding: 0x80, zeros, the 64-bit bit
    length), as torch ops where the rows lie; with ``index`` ([B] int64)
    each message is the Merkle leaf 0x00 ‖ index₈ ‖ row.  The card builds
    the same words in registers."""
    B, ln = rows.shape
    plen = 0 if index is None else 9
    mlen = plen + ln
    nblocks = (mlen + 72) // 64  # the message, 0x80 and 8 length bytes
    buf = torch.zeros((B, nblocks * 64), dtype=torch.int64, device=rows.device)
    if index is not None:
        for q in range(8):
            buf[:, 1 + q] = (index >> (8 * (7 - q))) & 0xFF
    buf[:, plen:mlen] = rows.to(torch.int64)
    buf[:, mlen] = 0x80
    for q in range(8):
        buf[:, nblocks * 64 - 8 + q] = ((8 * mlen) >> (8 * (7 - q))) & 0xFF
    b = buf.reshape(B, nblocks * 16, 4)
    words = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    return _to_int32(words).reshape(B, nblocks, 16)


def _leaf_words(values: torch.Tensor) -> torch.Tensor:
    """[T, n, len] uint8 leaf values → [T·n, nblocks, 16] int32 padded
    words of the leaf messages 0x00 ‖ index₈ ‖ value, the index counted
    within each tree."""
    T, n, ln = values.shape
    idx = torch.arange(n, dtype=torch.int64, device=values.device).repeat(T)
    return _message_words(values.reshape(T * n, ln), idx)


def _rows(rows: torch.Tensor) -> torch.Tensor:
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError(f"sha256_bytes takes [B, len] uint8 rows, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    return rows


def sha256_bytes_plain(rows: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of ``sha256_bytes``: [B, len] uint8
    messages → [B, 8] int32 digest words, padded as torch ops and hashed
    by :func:`sha256_plain`."""
    return sha256_plain(_message_words(_rows(rows)))


def _forest_values(values: torch.Tensor) -> torch.Tensor:
    if values.dtype != torch.uint8 or values.dim() != 3 or values.shape[1] < 1:
        raise ValueError(
            f"a forest takes [T, n ≥ 1, len] uint8 leaf values, got {values.dtype} "
            f"{tuple(values.shape)}")
    return values


def merkle_forest_plain(values: torch.Tensor, roots_only: bool = False,
                        sha: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """The plain PyTorch version of ``merkle_forest``: T trees' leaf values
    [T, n, len] uint8 → [T, R, 8] int32 rows, every level of each tree
    leaves first (R = Σ level_sizes(n), an odd level's repeated last hash
    among its rows), or with ``roots_only`` [T, 8], each tree's root.
    ``sha`` hashes the padded leaf words (:func:`sha256_plain` by
    default; chip_smoke.py passes a replay of it)."""
    values = _forest_values(values)
    T, n, _ = values.shape
    level = (sha or sha256_plain)(_leaf_words(values)).reshape(T, n, 8)
    rows = [level]
    while level.shape[1] > 1:
        if level.shape[1] % 2:
            level = torch.cat([level, level[:, -1:]], dim=1)
            rows[-1] = level
        level = merkle_level_plain(level.reshape(-1, 8)).reshape(T, -1, 8)
        rows.append(level)
    if roots_only:
        return level[:, 0].contiguous()
    return torch.cat(rows, dim=1)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = kernels.load("sha256")
    p = ctypes.c_void_p
    lib.sha256_launch.argtypes = [p, p, ctypes.c_int, ctypes.c_int, p]
    lib.sha256_launch.restype = ctypes.c_int
    lib.sha256_bytes_launch.argtypes = [p, p, ctypes.c_int, ctypes.c_longlong, p]
    lib.sha256_bytes_launch.restype = ctypes.c_int
    lib.sha256_error_string.argtypes = [ctypes.c_int]
    lib.sha256_error_string.restype = ctypes.c_char_p
    lib.error_string = lib.sha256_error_string
    return lib


@functools.lru_cache(maxsize=None)
def _merkle_lib() -> ctypes.CDLL:
    lib = kernels.load("merkle")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.merkle_forest_launch.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.merkle_forest_launch.restype = ctypes.c_int
    lib.merkle_error_string.argtypes = [ctypes.c_int]
    lib.merkle_error_string.restype = ctypes.c_char_p
    lib.error_string = lib.merkle_error_string
    return lib


def _words(t: torch.Tensor, what: str) -> torch.Tensor:
    if _UINT32 is not None and t.dtype == _UINT32:
        t = t.view(torch.int32)
    if t.dtype != torch.int32:
        raise TypeError(f"{what} takes int32 or uint32 words, got {t.dtype}")
    return t


def _launch(lib: ctypes.CDLL, name: str, call) -> None:
    rc = call(lib)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {lib.error_string(rc).decode()} ({rc})")
    LAUNCHES[name] += 1


def _out(out: Optional[torch.Tensor], rows: int, like: torch.Tensor, name: str) -> torch.Tensor:
    if out is None:
        return torch.empty((rows, 8), dtype=torch.int32, device=like.device)
    out = _words(out, name)
    if (tuple(out.shape) != (rows, 8) or out.device != like.device or not out.is_contiguous()
            or (out.device.type == "cuda" and out.data_ptr() % 16)):
        raise ValueError(f"{name} writes a contiguous, 16-byte aligned [{rows}, 8] on {like.device}")
    return out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (the kernels read 16-byte vectors)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def sha256(blocks: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, nblocks, 16] int32 words → [B, 8] int32 digest words (into
    ``out`` when given, a contiguous [B, 8] int32 tensor)."""
    blocks = _words(blocks, "sha256")
    if blocks.dim() != 3 or blocks.shape[2] != 16 or blocks.shape[1] < 1:
        raise ValueError(f"sha256 takes [B, nblocks ≥ 1, 16] words, got {tuple(blocks.shape)}")
    B, nblocks = blocks.shape[0], blocks.shape[1]
    if blocks.device.type == "cpu":
        res = sha256_plain(blocks)
        return res if out is None else _out(out, B, blocks, "sha256").copy_(res)
    if blocks.device.type != "cuda":
        raise ValueError(f"sha256 runs on cuda or cpu tensors, not {blocks.device}")
    dst = _out(out, B, blocks, "sha256")
    if B == 0:
        return dst
    blocks = _aligned(blocks)
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream(blocks.device).cuda_stream
        _launch(_lib(), "sha256", lambda lib: lib.sha256_launch(
            blocks.data_ptr(), dst.data_ptr(), B, nblocks, stream))
    return dst


def sha256_bytes(rows: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, len] uint8 messages, one a row (any alignment), → [B, 8] int32
    digest words (into ``out`` when given, a contiguous [B, 8] int32
    tensor); the kernel pads them itself."""
    rows = _rows(rows)
    B, ln = rows.shape
    if rows.device.type == "cpu":
        res = sha256_bytes_plain(rows)
        return res if out is None else _out(out, B, rows, "sha256").copy_(res)
    if rows.device.type != "cuda":
        raise ValueError(f"sha256_bytes runs on cuda or cpu tensors, not {rows.device}")
    dst = _out(out, B, rows, "sha256")
    if B == 0:
        return dst
    rows = rows.contiguous()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        _launch(_lib(), "sha256", lambda lib: lib.sha256_bytes_launch(
            rows.data_ptr(), dst.data_ptr(), B, ln, stream))
    return dst


# csrc/merkle.cu's FOREST_SMEM_MAX: a tree of more rows·32 bytes keeps its
# rows in global memory
FOREST_SMEM_BYTES = 232_448


def merkle_forest(values: torch.Tensor, roots_only: bool = False) -> torch.Tensor:
    """T Merkle trees in one launch: leaf values [T, n, len] uint8 →
    [T, R, 8] int32 rows, every level (R = Σ level_sizes(n)), or with
    ``roots_only`` the [T, 8] roots."""
    values = _forest_values(values)
    if values.device.type == "cpu":
        return merkle_forest_plain(values, roots_only)
    if values.device.type != "cuda":
        raise ValueError(f"merkle_forest runs on cuda or cpu tensors, not {values.device}")
    T, n, ln = values.shape
    rows = sum(level_sizes(n))
    dev = values.device
    out = torch.empty((T, 8) if roots_only else (T, rows, 8), dtype=torch.int32, device=dev)
    if T == 0:
        return out
    scratch = None
    if roots_only and rows * 32 > FOREST_SMEM_BYTES:
        scratch = torch.empty((T, rows, 8), dtype=torch.int32, device=dev)
    values = values.contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(_merkle_lib(), "merkle_forest", lambda lib: lib.merkle_forest_launch(
            values.data_ptr(), out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            T, n, ln, rows, int(roots_only), stream))
    return out


# ---------------------------------------------------------------------------
# Entry points (the reference's names)
# ---------------------------------------------------------------------------


def sha256_device(blocks) -> torch.Tensor:
    """[batch, nblocks, 16] uint32 big-endian words → [batch, 8] digests,
    in the input's dtype (uint32 or int32) on its device.  A numpy array
    goes to the card and comes back as uint32 words there."""
    unsigned = isinstance(blocks, np.ndarray) or blocks.dtype == _UINT32
    if isinstance(blocks, np.ndarray):
        words = np.ascontiguousarray(blocks, dtype=np.uint32)
        blocks = _to_device(words, resolve_device(None))
    res = sha256(blocks)
    return res.view(_UINT32) if unsigned and _UINT32 is not None else res


def _to_device(words: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(words.view(np.int32)).to(device)


def _be_bytes(words: torch.Tensor) -> torch.Tensor:
    """[..., 8] int32 digest words → their big-endian bytes [..., 32],
    swapped where they lie (on the card, not by the host after the copy)."""
    return words.view(torch.uint8).reshape(*words.shape, 4).flip(-1).reshape(
        *words.shape[:-1], 32)


def sha256_many(msgs: Sequence[bytes], device: DeviceLike = None) -> List[bytes]:
    """Batched SHA-256 of uniform-length messages (on the card unless
    ``device`` says otherwise): the joined messages go to the device as
    one uint8 tensor, one ``sha256_bytes`` pads and hashes them there, and
    the digests' bytes come back in one copy."""
    if not msgs:
        return []
    n = len(msgs[0])
    if any(len(m) != n for m in msgs):
        raise ValueError("sha256_many needs uniform-length messages")
    dev = resolve_device(device)
    B = len(msgs)
    if n:
        rows = torch.frombuffer(bytearray().join(msgs), dtype=torch.uint8).reshape(B, n).to(dev)
    else:
        rows = torch.empty((B, 0), dtype=torch.uint8, device=dev)
    raw = _be_bytes(sha256_bytes(rows)).cpu().numpy().tobytes()
    return [raw[i : i + 32] for i in range(0, len(raw), 32)]


def level_sizes(n_leaves: int) -> List[int]:
    """Each level's row count in the one buffer of
    :func:`merkle_levels_device`, leaves first: an odd level of more than
    one hash holds its repeated last hash too."""
    sizes = []
    n = n_leaves
    while True:
        rows = n + (n % 2 if n > 1 else 0)
        sizes.append(rows)
        if n == 1:
            return sizes
        n = rows // 2


def forest_shape(groups) -> Optional[Tuple[int, int, int]]:
    """(T, n, len) of a batch of trees whose T groups all hold n ≥ 1 values
    of len bytes (a sequence of byte-value lists, or a [T, n, len] uint8
    array), else None: a forest's trees share one shape."""
    if isinstance(groups, np.ndarray):
        T, n, ln = groups.shape
        return (T, n, ln) if T and n else None
    groups = list(groups)
    if not groups or not groups[0]:
        return None
    n, ln = len(groups[0]), len(groups[0][0])
    if all(len(g) == n and all(len(v) == ln for v in g) for g in groups):
        return len(groups), n, ln
    return None


def merkle_forest_device(values, device: DeviceLike = None, roots_only: bool = False) -> np.ndarray:
    """T trees of n uniform leaves, ``values`` [T, n, len] uint8 (a host
    array, sent to ``device``, the card by default, or a tensor where it
    lies), built in one ``merkle_forest`` launch and copied to the host
    once: [T, R·32] digest bytes, each tree's rows in order (leaves first),
    or with ``roots_only`` [T, 32], the roots."""
    t = values
    if not isinstance(t, torch.Tensor):
        arr = np.ascontiguousarray(values, dtype=np.uint8)
        t = torch.from_numpy(arr if arr.flags.writeable else arr.copy()).to(resolve_device(device))
    raw = _be_bytes(merkle_forest(t, roots_only))
    return raw.cpu().numpy().reshape(t.shape[0], -1)


def split_levels(raw: bytes, n_leaves: int) -> List[List[bytes]]:
    """One tree's rows (``R·32`` bytes, as :func:`merkle_forest_device`
    gives them) → its levels, ``MerkleTree.levels``' lists."""
    levels, pos = [], 0
    for rows in level_sizes(n_leaves):
        levels.append([raw[32 * (pos + i) : 32 * (pos + i + 1)] for i in range(rows)])
        pos += rows
    return levels


def merkle_levels_device(leaves: Sequence[bytes], device: DeviceLike = None) -> List[List[bytes]]:
    """All levels of the Merkle tree (leaf digests first) over
    uniform-length ``leaves``: a forest of one tree, one ``merkle_forest``
    launch and one copy to the host."""
    if not leaves:
        raise ValueError("empty Merkle tree")
    n, ln = len(leaves), len(leaves[0])
    if any(len(v) != ln for v in leaves):
        raise ValueError("merkle_levels_device needs uniform leaves")
    arr = np.frombuffer(b"".join(leaves), dtype=np.uint8).reshape(1, n, ln)
    return split_levels(merkle_forest_device(arr, device)[0].tobytes(), n)
