"""Fr (BLS12-381 scalar field) matrix products: the DKG's dealing plane.

The port of ``hbbft_tpu/ops/fr_jax.py``.  The dealing plane of the
elided DKG is matrix multiplication over Fr — the row grids
``ROWS_d = POW·C_d`` and value grids ``VAL_d = ROWS_d·POWᵀ`` of
``harness/dkg.py`` — about 2·10¹¹ Fr multiply-adds at N = 1024, hours on
one host core.  This module holds two layouts:

- **The reference's**: an Fr element is 33 little-endian 8-bit limbs
  (``FR_LIMBS``), a redundant form closed under the reference's fold
  (any value < 2^264, congruent mod r).  Its device programs —
  ``_carry_sweep``, ``_fold_once``, ``_reduce_digits``,
  ``_matmul_limbs``, ``_add_limbs``, ``_sample_limbs`` — are repeated
  here step for step in plain PyTorch, so their limbs equal
  ``fr_jax``'s byte for byte.  ``lax.scan`` becomes a Python loop over
  the digit axis; the int32 ``dot_general`` becomes a float64 matmul,
  which is exact: its operands are integers ≤ 255 and every partial sum
  is at most 255²·k < 2^53 (``_int_matmul``), while the sums beyond it
  run in int64.  Below ``_MAX_K`` the reference's int32 arithmetic does
  not overflow, so the two agree exactly.
- **The kernel's**: an Fr element is 8 little-endian 32-bit words held
  in an int32 tensor ``[..., 8]`` (``FR_WORDS``).  :func:`fr_matmul`
  takes any words (values < 2^256; canonical Fr in practice) and
  returns canonical words: ``(acc + a·b) mod r``.  On a CUDA tensor it
  lays the operands out as byte planes (:func:`fr_planes`, the
  ``fr_planes`` kernel) and launches the hand-written kernel
  ``csrc/fr_matmul.cu`` (the planes' u8 product on the int8 tensor
  cores, diagonal sums into exact 17-word sums, one reduction mod r at the
  end) or raises; on a CPU tensor it runs the plain version
  :func:`fr_matmul_plain` (the reference's limb programs, then a
  canonical reduction).  ``cuda_ec.LAUNCHES["fr_matmul"]`` and
  ``["fr_planes"]`` count the kernels' launches and nothing else.
  Converters between the two layouts run in torch on the tensor's
  device.

The host converters ``fr_to_limbs`` … ``limbs_to_be32`` are the
reference's, on numpy.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..crypto import fields as F
from . import kernels
from .cuda_ec import LAUNCHES

R = F.R
FR_LIMBS = 33  # 8-bit limbs; values < 2^264, congruent mod r
# the reference's int32 accumulation bound: 255²·k·33·(1 + 1/255) < 2^31
# (its carry sweep adds the running carry to a digit before the shift)
_MAX_K = 971
# The kernel's layout: 8 × 32-bit little-endian words.  ``fr_matmul``
# takes k ≤ _MAX_K, inside both its forms' own bounds: the kernel's
# diagonal sums of byte products (csrc/fr_words.cuh), at most 32·255²·k,
# stay below 2^31 for k ≤ 1,032 on any 256-bit inputs, and the plain
# version's four spare carry digits hold while the carry,
# ≤ 255²·k·33/255, stays below 2^32.
FR_WORDS = 8


def _fold_table(offset: int, count: int) -> np.ndarray:
    """[count, FR_LIMBS] u8 — row j holds ``2^(8·(offset+j)) mod r``
    as little-endian bytes (canonical, so the top limb is 0)."""
    out = np.zeros((count, FR_LIMBS), dtype=np.uint8)
    for j in range(count):
        k = pow(2, 8 * (offset + j), R)
        out[j] = np.frombuffer(k.to_bytes(FR_LIMBS, "little"), dtype=np.uint8)
    return out


# ---------------------------------------------------------------------------
# Host ↔ limb conversions (the reference's)
# ---------------------------------------------------------------------------


def fr_to_limbs(vals: Sequence[int]) -> np.ndarray:
    """Python ints (any size; reduced mod r) → [n, FR_LIMBS] u8."""
    raw = b"".join(int(v % R).to_bytes(FR_LIMBS, "little") for v in vals)
    return np.frombuffer(raw, dtype=np.uint8).reshape(len(vals), FR_LIMBS).copy()


def limbs_to_fr(arr: np.ndarray) -> List[int]:
    """[..., FR_LIMBS] u8 → canonical ints mod r (host reduction)."""
    raw = np.asarray(arr, dtype=np.uint8).reshape(-1, FR_LIMBS).tobytes()
    return [
        int.from_bytes(raw[i : i + FR_LIMBS], "little") % R
        for i in range(0, len(raw), FR_LIMBS)
    ]


def be32_to_limbs(buf: np.ndarray) -> np.ndarray:
    """The native layout ([n·32] u8, 32-byte big-endian words) →
    [n, FR_LIMBS] u8 little-endian."""
    b = np.asarray(buf, dtype=np.uint8).reshape(-1, 32)
    out = np.zeros((b.shape[0], FR_LIMBS), dtype=np.uint8)
    out[:, :32] = b[:, ::-1]
    return out


def limbs_to_be32(arr: np.ndarray) -> np.ndarray:
    """[..., FR_LIMBS] u8 → [n·32] u8 of canonical 32-byte big-endian
    words (the native ``fr_matmul`` buffer layout)."""
    vals = limbs_to_fr(arr)
    return np.frombuffer(b"".join(v.to_bytes(32, "big") for v in vals), dtype=np.uint8).copy()


# ---------------------------------------------------------------------------
# The reference's device programs, in plain PyTorch
# ---------------------------------------------------------------------------


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer [x, k] × [k, y] → int64 through a float64 matmul (CUDA has
    no integer matmul).  Exact while every partial sum is an integer
    below 2^53; the callers' are at most 255²·k (limb products) or
    38·255² (folds)."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).round().to(torch.int64)


def _carry_sweep(digits: torch.Tensor) -> torch.Tensor:
    """[..., D] integer (non-negative) → [..., D+4] u8 base-256 digits:
    the reference's ``lax.scan`` as a loop over the digit axis.  The
    running carry after any position is ≤ (max term)/255, so 4 extra
    digits absorb it."""
    d = digits.to(torch.int64)
    carry = torch.zeros(d.shape[:-1], dtype=torch.int64, device=d.device)
    out = []
    for i in range(d.shape[-1]):
        tot = carry + d[..., i]
        out.append(tot & 0xFF)
        carry = tot >> 8
    for _ in range(4):
        out.append(carry & 0xFF)
        carry = carry >> 8
    return torch.stack(out, dim=-1).to(torch.uint8)


def _fold_once(digits: torch.Tensor) -> torch.Tensor:
    """One fold + carry: every digit at position ≥ 32 of ``digits``
    ([..., D] u8) folded through ``2^(8j) mod r``; preserves the value
    mod r."""
    hi_n = digits.shape[-1] - 32
    lo = digits[..., :32].to(torch.int64)
    hi = digits[..., 32:]
    table = torch.from_numpy(_fold_table(32, hi_n)).to(digits.device)
    folded = _int_matmul(hi.reshape(-1, hi_n), table).reshape(*hi.shape[:-1], FR_LIMBS)
    folded[..., :32] += lo
    return _carry_sweep(folded)


def _reduce_digits(digits: torch.Tensor) -> torch.Tensor:
    """Integer convolution limbs → [..., FR_LIMBS] u8 (< 2^264, ≡ mod r):
    a carry sweep, then three folds (the reference's bound: three always
    suffice), then the guaranteed-zero digits sliced off."""
    d = _carry_sweep(digits)
    for _ in range(3):
        d = _fold_once(d)
    return d[..., :FR_LIMBS]


def _limb_conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[m, k, L] × [k, p, L] u8 → [m, p, 2L−1] int64 convolution limbs of
    Σ_k a·b: the limb product ``P[m, la, p, lb]`` as one matmul, then
    limb ``la`` added at positions ``la + lb``."""
    m, k, L = a.shape
    p = b.shape[1]
    prod = _int_matmul(a.permute(0, 2, 1).reshape(m * L, k), b.reshape(k, p * L))
    prod = prod.reshape(m, L, p, L)
    conv = torch.zeros((m, p, 2 * L - 1), dtype=torch.int64, device=a.device)
    for sh in range(L):
        conv[..., sh : sh + L] += prod[:, sh]
    return conv


def _matmul_limbs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[m, k, L] u8 × [k, p, L] u8 → [m, p, L] u8 (≡ product mod r), the
    reference's limb matmul step for step."""
    if a.shape[1] > _MAX_K:
        raise ValueError("contraction %d exceeds int32-safe bound" % a.shape[1])
    return _reduce_digits(_limb_conv(a, b))


def _add_limbs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise Fr addition of limb tensors (the fold keeps 33 limbs)."""
    return _reduce_digits(a.to(torch.int64) + b.to(torch.int64))


def _random_bytes(generator: torch.Generator, shape, device) -> torch.Tensor:
    """``shape + (48,)`` uniform u8 from ``generator`` on ``device``."""
    return torch.randint(
        0, 256, tuple(shape) + (48,), generator=generator, device=device, dtype=torch.uint8
    )


def _sample_limbs(generator: torch.Generator, shape, device=None) -> torch.Tensor:
    """Uniform Fr samples: 48 random bytes folded mod r (statistical
    distance < 2^-129 from uniform), as [..., FR_LIMBS] u8.  The bytes
    come from a ``torch.Generator`` where the reference draws from
    ``jax.random``: the values differ, the algorithm is the same."""
    device = generator.device if device is None else device
    return _reduce_digits(_random_bytes(generator, shape, device))


# ---------------------------------------------------------------------------
# The kernel's layout: 8 × 32-bit words
# ---------------------------------------------------------------------------

# r as 33 little-endian digits (the top one 0)
_R_DIGITS = np.frombuffer(R.to_bytes(FR_LIMBS, "little"), dtype=np.uint8).astype(np.int64)
# the quotient estimate of _canon_limbs: a value's digits 28..32 over
# ⌊r / 2^224⌋ + 1
_R_HEAD = (R >> 224) + 1


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` with row-major strides (``view`` to another element size
    needs them, and ``contiguous`` keeps odd strides on size-1 axes)."""
    return torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t)


def _minus(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """x − q·r on [..., 33] int64 digits (q ≥ 0 per element), digits
    swept back into [0, 256) with floor carries; the last carry is
    returned at index 33 (negative iff x < q·r)."""
    rd = torch.from_numpy(_R_DIGITS).to(x.device)
    d = x - q.unsqueeze(-1) * rd
    carry = torch.zeros(d.shape[:-1], dtype=torch.int64, device=d.device)
    out = []
    for i in range(FR_LIMBS):
        tot = d[..., i] + carry
        out.append(tot & 0xFF)
        carry = tot >> 8
    out.append(carry)
    return torch.stack(out, dim=-1)


def _canon_limbs(limbs: torch.Tensor) -> torch.Tensor:
    """[..., 33] u8 (any value < 2^264) → [..., 32] u8 of the canonical
    residue mod r.  q = ⌊digits 28..32 / (⌊r/2^224⌋ + 1)⌋ is at most
    ⌊v/r⌋ and at least ⌊v/r⌋ − 2, so v − q·r lies in [0, 3r) and two
    conditional subtractions of r finish."""
    x = limbs.to(torch.int64)
    head = torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
    for i in range(FR_LIMBS - 1, 27, -1):
        head = head * 256 + x[..., i]
    x = _minus(x, head // _R_HEAD)[..., :FR_LIMBS]
    one = torch.ones(x.shape[:-1], dtype=torch.int64, device=x.device)
    for _ in range(2):
        y = _minus(x, one)
        x = torch.where((y[..., FR_LIMBS] >= 0).unsqueeze(-1), y[..., :FR_LIMBS], x)
    return _dense(x[..., :32].to(torch.uint8))


def fr_to_words(vals: Sequence[int]) -> np.ndarray:
    """Python ints (reduced mod r) → [n, FR_WORDS] int32 canonical words."""
    raw = b"".join(int(v % R).to_bytes(32, "little") for v in vals)
    return np.frombuffer(raw, dtype="<i4").reshape(len(vals), FR_WORDS).copy()


def words_to_fr(words: torch.Tensor) -> List[int]:
    """[..., FR_WORDS] int32 → the ints they hold (unreduced: canonical
    words give canonical ints)."""
    raw = words.detach().to("cpu").contiguous().numpy().astype("<i4").tobytes()
    return [int.from_bytes(raw[i : i + 32], "little") for i in range(0, len(raw), 32)]


def words_to_limbs(words: torch.Tensor) -> torch.Tensor:
    """[..., 8] int32 words → [..., 33] u8 limbs of the same value (the
    top limb 0), on the words' device."""
    b = _dense(words).view(torch.uint8)
    return torch.nn.functional.pad(b, (0, 1))


def limbs_to_words(limbs: torch.Tensor) -> torch.Tensor:
    """[..., 33] u8 limbs (any value < 2^264) → [..., 8] int32 canonical
    words, on the limbs' device."""
    return _canon_limbs(limbs).view(torch.int32)


def fr_matmul_plain(
    a: torch.Tensor, b: torch.Tensor, acc: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The plain PyTorch version of ``fr_matmul``: the words as limbs,
    the reference's limb product and reduction (``_limb_conv``,
    ``_reduce_digits``), ``acc`` added by ``_add_limbs``, and the
    canonical residue as words.  Exact for k ≤ ``_MAX_K``."""
    out = _reduce_digits(_limb_conv(words_to_limbs(a), words_to_limbs(b)))
    if acc is not None:
        out = _add_limbs(out, words_to_limbs(acc))
    return limbs_to_words(out)


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = kernels.load("fr_matmul")
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.fr_matmul_launch.argtypes = [p, p, p, p, i, i, i, p]
        lib.fr_matmul_launch.restype = ctypes.c_int
        lib.fr_planes_launch.argtypes = [p, p, i, i, i, p]
        lib.fr_planes_launch.restype = ctypes.c_int
        lib.fr_matmul_error_string.argtypes = [ctypes.c_int]
        lib.fr_matmul_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


# The kernel's output tile (csrc/fr_matmul.cu): 4 Fr rows × 8 Fr columns,
# k in steps of 32
TILE_FR_M, TILE_FR_N, K_STEP = 4, 8, 32


def _k_steps(k: int) -> int:
    return max(1, -(-k // K_STEP))


def fr_planes_plain(x: torch.Tensor, a_side: bool) -> torch.Tensor:
    """The plain PyTorch version of ``fr_planes``: zero padding, then one
    permuted copy of the words' bytes."""
    if a_side:
        m, k = x.shape[:2]
        mt, ks = -(-m // TILE_FR_M), _k_steps(k)
        y = torch.nn.functional.pad(
            x.contiguous().view(torch.uint8), (0, 0, 0, ks * K_STEP - k, 0, mt * TILE_FR_M - m))
        # [tile, i % 4, step, k // 16 % 2, k % 16, g, h, u] (x = 4g + 2h + u)
        # → the block order [tile, step, i % 4, u, h, k // 16 % 2, g, k % 16]
        y = y.view(mt, TILE_FR_M, ks, 2, 16, 8, 2, 2).permute(0, 2, 1, 7, 6, 3, 5, 4)
        return y.reshape(mt, ks, TILE_FR_M * 32 * K_STEP)
    k, p = x.shape[:2]
    nt, ks = -(-p // TILE_FR_N), _k_steps(k)
    y = torch.nn.functional.pad(
        x.contiguous().view(torch.uint8), (0, 0, 0, nt * TILE_FR_N - p, 0, ks * K_STEP - k))
    # [step, k // 16 % 2, k % 16, tile, j % 8, c, e, t] (y = 8c + 4e + t)
    # → the block order [tile, step, j % 8, c, k // 16 % 2, t, e, k % 16]
    y = y.view(ks, 2, 16, nt, TILE_FR_N, 4, 2, 4).permute(3, 0, 4, 5, 1, 7, 6, 2)
    return y.reshape(nt, ks, TILE_FR_N * 32 * K_STEP)


def fr_planes(x: torch.Tensor, a_side: bool) -> torch.Tensor:
    """The byte planes the ``fr_matmul`` kernel reads, the wrapper of the
    ``fr_planes`` kernel (``csrc/fr_matmul.cu``).

    A side (``x`` = a, [m, k, 8] int32 words): [⌈m/4⌉, ⌈k/32⌉, 4096] u8.
    Fr row i's 32 plane rows hold its bytes x = 4g + 2h + u at plane row
    16u + 8h + g; block (tile, k-step) is 4 Fr rows × 32 bytes of k in
    wgmma's K-major core-matrix order
    ``[i % 4, u, h, k // 16 % 2, g, k % 16]``.

    B side (``x`` = b, [k, p, 8]): [⌈p/8⌉, ⌈k/32⌉, 8192] u8.  Fr column
    j's 32 plane rows hold its bytes y = t + 8c + 4e at plane row
    8c + 2t + e; block (tile, k-step) is 8 Fr columns × 32 bytes of k in
    the order ``[j % 8, c, k // 16 % 2, t, e, k % 16]``.

    With both orders, lane l = 4g + t of a warp holds, in every register,
    the product of byte positions l + u + δ, δ fixed by the register: one
    lane, one offset (csrc/fr_matmul.cu's diagonal sums).

    Zero past m (or p) and k; at least one k-step.  A CUDA tensor
    (contiguous, on a 16-byte boundary) launches the kernel on the current
    stream; a CPU tensor runs :func:`fr_planes_plain`."""
    if x.device.type == "cpu":
        return fr_planes_plain(x, a_side)
    if x.device.type != "cuda":
        raise ValueError(f"fr_planes runs on cuda or cpu tensors, not {x.device}")
    if x.dtype != torch.int32 or x.dim() != 3 or x.shape[2] != FR_WORDS:
        raise ValueError(f"fr_planes takes [.., .., 8] int32 words, got {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16 != 0:
        raise ValueError("fr_planes takes a contiguous tensor on a 16-byte boundary")
    with torch.cuda.device(x.device):
        return _launch_planes(_lib(), x, a_side, torch.cuda.current_stream().cuda_stream)


def _launch_planes(lib: ctypes.CDLL, x: torch.Tensor, a_side: bool, stream: int) -> torch.Tensor:
    """``fr_planes``' launch on a checked CUDA tensor, on the current device."""
    f, k = (x.shape[0], x.shape[1]) if a_side else (x.shape[1], x.shape[0])
    ft = TILE_FR_M if a_side else TILE_FR_N
    out = torch.empty((-(-f // ft), _k_steps(k), ft * 32 * K_STEP), dtype=torch.uint8,
                      device=x.device)
    if f == 0:
        return out
    rc = lib.fr_planes_launch(x.data_ptr(), out.data_ptr(), f, k, int(a_side), stream)
    if rc != 0:
        msg = lib.fr_matmul_error_string(rc).decode()
        raise RuntimeError(f"fr_planes launch failed: {msg} ({rc})")
    LAUNCHES["fr_planes"] += 1
    return out


def fr_matmul(a: torch.Tensor, b: torch.Tensor, acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The card's Fr product, the wrapper of the ``fr_matmul`` kernel:
    ``(acc + a·b) mod r`` for ``a`` [m, k, 8], ``b`` [k, p, 8] and ``acc``
    [m, p, 8] or None, int32 words (values < 2^256) → [m, p, 8] canonical
    words.  Refuses k > ``_MAX_K``, as the reference does.  A CUDA tensor
    launches the kernel on the current stream (no sync; raises if the
    launch fails); a CPU tensor runs :func:`fr_matmul_plain`."""
    if a.dim() != 3 or b.dim() != 3 or a.shape[2] != FR_WORDS or b.shape[2] != FR_WORDS:
        raise ValueError(f"fr_matmul takes [m, k, 8] × [k, p, 8] words, got "
                         f"{tuple(a.shape)} × {tuple(b.shape)}")
    m, k = a.shape[:2]
    p = b.shape[1]
    if b.shape[0] != k:
        raise ValueError(f"contractions differ: {k} and {b.shape[0]}")
    if k > _MAX_K:
        raise ValueError("contraction %d exceeds int32-safe bound" % k)
    operands = [a, b] if acc is None else [a, b, acc]
    if any(t.dtype != torch.int32 for t in operands):
        raise TypeError("fr_matmul takes int32 words")
    if acc is not None and tuple(acc.shape) != (m, p, FR_WORDS):
        raise ValueError(f"acc must be [{m}, {p}, 8], got {tuple(acc.shape)}")
    if any(t.device != a.device for t in operands):
        raise ValueError("fr_matmul's operands lie on different devices")
    if a.device.type == "cpu":
        return fr_matmul_plain(a, b, acc)
    if a.device.type != "cuda":
        raise ValueError(f"fr_matmul runs on cuda or cpu tensors, not {a.device}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in operands):
        raise ValueError("fr_matmul takes contiguous tensors on 16-byte boundaries")
    out = torch.empty((m, p, FR_WORDS), dtype=torch.int32, device=a.device)
    if m == 0 or p == 0:
        return out
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        planes_a = _launch_planes(lib, a, True, stream)
        planes_b = _launch_planes(lib, b, False, stream)
        rc = lib.fr_matmul_launch(
            planes_a.data_ptr(), planes_b.data_ptr(), None if acc is None else acc.data_ptr(),
            out.data_ptr(), m, k, p, stream,
        )
    if rc != 0:
        msg = lib.fr_matmul_error_string(rc).decode()
        raise RuntimeError(f"fr_matmul launch failed: {msg} ({rc})")
    LAUNCHES["fr_matmul"] += 1
    return out


# 2^(256·i) mod r for i = 0, 1: 48 random bytes are a 384-bit number
# lo + hi·2^256 with lo, hi < 2^256
_SAMPLE_FOLD = [1, pow(2, 256, R)]


def sample_words(generator: torch.Generator, n: int, device=None) -> torch.Tensor:
    """``n`` uniform Fr elements as [n, 8] canonical words on ``device``:
    48 random bytes from ``generator`` each (the bytes ``_sample_limbs``
    draws), folded mod r by one ``fr_matmul`` of ``[1, 2]`` (the table
    1, 2^256 mod r) against the bytes' two 256-bit halves ``[2, n]``."""
    device = generator.device if device is None else device
    words = _random_bytes(generator, (n,), device).view(torch.int32)  # [n, 12]
    halves = torch.zeros((2, n, FR_WORDS), dtype=torch.int32, device=device)
    halves[0] = words[:, :8]
    halves[1, :, :4] = words[:, 8:]
    table = torch.from_numpy(fr_to_words(_SAMPLE_FOLD)).to(device).reshape(1, 2, FR_WORDS)
    return fr_matmul(table, halves)[0]
