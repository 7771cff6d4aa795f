"""Windowed G1 scalar multiplication: the CUDA kernel and its plain twin.

The port of the main-path half of ``hbbft_tpu/ops/pallas_ec.py``:
``bits_to_digits`` and ``scalar_mul_windowed``.  The Pallas kernel
``_make_windowed_kernel(g2=False)`` (exec name ``win_g1``) becomes
``csrc/win_g1.cu``, written by hand for Hopper; :func:`win_g1` is its
wrapper:

- on a CUDA tensor it launches the kernel (or raises) — never a
  fallback;
- on a CPU tensor it runs :func:`windowed_plain`, the same window
  schedule on ``ops/ec.py``'s ``PointKernel`` in plain PyTorch.

The two agree limb for limb (same field schedule, same operation order),
so ``chip_smoke.py`` compares them exactly.  ``LAUNCHES`` counts kernel
launches (and nothing else), so a run can show that the main path went
through the kernel.  The point layout at this module's functions is
the reference's ``[K, 3, 38]`` int32; the TPU's tile transpose has no
counterpart (one thread per point reads its own row).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from . import kernels
from . import limbs as LB
from .ec import g1_kernel

LAUNCHES: Dict[str, int] = {"win_g1": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def bits_to_digits(bits: np.ndarray) -> np.ndarray:
    """[K, nbits] msb-first bits → [K, ceil(nbits/4)] msb-first 4-bit
    window digits (left-padded so the top window may be short)."""
    K, nbits = bits.shape
    nwin = -(-nbits // 4)
    padded = np.zeros((K, nwin * 4), dtype=np.int32)
    padded[:, nwin * 4 - nbits :] = bits
    d = padded.reshape(K, nwin, 4)
    return (d[..., 0] << 3) | (d[..., 1] << 2) | (d[..., 2] << 1) | d[..., 3]


def windowed_plain(pts: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel: table j·P (j = 0..15) by
    complete adds, then per window 4 doublings and one add of
    ``table[digit]`` (a digit outside 0..15 selects the identity, as the
    reference's masked cascade does)."""
    kern = g1_kernel()
    K = pts.shape[0]
    ident = kern.identity((K,), pts.device)
    table = [ident, pts]
    for j in range(2, 16):
        table.append(kern.add(table[j - 1], pts))
    tab = torch.stack(table)  # [16, K, 3, L]
    d = digits.to(torch.int64)
    d = torch.where((d >= 0) & (d <= 15), d, torch.zeros_like(d))
    rows = torch.arange(K, device=pts.device)
    acc = ident
    for w in range(digits.shape[1]):
        for _ in range(4):
            acc = kern.add(acc, acc)
        acc = kern.add(acc, tab[d[:, w], rows])
    return acc


def _check(pts: torch.Tensor, digits: torch.Tensor) -> None:
    L = LB.FQ_LIMBS
    if pts.dtype != torch.int32 or digits.dtype != torch.int32:
        raise TypeError(f"win_g1 takes int32 tensors, got {pts.dtype}, {digits.dtype}")
    if pts.dim() != 3 or tuple(pts.shape[1:]) != (3, L):
        raise ValueError(f"points must be [K, 3, {L}], got {tuple(pts.shape)}")
    if digits.dim() != 2 or digits.shape[0] != pts.shape[0]:
        raise ValueError(
            f"digits must be [K, nwin] with K = {pts.shape[0]}, got {tuple(digits.shape)}"
        )
    if pts.device != digits.device:
        raise ValueError(f"points on {pts.device}, digits on {digits.device}")


def _lib() -> ctypes.CDLL:
    lib = kernels.load("win_g1")
    p = ctypes.c_void_p
    lib.win_g1_launch.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int, p]
    lib.win_g1_launch.restype = ctypes.c_int
    lib.win_g1_error_string.argtypes = [ctypes.c_int]
    lib.win_g1_error_string.restype = ctypes.c_char_p
    return lib


def win_g1(pts: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """k·P per row: ``pts`` [K, 3, 38] int32 projective limbs ×
    ``digits`` [K, nwin] int32 msb-first 4-bit windows → [K, 3, 38].

    CUDA tensors launch the kernel on the current stream (no sync);
    CPU tensors run :func:`windowed_plain`."""
    _check(pts, digits)
    if pts.device.type == "cpu":
        return windowed_plain(pts, digits)
    if pts.device.type != "cuda":
        raise ValueError(f"win_g1 runs on cuda or cpu tensors, not {pts.device}")
    if not (pts.is_contiguous() and digits.is_contiguous()):
        raise ValueError("win_g1 takes contiguous tensors")
    K, nwin = pts.shape[0], digits.shape[1]
    out = torch.empty_like(pts)
    if K == 0:
        return out
    lib = _lib()
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        rc = lib.win_g1_launch(
            pts.data_ptr(), digits.data_ptr(), out.data_ptr(), K, nwin, stream
        )
    if rc != 0:
        raise RuntimeError(
            f"win_g1 launch failed: {lib.win_g1_error_string(rc).decode()} ({rc})"
        )
    LAUNCHES["win_g1"] += 1
    return out


def scalar_mul_windowed(pts: torch.Tensor, bits) -> torch.Tensor:
    """Batched G1 scalar-mul: ``pts`` [K, 3, 38] int32 (on the device
    that runs it) × ``bits`` [K, nbits] msb-first → [K, 3, 38] — the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    digits = bits_to_digits(np.asarray(bits))
    return win_g1(pts, torch.from_numpy(digits).to(torch.int32).to(pts.device))
