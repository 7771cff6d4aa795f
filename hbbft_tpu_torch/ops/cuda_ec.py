"""Scalar multiplication kernels: the CUDA kernels and their plain twins.

The port of the scalar-multiplication half of
``hbbft_tpu/ops/pallas_ec.py``.  Three Pallas kernels become CUDA C++
written by hand for Hopper, sharing ``csrc/bls_fq.cuh``:

- ``_make_windowed_kernel(g2=False)`` (exec name ``win_g1``) →
  ``csrc/win_g1.cu``, wrapper :func:`win_g1`, entry
  :func:`scalar_mul_windowed`;
- ``_make_windowed_kernel(g2=True)`` (``win_g2``) → ``csrc/win_g2.cu``,
  wrapper :func:`win_g2`, entry :func:`scalar_mul_windowed_g2`;
- ``_scalar_mul_kernel`` (``scan_g1``) → ``csrc/scan_g1.cu``, wrapper
  :func:`scan_g1`, entry :func:`scalar_mul_scan` (the counterpart of
  ``scalar_mul_pallas``).

Each wrapper, on a CUDA tensor, launches its kernel (or raises) — never
a fallback; on a CPU tensor it runs the kernel's plain PyTorch version
(:func:`windowed_plain`, :func:`windowed_g2_plain`, :func:`scan_plain`),
the same schedule on ``ops/ec.py``'s ``PointKernel``.  Kernel and twin
agree limb for limb (same field schedule, same operation order), so
``chip_smoke.py`` compares them exactly.  ``LAUNCHES`` counts kernel
launches (and nothing else), so a run can show that a path went through
a kernel.  The layouts at these functions are the reference's:
``[K, 3, 38]`` (G1) or ``[K, 3, 2, 38]`` (G2) int32 points and
``[K, n]`` int32 digits or bits; the TPU's tile transpose has no
counterpart (one thread per point reads its own row).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from . import kernels
from . import limbs as LB
from .ec import PointKernel, g1_kernel, g2_kernel

LAUNCHES: Dict[str, int] = {"win_g1": 0, "win_g2": 0, "scan_g1": 0}

# point shape each kernel takes after the leading K
_POINT_SHAPE: Dict[str, Tuple[int, ...]] = {
    "win_g1": (3, LB.FQ_LIMBS),
    "win_g2": (3, 2, LB.FQ_LIMBS),
    "scan_g1": (3, LB.FQ_LIMBS),
}


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


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _windowed(kern: PointKernel, pts: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """Table j·P (j = 0..15) by complete adds, then per window 4
    doublings and one add of ``table[digit]`` (a digit outside 0..15
    selects the identity, as the reference's masked cascade does)."""
    K = pts.shape[0]
    ident = kern.identity((K,), pts.device)
    table = [ident, pts]
    for j in range(2, 16):
        table.append(kern.add(table[j - 1], pts))
    tab = torch.stack(table)  # [16, K, 3, *el]
    d = digits.to(torch.int64)
    d = torch.where((d >= 0) & (d <= 15), d, torch.zeros_like(d))
    rows = torch.arange(K, device=pts.device)
    acc = ident
    for w in range(digits.shape[1]):
        for _ in range(4):
            acc = kern.add(acc, acc)
        acc = kern.add(acc, tab[d[:, w], rows])
    return acc


def windowed_plain(pts: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of ``win_g1``."""
    return _windowed(g1_kernel(), pts, digits)


def windowed_g2_plain(pts: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of ``win_g2``."""
    return _windowed(g2_kernel(), pts, digits)


def scan_plain(pts: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of ``scan_g1``: msb-first
    double-and-add, both sums computed and a per-row select (any
    nonzero bit takes acc + P), as ``ec_jax.PointKernel.scalar_mul``."""
    kern = g1_kernel()
    acc = kern.identity((pts.shape[0],), pts.device)
    for i in range(bits.shape[1]):
        acc = kern.add(acc, acc)
        acc = kern.select(bits[:, i] != 0, kern.add(acc, pts), acc)
    return acc


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _lib(name: str) -> ctypes.CDLL:
    lib = kernels.load(name)
    p = ctypes.c_void_p
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int, p]
    launch.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def _check(name: str, pts: torch.Tensor, aux: torch.Tensor) -> None:
    shape = _POINT_SHAPE[name]
    if pts.dtype != torch.int32 or aux.dtype != torch.int32:
        raise TypeError(f"{name} takes int32 tensors, got {pts.dtype}, {aux.dtype}")
    if tuple(pts.shape[1:]) != shape:
        dims = ", ".join(str(s) for s in shape)
        raise ValueError(f"points must be [K, {dims}], got {tuple(pts.shape)}")
    if aux.dim() != 2 or aux.shape[0] != pts.shape[0]:
        raise ValueError(
            f"{name} takes [K, n] digits or bits with K = {pts.shape[0]}, "
            f"got {tuple(aux.shape)}"
        )
    if pts.device != aux.device:
        raise ValueError(f"points on {pts.device}, digits or bits on {aux.device}")


def _run(
    name: str,
    plain: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    pts: torch.Tensor,
    aux: torch.Tensor,
) -> torch.Tensor:
    """CUDA tensors launch kernel ``name`` on the current stream (no
    sync; raises if the launch fails); CPU tensors run ``plain``."""
    _check(name, pts, aux)
    if pts.device.type == "cpu":
        return plain(pts, aux)
    if pts.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {pts.device}")
    if not (pts.is_contiguous() and aux.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    K, n = pts.shape[0], aux.shape[1]
    out = torch.empty_like(pts)
    if K == 0:
        return out
    lib = _lib(name)
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        rc = getattr(lib, f"{name}_launch")(
            pts.data_ptr(), aux.data_ptr(), out.data_ptr(), K, n, stream
        )
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")
    LAUNCHES[name] += 1
    return out


def win_g1(pts: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """k·P per row on G1: ``pts`` [K, 3, 38] int32 projective limbs ×
    ``digits`` [K, nwin] int32 msb-first 4-bit windows → [K, 3, 38]."""
    return _run("win_g1", windowed_plain, pts, digits)


def win_g2(pts: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """k·P per row on G2: ``pts`` [K, 3, 2, 38] int32 projective limbs ×
    ``digits`` [K, nwin] int32 msb-first 4-bit windows → [K, 3, 2, 38]."""
    return _run("win_g2", windowed_g2_plain, pts, digits)


def scan_g1(pts: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """k·P per row on G1 by the bit-serial ladder: ``pts`` [K, 3, 38]
    int32 × ``bits`` [K, nbits] int32 msb-first → [K, 3, 38]."""
    return _run("scan_g1", scan_plain, pts, bits)


def _host_aux(aux, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(aux, dtype=np.int32)).to(device)


def scalar_mul_windowed(pts: torch.Tensor, bits) -> torch.Tensor:
    """Batched G1 scalar-mul: ``pts`` [K, 3, 38] int32 (on the device
    that runs it) × ``bits`` [K, nbits] msb-first → [K, 3, 38] — the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    return win_g1(pts, _host_aux(bits_to_digits(np.asarray(bits)), pts.device))


def scalar_mul_windowed_g2(pts: torch.Tensor, bits) -> torch.Tensor:
    """Batched G2 scalar-mul (the counterpart of
    ``pallas_ec.scalar_mul_windowed_g2``): ``pts`` [K, 3, 2, 38] int32 ×
    ``bits`` [K, nbits] msb-first → [K, 3, 2, 38]."""
    return win_g2(pts, _host_aux(bits_to_digits(np.asarray(bits)), pts.device))


def scalar_mul_scan(pts: torch.Tensor, bits) -> torch.Tensor:
    """Batched G1 scalar-mul by the bit-serial ladder (the counterpart
    of ``pallas_ec.scalar_mul_pallas``): ``pts`` [K, 3, 38] int32 ×
    ``bits`` [K, nbits] msb-first → [K, 3, 38]."""
    return scan_g1(pts, _host_aux(bits, pts.device))
