"""The packed co-simulation's decision step: the ``cosim_hist`` and
``cosim_step`` kernels and their plain PyTorch versions.

The port of the body of ``hbbft_tpu/parallel/mesh.py::
packed_cosim_step_fn`` (``_body``, ``:506-534``), an XLA program the TPU
fuses into one launch an epoch.  Over n packed instance columns and a
``[Z, Z]`` zone-reachability matrix:

- :func:`cosim_hist` — ``a[z] = Σ_j dst_on[j]·[zone_j = z]``, the live,
  on-time receivers of each zone (``csrc/cosim_step.cu``,
  ``cosim_hist_kernel``);
- :func:`cosim_decide` — per instance p, the yes votes
  ``c1 = ovr_mask ? ovr_c1 : prop_on·Σ_z reach[zone_p, z]·a[z]``, the no
  votes ``c0 = n_live − c1``, and the closed form of the honest binary
  agreement (lift past f+1, bin past 2f+1): ``accepted = has1``,
  ``nondef = has1 & has0`` (the instance needs a real coin),
  ``dec_fail = accepted & (n_live − forged_cnt ≤ f)``, and
  ``commit += accepted`` in place (``cosim_step_kernel``);
- :func:`cosim_step` — both, on one device.

Columns: ``prop_on``, ``dst_on``, ``ovr_mask`` int8; ``zone``, ``ovr_c1``,
``forged_cnt``, ``commit`` int32; ``reach`` uint8 ``[Z, Z]``; every row
column of one length.  A zone must lie in ``[0, Z)``: outside it, a row
adds nothing to the histogram and its reach row is clamped (the
reference's scatter drops and its gather clamps).  Arithmetic is int32
and wraps as XLA's does.

Each wrapper, on CUDA tensors, launches its kernel on the current stream
(or raises; never a fallback) and counts it in
``cuda_ec.LAUNCHES["cosim_hist"]`` / ``["cosim_step"]``; on CPU tensors
it runs the plain version.  The plain versions are for the CPU tests and
for ``chip_smoke.py``'s comparison on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import kernels
from .cuda_ec import LAUNCHES

_ROW_DTYPES = {
    "prop_on": torch.int8,
    "dst_on": torch.int8,
    "zone": torch.int32,
    "ovr_mask": torch.int8,
    "ovr_c1": torch.int32,
    "forged_cnt": torch.int32,
    "commit": torch.int32,
}


def _check(device: torch.device, n: int, Z: int, **cols: torch.Tensor) -> None:
    if Z < 1:
        raise ValueError(f"the co-sim step takes Z ≥ 1 zones, not {Z}")
    for name, t in cols.items():
        want = (Z,) if name == "a" else (Z, Z) if name == "reach" else (n,)
        dtype = torch.uint8 if name == "reach" else _ROW_DTYPES.get(name, torch.int32)
        if t.dtype != dtype or tuple(t.shape) != want:
            raise ValueError(
                f"{name} must be {dtype} of shape {want}, got {t.dtype} {tuple(t.shape)}"
            )
        if t.device != device:
            raise ValueError(f"{name} lies on {t.device}, the step on {device}")
        if device.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def cosim_hist_plain(dst_on: torch.Tensor, zone: torch.Tensor, Z: int) -> torch.Tensor:
    """The plain PyTorch version of ``cosim_hist``: ``[Z]`` int32 (rows
    outside ``[0, Z)`` add 0 to zone 0; no host sync)."""
    ok = (zone >= 0) & (zone < Z)
    a = torch.zeros(Z, dtype=torch.int64, device=zone.device)
    a.index_add_(0, torch.where(ok, zone, 0).to(torch.int64),
                 torch.where(ok, dst_on.to(torch.int64), 0))
    return a.to(torch.int32)


def cosim_decide_plain(
    prop_on: torch.Tensor,
    zone: torch.Tensor,
    reach: torch.Tensor,
    ovr_mask: torch.Tensor,
    ovr_c1: torch.Tensor,
    forged_cnt: torch.Tensor,
    commit: torch.Tensor,
    a: torch.Tensor,
    n_live: int,
    f: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of ``cosim_step``: the reference's
    algebra on tensors; ``commit`` is advanced in place."""
    Z = a.shape[0]
    rows = reach.to(torch.int64)[zone.clamp(0, Z - 1).to(torch.int64)]  # [n, Z]
    c1_base = (prop_on.to(torch.int64) * (rows * a.to(torch.int64)[None, :]).sum(-1)).to(torch.int32)
    c1 = torch.where(ovr_mask != 0, ovr_c1, c1_base)
    c0 = (n_live - c1.to(torch.int64)).to(torch.int32)
    lift1 = torch.where(c1 >= f + 1, torch.full_like(c1, n_live), c1)
    lift0 = torch.where(c0 >= f + 1, torch.full_like(c0, n_live), c0)
    bin1 = lift1 >= 2 * f + 1
    bin0 = lift0 >= 2 * f + 1
    pos = c1 > 0
    neg = c0 > 0
    has1 = (pos & bin1) | (pos & ~bin1 & ~bin0) | (neg & ~bin0)
    has0 = (neg & bin0) | (pos & ~bin1 & bin0)
    valid = (n_live - forged_cnt.to(torch.int64)).to(torch.int32)
    dec_fail = has1 & (valid <= f)
    commit.add_(has1.to(torch.int32))
    return has1.to(torch.int8), (has1 & has0).to(torch.int8), dec_fail.to(torch.int8)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernels' library, its signatures set once."""
    lib = kernels.load("cosim_step")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cosim_hist_launch.argtypes = [p, p, i, i, p, p]
    lib.cosim_hist_launch.restype = i
    lib.cosim_step_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, p, p, p, p]
    lib.cosim_step_launch.restype = i
    lib.cosim_error_string.argtypes = [i]
    lib.cosim_error_string.restype = ctypes.c_char_p
    return lib


def _raise(lib: ctypes.CDLL, what: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.cosim_error_string(rc).decode()} ({rc})")


def _on_card(device: torch.device, name: str) -> bool:
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {device}")
    return True


def cosim_hist(dst_on: torch.Tensor, zone: torch.Tensor, Z: int) -> torch.Tensor:
    """The zone histogram ``[Z]`` int32 of ``dst_on`` (the wrapper of the
    ``cosim_hist`` kernel)."""
    n = zone.shape[0]
    _check(zone.device, n, Z, dst_on=dst_on, zone=zone)
    if not _on_card(zone.device, "cosim_hist"):
        return cosim_hist_plain(dst_on, zone, Z)
    a = torch.empty(Z, dtype=torch.int32, device=zone.device)
    lib = _lib()
    with torch.cuda.device(zone.device):
        rc = lib.cosim_hist_launch(
            dst_on.data_ptr(), zone.data_ptr(), n, Z, a.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise(lib, "cosim_hist", rc)
    if n:
        LAUNCHES["cosim_hist"] += 1
    return a


def cosim_decide(
    prop_on: torch.Tensor,
    zone: torch.Tensor,
    reach: torch.Tensor,
    ovr_mask: torch.Tensor,
    ovr_c1: torch.Tensor,
    forged_cnt: torch.Tensor,
    commit: torch.Tensor,
    a: torch.Tensor,
    n_live: int,
    f: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every instance's decision given the histogram ``a`` (the wrapper
    of the ``cosim_step`` kernel): ``(accepted, nondef, dec_fail)`` int8
    0/1, ``commit`` advanced in place."""
    n, Z = zone.shape[0], a.shape[0]
    _check(zone.device, n, Z, prop_on=prop_on, zone=zone, reach=reach, ovr_mask=ovr_mask,
           ovr_c1=ovr_c1, forged_cnt=forged_cnt, commit=commit, a=a)
    if not _on_card(zone.device, "cosim_step"):
        return cosim_decide_plain(prop_on, zone, reach, ovr_mask, ovr_c1, forged_cnt, commit,
                                  a, n_live, f)
    outs = [torch.empty(n, dtype=torch.int8, device=zone.device) for _ in range(3)]
    lib = _lib()
    with torch.cuda.device(zone.device):
        rc = lib.cosim_step_launch(
            prop_on.data_ptr(), zone.data_ptr(), reach.data_ptr(), ovr_mask.data_ptr(),
            ovr_c1.data_ptr(), forged_cnt.data_ptr(), commit.data_ptr(), a.data_ptr(),
            n, Z, int(n_live), int(f), *(o.data_ptr() for o in outs),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise(lib, "cosim_step", rc)
    if n:
        LAUNCHES["cosim_step"] += 1
    return outs[0], outs[1], outs[2]


def cosim_step(
    prop_on: torch.Tensor,
    dst_on: torch.Tensor,
    zone: torch.Tensor,
    reach: torch.Tensor,
    ovr_mask: torch.Tensor,
    ovr_c1: torch.Tensor,
    forged_cnt: torch.Tensor,
    commit: torch.Tensor,
    n_live: int,
    f: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One device's whole step: :func:`cosim_hist`, then
    :func:`cosim_decide` (two launches on the card)."""
    a = cosim_hist(dst_on, zone, reach.shape[0])
    return cosim_decide(prop_on, zone, reach, ovr_mask, ovr_c1, forged_cnt, commit, a,
                        n_live, f)


def cosim_step_plain(
    prop_on: torch.Tensor,
    dst_on: torch.Tensor,
    zone: torch.Tensor,
    reach: torch.Tensor,
    ovr_mask: torch.Tensor,
    ovr_c1: torch.Tensor,
    forged_cnt: torch.Tensor,
    commit: torch.Tensor,
    n_live: int,
    f: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`cosim_step`."""
    a = cosim_hist_plain(dst_on, zone, reach.shape[0])
    return cosim_decide_plain(prop_on, zone, reach, ovr_mask, ovr_c1, forged_cnt, commit, a,
                              n_live, f)
