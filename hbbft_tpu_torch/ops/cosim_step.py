"""The packed co-simulation's decision step: the ``cosim_hist`` and
``cosim_step`` kernels and their plain PyTorch versions.

The port of the body of ``hbbft_tpu/parallel/mesh.py::
packed_cosim_step_fn`` (``_body``, ``:506-534``), an XLA program the TPU
fuses into one launch an epoch.  Over n packed instance columns and a
``[Z, Z]`` zone-reachability matrix:

- :func:`cosim_hist` — ``a[z] = Σ_j dst_on[j]·[zone_j = z]``, the live,
  on-time receivers of each zone (``csrc/cosim_step.cu``,
  ``cosim_hist_kernel``: a mesh shard's partial);
- :func:`cosim_decide` — per instance p, the yes votes
  ``c1 = ovr_mask ? ovr_c1 : prop_on·Σ_z reach[zone_p, z]·a[z]``, the no
  votes ``c0 = n_live − c1``, and the closed form of the honest binary
  agreement (lift past f+1, bin past 2f+1): ``accepted = has1``,
  ``nondef = has1 & has0`` (the instance needs a real coin),
  ``dec_fail = accepted & (n_live − forged_cnt ≤ f)``, and
  ``commit += accepted`` in place (``cosim_step_kernel<false>``: a mesh
  shard's decision, given the ring-summed histogram);
- :func:`cosim_step` — both on one device, in ONE launch on the card
  (``cosim_step_kernel<true>``, a cooperative grid: each block's
  histogram, a grid barrier, then the decision from registers).

Columns: ``prop_on``, ``dst_on``, ``ovr_mask`` int8; ``zone``, ``ovr_c1``,
``forged_cnt``, ``commit`` int32; ``reach`` uint8 ``[Z, Z]``; every row
column of one length.  A zone must lie in ``[0, Z)``: outside it, a row
adds nothing to the histogram and its reach row is clamped (the
reference's scatter drops and its gather clamps).  Arithmetic is int32
and wraps as XLA's does.  On the card the columns may be any contiguous
views: 16-byte aligned ones are read and written with vector accesses,
others with scalar ones, with the same results.

The kernels keep state between launches in a :class:`CosimScratch`
(``4 + 3·Z`` int32 words on the card, zeroed once when made): the grid
barrier's word, ``cosim_hist``'s ticket and the histogram accumulators,
each left as the launch found it, so no epoch pays a memset.  A scratch
serves one stream at a time; the wrappers take one
(``parallel/mesh.packed_cosim_step_fn`` owns one a shard) or use the
module's own for the device, stream and Z.

Each wrapper, on CUDA tensors, launches its kernel on the current stream
(or raises — a refused cooperative launch too; never a fallback) and
counts it in ``cuda_ec.LAUNCHES["cosim_hist"]`` / ``["cosim_step"]``
(the decision of a mesh shard and the one-launch step both count as
``cosim_step``); on CPU tensors it runs the plain version.  The plain
versions are for the CPU tests and for ``chip_smoke.py``'s comparison on
the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

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

# the scratch's header words before its three [Z] accumulators
# (csrc/cosim_step.cu: W_HEAD)
_HEAD_WORDS = 4


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


class CosimScratch:
    """The kernels' state between launches on one device for one Z:
    ``words``, ``4 + 3·Z`` int32 zeroed once here (on the current stream)
    and left zeroed by every launch that completes.  Use it from one
    stream at a time."""

    __slots__ = ("Z", "words")

    def __init__(self, Z: int, device: torch.device):
        self.Z = int(Z)
        self.words = torch.zeros(_HEAD_WORDS + 3 * self.Z, dtype=torch.int32, device=device)


_SCRATCH: Dict[Tuple[torch.device, int, int], CosimScratch] = {}


def _scratch(scratch: Optional[CosimScratch], device: torch.device, Z: int) -> CosimScratch:
    if scratch is not None:
        if scratch.Z != Z or scratch.words.device != device:
            raise ValueError(
                f"a scratch for Z = {scratch.Z} on {scratch.words.device}, the step's Z = {Z} "
                f"on {device}"
            )
        return scratch
    key = (device, torch.cuda.current_stream(device).cuda_stream, Z)
    if key not in _SCRATCH:
        _SCRATCH[key] = CosimScratch(Z, device)
    return _SCRATCH[key]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernels' library, its signatures set once."""
    return bind(kernels.load("cosim_step"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures on a build of ``csrc/cosim_step.cu``
    (``scripts/torch_cosim_sweep.py`` binds patched builds with it)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cosim_step_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, p, p, p, p, p]
    lib.cosim_step_launch.restype = i
    lib.cosim_hist_launch.argtypes = [p, p, i, i, p, p, p]
    lib.cosim_hist_launch.restype = i
    lib.cosim_decide_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, p, p, p, p]
    lib.cosim_decide_launch.restype = i
    lib.cosim_step_blocks.argtypes = [i]
    lib.cosim_step_blocks.restype = i
    lib.cosim_probe_launch.argtypes = [i, p, i, p]
    lib.cosim_probe_launch.restype = i
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


def _launch(fn, device: torch.device, *args) -> int:
    """Call a launcher with ``device`` current and its current stream
    last (the device context is entered only when another is current)."""
    if device.index is not None and device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return fn(*args, torch.cuda.current_stream().cuda_stream)
    return fn(*args, torch.cuda.current_stream().cuda_stream)


def _masks(n: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three int8 masks as rows of one allocation, each row starting
    16-byte aligned so that the kernel stores them a chunk at a time."""
    m = torch.empty((3, -(-n // 16) * 16), dtype=torch.int8, device=device)
    return m[0, :n], m[1, :n], m[2, :n]


def cosim_hist(dst_on: torch.Tensor, zone: torch.Tensor, Z: int,
               scratch: Optional[CosimScratch] = None) -> torch.Tensor:
    """The zone histogram ``[Z]`` int32 of ``dst_on`` (the wrapper of the
    ``cosim_hist`` kernel: one launch, also at n = 0)."""
    n = zone.shape[0]
    _check(zone.device, n, Z, dst_on=dst_on, zone=zone)
    if not _on_card(zone.device, "cosim_hist"):
        return cosim_hist_plain(dst_on, zone, Z)
    a = torch.empty(Z, dtype=torch.int32, device=zone.device)
    scratch = _scratch(scratch, zone.device, Z)
    lib = _lib()
    rc = _launch(lib.cosim_hist_launch, zone.device, dst_on.data_ptr(), zone.data_ptr(), n, Z,
                 a.data_ptr(), scratch.words.data_ptr())
    _raise(lib, "cosim_hist", rc)
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
    """Every instance's decision given the histogram ``a`` (a mesh
    shard's: the wrapper of ``cosim_step_kernel<false>``, counted as
    ``cosim_step``; no launch at n = 0): ``(accepted, nondef, dec_fail)``
    int8 0/1, ``commit`` advanced in place."""
    n, Z = zone.shape[0], a.shape[0]
    _check(zone.device, n, Z, prop_on=prop_on, zone=zone, reach=reach, ovr_mask=ovr_mask,
           ovr_c1=ovr_c1, forged_cnt=forged_cnt, commit=commit, a=a)
    if not _on_card(zone.device, "cosim_step"):
        return cosim_decide_plain(prop_on, zone, reach, ovr_mask, ovr_c1, forged_cnt, commit,
                                  a, n_live, f)
    outs = _masks(n, zone.device)
    if n == 0:
        return outs
    lib = _lib()
    rc = _launch(
        lib.cosim_decide_launch, zone.device,
        prop_on.data_ptr(), zone.data_ptr(), reach.data_ptr(), ovr_mask.data_ptr(),
        ovr_c1.data_ptr(), forged_cnt.data_ptr(), commit.data_ptr(), a.data_ptr(),
        n, Z, int(n_live), int(f), *(o.data_ptr() for o in outs),
    )
    _raise(lib, "cosim_step", rc)
    LAUNCHES["cosim_step"] += 1
    return outs


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
    scratch: Optional[CosimScratch] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One device's whole step: the histogram and every decision, one
    cooperative launch of ``cosim_step_kernel<true>`` on the card (no
    launch at n = 0); ``(accepted, nondef, dec_fail)`` int8 0/1,
    ``commit`` advanced in place."""
    n, Z = zone.shape[0], reach.shape[0]
    _check(zone.device, n, Z, prop_on=prop_on, dst_on=dst_on, zone=zone, reach=reach,
           ovr_mask=ovr_mask, ovr_c1=ovr_c1, forged_cnt=forged_cnt, commit=commit)
    if not _on_card(zone.device, "cosim_step"):
        return cosim_step_plain(prop_on, dst_on, zone, reach, ovr_mask, ovr_c1, forged_cnt,
                                commit, n_live, f)
    outs = _masks(n, zone.device)
    if n == 0:
        return outs
    scratch = _scratch(scratch, zone.device, Z)
    lib = _lib()
    rc = _launch(
        lib.cosim_step_launch, zone.device,
        prop_on.data_ptr(), dst_on.data_ptr(), zone.data_ptr(), reach.data_ptr(),
        ovr_mask.data_ptr(), ovr_c1.data_ptr(), forged_cnt.data_ptr(), commit.data_ptr(),
        n, Z, int(n_live), int(f), *(o.data_ptr() for o in outs), scratch.words.data_ptr(),
    )
    _raise(lib, "cosim_step", rc)
    LAUNCHES["cosim_step"] += 1
    return outs


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


# ---------------------------------------------------------------------------
# Launch-cost probes (chip_smoke.py's floor beside the step)
# ---------------------------------------------------------------------------

PROBES = {"empty": 0, "grid": 1, "barrier": 2}


def step_blocks(n: int, device: torch.device) -> int:
    """The blocks of :func:`cosim_step`'s cooperative grid at n rows on
    ``device`` (a card)."""
    lib = _lib()
    with torch.cuda.device(device):
        blocks = lib.cosim_step_blocks(n)
    _raise(lib, "cosim_step_blocks", -blocks if blocks < 0 else 0)
    return blocks


def launch_probe(kind: str, device: torch.device, blocks: int = 1,
                 scratch: Optional[torch.Tensor] = None) -> None:
    """Enqueue one launch-cost probe on ``device``'s current stream:
    ``"empty"`` an empty ``<<<1, 32>>>`` kernel; ``"grid"`` a cooperative
    grid of ``blocks`` × 256 threads that does nothing; ``"barrier"`` the
    same grid crossing the step's grid barrier once, on ``scratch`` (its
    own zeroed int32 words, at least 4).  Counted nowhere."""
    lib = _lib()
    ptr = scratch.data_ptr() if scratch is not None else 0
    if kind == "barrier" and (scratch is None or scratch.numel() < _HEAD_WORDS):
        raise ValueError("the barrier probe needs a scratch of its own")
    _raise(lib, f"the {kind} probe", _launch(lib.cosim_probe_launch, device, PROBES[kind], ptr,
                                              blocks))
