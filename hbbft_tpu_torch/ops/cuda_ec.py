"""The port's CUDA kernels and their plain twins.

The port of ``hbbft_tpu/ops/pallas_ec.py``.  Its four Pallas kernels
become CUDA C++ written by hand for Hopper; the three scalar
multiplications share the Montgomery field of ``csrc/bls_mont.cuh``:

- ``_make_windowed_kernel(g2=False)`` (exec name ``win_g1``) →
  ``csrc/win_g1.cu``, wrapper :func:`win_g1`, entry
  :func:`scalar_mul_windowed`;
- ``_make_windowed_kernel(g2=True)`` (``win_g2``) → ``csrc/win_g2.cu``,
  wrapper :func:`win_g2`, entry :func:`scalar_mul_windowed_g2`;
- ``_scalar_mul_kernel`` (``scan_g1``) → ``csrc/scan_g1.cu``, wrapper
  :func:`scan_g1`, entry :func:`scalar_mul_scan` (the counterpart of
  ``scalar_mul_pallas``);
- ``_ring_permute_kernel`` (``ring_permute``) → ``csrc/ring_permute.cu``,
  wrapper :func:`ring_permute` over the shards of a
  ``parallel.mesh.Mesh`` (one launch per sending card and round, planned
  by :func:`ring_plan`, through :func:`ring_copies`).

Each wrapper, on a CUDA tensor, launches its kernel (or raises) — never
a fallback; on a CPU tensor it runs the kernel's plain PyTorch version
(:func:`windowed_plain`, :func:`windowed_g2_plain`, :func:`scan_plain`),
the same schedule on ``ops/ec.py``'s ``PointKernel``.  The kernels
compute the same field operations in the same order in Montgomery form
and return each coordinate's canonical residue, so they agree with their
twins at canonical values (``limbs.fq().canon``), coordinate by
coordinate, and ``chip_smoke.py`` compares them so, with tolerance 0.
``LAUNCHES`` counts kernel launches (and nothing else), so a run can
show that a path went through a kernel.  The layouts at these functions are the reference's:
``[K, 3, 38]`` (G1) or ``[K, 3, 2, 38]`` (G2) int32 points and
``[K, n]`` int32 digits or bits; the TPU's tile transpose has no
counterpart (one thread per point reads its own row).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, List, Sequence, Set, Tuple

import numpy as np
import torch

from . import kernels
from . import limbs as LB
from .ec import PointKernel, g1_kernel, g2_kernel

# every kernel of the port, ``ops/fr.py``'s ``fr_matmul`` and ``fr_planes``,
# ``ops/cosim_step.py``'s ``cosim_hist`` and ``cosim_step``, ``ops/sha256.py``'s
# ``sha256`` and ``merkle_forest`` and ``ops/gf256.py``'s ``gf_matmul`` included
LAUNCHES: Dict[str, int] = {
    "win_g1": 0, "win_g2": 0, "scan_g1": 0, "ring_permute": 0, "fr_matmul": 0, "fr_planes": 0,
    "cosim_hist": 0, "cosim_step": 0, "sha256": 0, "merkle_forest": 0, "gf_matmul": 0,
}
# the reliable-broadcast plane's kernels
RBC_KERNELS = ("sha256", "merkle_forest", "gf_matmul")

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
    int32 × ``bits`` [K, nbits] int32 msb-first → [K, 3, 38] (canonical
    limbs from the kernel)."""
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


# ---------------------------------------------------------------------------
# The ring step of the mesh reduction
# ---------------------------------------------------------------------------
# A mesh here is duck-typed: ``devices`` (shard j's torch.device),
# ``streams`` (shard j's CUDA stream, None on the CPU) and ``on(j)`` (a
# context that makes shard j's device and stream current) — see
# ``parallel/mesh.py``.


def _check_ring(bufs: List[torch.Tensor], mesh) -> None:
    if len(bufs) != len(mesh.devices):
        raise ValueError(f"{len(bufs)} buffers for a mesh of {len(mesh.devices)} shards")
    for j, (b, d) in enumerate(zip(bufs, mesh.devices)):
        if b.device != d:
            raise ValueError(f"shard {j}'s buffer is on {b.device}, its shard on {d}")
        if b.shape != bufs[0].shape or b.dtype != bufs[0].dtype:
            raise ValueError("ring buffers differ in shape or dtype")


def ring_permute_plain(bufs: List[torch.Tensor], mesh) -> List[torch.Tensor]:
    """The plain PyTorch version of ``ring_permute``: shard j receives
    shard (j-1)'s buffer, by ``Tensor.to`` on the current streams."""
    _check_ring(bufs, mesh)
    n = len(bufs)
    return [bufs[(j - 1) % n].to(mesh.devices[j], copy=True) for j in range(n)]


# copies in one launch's job table (ring_permute.cu's MAX_JOBS)
RING_MAX_JOBS = 8
# (sender card, receiver card) pairs with peer access enabled: the CUDA
# context keeps it for the process, so each pair is enabled once
_PEERS: Set[Tuple[int, int]] = set()


@functools.lru_cache(maxsize=None)
def _ring_lib() -> ctypes.CDLL:
    """The ring library, its signatures set once."""
    lib = kernels.load("ring_permute")
    p, u64 = ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)
    lib.ring_permute_launch.argtypes = [u64, u64, u64, ctypes.c_int, ctypes.c_int, p]
    lib.ring_permute_launch.restype = ctypes.c_int
    lib.ring_enable_peer.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ring_enable_peer.restype = ctypes.c_int
    lib.ring_permute_error_string.argtypes = [ctypes.c_int]
    lib.ring_permute_error_string.restype = ctypes.c_char_p
    lib.ring_permute_max_jobs.restype = ctypes.c_int
    if lib.ring_permute_max_jobs() != RING_MAX_JOBS:
        raise RuntimeError("ring_permute.cu's job table differs from RING_MAX_JOBS")
    return lib


def _ring_error(lib: ctypes.CDLL, what: str, rc: int) -> RuntimeError:
    return RuntimeError(f"{what} failed: {lib.ring_permute_error_string(rc).decode()} ({rc})")


def ring_plan(devices: Sequence[torch.device]) -> List[List[int]]:
    """The launches of one ring round over shards on ``devices``: shard j
    sends to shard (j+1) % n, and the senders on one card share launches
    of at most ``RING_MAX_JOBS`` copies, in shard order (cards in order of
    their first shard).  Returns each launch's sending shards; the first
    one's stream runs the launch."""
    by_card: Dict[torch.device, List[int]] = {}
    for j, d in enumerate(devices):
        by_card.setdefault(torch.device(d), []).append(j)
    return [
        shards[i : i + RING_MAX_JOBS]
        for shards in by_card.values()
        for i in range(0, len(shards), RING_MAX_JOBS)
    ]


def ring_copies(
    srcs: Sequence[torch.Tensor], dsts: Sequence[torch.Tensor], stream: torch.cuda.Stream
) -> None:
    """Store each ``srcs[i]``'s bytes into ``dsts[i]`` (same shape and
    dtype, contiguous; every src on ``stream``'s card, each dst on any
    card) from ``stream``, in one launch of the ring kernel of at most
    ``RING_MAX_JOBS`` copies (:func:`ring_plan` splits a round to fit).
    No sync; the caller orders the streams.  Raises if peer access or the
    launch fails."""
    if len(srcs) != len(dsts):
        raise ValueError(f"{len(srcs)} sources for {len(dsts)} destinations")
    if len(srcs) > RING_MAX_JOBS:
        raise ValueError(f"{len(srcs)} copies for a launch of at most {RING_MAX_JOBS}")
    for src, dst in zip(srcs, dsts):
        if not (src.is_cuda and dst.is_cuda):
            raise ValueError(f"ring copies run on cuda tensors, not {src.device} -> {dst.device}")
    sender = stream.device
    for src, dst in zip(srcs, dsts):
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError("a ring copy takes tensors of one shape and dtype")
        if not (src.is_contiguous() and dst.is_contiguous()):
            raise ValueError("a ring copy takes contiguous tensors")
        if src.device != sender:
            raise ValueError(f"the stream is on {sender}, a sender on {src.device}")
    lib = _ring_lib()
    card = sender.index
    for dst in dsts:
        pair = (card, dst.device.index)
        if pair[0] != pair[1] and pair not in _PEERS:
            rc = lib.ring_enable_peer(*pair)
            if rc != 0:
                raise _ring_error(lib, f"peer access cuda:{pair[0]} -> cuda:{pair[1]}", rc)
            _PEERS.add(pair)
    jobs = [(s.data_ptr(), d.data_ptr(), s.nbytes) for s, d in zip(srcs, dsts) if s.nbytes]
    if not jobs:
        return
    src_a, dst_a, nbytes_a = ((ctypes.c_uint64 * len(col))(*col) for col in zip(*jobs))
    rc = lib.ring_permute_launch(src_a, dst_a, nbytes_a, len(jobs), card, stream.cuda_stream)
    if rc != 0:
        raise _ring_error(lib, "ring_permute launch", rc)
    LAUNCHES["ring_permute"] += 1


def ring_copy(src: torch.Tensor, dst: torch.Tensor, stream: torch.cuda.Stream) -> None:
    """One launch of the ring kernel with one job: :func:`ring_copies`
    of ``src`` into ``dst``."""
    ring_copies([src], [dst], stream)


def ring_permute(bufs: List[torch.Tensor], mesh) -> List[torch.Tensor]:
    """One ring step (the counterpart of ``pallas_ec.ring_permute``):
    shard j's buffer lands on shard (j+1) % n, so shard j receives shard
    (j-1)'s.  ``bufs[j]`` lies on ``mesh.devices[j]`` and is ready in
    the order of ``mesh.streams[j]``; the received buffers are ready in
    the same sense.

    On CUDA each card launches the kernel once for the shards it sends
    from (:func:`ring_plan`), on its first sender's stream, into buffers
    on the right neighbours.  The two DMA semaphores of the TPU kernel
    become events: the launching stream waits until every sender's
    buffer is written and every receive buffer is free on its shard's
    stream, and every sender's and receiver's stream waits for the
    launch before anything it queues next.  The receive buffers are
    allocated on the receivers' streams and, with the sent buffers,
    recorded on the launching stream, so the caching allocator does not
    hand them out again while the copy is in flight.  CPU shards run
    :func:`ring_permute_plain`."""
    _check_ring(bufs, mesh)
    n = len(bufs)
    if all(b.device.type == "cpu" for b in bufs):
        return ring_permute_plain(bufs, mesh)
    if not all(b.device.type == "cuda" for b in bufs):
        raise ValueError("ring_permute runs on cuda or cpu shards")
    sent, recv, ready = [], [], []
    for j in range(n):
        with mesh.on(j):
            sent.append(bufs[j].contiguous())
            msg = bufs[(j - 1) % n]
            recv.append(torch.empty(msg.shape, dtype=msg.dtype, device=mesh.devices[j]))
            ev = torch.cuda.Event()
            ev.record(mesh.streams[j])  # shard j's buffer written, its receive buffer free
            ready.append(ev)
    finished = []
    for senders in ring_plan(mesh.devices):
        lead = senders[0]
        touched = sorted((set(senders) | {(j + 1) % n for j in senders}) - {lead})
        stream = mesh.streams[lead]
        for k in touched:
            stream.wait_event(ready[k])
        srcs = [sent[j] for j in senders]
        dsts = [recv[(j + 1) % n] for j in senders]
        for t in srcs + dsts:
            t.record_stream(stream)
        ring_copies(srcs, dsts, stream)
        done = torch.cuda.Event()
        done.record(stream)
        finished.append((done, touched))
    # only now, so that no card's launch waits for another card's
    for done, touched in finished:
        for k in touched:
            mesh.streams[k].wait_event(done)
    return recv
