"""Build and load the port's hand-written CUDA kernels.

Each kernel is one CUDA C++ source under ``hbbft_tpu_torch/csrc/`` with
a plain C entry point.  The scalar multiplications (``win_g1.cu``,
``win_g2.cu``, ``scan_g1.cu``) share the Montgomery field and ladders of
``csrc/bls_mont.cuh``; ``ring_permute.cu`` is a copy and includes no
field code; ``fr_matmul.cu`` (the DKG's Fr products, ``ops/fr.py``)
takes its arithmetic from ``csrc/fr_words.cuh``; ``cosim_step.cu`` (the
packed co-simulation's step, ``ops/cosim_step.py``) holds the
``cosim_step`` kernel (the whole step in one cooperative launch, or a
mesh shard's decision) and the ``cosim_hist`` kernel; ``sha256.cu`` (the
reliable broadcast's hashing, ``ops/sha256.py``) holds the ``sha256``
kernel and ``merkle.cu`` the ``merkle_forest`` kernel, both over the
compression of ``csrc/sha256.cuh``; ``gf_matmul.cu`` (its Reed–Solomon
products, ``ops/gf256.py``) holds the ``gf_matmul`` kernel for GF(2^8)
and GF(2^16) on the int8 tensor cores.  A kernel is compiled
on first use by ``nvcc`` for Hopper (``-gencode
arch=compute_90a,code=sm_90a``) into a shared library under
``build/hbbft_tpu_torch/`` at the repo root, and loaded with ``ctypes``.  The library's file name carries a hash of the source,
of every header beside it (``csrc/*.cuh``) and of the flags, so an
edited source or header is never shadowed by a stale build; an
``fcntl`` lock serialises concurrent builders.  ``ptxas -v`` output
(registers, stack, spills) lands in a ``.log`` beside each library.

Nothing is built or loaded at import time: the CPU tests import every
module on hosts without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
BUILD_DIR = PKG_DIR.parent / "build" / "hbbft_tpu_torch"

CSRC = PKG_DIR / "csrc"
SOURCES: Dict[str, pathlib.Path] = {
    name: CSRC / f"{name}.cu"
    for name in (
        "win_g1", "win_g2", "scan_g1", "ring_permute", "fr_matmul", "cosim_step", "sha256",
        "merkle", "gf_matmul",
    )
}

NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a CUDA host")
    return found


def lib_path(name: str) -> pathlib.Path:
    src = SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(src.parent.glob("*.cuh")):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> float:
    """Compile one kernel source if its library is missing; returns the
    seconds spent (0.0 when it was already built)."""
    out = lib_path(name)
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return 0.0
        tmp = out.with_suffix(".tmp.%d" % os.getpid())
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            capture_output=True,
            text=True,
            timeout=900,
        )
        (BUILD_DIR / f"{name}.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name} (rc {proc.returncode}):\n"
                + proc.stderr[-4000:]
            )
        os.replace(tmp, out)
    return time.perf_counter() - t0


def build_all() -> Dict[str, float]:
    """Build every kernel at once (one ``nvcc`` per source, all started
    together); returns each build's seconds.  Raises if any failed."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        futs = {n: pool.submit(build, n) for n in SOURCES}
        return {n: f.result() for n, f in futs.items()}


def build_log(name: str) -> str:
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(lib_path(name)))
            _LIBS[name] = lib
        return lib
