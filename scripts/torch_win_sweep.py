#!/usr/bin/env python3
"""Launch-shape and build-variant sweep of the scalar-mul kernels
``win_g1``, ``win_g2`` and ``scan_g1``.

The shipped sources are the default.  Every other variant is a copy of
``hbbft_tpu_torch/csrc`` under ``build/hbbft_tpu_torch/sweep/<variant>``
with text patches applied, built with the same ``nvcc`` flags and
loaded by ``ctypes``; the patches live in this script only:

- ``threads=N,floor=B``: ``THREADS`` and the ``__launch_bounds__``
  occupancy floor (minimum blocks an SM, which caps the registers a
  thread);
- ``inlined``: the Fq product ``__forceinline__`` at every call site
  instead of one ``__noinline__`` call;
- ``ptx``: the Fq product written with PTX carry chains
  (``mad.lo.cc`` / ``madc.hi.cc``, two instructions a partial product)
  instead of C ``uint64_t`` arithmetic;
- ``one-lane`` (``win_g2``): one thread a point, with a one-thread Fq2
  (Karatsuba, 3 Fq products an Fq2 product) in place of the lane pair;
- ``no-sqr`` (``scan_g1``): the ladder doubles by ``point_add(acc, acc)``
  (12 Fq products) in place of ``point_dbl`` (6 of them ``fe_sqr``);
- ``sqr-inlined`` (``scan_g1``): the Fq square ``__forceinline__``.

All builds run at once (one ``nvcc`` each); a variant that fails to
build is reported and skipped.  For each the script prints ptxas's
registers, stack and spill bytes (from the build's log), the build
seconds and the kernel's ms at the path's shape (CUDA events, median of
``--reps`` after a warm-up):

- ``win_g1``: 65,536 points × 24 windows (the 1024 × 64 flush's
  96-bit product coefficients);
- ``win_g2``: 236,672 points × 64 windows (the N = 128 DKG's fused
  MSM).  The G2 points are 4,096 distinct multiples of the generator
  repeated to that count: the ladder's work does not depend on the
  point, only on the shape;
- ``scan_g1``: 65,536 points × 255 bits of random scalars below r
  (chip_smoke.py's timed shape).

Every variant's output must equal the default build's exactly (both
are canonical limbs), and the default's must equal the plain version's
canonical residues on the first 512 rows.  Prints one JSON object per
variant, then the card's name and power limit.  Run from the repo root
on a CUDA host: ``python3 scripts/torch_win_sweep.py [--reps N] [--kernel NAME]``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import random
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = {"win_g1": (1 << 16, 24), "win_g2": (128 * 43 * 43, 64), "scan_g1": (1 << 16, 255)}
G2_DISTINCT = 4096
CHECK_ROWS = 512

FE_MUL_HEAD = "__device__ __noinline__ Fe fe_mul(const Fe a, const Fe b) {"
FE_SQR_HEAD = "__device__ __noinline__ Fe fe_sqr(const Fe a) {"

# the Fq product with PTX carry chains: row i adds a·b[i] into t and a
# 13th word A (lo halves, then hi halves one word up), then m·p with
# m = t[0]·(−p⁻¹), shifting down one word; the rows' values are the
# portable form's
PTX_FE_MUL = r"""
__device__ __noinline__ Fe fe_mul(const Fe a, const Fe b) {
  Fe t;
#pragma unroll
  for (int j = 0; j < NW; ++j) t.w[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint32_t A, x;
    asm("mov.u32 %12, 0;\n\t"
        "mad.lo.cc.u32 %0, %13, %25, %0;\n\t"
        "madc.lo.cc.u32 %1, %14, %25, %1;\n\t"
        "madc.lo.cc.u32 %2, %15, %25, %2;\n\t"
        "madc.lo.cc.u32 %3, %16, %25, %3;\n\t"
        "madc.lo.cc.u32 %4, %17, %25, %4;\n\t"
        "madc.lo.cc.u32 %5, %18, %25, %5;\n\t"
        "madc.lo.cc.u32 %6, %19, %25, %6;\n\t"
        "madc.lo.cc.u32 %7, %20, %25, %7;\n\t"
        "madc.lo.cc.u32 %8, %21, %25, %8;\n\t"
        "madc.lo.cc.u32 %9, %22, %25, %9;\n\t"
        "madc.lo.cc.u32 %10, %23, %25, %10;\n\t"
        "madc.lo.cc.u32 %11, %24, %25, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "mad.hi.cc.u32 %1, %13, %25, %1;\n\t"
        "madc.hi.cc.u32 %2, %14, %25, %2;\n\t"
        "madc.hi.cc.u32 %3, %15, %25, %3;\n\t"
        "madc.hi.cc.u32 %4, %16, %25, %4;\n\t"
        "madc.hi.cc.u32 %5, %17, %25, %5;\n\t"
        "madc.hi.cc.u32 %6, %18, %25, %6;\n\t"
        "madc.hi.cc.u32 %7, %19, %25, %7;\n\t"
        "madc.hi.cc.u32 %8, %20, %25, %8;\n\t"
        "madc.hi.cc.u32 %9, %21, %25, %9;\n\t"
        "madc.hi.cc.u32 %10, %22, %25, %10;\n\t"
        "madc.hi.cc.u32 %11, %23, %25, %11;\n\t"
        "madc.hi.u32 %12, %24, %25, %12;"
        : "+r"(t.w[0]), "+r"(t.w[1]), "+r"(t.w[2]), "+r"(t.w[3]), "+r"(t.w[4]), "+r"(t.w[5]), "+r"(t.w[6]), "+r"(t.w[7]), "+r"(t.w[8]), "+r"(t.w[9]), "+r"(t.w[10]), "+r"(t.w[11]),
          "=&r"(A)
        : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]), "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]), "r"(a.w[8]), "r"(a.w[9]), "r"(a.w[10]), "r"(a.w[11]), "r"(b.w[i]));
    const uint32_t m = t.w[0] * PINV;
    asm("mad.lo.cc.u32 %13, %14, %15, %0;\n\t"
        "madc.lo.cc.u32 %1, %14, %16, %1;\n\t"
        "madc.lo.cc.u32 %2, %14, %17, %2;\n\t"
        "madc.lo.cc.u32 %3, %14, %18, %3;\n\t"
        "madc.lo.cc.u32 %4, %14, %19, %4;\n\t"
        "madc.lo.cc.u32 %5, %14, %20, %5;\n\t"
        "madc.lo.cc.u32 %6, %14, %21, %6;\n\t"
        "madc.lo.cc.u32 %7, %14, %22, %7;\n\t"
        "madc.lo.cc.u32 %8, %14, %23, %8;\n\t"
        "madc.lo.cc.u32 %9, %14, %24, %9;\n\t"
        "madc.lo.cc.u32 %10, %14, %25, %10;\n\t"
        "madc.lo.cc.u32 %11, %14, %26, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "mad.hi.cc.u32 %0, %14, %15, %1;\n\t"
        "madc.hi.cc.u32 %1, %14, %16, %2;\n\t"
        "madc.hi.cc.u32 %2, %14, %17, %3;\n\t"
        "madc.hi.cc.u32 %3, %14, %18, %4;\n\t"
        "madc.hi.cc.u32 %4, %14, %19, %5;\n\t"
        "madc.hi.cc.u32 %5, %14, %20, %6;\n\t"
        "madc.hi.cc.u32 %6, %14, %21, %7;\n\t"
        "madc.hi.cc.u32 %7, %14, %22, %8;\n\t"
        "madc.hi.cc.u32 %8, %14, %23, %9;\n\t"
        "madc.hi.cc.u32 %9, %14, %24, %10;\n\t"
        "madc.hi.cc.u32 %10, %14, %25, %11;\n\t"
        "madc.hi.u32 %11, %14, %26, %12;"
        : "+r"(t.w[0]), "+r"(t.w[1]), "+r"(t.w[2]), "+r"(t.w[3]), "+r"(t.w[4]), "+r"(t.w[5]), "+r"(t.w[6]), "+r"(t.w[7]), "+r"(t.w[8]), "+r"(t.w[9]), "+r"(t.w[10]), "+r"(t.w[11]),
          "+r"(A), "=&r"(x)
        : "r"(m), "r"(P_W[0]), "r"(P_W[1]), "r"(P_W[2]), "r"(P_W[3]), "r"(P_W[4]), "r"(P_W[5]), "r"(P_W[6]), "r"(P_W[7]), "r"(P_W[8]), "r"(P_W[9]), "r"(P_W[10]), "r"(P_W[11]));
  }
  return fe_reduce_once(t);
}
"""

# one thread an Fq2 element: Karatsuba in the reference's order
FQ2M = r"""
struct Fe2 {
  Fe c0, c1;
};

// The field of G2: Fq2 = Fq[u]/(u² + 1), elements [2][38] at the boundary.
struct Fq2M {
  using E = Fe2;
  static constexpr int LIMBS = 2 * L;
  __device__ static __forceinline__ E add(const E& a, const E& b) {
    return {fe_add(a.c0, b.c0), fe_add(a.c1, b.c1)};
  }
  __device__ static __forceinline__ E sub(const E& a, const E& b) {
    return {fe_sub(a.c0, b.c0), fe_sub(a.c1, b.c1)};
  }
  // Karatsuba: c0 = a0b0 − a1b1, c1 = (a0 + a1)(b0 + b1) − a0b0 − a1b1
  __device__ static __forceinline__ E mul(const E& a, const E& b) {
    const Fe t0 = fe_mul(a.c0, b.c0);
    const Fe t1 = fe_mul(a.c1, b.c1);
    const Fe m = fe_mul(fe_add(a.c0, a.c1), fe_add(b.c0, b.c1));
    return {fe_sub(t0, t1), fe_sub(fe_sub(m, t0), t1)};
  }
  // 3·b = 12(1 + u): (12(a0 − a1), 12(a0 + a1))
  __device__ static __forceinline__ E mul_b3(const E& a) {
    return {fe_mul12(fe_sub(a.c0, a.c1)), fe_mul12(fe_add(a.c0, a.c1))};
  }
  __device__ static __forceinline__ E zero() { return {fe_zero(), fe_zero()}; }
  __device__ static __forceinline__ E one() { return {fe_one(), fe_zero()}; }
  __device__ static __forceinline__ E load(const int32_t* src) {
    return {fe_from_limbs(src), fe_from_limbs(src + L)};
  }
  __device__ static __forceinline__ void store(const E& a, int32_t* dst) {
    fe_to_limbs(a.c0, dst);
    fe_to_limbs(a.c1, dst + L);
  }
};
"""


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise ValueError(f"patch anchor not found: {old[:60]!r}")
    return text.replace(old, new)


def shape(threads: int, floor: int):
    def patch(files, name):
        src = files[f"{name}.cu"]
        shipped = re.search(r"constexpr int THREADS = \d+;", src)
        if shipped is None:
            raise ValueError(f"patch anchor not found: THREADS in {name}.cu")
        src = _sub(src, shipped.group(0), f"constexpr int THREADS = {threads};")
        files[f"{name}.cu"] = _sub(src, "__launch_bounds__(THREADS)",
                                   f"__launch_bounds__(THREADS, {floor})")
    return f"threads={threads},floor={floor}", patch


def inlined(files, name):
    files["bls_mont.cuh"] = _sub(files["bls_mont.cuh"], FE_MUL_HEAD,
                                 FE_MUL_HEAD.replace("__noinline__", "__forceinline__"))


def ptx(files, name):
    """The device pass takes the PTX form; nvcc's host pass keeps C."""
    hdr = files["bls_mont.cuh"]
    start = hdr.index(FE_MUL_HEAD)
    end = hdr.index("\n}\n", start) + 3
    files["bls_mont.cuh"] = (hdr[:start] + "#if defined(__CUDA_ARCH__)\n" + PTX_FE_MUL.strip("\n")
                             + "\n#else\n" + hdr[start:end] + "#endif\n" + hdr[end:])


def one_lane(files, name):
    files["bls_mont.cuh"] = _sub(files["bls_mont.cuh"], "template <class F>\nstruct Pt {",
                                 FQ2M.strip("\n") + "\n\ntemplate <class F>\nstruct Pt {")
    src = _sub(files["win_g2.cu"], "constexpr int LANES = 2;", "constexpr int LANES = 1;")
    files["win_g2.cu"] = _sub(src, "Fq2Lane", "Fq2M")


def no_sqr(files, name):
    files["bls_mont.cuh"] = _sub(files["bls_mont.cuh"], "acc = point_dbl<F>(acc);",
                                 "acc = point_add<F>(acc, acc);")


def sqr_inlined(files, name):
    files["bls_mont.cuh"] = _sub(files["bls_mont.cuh"], FE_SQR_HEAD,
                                 FE_SQR_HEAD.replace("__noinline__", "__forceinline__"))


def variant(*parts):
    """(label, patches) from shape() pairs and named patches."""
    labels, patches = [], []
    for part in parts:
        if isinstance(part, tuple):
            labels.append(part[0])
            patches.append(part[1])
        else:
            labels.append(part.__name__.replace("_", "-"))
            patches.append(part)
    return ",".join(labels), patches


# registers capped at 168 and 128 a thread (3 and 4 blocks of 128 an
# SM; 64 × 7), 256-thread blocks; then the product's forms
COMMON = [
    variant(shape(128, 3)), variant(shape(128, 4)), variant(shape(64, 7)),
    variant(shape(256, 1)), variant(inlined), variant(ptx),
    variant(ptx, shape(128, 3)), variant(ptx, shape(128, 4)),
]
VARIANTS = {
    "win_g1": COMMON,
    "win_g2": COMMON + [
        variant(one_lane), variant(one_lane, shape(256, 1)), variant(one_lane, shape(128, 3)),
        variant(one_lane, shape(128, 4)), variant(one_lane, inlined), variant(one_lane, ptx),
    ],
    # shipped: 256 threads; 256 × 2 is one wave of 65,536 points, registers
    # capped at 128
    "scan_g1": [
        variant(no_sqr), variant(sqr_inlined), variant(shape(128, 1)),
        variant(shape(256, 2)), variant(no_sqr, shape(128, 1)),
    ],
}


def build_variant(name: str, label: str, patches) -> tuple:
    """Patch a copy of the sources and build it; (library, log, seconds)."""
    from hbbft_tpu_torch.ops import kernels

    d = kernels.BUILD_DIR / "sweep" / f"{name}-{re.sub(r'[^A-Za-z0-9]+', '_', label)}"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    files = {p.name: p.read_text() for p in kernels.CSRC.iterdir() if p.suffix in (".cu", ".cuh")}
    for patch in patches:
        patch(files, name)
    for fname, text in files.items():
        (d / fname).write_text(text)
    so = d / f"lib{name}.so"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(so), str(d / f"{name}.cu")],
        capture_output=True, text=True, timeout=900,
    )
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(log[-1500:])
    return so, log, time.perf_counter() - t0


def ptxas(log: str) -> dict:
    """Registers, stack frame and spill bytes of the log's kernel (the
    entry function's own lines; a non-inlined callee has its own)."""
    lines = [ln.strip() for ln in log.splitlines() if "registers" in ln or "stack frame" in ln]
    out = {"ptxas": lines}
    log = log[log.find("Compiling entry function"):]
    m = re.search(r"Used (\d+) registers", log)
    out["registers"] = int(m.group(1)) if m else None
    m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", log)
    if m:
        out["stack_bytes"], out["spill_stores"], out["spill_loads"] = map(int, m.groups())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--kernel", choices=sorted(SHAPES), action="append",
                    help="sweep only this kernel (repeatable; default: all)")
    args = ap.parse_args()
    names = args.kernel or list(SHAPES)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_win_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    from hbbft_tpu_torch import native as NT
    from hbbft_tpu_torch.crypto import fields as F
    from hbbft_tpu_torch.crypto.curve import G1_GEN, G2_GEN
    from hbbft_tpu_torch.ops import cuda_ec, kernels, limbs as LB, packed_msm as PM

    builds = [(name, label, patches) for name in names for label, patches in VARIANTS[name]]
    built, failed = {}, {}
    with ThreadPoolExecutor(max_workers=len(builds) + 2) as pool:
        native_job = pool.submit(NT.build)
        defaults = {n: pool.submit(kernels.build, n) for n in names}
        jobs = {(n, label): pool.submit(build_variant, n, label, p) for n, label, p in builds}
        for n, job in defaults.items():
            seconds = job.result()
            built[(n, "default")] = (kernels.lib_path(n), kernels.build_log(n), seconds)
        for key, job in jobs.items():
            try:
                built[key] = job.result()
            except RuntimeError as exc:
                failed[key] = str(exc)
        native_job.result()
    for (name, label), msg in failed.items():
        print(json.dumps({"kernel": name, "variant": label, "build_error": msg}))

    dev = torch.device("cuda")
    rng = random.Random(0x5EE9)

    def g1_points(k):
        wires = NT.g1_mul_many(NT.g1_wire(G1_GEN), [rng.randrange(1, F.R) for _ in range(k)])
        arr = np.frombuffer(b"".join(wires), dtype=np.uint8).reshape(k, 96).copy()
        return PM._wire_points_g1(torch.from_numpy(arr).to(dev))

    def win_g1_inputs(k, nwin):
        sc = PM.scalar_bytes_batch([rng.randrange(1, 1 << 96) for _ in range(k)], 12)
        return g1_points(k), PM._scalar_digits(torch.from_numpy(sc).to(dev))

    def win_g2_inputs(k, nwin):
        ks = PM.scalar_bytes_batch([rng.randrange(1, F.R) for _ in range(G2_DISTINCT)], 32)
        raw = NT.g2_mul_many_raw(NT.g2_wire(G2_GEN), ks).reshape(G2_DISTINCT, 192)
        raw = np.tile(raw, (-(-k // G2_DISTINCT), 1))[:k].copy()
        sc = PM.scalar_bytes_batch([rng.randrange(1, F.R) for _ in range(k)], 32)
        return (PM._wire_points_g2(torch.from_numpy(raw).to(dev)),
                PM._scalar_digits(torch.from_numpy(sc).to(dev)))

    def scan_g1_inputs(k, nbits):
        bits = LB.scalars_to_bits([rng.randrange(0, F.R) for _ in range(k)], nbits)
        return g1_points(k), torch.from_numpy(bits).to(dev)

    make_inputs = {"win_g1": win_g1_inputs, "win_g2": win_g2_inputs, "scan_g1": scan_g1_inputs}
    plains = {"win_g1": cuda_ec.windowed_plain, "win_g2": cuda_ec.windowed_g2_plain,
              "scan_g1": cuda_ec.scan_plain}
    f = LB.fq()

    def launcher(name, so):
        fn = getattr(ctypes.CDLL(str(so)), f"{name}_launch")
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int

        def launch(pts, dig):
            out = torch.empty_like(pts)
            rc = fn(pts.data_ptr(), dig.data_ptr(), out.data_ptr(), pts.shape[0], dig.shape[1],
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{name} {so} launch failed ({rc})")
            return out

        return launch

    def time_ms(fn):
        fn()  # warm-up
        times = []
        for _ in range(args.reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return out, times

    for name in names:
        pts, dig = make_inputs[name](*SHAPES[name])
        assert tuple(dig.shape) == SHAPES[name]
        ref = launcher(name, built[(name, "default")][0])(pts, dig)
        plain = plains[name](pts[:CHECK_ROWS], dig[:CHECK_ROWS])
        torch.cuda.synchronize()
        if not torch.equal(ref[:CHECK_ROWS], f.canon(plain)):
            raise SystemExit(f"{name}: default build differs from the plain version")
        del plain
        for (bname, label), (so, log, seconds) in built.items():
            if bname != name:
                continue
            launch = launcher(name, so)
            out, times = time_ms(lambda: launch(pts, dig))
            if not torch.equal(out, ref):
                raise SystemExit(f"{name} {label}: output differs from the default build")
            row = {
                "kernel": name,
                "variant": label,
                "K": pts.shape[0],
                "n": dig.shape[1],  # windows, or bits for scan_g1
                "ms_median": statistics.median(times),
                "ms": times,
                "build_s": seconds,
                **ptxas(log),
            }
            print(json.dumps(row), flush=True)
            del out
    print(
        subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
