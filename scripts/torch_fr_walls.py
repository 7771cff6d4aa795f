#!/usr/bin/env python3
"""fr_matmul at the dealing's shapes, and the elided DKG at N = 1024, on the card.

1. Times the host's share of a ``fr_matmul`` call (the wall of 200 calls
   at one tile's shape with no sync between them), then ``fr_matmul`` on
   the card's own timeline (CUDA events around ``--reps`` calls queued
   behind a ``torch.cuda._sleep``, after a warm-up) at
   the three shapes of one dealer of the N = 1023 dealing (t = 340): rows
   ``[681, 341]·[341, 341]``, values ``[341, 341]·[341, 1023]`` and the λ
   row ``[1, 341]·[341, 1023]``, each with ``acc``, and the sampler's
   ``[1, 2]·[2, 116281]`` (``sample_words`` of one dealer's 341²
   coefficients), on random canonical Fr; each result must equal the plain
   version word for word.  Per shape: ``ms`` (the call as its callers see
   it: two ``fr_planes`` launches and the product), ``product_ms`` (the
   ``fr_matmul`` kernel alone on the planes) and ``planes_ms`` (both
   ``fr_planes`` launches).  Each shape's bound is chip_smoke.py's
   ``fr_bound``: the smaller of the 32-bit word form's IMAD count and the
   32-limb form's int8 tensor-core count, or the bytes if they take
   longer.
2. ``--split``: where the product kernel's time goes at the value grid.
   Builds patched copies of ``csrc/`` under
   ``build/hbbft_tpu_torch/sweep/fr_matmul-<variant>/`` (one ``nvcc``
   each, all at once; the patches live in this script only) and times each
   on the same planes:
   - ``no-epilogue``: the consumers skip the diagonal sums and the
     reducers the conversion, reduction and store (the main loop: loads
     and tensor cores);
   - ``loads-only``: that, without the ``wgmma`` either;
   - ``mma-only``: the producer arrives without copying, and no
     epilogue (the tensor cores on whatever the stages hold);
   - ``no-gather`` / ``no-reduce``: the whole kernel without the
     consumers' diagonal sums or without the reducers' work.
   Each variant is timed twice, in turn with the others; their outputs
   are not checked (they skip work); ptxas's registers and spills are
   printed for each.
3. The main loop's yardstick: ``torch._int_mm`` on int8 operands of the
   value grid's byte-plane shape, ``[10912, 352]·[352, 32736]`` (random
   values; only the shape matters).  It is cuBLAS's rate on the same MMA
   work with no diagonal sums, reduction or Fr output, and it writes the
   whole s32 product (1.43 GB); it computes no Fr product and never runs on
   the port's path.
4. Runs ``bench_dkg_1024``'s DKG (``bench.py:1968``):
   ``VectorizedDkg(range(1024), 341, Random(0xDA)).run(verify_honest=False)``,
   which routes to the device engine on the card, and checks that t + 1
   signature shares of its keys combine and verify.
5. ``--profile``: the same DKG again under ``torch.profiler`` (CPU and
   CUDA activities): device time by kernel (the profiler's own names,
   ours and torch's), summed into the device's busy time, and its share
   of the DKG's stage walls; the device's idle time between consecutive
   kernels, summed by the pair of kernels around each gap.

Prints one JSON object (also written to
``chiprun_out/torch_fr_walls.json``) and the card's name and power limit.
Run from the repo root on a CUDA host: ``python3 scripts/torch_fr_walls.py``
(``--skip-dkg`` for the kernels alone, ``--split`` for item 2,
``--profile`` for item 5).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import random
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N, T = 1023, 340
DKG_NODES, DKG_T, DKG_SEED = 1024, 341, 0xDA
SAMPLED = (T + 1) ** 2
HOST_CALLS = 200
# cycles the card sleeps while the timed calls are queued (~50 ms at 1.98 GHz)
SLEEP_CYCLES = 100_000_000

GATHER = "if (row_live && p0 + j < P) {"
REDUCE = "if (m < M && p < P) {"
# the consumers skip the diagonal sums, keeping the accumulators live (no
# accumulator reaches 2^32 − 1), and the reducers the conversion,
# reduction and store
NO_EPILOGUE = [(GATHER, "if (d[16 * j] == 0xFFFFFFFFu) {"), (REDUCE, "if (false) {")]
NO_MMA = [("wgmma_u8(d, da, db, ks > 0);", "")]
NO_LOADS = [("mbar_expect_tx(&sm.full[stage], bytes);", "mbar_arrive(&sm.full[stage]);"),
            ("bulk_load(sm.a[stage], a + (size_t)ks * A_STAGE, A_STAGE, &sm.full[stage]);", ""),
            ("if (bt < NT) {\n              bulk_load", "if (false) {\n              bulk_load")]
VARIANTS = {
    "no-epilogue": NO_EPILOGUE,
    "loads-only": NO_EPILOGUE + NO_MMA,
    "mma-only": NO_LOADS + NO_EPILOGUE,
    "no-gather": [(GATHER, "if (d[16 * j] == 0xFFFFFFFFu) {")],
    "no-reduce": [(REDUCE, "if (false) {")],
}


def build_variant(label: str, patches) -> tuple:
    """Patch a copy of the sources and build ``fr_matmul.cu``; (library, log)."""
    from hbbft_tpu_torch.ops import kernels

    d = kernels.BUILD_DIR / "sweep" / f"fr_matmul-{label}"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    files = {p.name: p.read_text() for p in kernels.CSRC.iterdir() if p.suffix in (".cu", ".cuh")}
    for old, new in patches:
        if old not in files["fr_matmul.cu"]:
            raise RuntimeError(f"{label}: patch anchor not found: {old[:60]!r}")
        files["fr_matmul.cu"] = files["fr_matmul.cu"].replace(old, new)
    for fname, text in files.items():
        (d / fname).write_text(text)
    so = d / "libfr_matmul.so"
    proc = subprocess.run(
        [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(so), str(d / "fr_matmul.cu")],
        capture_output=True, text=True, timeout=900,
    )
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(log[-1500:])
    return so, log


def ptxas(log: str) -> list:
    return [ln.strip() for ln in log.splitlines() if "registers" in ln or "stack frame" in ln]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--skip-dkg", action="store_true")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_fr_walls: needs a CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import fr_bound
    from hbbft_tpu_torch import native as NT
    from hbbft_tpu_torch.crypto import fields as F
    from hbbft_tpu_torch.harness.dkg import VectorizedDkg
    from hbbft_tpu_torch.ops import cuda_ec, fr as FR, kernels

    with ThreadPoolExecutor(max_workers=len(VARIANTS) + 2) as pool:
        native = pool.submit(NT.build)
        t0 = time.perf_counter()
        kernels.build("fr_matmul")
        out = {"build_s": time.perf_counter() - t0}
        variants = {v: pool.submit(build_variant, v, p) for v, p in VARIANTS.items()} if args.split else {}
        native.result()
        variants = {v: f.result() for v, f in variants.items()}
    out["ptxas"] = ptxas(kernels.build_log("fr_matmul"))
    dev = torch.device("cuda")
    rng = random.Random(0xF4)

    def words(n, *shape):
        raw = b"".join(rng.randrange(F.R).to_bytes(32, "little") for _ in range(n))
        host = np.frombuffer(raw, dtype="<i4").reshape(*shape, 8).copy()
        return torch.from_numpy(host).to(dev)

    def events_ms(fn, reps):
        """ms a call on the card's own timeline: the calls are queued behind
        a sleep, so they run back to back and the host's enqueue is not in
        it (the sleep outlasts the enqueue: a few ms against ~50 ms)."""
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def product(lib, pa, pb, acc, m, k, p):
        res = torch.empty((m, p, 8), dtype=torch.int32, device=dev)

        def run():
            rc = lib.fr_matmul_launch(pa.data_ptr(), pb.data_ptr(),
                                      None if acc is None else acc.data_ptr(), res.data_ptr(),
                                      m, k, p, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"fr_matmul_launch: {rc}")
        return run

    # the host's time a call: HOST_CALLS calls of one tile's product, no
    # sync between them (the card keeps up, so the wall is the host's)
    a1, b1 = words(1, 1, 1), words(8, 1, 8)
    FR.fr_matmul(a1, b1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        FR.fr_matmul(a1, b1)
    out["host_us_per_fr_matmul"] = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    torch.cuda.synchronize()
    shapes = {"rows": (2 * T + 1, T + 1, T + 1), "values": (T + 1, T + 1, N),
              "lambda": (1, T + 1, N), "sampler": (1, 2, SAMPLED)}
    out["shapes"] = {}
    lib = FR._lib()
    kept = {}
    for name, (m, k, p) in shapes.items():
        a, b = words(m * k, m, k), words(k * p, k, p)
        acc = None if name == "sampler" else words(m * p, m, p)
        got = FR.fr_matmul(a, b, acc)
        if not torch.equal(got, FR.fr_matmul_plain(a, b, acc)):
            print(f"torch_fr_walls: fr_matmul differs from its plain version at {name}",
                  file=sys.stderr)
            return 1
        pa, pb = FR.fr_planes(a, True), FR.fr_planes(b, False)
        if not (torch.equal(pa, FR.fr_planes_plain(a, True))
                and torch.equal(pb, FR.fr_planes_plain(b, False))):
            print(f"torch_fr_walls: fr_planes differs from its plain version at {name}",
                  file=sys.stderr)
            return 1
        ms = events_ms(lambda: FR.fr_matmul(a, b, acc), args.reps)
        product_ms = events_ms(product(lib, pa, pb, acc, m, k, p), args.reps)
        planes_ms = events_ms(lambda: (FR.fr_planes(a, True), FR.fr_planes(b, False)), args.reps)
        bound, bound_by, imad_ms, tc_ms = fr_bound(m, k, p, acc=acc is not None)
        out["shapes"][name] = {
            "m": m, "k": k, "p": p, "ms": ms, "product_ms": product_ms, "planes_ms": planes_ms,
            "bound_ms": bound, "bound_by": bound_by, "imad_bound_ms": imad_ms,
            "int8_tc_bound_ms": tc_ms, "share_of_bound": bound / ms,
            "product_share_of_bound": bound / product_ms, "macs_per_s": m * k * p / ms * 1e3,
        }
        if name == "values":
            kept = {"pa": pa, "pb": pb, "acc": acc}
    if args.split:
        m, k, p = shapes["values"]
        out["split_values"] = {}
        variants = {"shipped": (kernels.lib_path("fr_matmul"), kernels.build_log("fr_matmul")),
                    **variants}
        for label, (so, log) in list(variants.items()) * 2:
            vlib = ctypes.CDLL(str(so))
            vp, vi = ctypes.c_void_p, ctypes.c_int
            vlib.fr_matmul_launch.argtypes = [vp, vp, vp, vp, vi, vi, vi, vp]
            vlib.fr_matmul_launch.restype = ctypes.c_int
            run = product(vlib, kept["pa"], kept["pb"], kept["acc"], m, k, p)
            rec = out["split_values"].setdefault(label, {"product_ms": [], "ptxas": ptxas(log)})
            rec["product_ms"].append(events_ms(run, args.reps))
    out["clocks"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout.strip()
    # the main loop's yardstick: cuBLAS's int8 product at the planes' shape
    pm, pk, pn = 32 * (T + 1), 32 * -(-(T + 1) // 32), 32 * N
    ai = torch.randint(-128, 128, (pm, pk), dtype=torch.int8, device=dev)
    bi = torch.randint(-128, 128, (pn, pk), dtype=torch.int8, device=dev).t()
    out["int_mm_values_planes"] = {
        "shape": [pm, pk, pn], "ms": events_ms(lambda: torch._int_mm(ai, bi), args.reps),
        "macs": pm * pk * pn, "out_bytes": pm * pn * 4,
    }
    del ai, bi, kept
    torch.cuda.empty_cache()
    if not args.skip_dkg:
        dkg = VectorizedDkg(list(range(DKG_NODES)), DKG_T, random.Random(DKG_SEED))
        cuda_ec.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = dkg.run(verify_honest=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        shares = {i: res.shares[i].sign(b"dkg1024") for i in range(DKG_T + 1)}
        if res.engine != "device" or not res.pk_set.verify_signature(
                res.pk_set.combine_signatures(shares), b"dkg1024"):
            print("torch_fr_walls: the N = 1024 DKG's keys do not verify", file=sys.stderr)
            return 1
        out["dkg_1024"] = {"nodes": DKG_NODES, "threshold": DKG_T, "engine": res.engine,
                           "wall_s": wall, "last_phases": dkg.last_phases,
                           "launches": dict(cuda_ec.LAUNCHES)}
    if args.profile:
        # the same DKG under torch.profiler (which slows the host): device
        # time by kernel and the device's busy share of the DKG's walls
        from torch.profiler import ProfilerActivity, profile

        dkg = VectorizedDkg(list(range(DKG_NODES)), DKG_T, random.Random(DKG_SEED))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            dkg.run(verify_honest=False)
            torch.cuda.synchronize()
        dealing_s = dkg.last_phases["dealing"]
        kernels_ms = {}
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA:  # kernels and copies
                kernels_ms[ev.key] = {"ms": ev.self_device_time_total / 1e3, "count": ev.count}
        busy_ms = sum(v["ms"] for v in kernels_ms.values())
        # the device's idle gaps, by the kernels on either side of them
        evs = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        gaps = {}
        for prev, nxt in zip(evs, evs[1:]):
            pair = f"{prev.name.split('(')[0][-40:]} -> {nxt.name.split('(')[0][-40:]}"
            g = gaps.setdefault(pair, {"ms": 0.0, "count": 0})
            g["ms"] += max(0.0, nxt.time_range.start - prev.time_range.end) / 1e3
            g["count"] += 1
        out["dkg_profile"] = {
            "nodes": DKG_NODES, "threshold": DKG_T, "dealing_s": dealing_s,
            "last_phases": dkg.last_phases, "device_busy_ms": busy_ms,
            "device_busy_share_of_dkg": busy_ms / 1e3 / sum(dkg.last_phases.values()),
            "kernels": dict(sorted(kernels_ms.items(), key=lambda kv: -kv[1]["ms"])[:25]),
            "idle_ms": sum(g["ms"] for g in gaps.values()),
            "idle_by_neighbours": dict(sorted(gaps.items(), key=lambda kv: -kv[1]["ms"])[:12]),
        }
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "torch_fr_walls.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))
    print(out["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
