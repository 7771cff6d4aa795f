#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``hbbft_tpu_torch``) on one GPU.

Run from the repo root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvcc`` and a C++ compiler, and no network.
In order, and with no phase's failure caught:

1. **Build** — the native host library (``make -C native``) and every
   CUDA kernel of the port (one ``nvcc`` per source, all at once), with
   the build seconds and ``ptxas`` resource lines printed.
2. **Kernels against their plain versions** — ``win_g1`` at K = 1000
   (not a multiple of 128) on random r-torsion points with identity
   rows and zero scalars, at 96- and 255-bit scalars: exact limb
   equality with the plain PyTorch version on the card, and canonical
   equality with native ``hb_g1_mul``.  Then both timed at the main
   path's shape (K = 65,536, 96-bit scalars).
3. **The main path at full width** — N = 1024 validators × 64 fresh
   ciphertexts = 65,536 real BLS12-381 decryption shares per flush,
   settled by ``BatchingBackend(inner=CudaBackend()).prefetch`` three
   times: every share must verify, with no fallback, and every kernel
   must have been launched.  Two more flushes with one corrupted share,
   at 1024 × 64 (rejected by the fused check on the card) and at
   1024 × 4 (a product below ``G1_PRODUCT_DEVICE_MIN``, on the host),
   must cache ``False`` for exactly that obligation.
4. **Report** — flush seconds, shares/s and stage walls, then the
   ``kernels`` JSON line, the card's name and power limit, and the
   result line ``{"ok": true, "device": {...}}`` last.

Without a card, or outside a checkout of the repo, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import random
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

SEED = 0x5EED
N_NODES = 1024
GROUPS = 64
FLUSHES = 3
K_CHECK = 1000
K_TIME = N_NODES * GROUPS
TIME_REPS = 3

# The card's peak int32 multiply-add rate: the published fp32 rate of an
# H100 SXM (67 TFLOP/s = 2 flops per FMA lane-clock) halved for the
# FMA count, halved again because Hopper issues int32 on half as many
# lanes as fp32 (64 IMAD per clock per SM × 132 SMs × 1.98 GHz).
# Memory: 3.35 TB/s.
PEAK_IMAD_PER_S = 67e12 / 2 / 2
PEAK_BYTES_PER_S = 3.35e12
FQ_LIMBS = 38


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    ).stdout.strip()


def win_g1_imads(k: int, nwin: int) -> int:
    """int32 multiply-adds the windowed scalar multiplication needs on k
    points with nwin 4-bit windows: a point takes 14 + 5·nwin complete
    adds (the 16-entry table, then 4 doublings + 1 add per window), and
    a complete add 12 full Fq products of 38 × 38 limb multiply-adds.
    The reductions, sums and small products of the kernel's lazy
    schedule are its own overhead and are not counted."""
    point_add = 12 * FQ_LIMBS * FQ_LIMBS
    return k * (14 + 5 * nwin) * point_add


def win_g1_bound_ms(k: int, nwin: int):
    ops_ms = win_g1_imads(k, nwin) / PEAK_IMAD_PER_S * 1e3
    nbytes = k * (3 * 38 * 4) * 2 + k * nwin * 4  # points in + out, digits in
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA card")
    try:
        from hbbft_tpu_torch import native as NT
        from hbbft_tpu_torch.ops import cuda_ec, kernels
    except ImportError as exc:
        fail(f"run from the root of a checkout of the repo ({exc})")
    dev = torch.device("cuda")
    log(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}"
    )

    # -- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        native_job = pool.submit(NT.build)
        nvcc_job = pool.submit(kernels.build_all)
        if not native_job.result():
            fail("make -C native produced no library")
        nvcc_s = nvcc_job.result()
    log(f"build: {time.perf_counter() - t0:.1f} s wall; nvcc per kernel {nvcc_s}")
    for name in kernels.SOURCES:
        for line in kernels.build_log(name).splitlines():
            if "registers" in line or "stack frame" in line:
                log(f"ptxas {name}: {line.strip()}")
    if not NT.available():
        fail("native library did not load")

    from hbbft_tpu_torch.crypto import fields as F
    from hbbft_tpu_torch.crypto import threshold as T
    from hbbft_tpu_torch.crypto.curve import G1_GEN
    from hbbft_tpu_torch.harness.batching import BatchingBackend, DecObligation
    from hbbft_tpu_torch.harness.workload import DecryptionFlushWorkload
    from hbbft_tpu_torch.ops import packed_msm as PM
    from hbbft_tpu_torch.ops.backend_cuda import CudaBackend
    from hbbft_tpu_torch.ops.ec import g1_from_limbs

    import numpy as np

    rng = random.Random(SEED)
    base = NT.g1_wire(G1_GEN)

    def random_wires(k: int, n_ident: int):
        wires = NT.g1_mul_many(base, [rng.randrange(1, F.R) for _ in range(k)])
        ident = set(rng.sample(range(k), n_ident))
        for i in ident:
            wires[i] = bytes(96)
        arr = np.frombuffer(b"".join(wires), dtype=np.uint8).reshape(k, 96).copy()
        return wires, torch.from_numpy(arr).to(dev)

    def digits_for(scalars, nbytes: int):
        sc = torch.from_numpy(PM.scalar_bytes_batch(scalars, nbytes)).to(dev)
        return PM._scalar_digits(sc)

    # -- 2. kernels against their plain versions -------------------------
    max_err = 0
    wires, dev_wires = random_wires(K_CHECK, 10)
    pts = PM._wire_points_g1(dev_wires)
    for bits in (96, 255):
        scalars = [rng.randrange(0, 1 << bits) % F.R for _ in range(K_CHECK)]
        for i in rng.sample(range(K_CHECK), 10):
            scalars[i] = 0
        dig = digits_for(scalars, (bits + 7) // 8)
        got = cuda_ec.win_g1(pts, dig)
        plain = cuda_ec.windowed_plain(pts, dig)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - plain.to(torch.int64)).abs().max().item())
        max_err = max(max_err, err)
        if err != 0:
            fail(f"win_g1 differs from its plain version at {bits}-bit scalars (max |Δ| {err})")
        host = got.cpu().numpy()
        for i in range(K_CHECK):
            want = NT.g1_mul(wires[i], scalars[i])
            if NT.g1_wire(g1_from_limbs(host[i])) != want:
                fail(f"win_g1 row {i} at {bits}-bit scalars is not k·P")
        log(f"win_g1 K={K_CHECK} {bits}-bit: exact vs plain, canonical vs native: ok")

    # timed at the main path's shape: 65,536 points, 96-bit scalars
    _, dev_wires = random_wires(K_TIME, 64)
    pts = PM._wire_points_g1(dev_wires)
    dig = digits_for([rng.randrange(1, 1 << 96) for _ in range(K_TIME)], 12)
    nwin = dig.shape[1]
    got = cuda_ec.win_g1(pts, dig)  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIME_REPS):
        got = cuda_ec.win_g1(pts, dig)
    end.record()
    torch.cuda.synchronize()
    kernel_ms = start.elapsed_time(end) / TIME_REPS
    start.record()
    plain = cuda_ec.windowed_plain(pts, dig)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    err = int((got.to(torch.int64) - plain.to(torch.int64)).abs().max().item())
    max_err = max(max_err, err)
    if err != 0:
        fail(f"win_g1 differs from its plain version at K={K_TIME} (max |Δ| {err})")
    del plain
    bound_ms, bound_by = win_g1_bound_ms(K_TIME, nwin)
    log(
        f"win_g1 K={K_TIME} nwin={nwin}: kernel {kernel_ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), exact"
    )

    # -- 3. the main path at full width ----------------------------------
    work = DecryptionFlushWorkload(N_NODES, rng)
    inner = CudaBackend()
    batches = [work.obligations(b"flush-%d" % i, GROUPS) for i in range(FLUSHES)]
    cuda_ec.reset_launches()
    walls, phases = [], []
    for obs in batches:
        be = BatchingBackend(inner=inner)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        be.prefetch(obs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        phases.append(dict(be.last_flush_phases))
        if be.stats.fallback_items or be.stats.fallback_groups:
            fail(f"honest flush fell back: {be.stats}")
        if not all(be.verify_dec_share(o.pk_share, o.share, o.ciphertext) for o in obs):
            fail("an honest share did not verify")
        if be.stats.cache_misses:
            fail(f"verdicts were not cached by the flush: {be.stats}")
    launches = dict(cuda_ec.LAUNCHES)
    for name, n in launches.items():
        if n < 1:
            fail(f"kernel {name} was not launched on the main path")
    flush_s = statistics.median(walls)
    log(
        f"flush N={N_NODES} x {GROUPS} = {K_TIME} shares: median {flush_s:.3f} s "
        f"({K_TIME / flush_s:.1f} shares/s), walls {[round(w, 3) for w in walls]}, "
        f"launches {launches}"
    )
    log("last_flush_phases " + json.dumps({k: round(v, 4) for k, v in phases[-1].items()}))

    # one corrupted share, at the full width (the fused check runs on the
    # card and must reject) and at 1024 x 4 (a host-routed product): the
    # fallback must attribute it to exactly its obligation
    for groups in (GROUPS, 4):
        obs = work.obligations(b"corrupt-%d" % groups, groups)
        bad = (groups // 2) * N_NODES + 17
        ob = obs[bad]
        obs[bad] = DecObligation(
            ob.pk_share, T.DecryptionShare(ob.share.point * 7), ob.ciphertext
        )
        be = BatchingBackend(inner=inner)
        before = cuda_ec.LAUNCHES["win_g1"]
        t0 = time.perf_counter()
        be.prefetch(obs)
        corrupt_s = time.perf_counter() - t0
        on_card = cuda_ec.LAUNCHES["win_g1"] > before
        if on_card != (len(obs) >= inner.G1_PRODUCT_DEVICE_MIN):
            fail(f"the corrupted {N_NODES} x {groups} flush ran on the wrong side")
        verdicts = [be.verify_dec_share(o.pk_share, o.share, o.ciphertext) for o in obs]
        wrong = [i for i, v in enumerate(verdicts) if v is not (i != bad)]
        if wrong:
            fail(f"corrupted flush verdicts wrong at {wrong[:10]}")
        if be.stats.fallback_groups != 1 or be.stats.fallback_items != N_NODES:
            fail(f"corrupted flush fell back beyond its one group: {be.stats}")
        log(
            f"corrupted flush N={N_NODES} x {groups} ({'card' if on_card else 'host'}): "
            f"only obligation {bad} rejected in {corrupt_s:.3f} s; stats {be.stats}"
        )

    # -- 4. report ------------------------------------------------------
    kernels_line = {
        "kernels": [
            {
                "name": "win_g1",
                "route": "cuda",
                "source": "hbbft_tpu_torch/csrc/win_g1.cu",
                "replaces": "hbbft_tpu/ops/pallas_ec.py:230",
                "launches": launches["win_g1"],
                "max_abs_err": max_err,
                "ms": round(kernel_ms, 4),
                "plain_ms": round(plain_ms, 4),
                "bound_ms": round(bound_ms, 4),
                "bound_by": bound_by,
                "library_ms": None,
            }
        ]
    }
    log(json.dumps(kernels_line))
    log(card_line())
    log(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
