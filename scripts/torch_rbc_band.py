#!/usr/bin/env python3
"""The reliable-broadcast plane's routing band: the card against the
native host, by size.

``CudaBackend`` sends a SHA-256 batch, a forest of Merkle trees or a
Reed–Solomon product to the card only at or above its size rules
(``ops/backend_cuda.py``: ``SHA_DEVICE_MIN_ITEMS`` / ``_MAX_BYTES``,
``MERKLE_DEVICE_MIN_LEAVES`` / ``_MAX_BYTES``, ``GF8_DEVICE_MIN``,
``GF16_DEVICE_MIN``).  This script measures both sides as a caller sees
them (host bytes in, host bytes out, the card's copies included) after
building the native library and the ``sha256``, ``merkle`` and
``gf_matmul`` kernels:

1. ``sha256_many``: native ``NT.sha256_many`` against
   ``ops.sha256.sha256_many`` on the card, by batch count × message bytes;
2. Merkle forests: ``merkle_trees`` of a ``[T, n, len]`` array on
   ``CpuBackend`` (native ``MerkleTree`` tree after tree) against a
   ``CudaBackend`` with its rules open (one ``merkle_forest`` launch, the
   rows copied back), by trees × leaves × leaf bytes (the N = 1024 epoch's
   974 and 1,948 trees of 1,024 2-byte leaves, the 1 MB broadcast's 64
   leaves of 47,663 bytes, single trees and a grid);
3. codec products: native ``RS._matmul`` / ``_matmul16`` against the
   device codecs' product (``gf_matmul_device`` / ``gf16_matmul_device``
   and the copy back), by ``m·k·columns``;

at the shapes of ``chip_smoke.py``'s phase 7 (the 1 MB broadcast's
leaves, trees, parity, decode and missing rows; the N = 1024 epoch's
leaves, forests and products) and a grid around them.  Each time is the
median of several calls.  For each rule it prints the values, among
powers of two, that give the least total time over its grid when each
point runs where the rule sends it (the SHA-256 and forest rules have a
floor on the batch's messages or the forest's leaves and a ceiling on
its bytes in all, the codec rules a floor on m·k·columns), and both
sides' totals.  The JSON
also goes to ``chiprun_out/torch_rbc_band.json``; the last line is the
card's name and power limit.  Run from the repo root on a CUDA host:
``python3 scripts/torch_rbc_band.py`` (``--reps`` calls a point).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

SHA_COUNTS = (8, 16, 64, 256, 1024, 4096, 16384)
SHA_BYTES = (11, 65, 256, 1024, 4096, 47_672)
# (trees, leaves a tree, bytes a leaf)
FORESTS = (
    [(1, n, b) for n in (8, 16, 64, 256, 1024) for b in (2, 64, 1024, 47_663)]
    + [(T, n, b) for T in (8, 64) for n in (8, 64, 1024) for b in (2, 1024)]
    + [(974, 64, 2), (974, 1024, 2), (1948, 1024, 2)]
)
# (W, m, k, columns): the 1 MB broadcast (n = 64: 22 data, 42 parity
# shards of 47,663 bytes), the N = 1024 epoch (342 data, 682 parity, 50
# dead; 974 proposers' shards of L bytes, L/2 symbols each) and a grid
GF_SHAPES = (
    [(8, 42, 22, c) for c in (1, 64, 1024, 4096, 16384, 47_663)]
    + [(8, 22, 22, c) for c in (64, 1024, 16384, 47_663)]
    + [(8, 21, 22, 47_663), (8, 4, 4, 64), (8, 6, 10, 100)]
    + [(16, 682, 342, c) for c in (1, 16, 128, 974, 1948, 3896)]
    + [(16, 342, 342, c) for c in (16, 974, 1948)]
    + [(16, 50, 342, c) for c in (1, 2, 974)]
)
POW2 = [0] + [1 << i for i in range(0, 31)]


def median_s(fn, reps: int) -> float:
    fn()  # warm-up
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls)


def best_rule(points, floors, ceilings=()):
    """The rule values (0 or powers of two, one a key) that minimise the
    total time over ``points`` (dicts with ``host_s``, ``card_s`` and the
    keys' sizes) when a point runs on the card iff every size of
    ``floors`` reaches its value and none of ``ceilings`` passes its value
    (a ceiling may also be None: no ceiling).  On a tie the host keeps
    what the grid cannot tell apart: the larger floors, the smaller
    ceilings.  The floors of the reference (8 items) are the caller's."""
    keys = list(floors) + list(ceilings)
    grids = [[v for v in POW2 if v <= 2 * max(p[k] for p in points)] for k in floors]
    grids += [[v for v in POW2 if v <= 2 * max(p[k] for p in points)] + [None] for k in ceilings]
    best = None

    def on_card(p, vals):
        lo, hi = vals[: len(floors)], vals[len(floors):]
        return (all(p[k] >= v for k, v in zip(floors, lo))
                and all(v is None or p[k] <= v for k, v in zip(ceilings, hi)))

    def host_lean(vals):
        lo, hi = vals[: len(floors)], vals[len(floors):]
        return tuple(lo) + tuple(-(float("inf") if v is None else v) for v in hi)

    def walk(i, vals):
        nonlocal best
        if i == len(keys):
            t = sum(p["card_s"] if on_card(p, vals) else p["host_s"] for p in points)
            if best is None or t < best[0] or (t == best[0] and host_lean(vals) > host_lean(best[1])):
                best = (t, list(vals))
            return
        for v in grids[i]:
            walk(i + 1, vals + [v])

    walk(0, [])
    return {"values": dict(zip(keys, best[1])), "total_s": best[0],
            "all_host_s": sum(p["host_s"] for p in points),
            "all_card_s": sum(p["card_s"] for p in points)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_rbc_band: needs a CUDA card", file=sys.stderr)
        return 1
    from hbbft_tpu_torch import native as NT
    from hbbft_tpu_torch.crypto import rs as RS
    from hbbft_tpu_torch.crypto.merkle import MerkleTree
    from hbbft_tpu_torch.ops import gf256 as GF
    from hbbft_tpu_torch.ops import kernels
    from hbbft_tpu_torch.ops import sha256 as SH

    if not NT.build() or not NT.available():
        print("torch_rbc_band: the native library did not build", file=sys.stderr)
        return 1
    kernels.build_all()
    dev = torch.device("cuda")
    gen = np.random.default_rng(0xBA)
    out = {"reps": args.reps}

    sha = []
    for count in SHA_COUNTS:
        for nbytes in SHA_BYTES:
            if count * nbytes > 256 << 20:
                continue
            raw = gen.integers(0, 256, size=(count, nbytes), dtype=np.uint8)
            msgs = [r.tobytes() for r in raw]
            if SH.sha256_many(msgs, dev) != NT.sha256_many(msgs):
                raise SystemExit(f"torch_rbc_band: sha256 differs at {count} × {nbytes}")
            p = {"items": count, "bytes": nbytes, "total": count * nbytes,
                 "host_s": median_s(lambda: NT.sha256_many(msgs), args.reps),
                 "card_s": median_s(lambda: SH.sha256_many(msgs, dev), args.reps)}
            sha.append(p)
            print(f"sha256 {count} × {nbytes} B: host {p['host_s'] * 1e3:.4f} ms, "
                  f"card {p['card_s'] * 1e3:.4f} ms", flush=True)
    out["sha256"] = sha
    out["sha256_rule"] = best_rule(sha, ["items"], ["total"])

    from hbbft_tpu_torch.crypto.backend import CpuBackend
    from hbbft_tpu_torch.ops.backend_cuda import CudaBackend

    host_be, card_be = CpuBackend(), CudaBackend()
    for name, value in card_be.RBC_FLOOR.items():
        setattr(card_be, name, value)
    merkle = []
    for T, leaves, nbytes in FORESTS:
        if T * leaves * nbytes > 64 << 20:
            continue
        arr = gen.integers(0, 256, size=(T, leaves, nbytes), dtype=np.uint8)
        got = card_be.merkle_trees(arr)
        want = host_be.merkle_trees(arr)
        if [t.root_hash for t in got] != [t.root_hash for t in want] or got[-1].levels != want[-1].levels:
            raise SystemExit(f"torch_rbc_band: the forest differs at {T} × {leaves} × {nbytes}")
        reps = args.reps if T * leaves < 1 << 16 else 3
        p = {"trees": T, "leaves": leaves, "bytes": nbytes, "items": T * leaves,
             "total": T * leaves * nbytes,
             "host_s": median_s(lambda: host_be.merkle_trees(arr), reps),
             "card_s": median_s(lambda: card_be.merkle_trees(arr), reps)}
        merkle.append(p)
        print(f"forest {T} × {leaves} × {nbytes} B: host {p['host_s'] * 1e3:.4f} ms, "
              f"card {p['card_s'] * 1e3:.4f} ms", flush=True)
    out["merkle"] = merkle
    out["merkle_rule"] = best_rule(merkle, ["items"], ["total"])

    gf = {8: [], 16: []}
    for W, m, k, cols in GF_SHAPES:
        dtype = np.uint8 if W == 8 else np.uint16
        mat = gen.integers(0, 1 << W, size=(m, k), dtype=dtype)
        data = gen.integers(0, 1 << W, size=(k, cols), dtype=dtype)
        host = RS._matmul if W == 8 else RS._matmul16
        if W == 8:
            def card():
                return GF.gf_matmul_device(mat, data, dev).cpu().numpy()
        else:
            def card():
                return GF.gf16_matmul_device(mat, data, dev).cpu().numpy().view(np.uint16)
        if not np.array_equal(card(), host(mat, data)):
            raise SystemExit(f"torch_rbc_band: gf_matmul differs at W={W} {m}×{k}×{cols}")
        p = {"w": W, "m": m, "k": k, "columns": cols, "products": m * k * cols,
             "host_s": median_s(lambda: host(mat, data), args.reps),
             "card_s": median_s(card, args.reps)}
        gf[W].append(p)
        print(f"gf W={W} [{m}, {k}]·[{k}, {cols}]: host {p['host_s'] * 1e3:.4f} ms, "
              f"card {p['card_s'] * 1e3:.4f} ms", flush=True)
    out["gf8"], out["gf16"] = gf[8], gf[16]
    out["gf8_rule"] = best_rule(gf[8], ["products"])
    out["gf16_rule"] = best_rule(gf[16], ["products"])

    card_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    out["card"] = card_line
    for rule in ("sha256_rule", "merkle_rule", "gf8_rule", "gf16_rule"):
        print(f"{rule}: " + json.dumps(out[rule]), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "torch_rbc_band.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(card_line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
