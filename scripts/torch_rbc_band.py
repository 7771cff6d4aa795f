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

With ``--parent DIR`` (a directory holding another tree's ``sha256.cu``,
``sha256.cuh`` and ``merkle.cu``, e.g. the parent commit's
``hbbft_tpu_torch/csrc`` unpacked by ``git archive`` into a git-ignored
directory; repeatable) it also builds those two kernels of each and,
first, times them beside this tree's on the card's timeline, in turns
(each tree's calls, then again in the reverse order; each the median of
three runs of ``--reps`` launches enqueued behind a sleep) at
``PAIR_SHA`` (each tree's words entry on the padded words, its raw entry
on the rows where it has one) and ``PAIR_FORESTS``, every output checked
against ``hashlib`` and this tree's forest; and in the SHA-256 grid it
times the first such tree's ``sha256_many`` as that tree ran it (host
padding, the words kernel) beside the card's and the host's.
``--pairs-only`` stops after the pairs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import pathlib
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
# --parent: the sha256 kernel's shapes (messages, bytes) — chip_smoke.py's
# 7(e): the 1 MB broadcast's leaf message at 1,000 and 64, a batch that
# fills the card, the N = 1024 epoch's leaves, 1,000 short messages — and
# merkle_forest's (trees, leaves, bytes): the N = 1024 epoch's forest and
# the 1 MB broadcast's tree
PAIR_SHA = ([(1000, 47_672), (16_384, 4_096), (64, 47_672), (1024, 11)]
            + [(1000, n) for n in (0, 1, 55, 56, 63, 64, 119, 120)])
PAIR_FORESTS = [(974, 1024, 2), (1, 64, 47_663)]
SLEEP_CYCLES = 100_000_000


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


def parent_libs(src: str, label: str):
    """The ``sha256`` and ``merkle`` kernels of the sources in ``src``, built
    by ``nvcc`` with this tree's flags under build/; (sha256, merkle)
    libraries with their launch functions typed."""
    from hbbft_tpu_torch.ops import kernels

    out = kernels.BUILD_DIR / "parent" / label
    out.mkdir(parents=True, exist_ok=True)
    libs = []
    for name in ("sha256", "merkle"):
        so = out / f"lib{name}.so"
        proc = subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(so),
                               str(pathlib.Path(src) / f"{name}.cu")],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"torch_rbc_band: nvcc failed on the parent's {name}.cu:\n"
                             + proc.stderr[-3000:])
        libs.append(ctypes.CDLL(str(so)))
    p, i = ctypes.c_void_p, ctypes.c_int
    libs[0].sha256_launch.argtypes = [p, p, i, i, p]
    libs[0].sha256_launch.restype = i
    if hasattr(libs[0], "sha256_bytes_launch"):
        libs[0].sha256_bytes_launch.argtypes = [p, p, i, ctypes.c_longlong, p]
        libs[0].sha256_bytes_launch.restype = i
    libs[1].merkle_forest_launch.argtypes = [p, p, p, i, i, i, i, i, p]
    libs[1].merkle_forest_launch.restype = i
    return libs


def device_ms(fn, reps: int) -> float:
    """ms a call on the card's timeline: ``reps`` calls enqueued behind a
    sleep, so they run back to back."""
    import torch

    fn()  # warm-up
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    marks[0].record()
    torch.cuda._sleep(SLEEP_CYCLES)
    marks[1].record()
    for _ in range(reps):
        fn()
    marks[2].record()
    torch.cuda.synchronize()
    return marks[1].elapsed_time(marks[2]) / reps


def kernel_pairs(others, gen, reps: int):
    """Other trees' ``sha256`` and ``merkle_forest`` kernels (``others``:
    {label: (sha256 library, merkle library)}) against this tree's, in
    turns on one card (see the module docstring)."""
    import hashlib

    import torch

    from hbbft_tpu_torch.ops import sha256 as SH

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    lib, mlib = SH._lib(), SH._merkle_lib()

    def checked(rc):
        if rc:
            raise SystemExit(f"torch_rbc_band: a launch failed ({rc})")

    def turns(calls):
        """{label: [ms, ms]}: the calls timed in the order given, then in
        the reverse order."""
        got = {label: [] for label in calls}
        for label in list(calls) + list(reversed(list(calls))):
            got[label].append(statistics.median(device_ms(calls[label], reps) for _ in range(3)))
        return got

    rows = []
    for batch, nbytes in PAIR_SHA:
        raw = gen.integers(0, 256, size=(batch, nbytes), dtype=np.uint8)
        msgs = [r.tobytes() for r in raw]
        rows_t = torch.from_numpy(raw).to(dev)
        blocks = torch.from_numpy(SH.pad_messages(msgs).view(np.int32)).to(dev)
        nblocks = blocks.shape[1]
        outs, calls = {}, {}

        def add(label, lib_):
            for entry, fn in (("words", "sha256_launch"), ("raw", "sha256_bytes_launch")):
                if not hasattr(lib_, fn):
                    continue
                key = f"{label} {entry}" if label else entry
                out = outs[key] = torch.zeros((batch, 8), dtype=torch.int32, device=dev)
                if entry == "words":
                    calls[key] = lambda f=getattr(lib_, fn), o=out: checked(f(
                        blocks.data_ptr(), o.data_ptr(), batch, nblocks, stream))
                else:
                    calls[key] = lambda f=getattr(lib_, fn), o=out: checked(f(
                        rows_t.data_ptr(), o.data_ptr(), batch, nbytes, stream))

        for label, (plib, _) in others.items():
            add(label, plib)
        add("", lib)
        row = {"batch": batch, "bytes": nbytes, "blocks": nblocks, **turns(calls)}
        want = [hashlib.sha256(m).digest() for m in msgs]
        for label, t in outs.items():
            if SH.digests_to_bytes(t) != want:
                raise SystemExit(f"torch_rbc_band: sha256 ({label}) differs at {batch} × {nbytes}")
        rows.append(row)
        print("pair sha256 " + json.dumps(row), flush=True)
    for T, n, nbytes in PAIR_FORESTS:
        values = torch.from_numpy(gen.integers(0, 256, size=(T, n, nbytes), dtype=np.uint8)).to(dev)
        R = sum(SH.level_sizes(n))
        libs = {**{label: m for label, (_, m) in others.items()}, "new": mlib}
        outs = {k: torch.zeros((T, R, 8), dtype=torch.int32, device=dev) for k in libs}

        def forest(lib_, out):
            return lambda: checked(lib_.merkle_forest_launch(
                values.data_ptr(), out.data_ptr(), None, T, n, nbytes, R, 0, stream))

        row = {"trees": T, "leaves": n, "bytes": nbytes,
               **turns({k: forest(libs[k], outs[k]) for k in libs})}
        torch.cuda.synchronize()
        if any(not torch.equal(o, outs["new"]) for o in outs.values()):
            raise SystemExit(f"torch_rbc_band: merkle_forest differs at {T} × {n} × {nbytes}")
        rows.append(row)
        print("pair merkle_forest " + json.dumps(row), flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--parent", action="append", default=[],
                    help="another tree's csrc directory to time beside this one (repeatable)")
    ap.add_argument("--pairs-only", action="store_true", help="stop after the --parent pairs")
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
    others = {os.path.basename(os.path.dirname(os.path.abspath(d))) or d: d for d in args.parent}
    others = {label: parent_libs(d, label) for label, d in others.items()}
    plib = next(iter(others.values()), None)
    if others:
        out["pairs"] = kernel_pairs(others, gen, max(args.reps, 10))
    if args.pairs_only:
        return finish(out)

    def parent_many(msgs):
        """The parent tree's ``sha256_many``: padded on the host, its words
        kernel, the digests swapped by the host."""
        blocks = torch.from_numpy(SH.pad_messages(msgs).view(np.int32)).to(dev)
        res = torch.empty((len(msgs), 8), dtype=torch.int32, device=dev)
        rc = plib[0].sha256_launch(blocks.data_ptr(), res.data_ptr(), len(msgs), blocks.shape[1],
                                   torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"torch_rbc_band: the parent's sha256 launch failed ({rc})")
        return SH.digests_to_bytes(res)

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
            if plib is not None:
                if parent_many(msgs) != NT.sha256_many(msgs):
                    raise SystemExit(f"torch_rbc_band: the parent's sha256 differs at "
                                     f"{count} × {nbytes}")
                p["parent_card_s"] = median_s(lambda: parent_many(msgs), args.reps)
            sha.append(p)
            print(f"sha256 {count} × {nbytes} B: host {p['host_s'] * 1e3:.4f} ms, "
                  f"card {p['card_s'] * 1e3:.4f} ms"
                  + (f", parent's card {p['parent_card_s'] * 1e3:.4f} ms" if plib else ""),
                  flush=True)
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

    for rule in ("sha256_rule", "merkle_rule", "gf8_rule", "gf16_rule"):
        print(f"{rule}: " + json.dumps(out[rule]), flush=True)
    return finish(out)


def finish(out) -> int:
    """Write the JSON and print the card's name and power limit last."""
    card_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    out["card"] = card_line
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "torch_rbc_band.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(card_line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
