#!/usr/bin/env python3
"""Full HoneyBadger epochs on the card: walls by phase.

Two sequences of the port's ``VectorizedHoneyBadgerSim`` on
``CudaBackend()`` (real BLS12-381, the decryption flush's G1 aggregate
in ``win_g1``), after building the native library and the kernels:

1. ``bench.py``'s ``bench_hb_1024_real`` sequence: N = 1024,
   ``Random(0x1024)``, the last 50 nodes dead, ``verify_honest=True``,
   ``emit_minimal=False`` — setup, one cold epoch, three warm sequential
   epochs, then ``run_epochs([contribs] * 3, dead)`` pipelined (two
   epochs in flight).  Every batch must equal the contributions with
   974² shares verified and no fallback group.
2. ``bench_hb_epoch64_real``'s sequence: n = 64, ``Random(0x64)``,
   ``verify_honest=False``, ``emit_minimal=True`` — one warm-up epoch,
   then two timed epochs.

It prints a line a run, then one JSON object with the setup and cold
walls, the median s/epoch of the warm and pipelined epochs, the median
of each phase wall (``EpochResult.phases``: propose, rbc, agreement,
decrypt with its ``dec_*`` stages and the flush's ``flush_*`` stages,
assembly, commit_latency), the warm epochs' RBC wall split by work
(``harness.rbc_probe.RbcProbe``: the parity, decode and dead-row
products, the backend's trees, the independent re-root; medians, with
each product's shape and the RBC kernel launches the size rules send to
the card), the n = 64 epochs/s and the
launch counts; the JSON also goes to
``chiprun_out/torch_epoch_walls.json``.  The last
line is the card's name and power limit.  Run from the repo root on a
CUDA host: ``python3 scripts/torch_epoch_walls.py`` (``--nodes`` and
``--dead`` shrink the large sequence, ``--skip-large`` leaves it out).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _phase_medians(rows):
    keys = sorted({k for r in rows for k in r})
    return {k: statistics.median([r.get(k, 0.0) for r in rows]) for k in keys}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nodes", type=int, default=1024)
    ap.add_argument("--dead", type=int, default=50)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--skip-large", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_epoch_walls: needs a CUDA card", file=sys.stderr)
        return 1
    from hbbft_tpu_torch import native as NT
    from hbbft_tpu_torch.harness.epoch import VectorizedHoneyBadgerSim
    from hbbft_tpu_torch.harness.rbc_probe import RbcProbe
    from hbbft_tpu_torch.ops import cuda_ec, kernels

    NT.build()
    for name in ("win_g1", "sha256", "gf_matmul"):
        kernels.build(name)
    out = {"root": ROOT}

    def check(res, contribs, n_live, what):
        if res.batch.contributions != contribs or not res.fault_log.is_empty():
            raise SystemExit(f"torch_epoch_walls: {what}: wrong batch or faults {res.fault_log}")
        if n_live is not None and res.shares_verified != n_live**2:
            raise SystemExit(f"torch_epoch_walls: {what}: {res.shares_verified} shares verified")

    if not args.skip_large:
        n = args.nodes
        dead = set(range(n - args.dead, n))
        contribs = {i: [b"real-%04d" % i] for i in range(n) if i not in dead}
        n_live = len(contribs)
        cuda_ec.reset_launches()
        t0 = time.perf_counter()
        sim = VectorizedHoneyBadgerSim(n, random.Random(0x1024))
        out["setup_s"] = time.perf_counter() - t0
        print(f"N={n}: setup {out['setup_s']} s", flush=True)
        t0 = time.perf_counter()
        res = sim.run_epoch(contribs, dead=dead)
        out["cold_s"] = time.perf_counter() - t0
        out["cold_phases"] = res.phases
        check(res, contribs, n_live, "cold epoch")
        print(f"N={n}: cold epoch {out['cold_s']} s " + json.dumps(res.phases), flush=True)
        walls, rows, splits = [], [], []
        for e in range(args.epochs):
            t0 = time.perf_counter()
            with RbcProbe(sim.ref.ops, sim) as split:
                res = sim.run_epoch(contribs, dead=dead)
            walls.append(time.perf_counter() - t0)
            rows.append(res.phases)
            splits.append(split.walls)
            check(res, contribs, n_live, f"warm epoch {e}")
            print(f"N={n}: warm epoch {walls[-1]} s " + json.dumps(res.phases), flush=True)
            print(f"N={n}: warm epoch RBC split " + json.dumps(split.walls) + " calls "
                  + json.dumps(split.calls), flush=True)
        out["warm_walls"] = walls
        out["warm_s_per_epoch"] = statistics.median(walls)
        out["warm_phases"] = _phase_medians(rows)
        out["warm_rbc_split"] = _phase_medians(splits)
        out["rbc_calls"] = split.calls
        out["rbc_products"] = split.shapes
        out["rbc_sent_per_epoch"] = split.sent
        t0 = time.perf_counter()
        ress = sim.run_epochs([contribs] * args.epochs, dead=dead)
        out["pipelined_s_per_epoch"] = (time.perf_counter() - t0) / args.epochs
        for e, res in enumerate(ress):
            check(res, contribs, n_live, f"pipelined epoch {e}")
        out["pipelined_phases"] = _phase_medians([r.phases for r in ress])
        print(f"N={n}: pipelined {out['pipelined_s_per_epoch']} s/epoch", flush=True)
        if sim.be.stats.fallback_groups:
            raise SystemExit(f"torch_epoch_walls: a flush fell back: {sim.be.stats}")
        out["launches_large"] = dict(cuda_ec.LAUNCHES)
        del sim, res, ress

    contribs = {i: [b"e64-%d" % i] for i in range(64)}
    cuda_ec.reset_launches()
    t0 = time.perf_counter()
    sim = VectorizedHoneyBadgerSim(64, random.Random(0x64), verify_honest=False, emit_minimal=True)
    out["setup64_s"] = time.perf_counter() - t0
    check(sim.run_epoch(contribs), contribs, None, "n=64 warm-up")
    walls, rows = [], []
    for e in range(2):
        t0 = time.perf_counter()
        res = sim.run_epoch(contribs)
        walls.append(time.perf_counter() - t0)
        rows.append(res.phases)
        check(res, contribs, None, f"n=64 epoch {e}")
    out["epoch64_walls"] = walls
    out["epoch64_epochs_per_s"] = len(walls) / sum(walls)
    out["epoch64_phases"] = _phase_medians(rows)
    out["launches64"] = dict(cuda_ec.LAUNCHES)
    print(f"n=64: {out['epoch64_epochs_per_s']} epochs/s, walls {walls}", flush=True)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    out["card"] = card
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "torch_epoch_walls.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
