#!/usr/bin/env python3
"""The verified DKG's wall and stage walls, on the card.

Runs ``VectorizedDkg(range(128), 42, Random(0xD6)).run(verify_honest=True)``
once (236,672 G2 points in one fused MSM through ``win_g2``;
``bench_dkg_verified``'s shape, which chip_smoke.py cuts to N = 64)
after building the kernels, checks
that it logged no fault and completed every part, and prints one JSON
object with the wall, ``VectorizedDkg.last_phases`` and the launch
counts, then the card's name and power limit.  It uses only the
public entry points, so the same file runs on an older tree of the
repo for an A/B in one call.  Run from the repo root on a CUDA host:
``python3 scripts/torch_dkg_walls.py``.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NODES, T, SEED = 128, 42, 0xD6


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_dkg_walls: needs a CUDA card", file=sys.stderr)
        return 1
    from hbbft_tpu_torch import native as NT
    from hbbft_tpu_torch.harness.dkg import VectorizedDkg
    from hbbft_tpu_torch.ops import cuda_ec, kernels

    NT.build()
    kernels.build("win_g2")
    dkg = VectorizedDkg(list(range(NODES)), T, random.Random(SEED))
    cuda_ec.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = dkg.run(verify_honest=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not res.fault_log.is_empty() or len(res.complete) != NODES:
        print("torch_dkg_walls: the honest DKG did not complete cleanly", file=sys.stderr)
        return 1
    print(json.dumps({
        "root": ROOT,
        "dkg_s": wall,
        "checks_per_s": (res.row_checks + res.value_checks) / wall,
        "last_phases": dkg.last_phases,
        "launches": dict(cuda_ec.LAUNCHES),
    }))
    print(
        subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
