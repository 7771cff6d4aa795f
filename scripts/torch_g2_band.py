#!/usr/bin/env python3
"""Where a G2 MSM should run: the card or native host Pippenger.

Times the flat G2 MSM Σ kᵢ·Pᵢ with 255-bit scalars — the shape of the
verified DKG's fused check — on the card (``hbbft_tpu_torch`` packed
path: 192-byte wires copied to the card → torch unpack → ``win_g2``
kernel at 64 windows → torch complete-add tree → host point) and on the
host (native ``hb_g2_msm``), each the median of a few runs after a
warm-up, and checks that both give the same wire.  The last card run
of each size gives its stage walls (ship + unpack, ``win_g2``, tree,
finalize).

``VectorizedDkg.G2_DEVICE_MIN`` routes the fused check by this size.

Run from the repo root on a CUDA host: ``python3 scripts/torch_g2_band.py``.
Prints one JSON object per size, then the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import random
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# from a small DKG's fused check up; the card has led native from 2^12
# on (PERF.md), so the larger sizes stop at 2^16
SIZES = (1 << 8, 1 << 9, 1 << 10, 1 << 11, 1 << 12, 1 << 14, 1 << 16)
REPS = 3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_g2_band: needs a CUDA card", file=sys.stderr)
        return 1
    from hbbft_tpu_torch import native as NT
    from hbbft_tpu_torch.crypto import fields as F
    from hbbft_tpu_torch.crypto.curve import G2_GEN
    from hbbft_tpu_torch.ops import packed_msm as PM

    dev = torch.device("cuda")
    rng = random.Random(0xB2D)
    k_max = max(SIZES)
    ks = PM.scalar_bytes_batch([rng.randrange(1, F.R) for _ in range(k_max)], 32)
    raw = NT.g2_mul_many_raw(NT.g2_wire(G2_GEN), ks).reshape(k_max, 192)
    pool = [raw[i].tobytes() for i in range(k_max)]

    for k in SIZES:
        pts = pool[:k]
        scalars = [rng.randrange(0, F.R) for _ in range(k)]
        dev_s, host_s = [], []
        for rep in range(REPS + 1):
            phases: dict = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = PM.g2_msm_packed_wires(pts, scalars, dev, phases)
            dt_dev = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = NT.g2_msm(pts, scalars)
            dt_host = time.perf_counter() - t0
            if got != want:
                print(f"torch_g2_band: G2 MSM mismatch at K={k}", file=sys.stderr)
                return 1
            if rep:  # the first run is the warm-up
                dev_s.append(dt_dev)
                host_s.append(dt_host)
        row = {"k": k, "device_s": statistics.median(dev_s), "host_s": statistics.median(host_s)}
        row.update(device_runs=dev_s, host_runs=host_s, device_phases=phases)
        print(json.dumps(row), flush=True)
    print(
        subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True,
            text=True,
            timeout=60,
        ).stdout.strip()
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
