#!/usr/bin/env python3
"""Where a G1 MSM should run: the card or native host Pippenger.

Times the two G1 MSM shapes that ``CudaBackend`` routes by size, each on
the card (``hbbft_tpu_torch`` packed path: wire copy → torch unpack →
``win_g1`` kernel → complete-add trees → host point) and on the host
(the port's ``CpuBackend``, native ``hb_g1_msm``), each the median of a
few runs after a warm-up, and checks that both give the same point:

- ``flat``: Σ rᵢ·Pᵢ with the 128-bit random-linear-combination
  coefficients of a per-group ``batch_verify_shares`` (and of a
  duplicate-cell flush);
- ``product``: the fused flush's Σ_g t_g·(Σ_{i∈g} sᵢ·Pᵢ) over N senders
  × G groups with 96-bit s- and t-coefficients, which the card runs as
  24-window scalar muls plus group trees and the host as one flat MSM
  with the 255-bit scalars sᵢ·t_g mod r.

``CudaBackend.G1_DEVICE_MIN`` (flat) and ``G1_PRODUCT_DEVICE_MIN``
(product) are the smallest measured K where the card wins.

Run from the repo root on a CUDA host: ``python3 scripts/torch_g1_band.py``.
Prints one JSON object per shape and size, then the card's name and
power limit.
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

FLAT_SIZES = (256, 1024, 4096, 16384, 32768, 65536)
# (senders, groups): the flush shapes at N = 1024 and three smaller ones
PRODUCT_SHAPES = ((64, 4), (256, 4), (1024, 4), (1024, 8), (1024, 16), (1024, 32), (1024, 64))
REPS = 3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_g1_band: needs a CUDA card", file=sys.stderr)
        return 1
    from hbbft_tpu_torch import native as NT
    from hbbft_tpu_torch.crypto import fields as F
    from hbbft_tpu_torch.crypto.backend import CpuBackend
    from hbbft_tpu_torch.crypto.curve import G1, G1_GEN
    from hbbft_tpu_torch.ops import packed_msm as PM

    dev = torch.device("cuda")
    host = CpuBackend()
    rng = random.Random(0xBA7D)
    k_max = max(max(FLAT_SIZES), max(n * g for n, g in PRODUCT_SHAPES))
    wires = NT.g1_mul_many(NT.g1_wire(G1_GEN), [rng.randrange(1, F.R) for _ in range(k_max)])
    pool = [NT.g1_unwire(w, G1) for w in wires]
    for p, w in zip(pool, wires):
        p._wire = w

    def measure(name, k, on_device, on_host, **shape):
        dev_s, host_s = [], []
        for rep in range(REPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = on_device()
            dt_dev = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = on_host()
            dt_host = time.perf_counter() - t0
            if got != want:
                print(f"torch_g1_band: {name} MSM mismatch at K={k}", file=sys.stderr)
                sys.exit(1)
            if rep:  # the first run is the warm-up
                dev_s.append(dt_dev)
                host_s.append(dt_host)
        row = {"shape": name, "k": k, **shape}
        row.update(device_s=statistics.median(dev_s), host_s=statistics.median(host_s))
        print(json.dumps(row), flush=True)

    for k in FLAT_SIZES:
        pts = pool[:k]
        scalars = [rng.randrange(1, 1 << 128) | 1 for _ in range(k)]
        measure(
            "flat",
            k,
            lambda: PM.g1_msm_async(pts, scalars, dev)(),
            lambda: host.g1_msm(pts, scalars),
        )
    for n, g in PRODUCT_SHAPES:
        k = n * g
        pts = pool[:k]
        s_each = [rng.randrange(1, 1 << 96) | 1 for _ in range(n)]
        s = s_each * g  # group-major: sender i has the same s in every group
        t = [rng.randrange(1, 1 << 96) | 1 for _ in range(g)]
        sizes = [n] * g
        measure(
            "product",
            k,
            lambda: PM.g1_msm_product_async(pts, s, t, sizes, dev)(),
            lambda: host.g1_msm_product_async(pts, s, t, sizes)(),
            senders=n,
            groups=g,
        )
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
