#!/usr/bin/env python3
"""fr_matmul at the dealing's shapes, and the elided DKG at N = 1024, on the card.

1. Times the ``fr_matmul`` kernel (CUDA events, ``--reps`` launches after
   a warm-up) at the three shapes of one dealer of the N = 1023 dealing
   (t = 340): rows ``[681, 341]·[341, 341]``, values
   ``[341, 341]·[341, 1023]`` and the λ row ``[1, 341]·[341, 1023]``,
   each with ``acc``, on random canonical Fr; each result must equal the
   plain version word for word.  Each shape's bound is chip_smoke.py's
   ``fr_bound``: the smaller of the kernel's IMAD count and a 32-limb
   form's int8 tensor-core count, or the bytes if they take longer.
2. Runs ``bench_dkg_1024``'s DKG (``bench.py:1968``):
   ``VectorizedDkg(range(1024), 341, Random(0xDA)).run(verify_honest=False)``,
   which routes to the device engine on the card, and checks that t + 1
   signature shares of its keys combine and verify.

Prints one JSON object (also written to
``chiprun_out/torch_fr_walls.json``) and the card's name and power limit.
Run from the repo root on a CUDA host: ``python3 scripts/torch_fr_walls.py``
(``--skip-dkg`` for the kernel alone).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N, T = 1023, 340
DKG_NODES, DKG_T, DKG_SEED = 1024, 341, 0xDA


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--skip-dkg", action="store_true")
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

    NT.build()
    t0 = time.perf_counter()
    kernels.build("fr_matmul")
    out = {"build_s": time.perf_counter() - t0}
    out["ptxas"] = [l.strip() for l in kernels.build_log("fr_matmul").splitlines()
                    if "registers" in l or "stack frame" in l]
    dev = torch.device("cuda")
    rng = random.Random(0xF4)

    def words(n, *shape):
        raw = b"".join(rng.randrange(F.R).to_bytes(32, "little") for _ in range(n))
        host = np.frombuffer(raw, dtype="<i4").reshape(*shape, 8).copy()
        return torch.from_numpy(host).to(dev)

    shapes = {"rows": (2 * T + 1, T + 1, T + 1), "values": (T + 1, T + 1, N), "lambda": (1, T + 1, N)}
    out["shapes"] = {}
    for name, (m, k, p) in shapes.items():
        a, b, acc = words(m * k, m, k), words(k * p, k, p), words(m * p, m, p)
        got = FR.fr_matmul(a, b, acc)
        if not torch.equal(got, FR.fr_matmul_plain(a, b, acc)):
            print(f"torch_fr_walls: fr_matmul differs from its plain version at {name}",
                  file=sys.stderr)
            return 1
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(args.reps):
            FR.fr_matmul(a, b, acc)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / args.reps
        bound, bound_by, imad_ms, tc_ms = fr_bound(m, k, p, acc=True)
        out["shapes"][name] = {
            "m": m, "k": k, "p": p, "ms": ms, "bound_ms": bound, "bound_by": bound_by,
            "imad_bound_ms": imad_ms, "int8_tc_bound_ms": tc_ms, "share_of_bound": bound / ms,
            "share_of_imad_bound": imad_ms / ms, "macs_per_s": m * k * p / ms * 1e3,
        }
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
