#!/usr/bin/env python3
"""Timing of one ring step of the mesh (``cuda_ec.ring_permute``).

One step is ``ring_permute`` over a mesh of ``--shards`` shards at the
mesh flush's message shape ([64, 3, 38] int32 a shard), with
``Mesh.fork`` before it and ``Mesh.join`` after it, as the flush's ring
reduction runs it.  After a byte check against ``ring_permute_plain``
and a count of the ring kernel's launches a step, each of ``--trials``
trials times ``--reps`` steps two ways:

- paced by the host: back to back between two synchronizes (host
  clock), ms a step;
- on the card's own timeline: enqueued behind a ``torch.cuda._sleep``
  on the current stream, CUDA events around them, ms a step (the sleep
  must outlast the enqueue, or the script fails).

Prints one JSON line (medians, every trial, launches a step, the label)
and the card's name and power limit.  It uses only ``make_mesh``,
``ring_permute``, ``ring_permute_plain``, ``LAUNCHES`` and the mesh's
``fork``/``join``, so it runs unchanged on an older tree: for an A/B in
one call, unpack the parent with ``git archive`` into a git-ignored
``.scratch_*`` directory, copy this script into its ``scripts/``, and
run parent, change, change, parent.  Run from the repo root on a CUDA
host: ``python3 scripts/torch_ring_step.py [--shards 4] [--reps 100]
[--trials 5] [--label NAME]``.
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

# cycles the card sleeps while the steps are enqueued behind it (~0.25 s at
# the H100's 1.98 GHz boost clock)
SLEEP_CYCLES = 500_000_000


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--label", default=os.path.basename(ROOT))
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_ring_step: needs a CUDA card", file=sys.stderr)
        return 1
    from hbbft_tpu_torch.ops import cuda_ec
    from hbbft_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(args.shards)
    gen = np.random.default_rng(0x5EED)
    msg = [
        torch.from_numpy(gen.integers(-(2**31), 2**31, size=(64, 3, 38), dtype=np.int32)).to(d)
        for d in mesh.devices
    ]

    def step():
        mesh.fork()
        return mesh.join(cuda_ec.ring_permute(msg, mesh))

    want = cuda_ec.ring_permute_plain(msg, mesh)
    before = cuda_ec.LAUNCHES["ring_permute"]
    got = step()
    launches = cuda_ec.LAUNCHES["ring_permute"] - before
    torch.cuda.synchronize()
    if not all(torch.equal(g, w.to(g.device)) for g, w in zip(got, want)):
        raise SystemExit("ring_permute differs from ring_permute_plain")

    host, card = [], []
    for _ in range(args.trials):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            step()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) / args.reps * 1e3)

        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        marks[0].record()
        torch.cuda._sleep(SLEEP_CYCLES)
        marks[1].record()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            step()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        marks[2].record()
        torch.cuda.synchronize()
        slept_ms = marks[0].elapsed_time(marks[1])
        if enqueue_ms >= slept_ms:
            raise SystemExit(f"enqueue took {enqueue_ms} ms, the card slept {slept_ms} ms")
        card.append(marks[1].elapsed_time(marks[2]) / args.reps)
    print(
        json.dumps(
            {
                "label": args.label,
                "mesh": str(mesh),
                "launches_a_step": launches,
                "host_ms_median": statistics.median(host),
                "card_ms_median": statistics.median(card),
                "host_ms": host,
                "card_ms": card,
            }
        ),
        flush=True,
    )
    print(
        subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
