#!/usr/bin/env python3
"""Where the time of one full-width flush goes, on the card.

Drives ``BatchingBackend(inner=CudaBackend()).prefetch`` over N = 1024
validators × 64 fresh ciphertexts (65,536 decryption shares), or with
``--mesh N`` the same flush over ``CudaBackend(mesh=make_mesh(N))``
(N shards, each on its own stream): a few
warm flushes timed by the host clock (with their stage walls), then
one flush under ``torch.profiler`` (CPU + CUDA activities) for the
device's busy time by kernel.  Prints one JSON object per measurement,
then the card's name and power limit; with a path argument the
profiled flush's Chrome trace is written there.

Run from the repo root on a CUDA host:
``python3 scripts/torch_flush_profile.py [--mesh N] [TRACE.json]``.
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

N_NODES, GROUPS, WARM = 1024, 64, 3


def _on_device(evt) -> bool:
    return str(evt.device_type).endswith("CUDA")


def _busy_us(events) -> float:
    """Length of the union of the device events' time ranges."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_lo, cur_hi = 0.0, None, None
    for lo, hi in spans:
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        busy += cur_hi - cur_lo
    return busy


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", nargs="?", help="write the profiled flush's Chrome trace here")
    ap.add_argument("--mesh", type=int, default=0, help="shards of a mesh (0: one device)")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_flush_profile: needs a CUDA card", file=sys.stderr)
        return 1
    from hbbft_tpu_torch.harness.batching import BatchingBackend
    from hbbft_tpu_torch.harness.workload import DecryptionFlushWorkload
    from hbbft_tpu_torch.ops import cuda_ec
    from hbbft_tpu_torch.ops.backend_cuda import CudaBackend
    from hbbft_tpu_torch.parallel.mesh import make_mesh

    work = DecryptionFlushWorkload(N_NODES, random.Random(0xF10))
    inner = CudaBackend(mesh=make_mesh(args.mesh) if args.mesh else None)
    batches = [work.obligations(b"p-%d" % i, GROUPS) for i in range(WARM + 2)]
    walls, phases = [], []
    for obs in batches[:WARM + 1]:  # the first is the cold flush
        be = BatchingBackend(inner=inner)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        be.prefetch(obs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        phases.append(dict(be.last_flush_phases))
        assert be.stats.fallback_items == 0
    print(
        json.dumps(
            {
                "mesh": args.mesh,
                "cold_flush_s": walls[0],
                "warm_flush_s": walls[1:],
                "median_s": statistics.median(walls[1:]),
                "shares_per_s": N_NODES * GROUPS / statistics.median(walls[1:]),
                "phases": {k: statistics.median(p[k] for p in phases[1:]) for k in phases[-1]},
                "launch_s": [p["launch"] for p in phases[1:]],
            }
        ),
        flush=True,
    )

    be = BatchingBackend(inner=inner)
    cuda_ec.reset_launches()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        be.prefetch(batches[-1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_events = [e for e in prof.events() if _on_device(e)]
    busy_us = _busy_us(device_events)
    by_name = {}
    for e in device_events:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    rows = sorted(((us, name, n) for name, (us, n) in by_name.items()), reverse=True)
    print(
        json.dumps(
            {
                "profiled_flush_s": wall,
                "device_busy_ms": busy_us / 1e3,
                "device_idle_share": 1 - busy_us / 1e6 / wall,
                "launches": dict(cuda_ec.LAUNCHES),
                "top_device_ops": [
                    {"op": key[:80], "ms": us / 1e3, "calls": n} for us, key, n in rows[:12]
                ],
                "device_ops": len(rows),
                "device_calls": sum(n for _, _, n in rows),
            }
        ),
        flush=True,
    )
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
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
