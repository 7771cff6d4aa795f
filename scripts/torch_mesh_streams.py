#!/usr/bin/env python3
"""How the flush's ``win_g1`` work splits over streams on one card, and
what holds the flush's launch stage.

1. ``win_g1`` at the flush's shape (65,536 points, 96-bit scalars) in
   four layouts, each the span from a start event on the current stream
   to the join of every stream it used (CUDA events), median of 3 after
   a warm-up: one launch of 65,536 points; four launches of 16,384 on
   four streams (the layout of ``make_mesh(4)``); four launches of
   16,384 on one stream; two launches of 32,768 on two streams.
2. The launch stage: the host's time to enqueue a group tree
   (``packed_msm._group_tree``, 64 groups of 1,024) with the card idle,
   and right behind a pending ``win_g1`` launch, under
   ``torch.cuda.set_sync_debug_mode("warn")`` (which reports every
   call that synchronises), and the number of device calls the tree
   makes (``torch.profiler``).

Prints one JSON object per measurement, then the card's name and power
limit.  Run from the repo root on a CUDA host:
``python3 scripts/torch_mesh_streams.py``.
"""

from __future__ import annotations

import json
import os
import random
import statistics
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

K, GROUPS, REPS = 1 << 16, 64, 3


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_mesh_streams: needs a CUDA card", file=sys.stderr)
        return 1
    from hbbft_tpu_torch import native as NT
    from hbbft_tpu_torch.crypto import fields as F
    from hbbft_tpu_torch.crypto.curve import G1_GEN
    from hbbft_tpu_torch.ops import cuda_ec
    from hbbft_tpu_torch.ops import packed_msm as PM

    dev = torch.device("cuda")
    rng = random.Random(0x57EA)
    wires = NT.g1_mul_many(NT.g1_wire(G1_GEN), [rng.randrange(1, F.R) for _ in range(K)])
    arr = np.frombuffer(b"".join(wires), dtype=np.uint8).reshape(K, 96).copy()
    pts = PM._wire_points_g1(torch.from_numpy(arr).to(dev))
    sc = PM.scalar_bytes_batch([rng.randrange(1, 1 << 96) for _ in range(K)], 12)
    dig = PM._scalar_digits(torch.from_numpy(sc).to(dev))
    torch.cuda.synchronize()

    def layout(parts: int, streams: int):
        """``parts`` launches of K/parts points over ``streams`` streams."""
        step = K // parts
        chunks = [(pts[i * step : (i + 1) * step], dig[i * step : (i + 1) * step]) for i in range(parts)]
        side = [torch.cuda.Stream() for _ in range(streams)]

        def run():
            cur = torch.cuda.current_stream()
            for s in side:
                s.wait_stream(cur)
            outs = []
            for i, (p, d) in enumerate(chunks):
                with torch.cuda.stream(side[i % streams]):
                    outs.append(cuda_ec.win_g1(p, d))
            for s in side:
                cur.wait_stream(s)
            return outs

        return run

    def span_ms(fn) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    for name, parts, streams in (
        ("one launch", 1, 1),
        ("4 launches on 4 streams", 4, 4),
        ("4 launches on 1 stream", 4, 1),
        ("2 launches on 2 streams", 2, 2),
    ):
        run = layout(parts, streams)
        run()  # warm-up
        spans = [span_ms(run) for _ in range(REPS)]
        print(json.dumps({"win_g1": name, "points": K, "span_ms": spans,
                          "median_ms": statistics.median(spans)}), flush=True)

    prods = cuda_ec.win_g1(pts, dig)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        PM._group_tree(prods, GROUPS)
        torch.cuda.synchronize()
    tree_calls = sum(1 for e in prof.events() if str(e.device_type).endswith("CUDA"))

    def enqueue(pending: bool):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                p = cuda_ec.win_g1(pts, dig) if pending else prods
                t1 = time.perf_counter()
                PM._group_tree(p, GROUPS)
                t2 = time.perf_counter()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        syncs = sorted({str(w.message)[:120] for w in caught})
        return {"kernel_pending": pending, "kernel_enqueue_s": t1 - t0,
                "tree_enqueue_s": t2 - t1, "wait_after_s": t3 - t2,
                "sync_warnings": len(caught), "sync_kinds": syncs}

    for pending in (False, True, False, True):
        out = enqueue(pending)
        out["tree_device_calls"] = tree_calls
        print(json.dumps(out), flush=True)

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
