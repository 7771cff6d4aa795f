#!/usr/bin/env python3
"""The packed co-simulation's scale sweep on the card, with each epoch's
wall split by stage.

``bench.py``'s ``bench_cosim`` sequence on the port's
``PackedHoneyBadgerCosim`` (``hbbft_tpu_torch/harness/cosim.py``), after
building the ``cosim_step`` kernels:

1. the scale sweep: n ∈ {1,000, 4,096, 16,384, 65,536, 100,000} under
   ``WanModel(seed=0xC052, DEFAULT_TOPOLOGY, LatencyModel("lognormal"),
   deadline_ms=400)``, the last 2 % of nodes dead (inside f), each sim
   built from ``Random(0xC053)``; a cold epoch, then ``--epochs`` warm
   ``run_epoch_packed`` epochs.  A row a size, as ``bench_cosim`` emits
   it (``cosim_epochs_per_s``: the warm median, init, cold and warm
   walls, accepted, coin flips, peak RSS, bytes a validator, shards),
   plus each warm epoch's wall split into the WAN view, the host mask
   building, the copies to the card (the reach matrix with them), the
   step (one ``cosim_step`` launch on one card; a ``cosim_hist`` and a
   ``cosim_step`` launch a shard on a mesh) and the copies back, each
   ended by a
   synchronize (medians, and ``other``: what the epoch spent outside
   them), and the launches;
2. the equivalence leg: ``VectorizedQueueingSim(1024, Random(0xC051),
   batch_size=1024, mock=True)`` on ``CudaBackend()`` against
   ``PackedQueueingCosim(1024, Random(0xC051), batch_size=1024)``, 2,048
   transactions, the last 30 dead, 2 epochs; batches, accepted sets and
   fault logs must be equal (``cosim_twin_identity``, with both planes'
   walls);
3. the ``cosim_sweep`` summary row.

Each row is one JSON line; all of them also go to
``chiprun_out/torch_cosim_walls.json``.  The last line is the card's name
and power limit.  Run from the repo root on a CUDA host:
``python3 scripts/torch_cosim_walls.py`` (``--ns 1000,16384`` for some
sizes, ``--epochs`` for a longer warm leg, ``--skip-twin`` to leave the
equivalence leg out).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import resource
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STAGES = ("wan_view", "masks", "to_card", "step", "from_card")


def _row(metric, value, unit, **kw):
    row = {"metric": metric, "value": value, "unit": unit, **kw}
    print(json.dumps(row), flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ns", default="1000,4096,16384,65536,100000")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--skip-twin", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_cosim_walls: needs a CUDA card", file=sys.stderr)
        return 1
    from hbbft_tpu_torch.harness import wan as W
    from hbbft_tpu_torch.harness.cosim import PackedHoneyBadgerCosim, PackedQueueingCosim
    from hbbft_tpu_torch.harness.epoch import VectorizedQueueingSim
    from hbbft_tpu_torch.ops import cuda_ec, kernels

    kernels.build("cosim_step")
    card = torch.cuda.get_device_name(0)
    torch.zeros(1, device="cuda")  # the CUDA context
    # the process's peak RSS before the first sim (the CUDA context and
    # the libraries): each row's peak_rss_mb is the process's high-water
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    print(json.dumps({"peak_rss_mb_before": rss0, "device": card}), flush=True)
    rows = []
    wan = W.WanModel(seed=0xC052, topology=W.DEFAULT_TOPOLOGY,
                     latency=W.LatencyModel("lognormal"), deadline_ms=400.0)
    for n in [int(x) for x in args.ns.split(",") if x]:
        n_dead = min(n // 50, (n - 1) // 3)  # 2 % crashed, inside the f bound
        dead = set(range(n - n_dead, n))
        t0 = time.perf_counter()
        sim = PackedHoneyBadgerCosim(n, random.Random(0xC053), wan=wan)
        init_s = time.perf_counter() - t0
        cold = sim.run_epoch_packed(dead=dead)
        cuda_ec.reset_launches()
        warm, stages = [], []
        for _ in range(args.epochs):
            warm.append(sim.run_epoch_packed(dead=dead))
            split = dict(sim.last_phases)
            split["other"] = warm[-1].wall_s - sum(split[k] for k in STAGES)
            stages.append(split)
        rate = statistics.median(s.epochs_per_s for s in warm)
        last = warm[-1]
        rows.append(_row(
            "cosim_epochs_per_s", rate, "epochs/s",
            nodes=n, dead=n_dead, epochs=args.epochs, init_s=init_s, cold_epoch_s=cold.wall_s,
            warm_epoch_s=1.0 / rate, warm_walls_s=[s.wall_s for s in warm],
            accepted=last.accepted, coin_flips=last.coin_flips,
            peak_rss_mb=last.peak_rss_bytes / 2**20, bytes_per_validator=last.bytes_per_validator,
            mesh_devices=last.mesh_devices, wan_zones=len(W.DEFAULT_TOPOLOGY.zones),
            wan_distribution="lognormal",
            stages_s={k: statistics.median(s[k] for s in stages) for k in STAGES + ("other",)},
            launches={k: v for k, v in cuda_ec.LAUNCHES.items() if v}, device=card,
        ))

    if not args.skip_twin:
        n, epochs = 1024, 2
        dead = set(range(n - 30, n))
        legacy = VectorizedQueueingSim(n, random.Random(0xC051), batch_size=n, mock=True)
        packed = PackedQueueingCosim(n, random.Random(0xC051), batch_size=n)
        txs = [b"cosim-%06d" % i for i in range(2 * n)]
        legacy.input_all(txs)
        packed.input_all(txs)
        dict_s, packed_s = [], []
        for e in range(epochs):
            t0 = time.perf_counter()
            res_l = legacy.run_epoch(dead=dead)
            t1 = time.perf_counter()
            res_p = packed.run_epoch(dead=dead)
            dict_s.append(t1 - t0)
            packed_s.append(time.perf_counter() - t1)
            if (res_l.batch != res_p.batch or res_l.accepted != res_p.accepted
                    or [f.compact() for f in res_l.fault_log] != [f.compact() for f in res_p.fault_log]):
                raise SystemExit(f"torch_cosim_walls: the packed plane diverged at epoch {e}")
        rows.append(_row("cosim_twin_identity", 1.0, "bool", nodes=n, epochs=epochs,
                         dead=len(dead), dict_walls_s=dict_s, packed_walls_s=packed_s,
                         device=card))

    sweep = [r for r in rows if r["metric"] == "cosim_epochs_per_s"]
    if sweep:
        rows.append(_row(
            "cosim_sweep", max(r["nodes"] for r in sweep), "validators",
            rates={str(r["nodes"]): r["value"] for r in sweep},
            peak_rss_mb={str(r["nodes"]): r["peak_rss_mb"] for r in sweep},
            host_cores=os.cpu_count(), device=card,
        ))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "torch_cosim_walls.json"), "w") as fh:
        json.dump(rows, fh, indent=1)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
