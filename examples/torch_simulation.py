#!/usr/bin/env python3
"""Timed QueueingHoneyBadger network simulation on the PyTorch/CUDA port
(``hbbft_tpu_torch``) — the reference's headline benchmark binary
(``examples/simulation.rs``), with the flag surface and per-epoch output
table of ``examples/simulation.py``:

    python examples/torch_simulation.py -n 10 -f 0 -t 1000 -b 100 \
        --lag 100 --bw 2000 --cpu 100 --tx-size 10

``--real-bls`` deals real BLS12-381 threshold keys (default: the fast
mock crypto); ``--batched`` routes share verifications through the
batching façade (``BatchingBackend``), whose flushes run their G1
aggregate on the card.  ``--vectorized`` runs the array-based full-epoch
co-simulation (``harness/epoch.py``; with ``--dynamic`` the DHB stack of
``harness/dynamic.py``, with ``--virtual`` each epoch's simulated
latency under the --lag/--bw/--cpu profile).

``--device`` picks the backend's device: ``cuda`` (the default) needs a
card and raises without one; ``cpu`` runs every kernel's plain PyTorch
version.  There is no ``--trace``: the trace recorder is not part of the
port.
"""

import argparse
import random
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from hbbft_tpu_torch.harness.simulation import HwQuality, simulate_queueing_honey_badger
from hbbft_tpu_torch.ops.backend_cuda import CudaBackend


def _vectorized(args, ops) -> dict:
    rng = random.Random(args.seed)
    hw = HwQuality.from_flags(args.lag, args.bw, args.cpu) if args.virtual else None
    kw = dict(batch_size=args.batch, mock=not args.real_bls, ops=ops, verify_honest=False,
              emit_minimal=True, hw=hw)
    if args.dynamic:
        from hbbft_tpu_torch.harness.dynamic import VectorizedDynamicQueueingSim
        from hbbft_tpu_torch.protocols.change import Complete, Remove

        qsim = VectorizedDynamicQueueingSim(args.nodes, rng, **kw)
        f = (args.nodes - 1) // 3
        churn_target = max(qsim.validators)
        for v in qsim.validators[: f + 1]:
            qsim.vote_for(v, Remove(churn_target))
    else:
        from hbbft_tpu_torch.harness.epoch import VectorizedQueueingSim

        qsim = VectorizedQueueingSim(args.nodes, rng, **kw)
    qsim.input_all(
        [b"tx-%08d" % i + bytes(max(0, args.tx_size - 11)) for i in range(args.txs)]
    )
    all_ids = qsim.validators if args.dynamic else sorted(qsim.sim.netinfos)
    if args.dynamic and args.faulty:
        # keep the churn target (the highest id) alive: kill the
        # `faulty` ids just below it
        dead = set(all_ids[-(args.faulty + 1) : -1])
    else:
        dead = set(all_ids[-args.faulty :]) if args.faulty else set()
    committed: set = set()
    epoch = 0
    t0 = time.perf_counter()
    if args.virtual:
        print(f"{'Epoch':>5} {'Time':>8} {'SimTime':>9} {'Txs':>7} {'Total':>7}")
    else:
        print(f"{'Epoch':>5} {'Time':>8} {'Txs':>7} {'Total':>7}")
    while len(committed) < args.txs:
        te = time.perf_counter()
        if args.dynamic:
            # an era switch can shrink the validator set (and its f
            # bound): keep only still-current dead ids, capped at the new
            # set's tolerance
            cur = qsim.validators
            f_cap = (len(cur) - 1) // 3
            dead = set(sorted(v for v in dead if v in cur)[:f_cap])
        res = qsim.run_epoch(dead=dead)
        committed.update(res.batch.tx_iter())
        note = ""
        if args.dynamic and isinstance(res.change, Complete):
            note = f"  [era {res.era}: {res.change.change!r} complete]"
        virt = res.inner.virtual if args.dynamic else res.virtual
        sim_col = f" {virt.total_s:>8.2f}s" if args.virtual and virt else ""
        print(
            f"{epoch:>5} {time.perf_counter() - te:>7.2f}s{sim_col} "
            f"{len(res.batch):>7} {len(committed):>7}{note}"
        )
        epoch += 1
    wall = time.perf_counter() - t0
    print(
        f"\n{epoch} epochs | wall {wall:.2f}s "
        f"({epoch / wall:.2f} epochs/s, {len(committed) / wall:.0f} distinct tx/s)"
    )
    return {"epochs": epoch, "wall_s": wall, "committed": len(committed)}


def main(argv=None) -> dict:
    """Parse ``argv`` (``sys.argv[1:]`` when None), run, print the
    table; returns the run's summary: epochs, walls and the number of
    transactions every live node committed."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-n", "--nodes", type=int, default=10, help="total validators")
    p.add_argument("-f", "--faulty", type=int, default=0, help="crashed (silent) nodes")
    p.add_argument("-t", "--txs", type=int, default=1000, help="transactions to process")
    p.add_argument("-b", "--batch", type=int, default=100, help="batch size (txs/epoch)")
    p.add_argument("--lag", type=float, default=100.0, help="message latency, ms")
    p.add_argument("--bw", type=float, default=2000.0, help="upstream bandwidth, kbit/s")
    p.add_argument("--cpu", type=float, default=100.0, help="CPU speed, %% of host")
    p.add_argument("--tx-size", type=int, default=10, help="transaction size, bytes")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--real-bls", action="store_true", help="real BLS12-381 crypto")
    p.add_argument("--batched", action="store_true", help="fused batched verification")
    p.add_argument(
        "--vectorized",
        action="store_true",
        help="array-based full-epoch co-simulation (north-star scale)",
    )
    p.add_argument(
        "--dynamic",
        action="store_true",
        help="with --vectorized: the full QHB = DHB + queue stack "
        "(votes/on-chain DKG/era machinery active), and one "
        "Remove-churn of the highest node id mid-run",
    )
    p.add_argument(
        "--virtual",
        action="store_true",
        help="with --vectorized: also print each epoch's SIMULATED "
        "latency under the --lag/--bw/--cpu hardware profile",
    )
    p.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="the backend's device: cuda needs a card; cpu runs the "
        "kernels' plain PyTorch versions",
    )
    args = p.parse_args(argv)
    if 3 * args.faulty >= args.nodes:
        p.error("requires 3·f < n")
    if args.dynamic and not args.vectorized:
        p.error("--dynamic requires --vectorized")

    ops = CudaBackend(device=args.device)
    if args.vectorized:
        return _vectorized(args, ops)
    if args.batched:
        from hbbft_tpu_torch.harness.batching import BatchingBackend

        ops = BatchingBackend(inner=ops)
    stats, wall, sim_time = simulate_queueing_honey_badger(
        num_nodes=args.nodes,
        num_dead=args.faulty,
        num_txs=args.txs,
        batch_size=args.batch,
        tx_size=args.tx_size,
        lag_ms=args.lag,
        bw_kbit_s=args.bw,
        cpu_pct=args.cpu,
        rng=random.Random(args.seed),
        mock_crypto=not args.real_bls,
        ops=ops,
        verbose=True,
    )
    print(
        f"\n{len(stats.rows)} epochs | wall {wall:.2f}s "
        f"({len(stats.rows) / wall:.2f} epochs/s) | simulated {sim_time:.2f}s"
    )
    return {"epochs": len(stats.rows), "wall_s": wall, "sim_s": sim_time,
            "committed": len(stats.committed_txs()), "stats": stats}


if __name__ == "__main__":
    main()
