"""The port's ``TestNetwork`` and its adversaries against the reference's.

``harness/network.py``: the equivocating and forged-share adversaries
(the replay/inject one runs in the broadcast and QHB files), the
partition and seeded-delay schedules, kill/restart and
the batched-prefetch cadence, each driven through the reference's
network and the port's (``ops=CudaBackend(device="cpu")``) from one seed.
Step sequences, outputs by ``dumps`` bytes and fault logs are identical
(tolerance 0).  With ``ops=None`` the port's network resolves to the
card and raises without CUDA.
"""

import math
import random

import pytest
import torch

from torch_twin import PORT, twin


def _equivocation(side, seed):
    """Two corrupted nodes send BVal(true) to one half and BVal(false)
    to the other, then fall silent; the rest still agree."""
    rng = random.Random(seed)
    A, S = side.ag, side.sbv
    N = side.net
    Sch = N.MessageScheduler

    def make_pair(adv):
        return (
            A.AgreementMessage(0, A.SbvContent(S.BVal(True))),
            A.AgreementMessage(0, A.SbvContent(S.BVal(False))),
        )

    net = side.network(
        5, 2, lambda adv: N.EquivocatingAdversary(Sch(Sch.RANDOM, rng), make_pair),
        lambda ni: A.Agreement(ni, 0, 0), rng,
    )
    for nid in sorted(net.nodes):
        net.input(nid, bool(nid % 2))
    net.step_until(lambda: all(n.terminated() for n in net.nodes.values()))
    assert len({tuple(n.outputs) for n in net.nodes.values()}) == 1
    return net


def test_equivocating_adversary_matches_reference():
    twin(_equivocation, 50)


def _run_hb_net(side, net, rng, epochs=2, pump=None):
    """Every node proposes one contribution an epoch until each has
    ``epochs`` batches."""
    def batches(node):
        return [b for b in node.outputs if isinstance(b, side.hb.Batch)]

    guard = 0
    while not all(len(batches(n)) >= epochs for n in net.nodes.values()):
        guard += 1
        assert guard < 100_000, "network stalled"
        for nid in sorted(net.nodes):
            node = net.nodes[nid]
            if not node.instance.has_input() and len(batches(node)) < epochs:
                net.input(nid, [b"%d-%d" % (nid, len(batches(node)))])
        if pump is not None and guard % 7 == 0:
            pump(net)
        if net.any_busy():
            net.step()
        elif net.held_messages:
            net.release_held()
    return net


def _bad_shares(side, seed):
    rng = random.Random(seed)
    N = side.net
    Sch = N.MessageScheduler
    net = side.network(
        4, 1, lambda adv: N.BadShareAdversary(Sch(Sch.RANDOM, rng), rng, epochs=2),
        lambda ni: side.hb.HoneyBadger(ni, rng=random.Random(f"{ni.our_id}-n")), rng,
    )
    _run_hb_net(side, net, rng)
    kinds = {f.compact() for n in net.nodes.values() for f in n.faults}
    assert kinds == {"4:INVALID_DECRYPTION_SHARE"}, kinds
    return net


def test_bad_share_adversary_matches_reference():
    twin(_bad_shares, 51)


def _partition(side, seed):
    rng = random.Random(seed)
    sched = side.net.PartitionSchedule([[0, 1], [2, 3]])
    net = side.network(
        4, 0, side.silent(rng), lambda ni: side.hb.HoneyBadger(ni, rng=random.Random(f"{ni.our_id}-p")),
        rng, message_filter=sched,
    )
    for nid in sorted(net.nodes):
        net.input(nid, [b"p%d" % nid])
    while net.any_busy():
        net.step()
    assert not any(n.outputs for n in net.nodes.values())  # no quorum either side
    held = sched.held_count
    sched.heal(net)
    _run_hb_net(side, net, rng, epochs=1)
    return {"net": net, "held": held}


def test_partition_schedule_matches_reference():
    ref, port = twin(_partition, 52)
    assert port["held"] > 0


def _delays(side, seed):
    rng = random.Random(seed)
    sched = side.net.SeededDelaySchedule(random.Random(seed + 1), p_delay=0.3, p_release=0.5)
    net = side.network(
        4, 0, side.silent(rng), lambda ni: side.hb.HoneyBadger(ni, rng=random.Random(f"{ni.our_id}-d")),
        rng, message_filter=sched,
    )
    _run_hb_net(side, net, rng, epochs=2, pump=sched.pump)
    return {"net": net, "held": sched.held_count}


def test_seeded_delay_schedule_matches_reference():
    ref, port = twin(_delays, 53)
    assert port["held"] > 0


def _kill_restart(side, seed):
    rng = random.Random(seed)
    net = side.network(
        4, 0, side.silent(rng), lambda ni: side.hb.HoneyBadger(ni, rng=random.Random(f"{ni.our_id}-k")), rng,
    )
    for nid in sorted(net.nodes):
        net.input(nid, [b"k%d" % nid])
    for _ in range(40):
        net.step()
    node = net.kill(3)
    queued = len(net._down[3])
    while net.any_busy():
        net.step()
    net.restart(3, node.algo)
    _run_hb_net(side, net, rng, epochs=2)
    return {"net": net, "queued": queued}


def test_kill_restart_matches_reference():
    twin(_kill_restart, 54)


def _prefetch_cadence(side, seed):
    rng = random.Random(seed)
    ops = side.ops(batching=True)
    calls = []
    inner = ops.prefetch

    def prefetch(obs):
        calls.append(len(obs))
        inner(obs)

    ops.prefetch = prefetch
    net = side.network(
        4, 0, side.silent(rng), lambda ni: side.hb.HoneyBadger(ni, rng=random.Random(f"{ni.our_id}-c")),
        rng, mock_crypto=False, ops=ops,
    )
    _run_hb_net(side, net, rng, epochs=1)
    assert net.prefetch_every == 4
    assert len(calls) == math.ceil(len(net.trace) / 4)
    return {"net": net, "calls": calls}


def test_prefetch_cadence_matches_reference():
    twin(_prefetch_cadence, 55)


def test_scheduler_and_idle_network():
    rng = random.Random(56)
    net = PORT.network(4, 0, PORT.silent(rng, "first"), lambda ni: PORT.bc.Broadcast(ni, 0), rng)
    with pytest.raises(RuntimeError, match="idle"):
        net.step_until(lambda: False)
    net.input(0, b"x")
    assert net.step() == 1  # FIRST: the lowest busy node
    net.dispatch_messages(0, [PORT.step.Target.to("nobody").message("dropped")])
    net.step_until(lambda: all(n.terminated() for n in net.nodes.values()))
    assert net.observer.outputs == [b"x"]
    assert net.prefetch_every == 0


def test_default_ops_is_the_card(monkeypatch):
    from hbbft_tpu_torch.harness import network
    from hbbft_tpu_torch.ops.backend_cuda import CudaBackend

    def build(ops=None):
        rng = random.Random(57)
        return network.TestNetwork(
            4, 0, PORT.silent(rng), lambda ni: PORT.bc.Broadcast(ni, 0), rng, ops=ops
        )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build()
    made = []
    real_init = CudaBackend.__init__

    def init(self, device=None, mesh=None):
        made.append(device)
        real_init(self, device="cpu")

    monkeypatch.setattr(CudaBackend, "__init__", init)
    net = build()
    assert made == [None]  # the default device, i.e. the card
    assert isinstance(net.ops, CudaBackend)
    assert all(n.algo.netinfo.ops is net.ops for n in net.nodes.values())
