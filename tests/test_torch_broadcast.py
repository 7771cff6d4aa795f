"""The port's reliable broadcast against the reference's.

The scenarios of ``tests/test_broadcast.py`` (silent, first-delivery,
proposing-equivocator and random-fuzz adversaries across network sizes
with f = (N−1)/3 corrupted nodes), each run through the reference's
``TestNetwork`` and the port's (``ops=CudaBackend(device="cpu")``) from
one seed: the step sequence, every node's outputs by ``dumps`` bytes and
every fault log must be identical (tolerance 0), and every good node and
the observer deliver the proposed value exactly once.
"""

import random

import pytest

from torch_twin import PORT, twin


def _propose_adversary(side, scheduler):
    """A corrupt node runs its own broadcast instance claiming to
    propose and leaks its messages (reference ``tests/broadcast.rs:31-91``)."""
    N = side.net

    class ProposeAdversary(N.Adversary):
        def __init__(self):
            self.has_sent = False
            self.adv_netinfos = {}

        def init(self, all_nodes, adv_netinfos):
            self.adv_netinfos = adv_netinfos

        def pick_node(self, nodes):
            return scheduler.pick_node(nodes)

        def push_message(self, sender_id, tm):
            pass

        def step(self):
            if self.has_sent or not self.adv_netinfos:
                return []
            self.has_sent = True
            adv_id = sorted(self.adv_netinfos)[0]
            bc = side.bc.Broadcast(self.adv_netinfos[adv_id], adv_id)
            step = bc.handle_input(b"Fake news")
            return [N.MessageWithSender(adv_id, tm) for tm in step.messages]

    return ProposeAdversary()


def _adversary(side, kind, rng):
    N = side.net
    S = N.MessageScheduler
    if kind == "random":
        return lambda adv: N.SilentAdversary(S(S.RANDOM, rng))
    if kind == "first":
        return lambda adv: N.SilentAdversary(S(S.FIRST, rng))
    if kind == "propose":
        return lambda adv: _propose_adversary(side, S(S.RANDOM, rng))
    assert kind == "fuzz"
    gen_rng = random.Random(4)

    def gen():
        T = side.step.Target
        msg = side.bc.random_message(gen_rng)
        if gen_rng.random() < 0.5:
            return T.all().message(msg)
        return T.to(gen_rng.randrange(4)).message(msg)

    return lambda adv: N.RandomAdversary(0.2, 0.2, gen, rng)


def _sweep(side, kind, proposed, seed, sizes=None):
    rng = random.Random(seed)
    if sizes is None:
        sizes = list(range(1, 7)) + [rng.randrange(8, 16)]
    nets = {}
    for size in sizes:
        f = (size - 1) // 3
        net = side.network(
            size - f, f, _adversary(side, kind, rng), lambda ni: side.bc.Broadcast(ni, 0), rng
        )
        net.input(0, proposed)
        net.step_until(lambda: all(n.terminated() for n in net.nodes.values()))
        for node in list(net.nodes.values()) + [net.observer]:
            assert node.outputs == [proposed], node.id
        nets[f"n{size}"] = net
    return nets


@pytest.mark.parametrize(
    "kind,proposed,seed,sizes",
    [
        ("random", b"Foo", 1, None),
        ("first", b"Foo", 2, None),
        ("propose", b"Foo", 3, None),
        ("fuzz", b"RandomFoo", 5, [4, 7]),
        ("random", b"payload at reference scale", 0x30, [34]),
    ],
    ids=["silent-random", "silent-first", "adv-propose", "random-adversary", "reference-scale"],
)
def test_broadcast_sweeps_match_reference(kind, proposed, seed, sizes):
    twin(_sweep, kind, proposed, seed, sizes)


def _one(side, good, adv, seed, value):
    rng = random.Random(seed)
    if value is None:
        value = bytes(rng.randrange(256) for _ in range(10_000))
    net = side.network(good, adv, _adversary(side, "random", rng), lambda ni: side.bc.Broadcast(ni, 0), rng)
    net.input(0, value)
    net.step_until(lambda: all(n.terminated() for n in net.nodes.values()))
    assert all(n.outputs == [value] for n in net.nodes.values())
    return net


def test_broadcast_equal_leaves_match_reference():
    # 32 spaces: every shard is equal, the index-bound leaf hashes must
    # still give distinct valid proofs
    twin(_one, 8, 0, 6, b" " * 32)


def test_broadcast_large_value_medium_network_match_reference():
    twin(_one, 9, 4, 7, None)


def test_non_proposer_cannot_input():
    nis = PORT.ni.NetworkInfo.generate_map(range(4), random.Random(8), mock=True, ops=PORT.ops())
    bc = PORT.bc.Broadcast(nis[1], 0)
    with pytest.raises(PORT.bc.InstanceCannotPropose):
        bc.handle_input(b"nope")
    with pytest.raises(PORT.bc.BroadcastError):
        PORT.bc.Broadcast(nis[1], 99)


def _garbage(side, seed):
    """Random garbage handled by a fresh instance: every fault names the
    sender; the garbage and the faults match the reference's."""
    rng = random.Random(seed)
    nis = side.ni.NetworkInfo.generate_map(range(4), rng, mock=True, ops=side.ops())
    out = []
    for i in range(24):
        bc = side.bc.Broadcast(nis[1], 0)
        msg = side.bc.random_message(rng, 4)
        step = bc.handle_message(2, msg)
        assert all(f.node_id == 2 for f in step.fault_log)
        out.append((msg, [f.compact() for f in step.fault_log], len(step.messages)))
    return out


def test_random_message_and_faulty_proofs_match_reference():
    twin(_garbage, 9)
