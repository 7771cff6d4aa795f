"""The port's DynamicHoneyBadger and QueueingHoneyBadger against the
reference's.

The scenarios of ``tests/test_dynamic_honey_badger.py`` and
``tests/test_queueing_honey_badger.py`` — a Remove(0) → Add(0) cycle with
votes and the on-chain DKG while transactions commit, the builders, the
vote counter, the replay/garbage fuzzer over the whole QHB stack — and
the DHB validation case of ``tests/test_adversarial.py``, each run
through the reference and the port (``ops=CudaBackend(device="cpu")``)
from one seed.  Step sequences, every ``DhbBatch`` (epoch,
contributions, change, key set) by ``dumps`` bytes and fault logs are
identical (tolerance 0).  The port's sequential churn is also held
against its vectorized era change (``harness/dynamic.py``), as the
reference's ``tests/test_dkg_vec.py`` holds its own two engines: the
same changes in order, the same committed set, the same final
validators.  The churn with real BLS is not run through
the reference (about 8 s of CPU for that side alone): ``chip_smoke.py``'s
phase 5(d) runs it on the port, on the card and on the host, and
``test_real_bls_churn_on_the_port`` runs the same driver here.
"""

import random

from torch_twin import PORT, twin


def _changes(side, node, cls):
    C = side.change
    return any(
        isinstance(b.change, C.Complete) and isinstance(b.change.change, cls) for b in node.outputs
    )


def _dhb_churn(side, seed, txs_per_node=4):
    rng = random.Random(seed)
    C, D = side.change, side.dhb
    net = side.network(
        4, 0, side.silent(rng), lambda ni: D.DynamicHoneyBadger(ni, rng=random.Random(f"dhb-{ni.our_id}")), rng,
    )
    queues = {nid: [b"tx-%d-%d" % (nid, i) for i in range(txs_per_node)] for nid in net.nodes}
    all_txs = {tx for q in queues.values() for tx in q}
    node0_pk = net.nodes[0].instance.netinfo.public_key(0)
    for nid in sorted(net.nodes):
        net.input(nid, D.ChangeInput(C.Remove(0)))

    def committed(node):
        return {tx for b in node.outputs for tx in b.tx_iter()}

    state = {"removed": False, "added": False}
    guard = 0
    while not (state["added"] and all(committed(n) >= all_txs for n in net.nodes.values())):
        guard += 1
        assert guard < 200_000, state
        if not state["removed"] and all(_changes(side, n, C.Remove) for n in net.nodes.values()):
            state["removed"] = True
            for nid in sorted(net.nodes):
                if net.nodes[nid].instance.netinfo.is_validator:
                    net.input(nid, D.ChangeInput(C.Add(0, node0_pk)))
        if not state["added"] and all(_changes(side, n, C.Add) for n in net.nodes.values()):
            state["added"] = True
        if rng.random() < 0.2 or not net.any_busy():
            nid = rng.choice(sorted(net.nodes))
            node = net.nodes[nid]
            inst = node.instance
            if inst.netinfo.is_validator and not inst.has_input():
                node.handle_input(D.UserInput([tx for tx in queues[nid] if tx not in committed(node)][:2]))
                msgs = list(node.messages)
                node.messages.clear()
                net.dispatch_messages(nid, msgs)
                continue
        if net.any_busy():
            net.step()
    plans = [b.join_plan() for b in net.nodes[1].outputs if b.join_plan() is not None]
    assert plans
    return {"net": net, "plans": plans, "era": [n.algo.start_epoch for n in net.nodes.values()]}


def test_dhb_remove_then_add_matches_reference():
    ref, port = twin(_dhb_churn, 80)
    assert min(port["era"]) > 0


def _vectorized_churn(pkg, n, seed, ops=None):
    """``tests/test_dkg_vec.py``'s ``test_matches_sequential_churn_semantics``
    cycle on one package's ``VectorizedDynamicSim``: every node votes
    ``Remove(0)``; once it completes, the validators vote ``Add(0)`` with
    node 0's key; then one more epoch.  Returns the completed changes,
    the committed transactions, the final validators and every epoch's
    outcome as ``dumps`` bytes."""
    import importlib

    Dyn = importlib.import_module(f"{pkg}.harness.dynamic")
    C = importlib.import_module(f"{pkg}.protocols.change")
    dumps = importlib.import_module(f"{pkg}.core.serialize").dumps
    sim = Dyn.VectorizedDynamicSim(n, random.Random(seed), mock=True, **({"ops": ops} if ops else {}))
    txs = {nid: [b"tx-%d-%d" % (nid, i) for i in range(2)] for nid in range(n)}
    committed, changes, epochs = set(), [], []

    def run(contribs):
        r = sim.run_epoch(contribs)
        committed.update(r.batch.tx_iter())
        epochs.append(dumps((r.batch, r.change, r.era, list(r.validators))))
        return r

    for v in range(n):
        sim.vote_for(v, C.Remove(0))
    changes.append(run(txs).change)
    assert 0 not in sim.validators
    pk = sim.pub_keys[0]
    for v in sim.validators:
        sim.vote_for(v, C.Add(0, pk))
    changes.append(run({i: txs[i] for i in sim.validators}).change)
    # common subset needs >= N - f proposers every epoch: the rest propose
    # empty contributions while node 0 catches up
    run({i: (txs[i] if i == 0 else []) for i in sim.validators})
    return changes, committed, sorted(sim.validators), epochs


def test_matches_sequential_churn_semantics():
    """The port's two engines through the same Remove(0) → Add(0) cycle
    (the reference's cross-engine gate): the sequential
    DynamicHoneyBadger network and the vectorized dynamic sim complete
    the same changes in order, commit the same transactions and end
    with the same validators; the vectorized run also equals the
    reference's ``VectorizedDynamicSim`` epoch for epoch."""
    from hbbft_tpu_torch.ops.backend_cuda import CudaBackend

    C = PORT.change
    net = _dhb_churn(PORT, 88, txs_per_node=2)["net"]
    seq_node = net.nodes[0]
    seq_changes = [b.change for b in seq_node.outputs if isinstance(b.change, C.Complete)]
    assert [type(c.change) for c in seq_changes] == [C.Remove, C.Add]
    n = len(net.nodes)
    changes, committed, validators, epochs = _vectorized_churn(
        "hbbft_tpu_torch", n, 89, ops=CudaBackend(device="cpu"))
    assert all(isinstance(c, C.Complete) for c in changes)
    assert changes[0].change == seq_changes[0].change == C.Remove(0)
    # the Add keys are per-run key material (different dealing seeds)
    assert changes[1].change.node_id == seq_changes[1].change.node_id == 0
    assert committed == _committed(seq_node)
    assert validators == sorted(seq_node.instance.netinfo.all_ids)
    ref = _vectorized_churn("hbbft_tpu", n, 89)
    assert epochs == ref[3] and committed == ref[1] and validators == ref[2]


def test_real_bls_churn_on_the_port():
    """``chip_smoke.py``'s phase 5(d) driver on the CPU, on the port's
    host route: the Remove(0) → Add(0) churn with real BLS, so DhbKeyGen
    runs over SyncKeyGen with real keys, votes and key-generation
    messages are signed and verified, and the era restarts under the
    generated keys.  The driver itself raises if the nodes disagree on a
    batch or on the key set, or if the new key shares do not sign."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    be = PORT.ops(batching=True)
    run = cs.seq_dhb_churn(be)
    assert run["eras"][0] > 0 and be.stats.flushes > 0 and be.stats.fallback_groups == 0
    assert run["epochs"] >= 2


def _join(side, seed):
    """A fresh observer joins from a change-bearing batch's JoinPlan,
    and the single-validator network of ``build_first_node`` commits."""
    run = _dhb_churn(side, seed, txs_per_node=2)
    plan = run["plans"][0]
    nis = side.ni.NetworkInfo.generate_map(range(5), random.Random(seed), mock=True, ops=side.ops())
    kw = {"ops": side.ops()}
    dhb, step = side.dhb.DynamicHoneyBadgerBuilder().rng(random.Random(2)).build_joining(
        "joiner", nis[4].secret_key, plan, **kw
    )
    solo_kw = {"ops": side.ops()} if side.is_port else {}
    solo = side.dhb.DynamicHoneyBadgerBuilder().rng(random.Random(81)).build_first_node("solo", mock=True, **solo_kw)
    solo_step = solo.handle_input(side.dhb.UserInput([b"t1"]))
    assert b"t1" in set(solo_step.output[0].tx_iter())
    return {
        "plan": plan,
        "joined": (dhb.start_epoch, dhb.netinfo.is_validator, [tm.message for tm in step.messages]),
        "solo": [side.canon(b) for b in solo_step.output],
    }


def test_join_plan_and_first_node_match_reference():
    twin(_join, 81)


def _votes(side, seed):
    C, V = side.change, side.votes
    nis = side.ni.NetworkInfo.generate_map(range(4), random.Random(seed), mock=True, ops=side.ops())
    counters = {i: V.VoteCounter(nis[i], 0) for i in range(4)}
    sv1 = counters[0].sign_vote_for(C.Remove(3))
    sv2 = counters[0].sign_vote_for(C.Remove(2))
    c = counters[1]
    out = [c.add_pending_vote(0, sv1), c.add_pending_vote(0, sv2), list(c.pending_votes())]
    svx = counters[2].sign_vote_for(C.Remove(2))
    out += [c.add_committed_vote(1, sv2), c.compute_winner(), c.add_committed_vote(1, svx), c.compute_winner()]
    forged = V.SignedVote(V.Vote(C.Remove(2), 0, 5), sv1.voter, sv1.sig)
    out.append(counters[3].add_pending_vote(1, forged))
    return [[f.compact() for f in o] if hasattr(o, "is_empty") else o for o in out]


def test_vote_counter_matches_reference():
    ref, port = twin(_votes, 82)
    assert port[4] is None and port[6] == PORT.change.Remove(2) and port[7] == ["1:INVALID_VOTE_SIGNATURE"]


def _dhb_rejects(side):
    D = side.dhb
    ni = side.ni.NetworkInfo.generate_map(range(4), random.Random(0xAD), mock=True, ops=side.ops())[0]
    assert D._message_era("garbage") is None
    assert D._message_era(D.DhbSignedVote(signed_vote="junk")) is None
    dhb = D.DynamicHoneyBadgerBuilder().build(ni)
    out = []
    for msg in (
        D.DhbSignedVote(signed_vote="junk"),
        D.DhbHoneyBadger(start_epoch="0", msg="x"),
        D.DhbKeyGen(era=True, kg_msg="x", sig=b""),
        "junk",
        D.DhbKeyGen(era=0, kg_msg=D.KgAck("x"), sig=b"bad"),
    ):
        out.append([f.compact() for f in dhb.handle_message(1, msg).fault_log])
    assert all(out)
    return out


def test_dynamic_hb_rejects_malformed_messages():
    twin(_dhb_rejects)


def _new_qhb(side):
    def build(ni):
        rng = random.Random(f"qhb-{ni.our_id}")
        dhb = side.dhb.DynamicHoneyBadger(ni, rng=rng)
        return side.qhb.QueueingHoneyBadger(dhb, batch_size=8, rng=rng)

    return build


def _drive_qhb(side, net, done, on_step=None):
    guard = 0
    while not done():
        guard += 1
        assert guard < 200_000, "QHB stalled"
        if on_step is not None:
            on_step()
            if done():
                break
        if net.any_busy():
            net.step()
            continue
        progressed = False
        for nid in sorted(net.nodes):
            node = net.nodes[nid]
            step = node.instance.propose()
            if not step.is_empty():
                node._absorb(step)
                msgs = list(node.messages)
                node.messages.clear()
                net.dispatch_messages(nid, msgs)
                progressed = True
        assert progressed or net.any_busy(), "network wedged"


def _committed(node):
    return {tx for b in node.outputs for tx in b.tx_iter()}


def _qhb_churn(side, seed, txs=8):
    rng = random.Random(seed)
    C, D = side.change, side.dhb
    net = side.network(4, 0, side.silent(rng), _new_qhb(side), rng)
    first = [b"tx-a-%d" % i for i in range(txs)]
    second = [b"tx-b-%d" % i for i in range(txs)]
    node0_pk = net.nodes[0].instance.dyn_hb.netinfo.public_key(0)
    for nid in sorted(net.nodes):
        for tx in first:
            net.input(nid, tx)
    for nid in sorted(net.nodes):
        net.input(nid, D.ChangeInput(C.Remove(0)))
    state = {"removed": False, "added": False}

    def on_step():
        if not state["removed"] and all(_changes(side, n, C.Remove) for n in net.nodes.values()):
            state["removed"] = True
            for nid in sorted(net.nodes):
                if net.nodes[nid].instance.dyn_hb.netinfo.is_validator:
                    for tx in second:
                        net.input(nid, tx)
                    net.input(nid, D.ChangeInput(C.Add(0, node0_pk)))
        if not state["added"] and all(_changes(side, n, C.Add) for n in net.nodes.values()):
            state["added"] = True

    _drive_qhb(
        side, net,
        lambda: state["added"] and all(_committed(n) >= set(first) | set(second) for n in net.nodes.values()),
        on_step,
    )
    return net


def test_qhb_txs_and_churn_match_reference():
    twin(_qhb_churn, 90)


def _qhb_auto(side, seed):
    rng = random.Random(seed)
    net = side.network(4, 0, side.silent(rng), _new_qhb(side), rng)
    txs = [b"solo-%d" % i for i in range(4)]
    for nid in sorted(net.nodes):
        for tx in txs:
            net.input(nid, tx)
    net.step_until(lambda: all(_committed(n) >= set(txs) for n in net.nodes.values()), max_steps=100_000)
    qhb, step = side.qhb.QueueingHoneyBadger.builder(
        side.dhb.DynamicHoneyBadger(net.nodes[1].algo.dyn_hb.netinfo, rng=random.Random(3))
    ).batch_size(4).rng(random.Random(4)).build_with_transactions([b"b1", b"b2"])
    return {"net": net, "built": [tm.message for tm in step.messages]}


def test_qhb_builder_and_auto_propose_match_reference():
    twin(_qhb_auto, 91)


def _qhb_fuzz(side, seed):
    rng = random.Random(seed)
    A, B, H, D = side.ag, side.bc, side.hb, side.dhb
    T = side.step

    def garbage():
        pid = rng.randrange(4)
        if rng.randrange(2):
            inner = side.cs.CsBroadcast(pid, B.random_message(rng, 4))
        else:
            inner = side.cs.CsAgreement(pid, A.random_message(rng))
        msg = D.DhbHoneyBadger(0, H.HoneyBadgerMessage(rng.randrange(3), H.HbCommonSubset(inner)))
        target = T.Target.all() if rng.randrange(2) else T.Target.to(rng.randrange(4))
        return T.TargetedMessage(target, msg)

    net = side.network(3, 1, lambda adv: side.net.RandomAdversary(0.2, 0.4, garbage, rng), _new_qhb(side), rng)
    txs = [b"fuzz-%d" % i for i in range(6)]
    for nid in sorted(net.nodes):
        for tx in txs:
            net.input(nid, tx)
    _drive_qhb(side, net, lambda: all(_committed(n) >= set(txs) for n in net.nodes.values()))
    return net


def test_qhb_random_adversary_fuzz_matches_reference():
    ref, port = twin(_qhb_fuzz, 95)
    assert any(n.faults for n in port.nodes.values())
