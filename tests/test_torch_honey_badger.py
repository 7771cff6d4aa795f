"""The port's sequential HoneyBadger against the reference's.

The scenarios of ``tests/test_honey_badger.py`` (silent sizes, the
first-delivery scheduler, forged decryption shares, real BLS, the
arrival-order cases), ``tests/test_batching.py``'s
``test_honey_badger_batched_*``, the HoneyBadger validation cases of
``tests/test_adversarial.py`` and the options the port carries over
(speculative combine, ``reveal_mode="ordered"`` with
``max_outstanding_reveals``, ``fast_forward``, ``gc_epochs``), each run
through the reference and the port (``ops=CudaBackend(device="cpu")`` or
``BatchingBackend`` over it) from one seed.  Step sequences, outputs by
``dumps`` bytes and fault logs are identical (tolerance 0); so are the
batching layer's flushes (``crypto_obligations`` at enqueue), obligation
for obligation, and its counters.  The port's sequential engine also
gives the first batch of the port's ``VectorizedHoneyBadgerSim``, as
``tests/test_epoch_vec.py`` checks for the reference.
"""

import pickle
import random

import pytest
import torch

from torch_twin import PORT, twin

torch.set_num_threads(1)


def _faulty_share_adversary(side, scheduler, rng, num_epochs=2):
    """Well-formed but wrong mock decryption shares for every proposer
    in early epochs (reference ``tests/honey_badger.rs:38-124``)."""
    N, H = side.net, side.hb

    class FaultyShareAdversary(N.Adversary):
        def __init__(self):
            self.adv_ids, self.all_ids, self.sent = [], [], False

        def init(self, all_nodes, adv_netinfos):
            self.adv_ids, self.all_ids = sorted(adv_netinfos), sorted(all_nodes)

        def pick_node(self, nodes):
            return scheduler.pick_node(nodes)

        def push_message(self, sender_id, tm):
            pass

        def step(self):
            if self.sent or not self.adv_ids:
                return []
            self.sent = True
            out = []
            for adv_id in self.adv_ids:
                for epoch in range(num_epochs):
                    for proposer in self.all_ids:
                        bogus = side.mock.MockDecryptionShare(
                            rng.randrange(2**256).to_bytes(32, "big"),
                            rng.randrange(2**256).to_bytes(32, "big"),
                        )
                        msg = H.HoneyBadgerMessage(epoch, H.HbDecryptionShare(proposer, bogus))
                        out.append(N.MessageWithSender(adv_id, side.step.Target.all().message(msg)))
            return out

    return FaultyShareAdversary()


def _run_hb(
    side, seed, size, txs_per_node=6, batch_contrib=2, adversary="random",
    mock=True, batching=False, hb_kw=None, record_flushes=False,
):
    """``tests/test_honey_badger.py``'s ``run_honey_badger``: random
    interleaving of proposals and steps until every transaction is
    committed at every node."""
    rng = random.Random(seed)
    f = (size - 1) // 3
    S = side.net.MessageScheduler
    if adversary == "faulty-shares":
        factory = lambda adv: _faulty_share_adversary(side, S(S.RANDOM, rng), rng)
    else:
        factory = side.silent(rng, adversary)
    ops = side.ops(batching=batching)
    flushes = []
    if record_flushes:
        inner_prefetch = ops.prefetch

        def prefetch(obs):
            obs = list(obs)
            flushes.append([_ob_bytes(ob) for ob in obs])
            inner_prefetch(obs)

        ops.prefetch = prefetch
    hb_kw = hb_kw or {}
    net = side.network(
        size - f, f, factory,
        lambda ni: side.hb.HoneyBadger(ni, rng=random.Random(f"{ni.our_id}-0"), **hb_kw),
        rng, mock_crypto=mock, ops=ops,
    )
    queues = {nid: [b"tx-%d-%d" % (nid, i) for i in range(txs_per_node)] for nid in net.nodes}
    all_txs = {tx for q in queues.values() for tx in q}

    def committed(node):
        return {tx for b in node.outputs if isinstance(b, side.hb.Batch) for tx in b.tx_iter()}

    guard = 0
    while not all(committed(n) >= all_txs for n in net.nodes.values()):
        guard += 1
        assert guard < 100_000, "HoneyBadger failed to commit all txs"
        if rng.random() < 0.1 or not net.any_busy():
            nid = rng.choice(sorted(net.nodes))
            node = net.nodes[nid]
            if not node.instance.has_input():
                contrib = [tx for tx in queues[nid] if tx not in committed(node)][:batch_contrib]
                node.handle_input(contrib)
                msgs = list(node.messages)
                node.messages.clear()
                net.dispatch_messages(nid, msgs)
                continue
        if net.any_busy():
            net.step()
    seqs = [[side.canon(b) for b in n.outputs] for n in net.nodes.values()]
    k = min(len(s) for s in seqs)
    assert k > 0 and all(s[:k] == seqs[0][:k] for s in seqs)
    out = {"net": net}
    if batching:
        st = ops.stats
        out["stats"] = [st.prefetched, st.flushes, st.cache_hits, st.cache_misses,
                        st.fallback_groups, st.fallback_items]
    if record_flushes:
        out["flushes"] = flushes
    return out


def _ob_bytes(ob):
    if type(ob).__name__ == "SigObligation":
        return (b"s", ob.pk_share.to_bytes(), ob.share.to_bytes(), ob.msg)
    return (b"d", ob.pk_share.to_bytes(), ob.share.to_bytes(), ob.ciphertext.to_bytes())


@pytest.mark.parametrize("size", [1, 2, 4, 7])
def test_silent_sizes_match_reference(size):
    twin(_run_hb, 40 + size, size, txs_per_node=4)


def test_first_scheduler_matches_reference():
    twin(_run_hb, 41, 4, adversary="first")


def test_faulty_shares_match_reference():
    ref, port = twin(_run_hb, 42, 7, adversary="faulty-shares")
    flagged = {f.node_id for n in port["net"].nodes.values() for f in n.faults}
    assert flagged and flagged <= {5, 6}, flagged


def test_real_bls_matches_reference():
    twin(_run_hb, 43, 4, txs_per_node=2, mock=False)


def test_speculative_combine_matches_reference():
    ref, port = twin(_run_hb, 44, 7, adversary="faulty-shares", hb_kw={"speculative": True})
    assert any(n.faults for n in port["net"].nodes.values())


@pytest.mark.parametrize("outstanding", [1, 3])
def test_ordered_reveal_matches_reference(outstanding):
    ref, port = twin(
        _run_hb, 45, 4, txs_per_node=6,
        hb_kw={"reveal_mode": "ordered", "max_outstanding_reveals": outstanding},
    )
    kinds = {type(o).__name__ for o in port["net"].nodes[0].outputs}
    assert kinds == {"OrderedBatch", "Batch"}


def test_batched_mock_matches_reference_and_unbatched():
    ref, port = twin(_run_hb, 77, 7, txs_per_node=3, batching=True, record_flushes=True)
    prefetched, flushes, hits = port["stats"][:3]
    assert prefetched > 0 and hits > 0 and 0 < flushes <= len([f for f in port["flushes"] if f])
    plain = _run_hb(PORT, 77, 7, txs_per_node=3)
    assert PORT.outcome(plain["net"]) == PORT.outcome(port["net"])


def test_batched_real_bls_matches_reference():
    """Real BLS, N = 4, under the batching façade: the same flushes
    (each obligation by its bytes), the same counters and the same
    batches as the reference's, and none of them fell back."""
    ref, port = twin(
        _run_hb, 43, 4, txs_per_node=2, mock=False, batching=True, record_flushes=True
    )
    stats = port["stats"]
    assert stats[0] > 0 and stats[2] > 0 and stats[4:] == [0, 0]
    assert sum(len(f) for f in port["flushes"]) >= stats[0]


def _obligations(side):
    """``crypto_obligations`` on crafted real-BLS messages at each layer
    of the nesting: a coin share at a bare ``CommonCoin``, a coin share
    inside HB → CS → Agreement, a decryption share with and without a
    known ciphertext, wrapped by DHB, and garbage."""
    B, H, A, C = side.batching, side.hb, side.ag, side.coin
    nis = side.ni.NetworkInfo.generate_map(range(4), random.Random(46), mock=False, ops=side.ops())
    ni = nis[0]
    nonce = C.make_nonce(ni.invocation_id(), 3, 1, 2)
    share = nis[2].secret_key_share.sign(nonce)
    coin = C.CommonCoin(ni, nonce)
    hb = H.HoneyBadger(ni, rng=random.Random(1))
    ct = ni.public_key_set.public_key().encrypt(b"secret", random.Random(2))
    hb.ciphertexts[0] = {1: ct}
    dec = nis[2].secret_key_share.decrypt_share_no_verify(ct)
    coin_in_hb = H.HoneyBadgerMessage(
        3, H.HbCommonSubset(side.cs.CsAgreement(1, A.AgreementMessage(2, A.CoinContent(C.CommonCoinMessage(share)))))
    )
    dhb = side.dhb.DynamicHoneyBadger(ni, rng=random.Random(3))
    dhb.honey_badger = hb
    cases = [
        (coin, 2, C.CommonCoinMessage(share)),
        (hb, 2, coin_in_hb),
        (hb, 2, H.HoneyBadgerMessage(0, H.HbDecryptionShare(1, dec))),
        (hb, 2, H.HoneyBadgerMessage(1, H.HbDecryptionShare(1, dec))),
        (dhb, 2, side.dhb.DhbHoneyBadger(0, H.HoneyBadgerMessage(0, H.HbDecryptionShare(1, dec)))),
        (hb, "ghost", H.HoneyBadgerMessage(0, H.HbDecryptionShare(1, dec))),
        (hb, 2, "garbage"),
        (hb, 2, H.HoneyBadgerMessage(3, H.HbCommonSubset(side.cs.CsAgreement([1], "x")))),
    ]
    return [[_ob_bytes(ob) for ob in B.crypto_obligations(algo, sender, msg)] for algo, sender, msg in cases]


def test_crypto_obligations_match_reference():
    ref, port = twin(_obligations)
    assert [len(o) for o in ref] == [1, 1, 1, 0, 1, 0, 0, 0]


def test_arrival_order_of_share_faults():
    nis = PORT.ni.NetworkInfo.generate_map(range(4), random.Random(0x5EED), mock=True, ops=PORT.ops())
    runs = []
    for order in ([0, 1, 2, 3], [2, 0, 3, 1]):
        hb = PORT.hb.HoneyBadger(nis[0])
        hb.received_shares[0] = {1: {sid: b"bogus" for sid in order}}
        incorrect, faults = hb._verify_pending_decryption_shares(1, b"ciphertext", 0)
        assert incorrect == {0, 1, 2, 3}
        runs.append([f.node_id for f in faults])
    assert runs[0] == runs[1] == [0, 1, 2, 3]


def _rejects(side):
    H = side.hb
    ni = side.ni.NetworkInfo.generate_map(range(4), random.Random(0xAD), mock=True, ops=side.ops())[0]
    out = []
    hb = H.HoneyBadger(ni)
    for bad_epoch in ("7", None, True, 1.5, [2]):
        out.append([f.compact() for f in hb.handle_message(1, H.HoneyBadgerMessage(bad_epoch, "x")).fault_log])
    for proposer in ([1, 2], {}, "ghost", 99):
        out.append([f.compact() for f in hb.handle_message(
            1, H.HoneyBadgerMessage(0, H.HbDecryptionShare(proposer, b"s"))).fault_log])
    out.append([f.compact() for f in hb.handle_message(1, "junk").fault_log])
    with pytest.raises(side.algorithm.UnknownSenderError):
        hb.handle_message("ghost", H.HoneyBadgerMessage(0, "x"))
    # a flood of far-future messages: dropped, the sender attributed every 32nd
    for _ in range(64):
        out.append([f.compact() for f in hb.handle_message(2, H.HoneyBadgerMessage(500, "x")).fault_log])
    assert all(o for o in out[:10])
    return out


def test_honey_badger_rejects_malformed_messages():
    ref, port = twin(_rejects)
    assert port[-1] == ["2:EPOCH_OUT_OF_RANGE"]


def _fast_forward_and_gc(side):
    """Batches from a finished run installed into fresh instances by
    ``fast_forward``; ``gc_epochs`` on the finished ones."""
    run = _run_hb(side, 47, 4, txs_per_node=4)["net"]
    batches = [b for b in run.nodes[0].outputs if isinstance(b, side.hb.Batch)]
    nis = side.ni.NetworkInfo.generate_map(range(4), random.Random(48), mock=True, ops=side.ops())
    fresh = side.hb.HoneyBadger(nis[1], rng=random.Random(4))
    step = fresh.fast_forward(batches[-1].epoch, batches)
    again = fresh.fast_forward(0, batches)
    dropped = [n.algo.gc_epochs() for n in run.nodes.values()]
    return {
        "run": run,
        "forwarded": step.output,
        "epoch": fresh.epoch,
        "again": (again.output, fresh.epoch),
        "dropped": dropped,
    }


def test_fast_forward_and_gc_match_reference():
    ref, port = twin(_fast_forward_and_gc)
    assert port["epoch"] > 1


def test_left_out_options_raise_type_error():
    ni = PORT.ni.NetworkInfo.generate_map(range(4), random.Random(1), mock=True, ops=PORT.ops())[0]
    # the reference reads reveal_mode=None from HBBFT_TPU_ORDERED_COMMIT
    with pytest.raises(TypeError):
        PORT.hb.HoneyBadger(ni, reveal_mode=None)
    with pytest.raises(TypeError):
        PORT.hb.HoneyBadgerBuilder(ni).reveal_mode(None).build()
    with pytest.raises(ValueError):
        PORT.hb.HoneyBadger(ni, reveal_mode="eager")
    assert PORT.hb.HoneyBadgerBuilder(ni).build().reveal_mode == "inline"
    assert PORT.hb.HoneyBadgerBuilder(ni).ordered().build().reveal_mode == "ordered"
    net = PORT.network(4, 0, PORT.silent(random.Random(2)), lambda n: PORT.hb.HoneyBadger(n), random.Random(3))
    with pytest.raises(TypeError):
        pickle.dumps(net)  # checkpointing is not part of the port


# ---------------------------------------------------------------------------
# The sequential engine against the port's vectorized epoch
# ---------------------------------------------------------------------------


def _sequential_first_batch(seed, size, n_dead, contributions, mock=True):
    """``tests/test_epoch_vec.py``'s ``sequential_first_batch`` on the
    port: every live node proposes up front; the first batch (identical
    at every correct node)."""
    rng = random.Random(seed)
    net = PORT.network(
        size - n_dead, n_dead, PORT.silent(rng),
        lambda ni: PORT.hb.HoneyBadger(ni, rng=random.Random(f"{ni.our_id}-seq")),
        rng, mock_crypto=mock,
    )
    for nid in sorted(net.nodes):
        net.input(nid, contributions[nid])
    while not all(n.outputs for n in net.nodes.values()):
        assert net.any_busy(), "sequential run stalled"
        net.step()
    first = net.nodes[0].outputs[0]
    assert all(n.outputs[0] == first for n in net.nodes.values())
    return first


@pytest.mark.parametrize(
    "n,dead,mock", [(7, (), True), (10, (7, 8, 9), True), (4, (), False)],
    ids=["all-live", "f-dead", "real-bls"],
)
def test_sequential_matches_vectorized_epoch(n, dead, mock):
    from hbbft_tpu_torch.harness.epoch import VectorizedHoneyBadgerSim

    contributions = {i: [b"c%d" % i] for i in range(n)}
    seq = _sequential_first_batch(71, n, len(dead), contributions, mock=mock)
    sim = VectorizedHoneyBadgerSim(n, random.Random(72), mock=mock, ops=PORT.ops())
    vec = sim.run_epoch({i: c for i, c in contributions.items() if i not in dead}, dead=set(dead))
    assert vec.batch.epoch == seq.epoch == 0
    assert PORT.ser.dumps(vec.batch) == PORT.ser.dumps(seq)
    assert set(vec.accepted) == set(range(n)) - set(dead)


def test_forged_real_share_on_a_forced_flush():
    """``chip_smoke.py``'s phase 5(c) driver on the CPU: a forged real
    decryption share checked in a flush whose G1 MSMs take the card's
    route at any size (the plain versions here) and on the host: the
    same fault, the same batch, and the forced flush falls back."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    from hbbft_tpu_torch.harness.batching import BatchingBackend
    from hbbft_tpu_torch.ops.backend_cuda import CudaBackend

    runs = []
    for force in (True, False):
        inner = CudaBackend(device="cpu")
        be = BatchingBackend(inner=cs.forced(inner) if force else inner)
        runs.append((cs.seq_forged_share(be), be.stats))
    (batch, faults, forger), stats = runs[0]
    assert runs[1][0] == (batch, faults, forger)
    assert {f for fs in faults.values() for f in fs} == {f"{forger!r}:INVALID_DECRYPTION_SHARE"}
    assert stats.fallback_groups == runs[1][1].fallback_groups == 1
    assert CudaBackend.G1_PRODUCT_DEVICE_MIN == CudaBackend.G1_DEVICE_MIN == 1 << 12
