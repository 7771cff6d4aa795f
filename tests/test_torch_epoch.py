"""The slice as a whole: full HoneyBadger epochs in the port.

The same seed goes through the reference's ``VectorizedHoneyBadgerSim``
(``hbbft_tpu/harness/epoch.py``, on its CPU backend) and the port's
(``hbbft_tpu_torch/harness/epoch.py``) on the CPU:
``ops=CudaBackend(device="cpu")`` runs the card's route with every kernel's plain version, and the small
flushes of these sizes stay on the host by the backend's size rules
unless a test lowers them.  Tolerance is 0 throughout: batches compare
by their ``dumps`` bytes, fault logs entry by entry, and every counter
exactly.  Also here: the decryption side of the key set (batched and
speculative Lagrange combines), the key dealing, the validator set
carried across by ``state.py``, and the divergent view-class schedules
on ``tests/test_epoch_vec.py``'s ``TestDivergentViews`` and
``TestMultiEpochDivergence`` inputs (both packages' vectorized
agreements and epochs, and both packages' sequential ``TestNetwork``
runs of the same partition schedule).
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from hbbft_tpu.core.network_info import NetworkInfo as RNI
from hbbft_tpu.core.serialize import dumps as rdumps
from hbbft_tpu.crypto import mock as RM
from hbbft_tpu.crypto import threshold as RT
from hbbft_tpu.harness import epoch as RE_MOD
from hbbft_tpu.harness.epoch import VectorizedHoneyBadgerSim as RSim
from hbbft_tpu.harness.epoch import VectorizedQueueingSim as RQSim
from hbbft_tpu_torch import native as PN
from hbbft_tpu_torch import state
from hbbft_tpu_torch.core.network_info import NetworkInfo as PNI
from hbbft_tpu_torch.core.serialize import dumps as pdumps
from hbbft_tpu_torch.crypto import mock as PM
from hbbft_tpu_torch.crypto import threshold as PT
from hbbft_tpu_torch.crypto.backend import CpuBackend
from hbbft_tpu_torch.harness import epoch as PE_MOD
from hbbft_tpu_torch.harness.epoch import VectorizedHoneyBadgerSim as PSim
from hbbft_tpu_torch.harness.epoch import VectorizedQueueingSim as PQSim
from hbbft_tpu_torch.ops import cuda_ec
from hbbft_tpu_torch.ops.backend_cuda import CudaBackend
from torch_twin import twin

torch.set_num_threads(1)


def _faults(log):
    return [(f.node_id, f.kind.name) for f in log]


def _assert_same(ref, port):
    """One epoch's outcome, reference against port, byte for byte."""
    assert (ref.batch is None) == (port.batch is None)
    if ref.batch is not None:
        assert pdumps(port.batch) == rdumps(ref.batch)
    assert port.accepted == ref.accepted
    assert _faults(port.fault_log) == _faults(ref.fault_log)
    assert port.coin_flips == ref.coin_flips
    assert port.shares_verified == ref.shares_verified
    assert port.agreement_epochs == ref.agreement_epochs
    if ref.observer_batch is not None:
        assert pdumps(port.observer_batch) == rdumps(ref.observer_batch)


def _contribs(n, tag=b"c"):
    return {i: [tag + b"-%d" % i] for i in range(n)}


def _pair(n, seed, mock, **kw):
    return (
        RSim(n, random.Random(seed), mock=mock, **kw),
        PSim(n, random.Random(seed), mock=mock, ops=CudaBackend(device="cpu"), **kw),
    )


# ---------------------------------------------------------------------------
# The decryption side of the key set
# ---------------------------------------------------------------------------


def _dealt(n, seed, mock=False):
    """The same key set dealt in both packages from one seed."""
    return (
        RNI.generate_map(range(n), random.Random(seed), mock=mock),
        PNI.generate_map(range(n), random.Random(seed), mock=mock, ops=CpuBackend()),
    )


def _combine_rows(nets, n_cts, seed, drop=None):
    """Decryption-share rows of every node for ``n_cts`` ciphertexts,
    the same in both packages.  ``drop``: (row, index) removed, so that
    row's lowest-(t+1) subset differs from the rest."""
    (rn, pn) = nets
    rng_r, rng_p = random.Random(seed), random.Random(seed)
    r_pk, p_pk = rn[0].public_key_set, pn[0].public_key_set
    rows = {"r": [], "p": []}
    cts = {"r": [], "p": []}
    for c in range(n_cts):
        msg = b"row-%d" % c
        rct = r_pk.public_key().encrypt(msg, rng_r)
        pct = p_pk.public_key().encrypt(msg, rng_p)
        assert pdumps(pct) == rdumps(rct)
        rrow = {rn[i].node_index(i): rn[i].secret_key_share.decrypt_share_no_verify(rct) for i in rn}
        prow = {pn[i].node_index(i): pn[i].secret_key_share.decrypt_share_no_verify(pct) for i in pn}
        if drop is not None and drop[0] == c:
            rrow.pop(drop[1])
            prow.pop(drop[1])
        rows["r"].append(rrow)
        rows["p"].append(prow)
        cts["r"].append(rct)
        cts["p"].append(pct)
    return rows, cts


def test_combine_decryption_shares_many_matches_reference_on_the_native_route(monkeypatch):
    nets = _dealt(7, 0xC0B)
    rows, cts = _combine_rows(nets, 6, 1, drop=(2, 0))
    calls = []
    many = PN.g1_msm_many_raw
    monkeypatch.setattr(PN, "g1_msm_many_raw", lambda *a: calls.append(a[0]) or many(*a))
    want = nets[0][0].public_key_set.combine_decryption_shares_many(rows["r"], cts["r"])
    got = nets[1][0].public_key_set.combine_decryption_shares_many(rows["p"], cts["p"])
    assert got == want
    assert want == [b"row-%d" % c for c in range(6)]
    # five rows share one subset: one native many-MSM over them; the row
    # with a different subset takes the per-row path
    assert calls == [5]
    one = nets[1][0].public_key_set.combine_decryption_shares(rows["p"][2], cts["p"][2])
    assert one == want[2]


def test_combine_and_check_many_rejects_exactly_the_bad_row():
    nets = _dealt(7, 0xC0C)
    rows, cts = _combine_rows(nets, 5, 2)
    rn, pn = nets
    bad = 3
    idx = sorted(rows["r"][bad])[0]
    rows["r"][bad][idx] = RT.DecryptionShare(rows["r"][bad][idx].point * 5)
    rows["p"][bad][idx] = PT.DecryptionShare(rows["p"][bad][idx].point * 5)
    want = rn[0].public_key_set.combine_and_check_decryption_shares_many(rows["r"], cts["r"])
    got = pn[0].public_key_set.combine_and_check_decryption_shares_many(rows["p"], cts["p"])
    assert got == want
    assert [w is None for w in want] == [i == bad for i in range(5)]


@pytest.mark.parametrize("n,mock", [(4, False), (7, True)], ids=["real4", "mock7"])
def test_generate_map_deals_the_reference_keys(n, mock):
    rn, pn = _dealt(n, 0xD1 + n, mock)
    for nid in range(n):
        r, p = rn[nid], pn[nid]
        assert pdumps(p.secret_key_share) == rdumps(r.secret_key_share)
        assert pdumps(p.secret_key) == rdumps(r.secret_key)
        assert pdumps(p.public_key_share(nid)) == rdumps(r.public_key_share(nid))
        assert pdumps(p.public_key(nid)) == rdumps(r.public_key(nid))
    assert pdumps(pn[0].public_key_set) == rdumps(rn[0].public_key_set)
    assert pn[0].invocation_id() == rn[0].invocation_id()


def test_precompute_shares_matches_the_reference_key_shares():
    rn, pn = _dealt(10, 0xE5)
    pk = pn[0].public_key_set
    fresh = PT.PublicKeySet(pk.commitment, pk.master_g1)  # an empty share cache
    fresh.precompute_shares(10)  # the native forward-difference range
    for i in range(10):
        assert pdumps(fresh.public_key_share(i)) == rdumps(rn[i].public_key_share(i))


# ---------------------------------------------------------------------------
# Epoch parity
# ---------------------------------------------------------------------------


def test_real_bls_two_epochs():
    ref, port = _pair(4, 0x4E, mock=False)
    for e in range(2):
        c = _contribs(4, b"real%d" % e)
        r, p = ref.run_epoch(c), port.run_epoch(c)
        _assert_same(r, p)
        assert p.batch.contributions == c and p.shares_verified == 16
        assert sorted(p.phases) == sorted(r.phases)


def test_mock_dead_corrupt_shards_and_forged_decryption_shares():
    ref, port = _pair(7, 0x7D, mock=True)
    kw = dict(dead={4}, corrupt_shards={0: {5: b"\xff\x00"}})
    r = ref.run_epoch(
        _contribs(7), forged_dec={6: {p: RM.MockDecryptionShare(b"\0" * 32, b"\1" * 32) for p in range(4)}}, **kw
    )
    p = port.run_epoch(
        _contribs(7), forged_dec={6: {p: PM.MockDecryptionShare(b"\0" * 32, b"\1" * 32) for p in range(4)}}, **kw
    )
    _assert_same(r, p)
    assert {f[0] for f in _faults(p.fault_log)} == {5, 6}


def test_mock_late_and_late_subset():
    ref, port = _pair(13, 0x13, mock=True)
    kw = dict(dead={12}, late={2, 9}, late_subset={4: {0, 1, 2, 3}})
    _assert_same(ref.run_epoch(_contribs(13), **kw), port.run_epoch(_contribs(13), **kw))
    kw = dict(late_subset={1: set(range(9))})
    _assert_same(ref.run_epoch(_contribs(13), **kw), port.run_epoch(_contribs(13), **kw))


def test_kitchen_sink_adversarial_epoch():
    """Every adversarial surface at once (the reference's
    ``test_kitchen_sink_adversarial_epoch`` inputs): n = 25, f = 8,
    silent nodes, late proposers, a corrupted echo shard, forged
    decryption shares, Byzantine BVal/Aux votes and the observer."""
    ref, port = _pair(25, 130, mock=True)
    kw = dict(
        dead={21, 22, 23, 24},
        late={3, 17},
        corrupt_shards={0: {5: b"\xff\x00"}},
        adv_bval={1: (3, 0)},
        adv_aux={1: (3, 0)},
        observe=True,
    )
    c = {i: [b"ks-%02d" % i] for i in range(25)}
    r = ref.run_epoch(
        c, forged_dec={20: {q: RM.MockDecryptionShare(b"\0" * 32, b"\3" * 32) for q in range(4)}}, **kw
    )
    p = port.run_epoch(
        c, forged_dec={20: {q: PM.MockDecryptionShare(b"\0" * 32, b"\3" * 32) for q in range(4)}}, **kw
    )
    _assert_same(r, p)
    assert pdumps(p.observer_batch) == pdumps(p.batch)


def test_forged_coin_on_real_bls():
    # a split broadcast (late_subset) drives instance 0 to the real coin
    ref, port = _pair(4, 0xF06, mock=False)
    kw = dict(late_subset={0: {0, 1}}, forged_coin={3})
    r, p = ref.run_epoch(_contribs(4), **kw), port.run_epoch(_contribs(4), **kw)
    _assert_same(r, p)
    assert p.coin_flips > 0
    assert ("INVALID_SIGNATURE_SHARE" in {k for _, k in _faults(p.fault_log)})
    assert port.be.stats.fallback_groups == ref.be.stats.fallback_groups > 0


def test_observer_lane_real_bls():
    ref, port = _pair(4, 0x0B5, mock=False, verify_honest=False)
    r = ref.run_epoch(_contribs(4), observe=True)
    p = port.run_epoch(_contribs(4), observe=True)
    _assert_same(r, p)
    assert p.observer_batch is not None


@pytest.mark.parametrize("mock", [True, False], ids=["mock", "real"])
def test_ordered_reveal_matches_reference_and_inline(mock):
    n = 7 if mock else 4
    seqs = [_contribs(n, b"o%d" % e) for e in range(3)]
    ref, port = _pair(n, 0x0D, mock, reveal_mode="ordered", max_outstanding_reveals=2)
    rr = ref.run_epochs(seqs, pipeline=False, dead={1})
    pp = port.run_epochs(seqs, pipeline=False, dead={1})
    inline = PSim(n, random.Random(0x0D), mock=mock, ops=CudaBackend(device="cpu"))
    ii = inline.run_epochs(seqs, pipeline=False, dead={1})
    for r, p, i in zip(rr, pp, ii):
        _assert_same(r, p)
        assert pdumps(p.batch) == pdumps(i.batch)
        assert _faults(p.fault_log) == _faults(i.fault_log)


@pytest.mark.parametrize("mock", [True, False], ids=["mock", "real"])
def test_speculative_decryption(mock):
    n = 7 if mock else 4
    ref, port = _pair(n, 0x5C, mock, speculative=True)
    if mock:
        fr = {5: {0: RM.MockDecryptionShare(b"\0" * 32, b"\2" * 32)}}
        fp = {5: {0: PM.MockDecryptionShare(b"\0" * 32, b"\2" * 32)}}
    else:
        fr = fp = None
    r = ref.run_epoch(_contribs(n), forged_dec=fr)
    p = port.run_epoch(_contribs(n), forged_dec=fp)
    _assert_same(r, p)
    assert p.phases["spec_hits"] == r.phases["spec_hits"] > 0
    assert p.phases["spec_misses"] == r.phases["spec_misses"]


@pytest.mark.parametrize("mock", [True, False], ids=["mock", "real"])
def test_pipelined_epochs_match_sequential(mock):
    n = 7 if mock else 4
    seqs = [_contribs(n, b"p%d" % e) for e in range(3)]
    ref = RSim(n, random.Random(0x919), mock=mock)
    seq_port = PSim(n, random.Random(0x919), mock=mock, ops=CudaBackend(device="cpu"))
    pipe_port = PSim(n, random.Random(0x919), mock=mock, ops=CudaBackend(device="cpu"))
    rr = ref.run_epochs(seqs, dead={2}, pipeline=True)
    ss = seq_port.run_epochs(seqs, dead={2}, pipeline=False)
    pp = pipe_port.run_epochs(seqs, dead={2}, pipeline=True)
    for r, s, p in zip(rr, ss, pp):
        _assert_same(r, p)
        _assert_same(r, s)
    with pytest.raises(ValueError, match="deep"):
        pipe_port.run_epochs(seqs, pipeline="deep")


def test_queueing_sim_three_epochs():
    r = RQSim(7, random.Random(80), batch_size=8, mock=True)
    p = PQSim(7, random.Random(80), batch_size=8, mock=True, ops=CudaBackend(device="cpu"))
    txs = [b"qtx-%d" % i for i in range(24)]
    r.input_all(txs)
    p.input_all(txs)
    for _ in range(3):
        _assert_same(r.run_epoch(dead={6}), p.run_epoch(dead={6}))
        assert [list(q.queue) for q in p.queues.values()] == [
            list(q.queue) for q in r.queues.values()
        ]


def test_from_netinfos_over_the_reference_keys():
    rn = RNI.generate_map(range(4), random.Random(0xCA))
    arrays = state.validator_set_arrays(rn)
    pn = state.netinfos_from_arrays(arrays, ops=CudaBackend(device="cpu"))
    ref = RSim.from_netinfos(rn, random.Random(0xCB))
    port = PSim.from_netinfos(pn, random.Random(0xCB))
    for e in range(2):
        c = _contribs(4, b"k%d" % e)
        _assert_same(ref.run_epoch(c), port.run_epoch(c))


def test_unported_options_are_refused():
    """What the port still leaves out raises: ``pipeline="deep"``.  The
    divergent schedules are ported; passing both at once is the
    reference's ``ValueError``."""
    ref, sim = _pair(4, 1, mock=True)
    with pytest.raises(ValueError):
        sim.run_epochs([_contribs(4)] * 2, pipeline="deep")
    both = dict(divergent=object(), div_schedule=object())
    with pytest.raises(ValueError, match="mutually exclusive"):
        ref.run_epoch(_contribs(4), **both)
    with pytest.raises(ValueError, match="mutually exclusive"):
        sim.run_epoch(_contribs(4), **both)


# ---------------------------------------------------------------------------
# The card's route on the CPU, and no fallback
# ---------------------------------------------------------------------------


def _device_route_sim(seed):
    ops = CudaBackend(device="cpu")
    ops.G1_PRODUCT_DEVICE_MIN = 1  # the flush's product MSM takes the device path
    nets = PNI.generate_map(range(4), random.Random(seed), ops=ops)
    return PSim.from_netinfos(nets, random.Random(seed + 1))


def test_card_route_on_the_cpu_gives_the_reference_batch(monkeypatch):
    rn = RNI.generate_map(range(4), random.Random(0xCD))
    ref = RSim.from_netinfos(rn, random.Random(0xCD + 1))
    port = _device_route_sim(0xCD)
    plain = []
    windowed = cuda_ec.windowed_plain
    monkeypatch.setattr(
        cuda_ec, "windowed_plain", lambda pts, d: plain.append(pts.shape[0]) or windowed(pts, d)
    )
    before = cuda_ec.LAUNCHES["win_g1"]
    c = _contribs(4, b"dev")
    r, p = ref.run_epoch(c), port.run_epoch(c)
    _assert_same(r, p)
    assert plain == [16]  # the epoch's 4 × 4 shares, one plain windowed pass
    assert cuda_ec.LAUNCHES["win_g1"] == before  # CPU tensors: no kernel
    assert port.be.stats.fallback_groups == 0


def test_a_kernel_failure_raises_out_of_the_epoch(monkeypatch):
    port = _device_route_sim(0xCE)

    def broken(pts, digits):
        raise RuntimeError("win_g1 failed")

    monkeypatch.setattr(cuda_ec, "win_g1", broken)
    with pytest.raises(RuntimeError, match="win_g1 failed"):
        port.run_epoch(_contribs(4))


def test_the_epoch_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PSim(4, random.Random(0), mock=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        PQSim(4, random.Random(0), mock=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        PNI.generate_map(range(4), random.Random(0), mock=True)
    arrays = state.validator_set_arrays(RNI.generate_map(range(4), random.Random(0)))
    with pytest.raises(RuntimeError, match="CUDA"):
        state.netinfos_from_arrays(arrays)
    sim = PSim(4, random.Random(0), mock=True, ops=CudaBackend(device="cpu"))
    assert sim.ref.ops.device.type == "cpu"


def test_validator_set_round_trip():
    rn = RNI.generate_map(range(5), random.Random(0x5E7))
    arrays = state.validator_set_arrays(rn)
    assert arrays["sk_share_scalars"].shape == (5, 32)
    assert arrays["commitment_wires"].shape == (2, 192)
    assert arrays["pk_wires"].shape == (5, 192)
    pn = state.netinfos_from_arrays(arrays, ops=CpuBackend())
    again = state.validator_set_arrays(pn)
    for k in arrays:
        assert np.array_equal(again[k], arrays[k]), k
    for nid in range(5):
        assert pdumps(pn[nid].public_key_share(nid)) == rdumps(rn[nid].public_key_share(nid))
        assert pdumps(pn[nid].public_key(nid)) == rdumps(rn[nid].public_key(nid))
    bad = dict(arrays, pk_wires=arrays["pk_wires"][::-1].copy())
    with pytest.raises(ValueError, match="does not match"):
        state.netinfos_from_arrays(bad, ops=CpuBackend())


def test_carried_share_scalars_must_match_the_commitment():
    arrays = state.validator_set_arrays(RNI.generate_map(range(5), random.Random(0x5E8)))
    scalars = arrays["sk_share_scalars"].copy()
    scalars[2, -1] ^= 1  # node 2's share scalar, off by one in its last bit
    bad = dict(arrays, sk_share_scalars=scalars)
    with pytest.raises(ValueError, match="key share of node 2 does not match"):
        state.netinfos_from_arrays(bad, ops=CpuBackend())


# ---------------------------------------------------------------------------
# Divergent view classes (tests/test_epoch_vec.py's TestDivergentViews and
# TestMultiEpochDivergence, on their own inputs)
# ---------------------------------------------------------------------------


def _agreement(res):
    """One ``AgreementResult``, comparable with ``==``."""
    return (
        res.decisions,
        res.epochs_used,
        res.coin_flips,
        res.crypto_flushes,
        _faults(res.fault_log),
        res.diverged,
        res.class_epochs,
    )


def _nets(E, n, seed, mock=True):
    """Keys dealt from ``Random(seed)`` in the package of epoch module
    ``E`` (the port's on ``CudaBackend(device="cpu")``)."""
    if E is RE_MOD:
        return RNI.generate_map(range(n), random.Random(seed), mock=mock)
    return PNI.generate_map(range(n), random.Random(seed), mock=mock, ops=CudaBackend(device="cpu"))


def _agree_pair(n, seed, mock, est0, schedule, batched=False, dead=None):
    """``VectorizedAgreement(...).run(est0, **schedule(E))`` in both
    packages on the same dealt keys, ``E`` each package's epoch module;
    asserts the two outcomes equal and returns the port's."""
    from hbbft_tpu.harness import batching as RB
    from hbbft_tpu_torch.harness import batching as PB

    out = []
    for E, be in (
        (RE_MOD, RB.BatchingBackend() if batched else None),
        (PE_MOD, PB.BatchingBackend(inner=CudaBackend(device="cpu")) if batched else None),
    ):
        ag = E.VectorizedAgreement(_nets(E, n, seed, mock), 0, sorted(est0), dead=dead, be=be)
        out.append(ag.run(est0, **schedule(E)))
    assert _agreement(out[1]) == _agreement(out[0])
    return out[1]


def _raise_alike(run):
    """``run(E)`` raises in both packages: the same exception type and
    message.  Returns the message."""
    caught = []
    for E in (RE_MOD, PE_MOD):
        with pytest.raises(Exception) as info:
            run(E)
        caught.append((type(info.value).__name__, str(info.value)))
    assert caught[1] == caught[0]
    return caught[1]


class _WaveAdversary:
    """A factory of the sequential engines' epoch-0 equivocator: every
    adversary node sends each class's members ``msgs(value)`` for that
    class's value, then stays silent (the reference tests' local
    ``EquivocatingAdversary``)."""

    def __init__(self, side, classes, inner):
        self.side, self.classes, self.inner = side, classes, inner

    def __call__(self, seed):
        side, classes, inner = self.side, self.classes, self.inner
        N = side.net
        ag = side.ag

        class Equiv(N.Adversary):
            def __init__(self):
                self.scheduler = N.MessageScheduler(N.MessageScheduler.FIRST, random.Random(seed))
                self.sent = False
                self.adv_ids = []

            def init(self, all_nodes, adv_netinfos):
                self.adv_ids = sorted(adv_netinfos)

            def pick_node(self, nodes):
                return self.scheduler.pick_node(nodes)

            def push_message(self, sender_id, tm):
                pass

            def step(self):
                if self.sent:
                    return []
                self.sent = True
                out = []
                for adv in self.adv_ids:
                    for members, val in classes:
                        for r in sorted(members):
                            for msg in inner(val):
                                out.append(N.MessageWithSender(
                                    adv,
                                    side.step.TargetedMessage(
                                        side.step.Target.to(r), ag.AgreementMessage(0, ag.SbvContent(msg))
                                    ),
                                ))
                return out

        return Equiv()


def _epoch0_msg(side, m, kind, val=None):
    ag = side.ag
    return (
        isinstance(m, ag.AgreementMessage)
        and m.epoch == 0
        and isinstance(m.content, ag.SbvContent)
        and isinstance(m.content.msg, kind)
        and (val is None or m.content.msg.value is val)
    )


class TestDivergentViews:
    """n = 7, f = 2; honest 0-4 (est: 0-3 true, 4 false); Byzantine 5, 6
    send BVal(true) to class A = {0, 1} and BVal(false) to class
    B = {2, 3, 4}, then stay silent."""

    CLASS_A = frozenset({0, 1})
    CLASS_B = frozenset({2, 3, 4})
    EST0 = {0: {0: True, 1: True, 2: True, 3: True, 4: False}}

    @classmethod
    def _div(cls, E, **kw):
        args = dict(class_a=cls.CLASS_A, equiv={5: (True, False), 6: (True, False)},
                    instances=frozenset({0}))
        args.update(kw)
        return E.DivergentEpoch0(**args)

    @classmethod
    def _sequential(cls, side, mock, seed):
        """The sequential ``Agreement`` on ``TestNetwork`` under the
        staged wave schedule (``release_held``), in one package."""
        A, B = cls.CLASS_A, cls.CLASS_B
        BVal, Aux = side.sbv.BVal, side.sbv.Aux
        BoolSet = side.bool_set.BoolSet
        phase = {"n": 1}

        def filt(sender, recipient, m):
            # W1 holds true-BVals to B, the relayed false-BVals to A and
            # every epoch-0 Aux; later phases release wave by wave
            if recipient == side.net.TestNetwork.OBSERVER_ID:
                return True
            if phase["n"] <= 1 and _epoch0_msg(side, m, BVal, True) and recipient in B:
                return False
            if (phase["n"] <= 2 and _epoch0_msg(side, m, BVal, False) and recipient in A
                    and sender in {2, 3}):
                return False
            if phase["n"] <= 3 and _epoch0_msg(side, m, Aux):
                return False
            return True

        adversary = _WaveAdversary(side, ((A, True), (B, False)), lambda v: (BVal(v),))
        net = side.network(
            5, 2, lambda advs: adversary(seed + 1), lambda ni: side.ag.Agreement(ni, 0, 0),
            random.Random(seed), mock_crypto=mock, message_filter=filt,
        )
        for nid in range(4):
            net.input(nid, True)
        net.input(4, False)

        def drain():
            while net.any_busy():
                net.step()

        drain()
        bins = {nid: net.nodes[nid].algo.sbv_broadcast.bin_values for nid in range(5)}
        assert all(bins[nid] == BoolSet.single(True) for nid in A), bins
        assert all(bins[nid] == BoolSet.single(False) for nid in B), bins
        phase["n"] = 2
        net.release_held(lambda s, r, m: _epoch0_msg(side, m, BVal, True) and r in B)
        drain()
        phase["n"] = 3
        net.release_held(lambda s, r, m: _epoch0_msg(side, m, BVal, False) and r in A)
        drain()
        assert all(net.nodes[nid].algo.sbv_broadcast.bin_values == BoolSet.both() for nid in range(5))
        phase["n"] = 4
        net.release_held()
        net.step_until(lambda: all(n.terminated() for n in net.nodes.values()))
        decisions = {nid: net.nodes[nid].algo.decision for nid in range(5)}
        assert len(set(decisions.values())) == 1
        return {"net": net, "decision": decisions[0],
                "epochs": {nid: net.nodes[nid].algo.epoch for nid in range(5)}}

    @pytest.mark.parametrize("mock", [True, False], ids=["mock", "real"])
    def test_divergent_cross_engine(self, mock):
        seed = 0xD1 if mock else 0xD2
        # the sequential engines agree step for step across packages ...
        _, seq = twin(self._sequential, mock, seed)
        # ... and the vectorized engines agree with each other and with them
        res = _agree_pair(7, seed, mock, self.EST0, lambda E: {"divergent": self._div(E)})
        assert res.diverged
        assert res.decisions[0] == seq["decision"]
        assert set(seq["epochs"].values()) == {res.epochs_used[0]}

    def test_epoch_divergent_batches_match_uniform(self):
        contribs = {i: [b"dv-%d" % i] for i in range(5)}
        kw = dict(late_subset={4: {0, 1, 2, 3}})
        ref, port = _pair(7, 0xE7, mock=True)
        r = ref.run_epoch(contribs, divergent=self._div(RE_MOD, instances=frozenset({4})), **kw)
        p = port.run_epoch(contribs, divergent=self._div(PE_MOD, instances=frozenset({4})), **kw)
        _assert_same(r, p)
        twin_sim = PSim(7, random.Random(0xE7), mock=True, ops=CudaBackend(device="cpu"))
        u = twin_sim.run_epoch(contribs, dead={5, 6}, **kw)
        assert p.accepted == u.accepted and 4 in p.accepted
        assert p.diverged and not u.diverged and p.class_epochs == {}
        assert pdumps(p.batch) == pdumps(u.batch)
        assert p.shares_verified == u.shares_verified

    @pytest.mark.parametrize(
        "mock", [True, pytest.param(False, marks=pytest.mark.slow)], ids=["mock", "real"]
    )
    def test_divergent_at_scale_256(self, mock):
        # the full Byzantine budget: f = 85 equivocators split the epoch-0
        # views of a late-subset instance; |B| = f + 1
        n = 256
        f = (n - 1) // 3
        equiv = {n - 1 - i: (True, False) for i in range(f)}
        live = [i for i in range(n) if i not in equiv]
        B = live[: f + 1]
        class_a = frozenset(live[f + 1 :])
        p = B[-1]
        late = set(class_a) | {B[0]}
        contribs = {i: [b"dv-%03d" % i] for i in live}
        kw = dict(verify_honest=False, emit_minimal=True)
        ref, port = _pair(n, 0xE7, mock, **kw)
        outs = [
            sim.run_epoch(contribs, late_subset={p: late},
                          divergent=E.DivergentEpoch0(class_a=class_a, equiv=equiv,
                                                      instances=frozenset({p})))
            for sim, E in ((ref, RE_MOD), (port, PE_MOD))
        ]
        _assert_same(*outs)
        assert p in outs[1].accepted and len(outs[1].accepted) == len(live)
        uniform = PSim(n, random.Random(0xE7), mock=mock, ops=CudaBackend(device="cpu"), **kw)
        u = uniform.run_epoch(contribs, dead=set(equiv), late_subset={p: late})
        assert pdumps(outs[1].batch) == pdumps(u.batch)
        assert outs[1].shares_verified == u.shares_verified

    def test_epoch_late_subset_excluded_when_minority(self):
        ref, port = _pair(7, 0xE8, mock=True)
        contribs = {i: [b"ls-%d" % i] for i in range(7)}
        r, p = (s.run_epoch(contribs, late_subset={3: {3, 5}}) for s in (ref, port))
        _assert_same(r, p)
        assert set(p.accepted) == set(range(7)) - {3}

    def test_divergent_schedule_validation(self):
        def run(E, dead=None, **kw):
            ag = E.VectorizedAgreement(_nets(E, 7, 3), 0, [0], dead=dead)
            return ag.run({0: True}, divergent=self._div(E, **kw))

        # too many Byzantine: 2 equivocators + 1 dead > f = 2
        assert "exceed" in _raise_alike(lambda E: run(E, dead={4}))[1]
        # unanimous est: the equivocators alone cannot push B's cascade
        assert "non-divergent" in _raise_alike(run)[1]
        # an equivocator that is also dead; an instance that is not run
        assert "cannot also be dead" in _raise_alike(lambda E: run(E, dead={5}))[1]
        assert "unknown" in _raise_alike(lambda E: run(E, instances=frozenset({9})))[1]


class TestMultiEpochDivergence:
    """n = 11, f = 3: honest 0-7 (ests 0-3 true, 4-7 false), Byzantine
    8-10 equivocate epoch-0 BVal and Aux per class.  Class A = {0..4}
    counts an 8-true Aux prefix and decides true at epoch 0; class
    B = {5, 6, 7} counts {6 false, 2 true}, continues, and decides true at
    epoch 1 through f + 1 Terms from A."""

    A = frozenset({0, 1, 2, 3, 4})
    B = frozenset({5, 6, 7})
    EQUIV = (8, 9, 10)
    EST0 = {0: {nid: nid < 4 for nid in range(8)}}

    @classmethod
    def _schedule(cls, E, **kw):
        sched = E.DivergentSchedule(
            classes=(cls.A, cls.B),
            equiv={e: (True, False) for e in cls.EQUIV},
            equiv_aux=True,
            directives={
                0: (
                    E.ClassDirective(withhold=False, aux_counted=((True, 8),)),
                    E.ClassDirective(withhold=True, aux_counted=((False, 6), (True, 2))),
                )
            },
            instances=frozenset({0}),
        )
        return dataclasses.replace(sched, **kw)

    @classmethod
    def _sequential(cls, side, mock, seed):
        A, B = cls.A, cls.B
        BVal, Aux = side.sbv.BVal, side.sbv.Aux
        BoolSet = side.bool_set.BoolSet
        phase = {"n": 1}

        def filt(sender, recipient, m):
            # each class sees only its wave early; cross-class Auxes are
            # held so each class counts exactly the adversary's prefix
            if recipient == side.net.TestNetwork.OBSERVER_ID:
                return True
            if phase["n"] <= 1 and _epoch0_msg(side, m, BVal, False) and recipient in A:
                return False
            if phase["n"] <= 1 and _epoch0_msg(side, m, BVal, True) and recipient in B:
                return False
            if (phase["n"] <= 2 and _epoch0_msg(side, m, Aux) and sender not in cls.EQUIV
                    and (sender in A) != (recipient in A)):
                return False
            return True

        adversary = _WaveAdversary(side, ((A, True), (B, False)), lambda v: (BVal(v), Aux(v)))
        net = side.network(
            8, 3, lambda advs: adversary(seed + 1), lambda ni: side.ag.Agreement(ni, 0, 0),
            random.Random(seed), mock_crypto=mock, message_filter=filt,
        )
        for nid in range(8):
            net.input(nid, nid < 4)

        def drain():
            while net.any_busy():
                net.step()

        drain()
        assert all(net.nodes[nid].algo.sbv_broadcast.bin_values == BoolSet.single(False) for nid in B)
        assert all(net.nodes[nid].algo.decision is True and net.nodes[nid].algo.epoch == 0 for nid in A)
        phase["n"] = 2
        net.release_held(lambda s, r, m: _epoch0_msg(side, m, BVal))
        drain()
        assert all(net.nodes[nid].algo.sbv_broadcast.bin_values == BoolSet.both() for nid in B)
        phase["n"] = 3
        net.release_held(lambda s, r, m: _epoch0_msg(side, m, Aux, True) and r in B and s in {0, 1})
        drain()
        phase["n"] = 4
        net.release_held()
        net.step_until(lambda: all(n.terminated() for n in net.nodes.values()))
        decisions = {nid: net.nodes[nid].algo.decision for nid in range(8)}
        assert set(decisions.values()) == {True}
        return {"net": net, "epochs": {nid: net.nodes[nid].algo.epoch for nid in range(8)}}

    @pytest.mark.parametrize("mock", [True, False], ids=["mock", "real"])
    def test_cross_engine_divergent_decision_epochs(self, mock):
        seed = 0xDD if mock else 0xDE
        _, seq = twin(self._sequential, mock, seed)
        res = _agree_pair(11, seed, mock, self.EST0, lambda E: {"div_schedule": self._schedule(E)})
        assert res.diverged and res.decisions[0] is True
        # per-class deciding epochs: A at 0, B at 1, in both engines
        assert res.class_epochs[0] == (0, 1) and res.epochs_used[0] == 1
        assert [seq["epochs"][nid] for nid in range(8)] == [0] * 5 + [1] * 3

    def test_three_view_classes(self):
        def sched(E):
            d0 = E.ClassDirective(withhold=False, aux_counted=((True, 8),))
            db = E.ClassDirective(withhold=True, aux_counted=((False, 6), (True, 2)))
            return {"div_schedule": self._schedule(
                E, classes=(self.A, frozenset({5, 6}), frozenset({7})),
                equiv={e: (True, False, False) for e in self.EQUIV},
                directives={0: (d0, db, db)},
            )}

        res = _agree_pair(11, 0xD3C, True, self.EST0, sched)
        assert res.decisions[0] is True and res.class_epochs[0] == (0, 1, 1)

    @pytest.mark.parametrize(
        "mock,batched", [(True, False), (False, False), (False, True)],
        ids=["mock", "real", "real-batched"],
    )
    def test_divergent_continuation_reaches_real_coin(self, mock, batched):
        # neither class decides at epoch 0; the carried state reaches the
        # real coin at epoch 2 with the still-running honest nodes as
        # senders (batched: through the coin plane's one fused flush)
        def sched(E):
            return {"div_schedule": self._schedule(E, directives={0: (
                E.ClassDirective(withhold=False, aux_counted=((True, 7), (False, 1))),
                E.ClassDirective(withhold=True, aux_counted=((False, 6), (True, 2))),
            )})}

        res = _agree_pair(11, 0xDC0, mock, self.EST0, sched, batched=batched)
        assert res.decisions[0] is True and res.coin_flips >= 1
        e = res.epochs_used[0]
        assert e in (2, 3) and res.class_epochs[0] == (e, e)

    def test_epoch_batches_with_divergent_timing(self):
        n, p = 11, 6
        contribs = {i: [b"md-%02d" % i] for i in range(n)}
        late = {p: {0, 1, 2, 3}}
        ref, port = _pair(n, 0xEA, mock=True)
        outs = [
            sim.run_epoch(contribs, late_subset=late,
                          div_schedule=self._schedule(E, instances=frozenset({p})))
            for sim, E in ((ref, RE_MOD), (port, PE_MOD))
        ]
        _assert_same(*outs)
        assert outs[1].accepted == sorted(range(n))
        assert outs[1].diverged and outs[1].class_epochs == {p: (0, 1)}
        uniform = PSim(n, random.Random(0xEA), mock=True, ops=CudaBackend(device="cpu"))
        u = uniform.run_epoch(contribs, late_subset=late)
        assert pdumps(outs[1].batch) == pdumps(u.batch) and outs[1].accepted == u.accepted

    @pytest.mark.parametrize("case,match", [
        ("partition", "partition"),
        ("row", "per class"),
        ("equiv", "per class"),
        ("short", "termination threshold"),
        ("wide", "senders exist"),
        ("both", "mutually exclusive"),
    ])
    def test_schedule_validation(self, case, match):
        def run(E):
            prefix_b = E.ClassDirective(withhold=True, aux_counted=((False, 6), (True, 2)))
            kw = {
                "partition": dict(classes=(self.A, frozenset({5, 6}))),
                "row": dict(directives={0: (E.ClassDirective(withhold=False),)}),
                "equiv": dict(equiv={8: (True,), 9: (True, False), 10: (True, False)}),
                "short": dict(directives={0: (
                    E.ClassDirective(withhold=False, aux_counted=((True, 6),)), prefix_b)}),
                "wide": dict(directives={0: (
                    E.ClassDirective(withhold=False, aux_counted=((True, 9),)), prefix_b)}),
                "both": {},
            }[case]
            extra = {"divergent": object()} if case == "both" else {}
            return E.VectorizedAgreement(_nets(E, 11, 5), 0, [0]).run(
                self.EST0, div_schedule=self._schedule(E, **kw), **extra)

        kind, msg = _raise_alike(run)
        assert kind == "ValueError" and match in msg


def test_chip_smoke_divergent_driver():
    """``chip_smoke.py``'s phase 6(e) schedule: at n = 11 it is
    ``TestMultiEpochDivergence``'s; at the chip's n = 64 (mock keys here)
    its driver gives the reference's epochs."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    assert cs.div_schedule(PE_MOD, 11, 6) == TestMultiEpochDivergence._schedule(
        PE_MOD, instances=frozenset({6}))
    n, p = cs.EPOCH_NODES, cs.DIV_INSTANCE
    ref, port = _pair(n, cs.EPOCH_SEED, mock=True)
    contribs = {i: [b"div-%d" % i] for i in range(n)}
    want = []
    for _ in range(2):
        r = ref.run_epoch(contribs, late_subset={p: set(cs.DIV_LATE)},
                          div_schedule=cs.div_schedule(RE_MOD, n, p))
        want.append((rdumps(r.batch), r.accepted, _faults(r.fault_log), r.coin_flips,
                     r.shares_verified, r.agreement_epochs, {p: (0, 1)}))
    got = [o for o, _ in cs.divergent_epochs(port, n, 2)]
    assert got == want
    assert got[0][4] == n * (n - (n - 1) // 3)  # the equivocators are silent in the decryption
