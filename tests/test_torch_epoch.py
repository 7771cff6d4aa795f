"""The slice as a whole: full HoneyBadger epochs in the port.

The same seed goes through the reference's ``VectorizedHoneyBadgerSim``
(``hbbft_tpu/harness/epoch.py``, on its CPU backend) and the port's
(``hbbft_tpu_torch/harness/epoch.py``) on the CPU:
``ops=CudaBackend(device="cpu")`` runs the card's route with every kernel's plain version, and the small
flushes of these sizes stay on the host by the backend's size rules
unless a test lowers them.  Tolerance is 0 throughout: batches compare
by their ``dumps`` bytes, fault logs entry by entry, and every counter
exactly.  Also here: the decryption side of the key set (batched and
speculative Lagrange combines), the key dealing, and the validator set
carried across by ``state.py``.
"""

import random

import numpy as np
import pytest
import torch

from hbbft_tpu.core.network_info import NetworkInfo as RNI
from hbbft_tpu.core.serialize import dumps as rdumps
from hbbft_tpu.crypto import mock as RM
from hbbft_tpu.crypto import threshold as RT
from hbbft_tpu.harness.epoch import VectorizedHoneyBadgerSim as RSim
from hbbft_tpu.harness.epoch import VectorizedQueueingSim as RQSim
from hbbft_tpu_torch import native as PN
from hbbft_tpu_torch import state
from hbbft_tpu_torch.core.network_info import NetworkInfo as PNI
from hbbft_tpu_torch.core.serialize import dumps as pdumps
from hbbft_tpu_torch.crypto import mock as PM
from hbbft_tpu_torch.crypto import threshold as PT
from hbbft_tpu_torch.crypto.backend import CpuBackend
from hbbft_tpu_torch.harness.epoch import VectorizedHoneyBadgerSim as PSim
from hbbft_tpu_torch.harness.epoch import VectorizedQueueingSim as PQSim
from hbbft_tpu_torch.ops import cuda_ec
from hbbft_tpu_torch.ops.backend_cuda import CudaBackend

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
    sim = PSim(4, random.Random(1), mock=True, ops=CudaBackend(device="cpu"))
    with pytest.raises(TypeError):
        sim.run_epoch(_contribs(4), divergent=object())
    with pytest.raises(TypeError):
        sim.run_epoch(_contribs(4), div_schedule=object())
    with pytest.raises(ValueError):
        sim.run_epochs([_contribs(4)] * 2, pipeline="deep")


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
