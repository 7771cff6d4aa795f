"""Virtual-time accounting (``hw=``) in the port against the reference.

The same seed and ``HwQuality`` go through the reference's epoch drivers
(``hbbft_tpu/harness/{epoch,dynamic}.py``) and the port's
(``ops=CudaBackend(device="cpu")``).  The network terms come from
message counts and sizes alone, so they must be equal with tolerance 0:
``rounds``, ``per_node_msgs``, ``per_node_bytes``, ``network_s`` and
every breakdown entry but the ``cpu:`` ones.  The ``cpu:`` terms are
measured walls scaled by the cpu factor; they are not compared, but
their keys must be the same and ``total_s == network_s + cpu_s``.  Also:
the era-switch epoch's ``dkg-part`` / ``dkg-ack`` terms, the sequential
driver under ``hw``, and ``reveal_mode="ordered"`` with ``hw=`` raising.
"""

import random

import pytest
import torch

from hbbft_tpu.harness import dynamic as RD
from hbbft_tpu.harness.epoch import VectorizedHoneyBadgerSim as RSim
from hbbft_tpu.harness.epoch import VectorizedQueueingSim as RQSim
from hbbft_tpu.harness.simulation import HwQuality as RHw
from hbbft_tpu.protocols import change as RC
from hbbft_tpu_torch.harness import dynamic as PD
from hbbft_tpu_torch.harness.epoch import VectorizedHoneyBadgerSim as PSim
from hbbft_tpu_torch.harness.epoch import VectorizedQueueingSim as PQSim
from hbbft_tpu_torch.harness.simulation import HwQuality as PHw
from hbbft_tpu_torch.ops.backend_cuda import CudaBackend
from hbbft_tpu_torch.protocols import change as PC

torch.set_num_threads(1)

FLAGS = (100, 2000, 100)


def _cpu():
    return CudaBackend(device="cpu")


def _network(v):
    """The measured-wall-free part of a virtual account."""
    return (
        v.rounds,
        v.per_node_msgs,
        v.per_node_bytes,
        v.network_s,
        {k: x for k, x in v.breakdown.items() if not k.startswith("cpu:")},
    )


def _assert_same_account(ref, port):
    assert _network(port) == _network(ref)
    assert sorted(port.breakdown) == sorted(ref.breakdown)
    assert port.total_s == port.network_s + port.cpu_s
    assert port.cpu_s == sum(x for k, x in port.breakdown.items() if k.startswith("cpu:"))
    assert port.cpu_s >= 0


def test_hw_quality_matches_reference():
    for flags in ((), FLAGS, (40, 100_000, 50)):
        p, r = PHw.from_flags(*flags), RHw.from_flags(*flags)
        assert (p.latency, p.inv_bw, p.cpu_factor) == (r.latency, r.inv_bw, r.cpu_factor)
    assert PHw() == PHw(0.1, 8_000 / 2_000_000, 100.0)


@pytest.mark.parametrize(
    "mock,n,seed", [(True, 7, 0x71), (True, 13, 0x72), (False, 4, 0x73)], ids=["mock-7", "mock-13", "real-4"]
)
def test_epoch_virtual_account_matches_reference(mock, n, seed):
    hw_r, hw_p = RHw.from_flags(*FLAGS), PHw.from_flags(*FLAGS)
    ref = RSim(n, random.Random(seed), mock=mock, hw=hw_r)
    port = PSim(n, random.Random(seed), mock=mock, ops=_cpu(), hw=hw_p)
    f = (n - 1) // 3
    plans = [{}, dict(dead={n - 1}), dict(late_subset={0: set(range(f + 1))}) if n >= 7 else {}]
    for e, kw in enumerate(plans):
        c = {i: [b"v-%d-%d" % (e, i)] for i in range(n)}
        a, b = ref.run_epoch(c, **kw), port.run_epoch(c, **kw)
        if not kw:
            assert b.batch.contributions == c
        assert b.accepted == a.accepted and b.coin_flips == a.coin_flips
        _assert_same_account(a.virtual, b.virtual)
        assert {"cpu:propose", "cpu:rbc", "cpu:agreement", "cpu:decrypt", "cpu:assembly"} <= set(
            b.virtual.breakdown
        )
    # no hw: no account
    assert PSim(n, random.Random(seed), mock=mock, ops=_cpu()).run_epoch(c).virtual is None


def test_run_epochs_runs_sequentially_under_hw():
    hw_r, hw_p = RHw.from_flags(*FLAGS), PHw.from_flags(*FLAGS)
    ref = RSim(7, random.Random(0x75), mock=True, hw=hw_r)
    port = PSim(7, random.Random(0x75), mock=True, ops=_cpu(), hw=hw_p)
    seq = [{i: [b"s-%d-%d" % (e, i)] for i in range(7)} for e in range(3)]
    a, b = ref.run_epochs(seq, pipeline=True), port.run_epochs(seq, pipeline=True)
    for x, y in zip(a, b):
        assert y.batch.contributions == x.batch.contributions
        assert "propose" in y.phases  # the sequential driver's walls
        _assert_same_account(x.virtual, y.virtual)
    q_r = RQSim(7, random.Random(0x76), batch_size=8, mock=True, hw=hw_r)
    q_p = PQSim(7, random.Random(0x76), batch_size=8, mock=True, ops=_cpu(), hw=hw_p)
    for q in (q_r, q_p):
        q.input_all([b"q%02d" % i for i in range(20)])
    for _ in range(2):
        _assert_same_account(q_r.run_epoch().virtual, q_p.run_epoch().virtual)


def test_ordered_reveals_refuse_hw():
    sim = PSim(4, random.Random(1), mock=True, ops=_cpu(), hw=PHw(), reveal_mode="ordered")
    with pytest.raises(ValueError, match="hw="):
        sim.run_epoch({i: [b"o"] for i in range(4)})


@pytest.mark.parametrize("mock,n,seed", [(True, 7, 0x77), (False, 4, 0x78)], ids=["mock-7", "real-4"])
def test_era_switch_adds_the_dkg_rounds(mock, n, seed):
    hw_r, hw_p = RHw.from_flags(*FLAGS), PHw.from_flags(*FLAGS)
    ref = RD.VectorizedDynamicSim(n, random.Random(seed), mock=mock, hw=hw_r)
    port = PD.VectorizedDynamicSim(n, random.Random(seed), mock=mock, ops=_cpu(), hw=hw_p)
    f = (n - 1) // 3
    for sim, C in ((ref, RC), (port, PC)):
        for v in range(f + 1):
            sim.vote_for(v, C.Remove(n - 1))
    a = ref.run_epoch({i: [b"d%d" % i] for i in range(n)})
    b = port.run_epoch({i: [b"d%d" % i] for i in range(n)})
    assert b.era == a.era == 1 and b.validators == a.validators
    va, vb = a.inner.virtual, b.inner.virtual
    _assert_same_account(va, vb)
    assert {"dkg-part", "dkg-ack", "cpu:dkg"} <= set(vb.breakdown)
    # the DKG's rounds are sized for the new validator set
    m, t = n - 1, (n - 2) // 3
    part = (m - 1) * ((t + 1) ** 2 * 192 + m * ((t + 1) * 32 + 150))
    ack = m * (m - 1) * (m * 182 + 8)
    assert vb.breakdown["dkg-part"] == part * hw_p.inv_bw + hw_p.latency
    assert vb.breakdown["dkg-ack"] == ack * hw_p.inv_bw + hw_p.latency
    # the next epoch, under the new keys, has no DKG term
    a2 = ref.run_epoch({i: [b"e%d" % i] for i in ref.validators})
    b2 = port.run_epoch({i: [b"e%d" % i] for i in port.validators})
    _assert_same_account(a2.inner.virtual, b2.inner.virtual)
    assert "dkg-part" not in b2.inner.virtual.breakdown


def test_dkg_terms_keep_total_equal_to_network_plus_cpu():
    """``_add_dkg_virtual`` on an account whose terms, added one by one to
    ``total_s`` as the reference does, end one ulp away from
    ``network_s + cpu_s`` (n = 6, network 0.1 s, cpu 0.011 s, a 43 ms
    DKG wall): the port keeps the account's invariant exactly."""
    from hbbft_tpu_torch.harness.epoch import VirtualEpochTime

    sim = PD.VectorizedDynamicSim(6, random.Random(0), mock=True, ops=_cpu(), hw=PHw.from_flags(*FLAGS))
    v = VirtualEpochTime(total_s=0.1 + 0.011, rounds=0, per_node_msgs=0, per_node_bytes=0,
                         network_s=0.1, cpu_s=0.011, breakdown={})
    sim._add_dkg_virtual(v, 0.043)
    assert v.total_s == v.network_s + v.cpu_s
    assert v.cpu_s == 0.011 + 0.043 and v.rounds == 2


def test_dynamic_queueing_takes_hw_and_wan():
    """The dynamic queueing stack under ``hw=`` and a WAN model with a
    correlated failure: the crash set merges before queue sampling, and
    every epoch (batches, changes, accounts) equals the reference's."""
    from hbbft_tpu.core.serialize import dumps as rdumps
    from hbbft_tpu.harness import wan as RW
    from hbbft_tpu_torch.core.serialize import dumps as pdumps
    from hbbft_tpu_torch.harness import wan as PW

    def model(W):
        topo = W.GeoTopology(zones=("a", "b", "c"),
                             delay_ms=((2, 80, 250), (80, 2, 120), (250, 120, 2)), weights=(6, 4, 3))
        return W.WanModel(seed=17, topology=topo, latency=W.LatencyModel("pareto", alpha=1.5),
                          deadline_ms=200.0, failures=(W.CorrelatedFailure(1, 2, 2),))

    sides = {
        "ref": (RD.VectorizedDynamicQueueingSim(7, random.Random(0x79), batch_size=8, mock=True,
                                                hw=RHw.from_flags(*FLAGS)), model(RW), rdumps, RC),
        "port": (PD.VectorizedDynamicQueueingSim(7, random.Random(0x79), batch_size=8, mock=True,
                                                 ops=_cpu(), hw=PHw.from_flags(*FLAGS)),
                 model(PW), pdumps, PC),
    }
    rows = {}
    for side, (q, wan, dumps, C) in sides.items():
        q.input_all([b"w%02d" % i for i in range(30)])
        out = []
        for e in range(3):
            if e == 1:
                for v in range(3):
                    q.vote_for(v, C.Remove(6))
            res = q.run_epoch(wan=wan)
            out.append((dumps(res.batch), dumps(res.change), res.era, list(res.validators),
                        [(f.node_id, f.kind.name) for f in res.fault_log], _network(res.inner.virtual)))
        rows[side] = out
    assert rows["port"] == rows["ref"]
    assert any(r[2] == 1 for r in rows["port"])
