"""The era change in the port: the dynamic harness against the reference's.

The same seed goes through the reference's ``VectorizedDynamicSim`` /
``VectorizedDynamicQueueingSim`` (``hbbft_tpu/harness/dynamic.py``, on
its CPU backend) and the port's (``hbbft_tpu_torch/harness/dynamic.py``,
``ops=CudaBackend(device="cpu")``).  On a CPU device both DKGs take the
host engine, so every epoch must agree exactly: batch bytes (``dumps``),
change states, era, validator set and fault log, and at the end the key
set's bytes and every share.  Covered: the Remove → Add churn cycle
(mock n = 7 and real BLS n = 4), stale-era votes, the queueing stack
with churn (mock n = 7, real n = 4), the join plan with an observer that
verifies a signature of the new era, the churn with the DKG's device
engine forced on both sides (its keys are sampled by different
generators, so the user contributions and membership are compared), and
a divergent view-class schedule passed through to the epoch driver
(``wan=`` and ``hw=`` are held against the reference in
``tests/test_torch_virtual.py``).
"""

import random

import pytest
import torch

from hbbft_tpu.core.serialize import dumps as rdumps
from hbbft_tpu.harness import dynamic as RD
from hbbft_tpu.protocols import change as RC
from hbbft_tpu_torch.core.serialize import dumps as pdumps
from hbbft_tpu_torch.crypto import threshold as PT
from hbbft_tpu_torch.harness import dkg as PDKG
from hbbft_tpu_torch.harness import dynamic as PD
from hbbft_tpu_torch.ops import cuda_ec
from hbbft_tpu_torch.ops.backend_cuda import CudaBackend
from hbbft_tpu_torch.protocols import change as PC

torch.set_num_threads(1)

SIDES = {"ref": (RD, RC, rdumps), "port": (PD, PC, pdumps)}


def _kw(side):
    return {"ops": CudaBackend(device="cpu")} if side == "port" else {}


def _outcome(side, res):
    dumps = SIDES[side][2]
    return (
        dumps(res.batch),
        dumps(res.change),
        res.era,
        list(res.validators),
        [(f.node_id, f.kind.name) for f in res.fault_log],
    )


def _keys(side, sim):
    """The current era's key material, comparable across packages."""
    dumps = SIDES[side][2]
    shares = [
        ni.secret_key_share.scalar if hasattr(ni.secret_key_share, "scalar") else dumps(ni.secret_key_share)
        for _, ni in sorted(sim.sim.netinfos.items())
    ]
    return dumps(sim.sim.pk_set), shares


def _cycle(side, mock, n, seed):
    mod, C = SIDES[side][0], SIDES[side][1]
    sim = mod.VectorizedDynamicSim(n, random.Random(seed), mock=mock, **_kw(side))
    f = (n - 1) // 3
    outs = []

    def run(tag):
        res = sim.run_epoch({i: [b"tx-%d-%d" % (i, tag)] for i in sim.validators})
        outs.append(_outcome(side, res))

    run(0)
    for v in sim.validators[: f + 1]:
        sim.vote_for(v, C.Remove(n - 1))
    run(1)
    run(2)
    pk = sim.register_candidate(n - 1)
    for v in sim.validators[: f + 1]:
        sim.vote_for(v, C.Add(n - 1, pk))
    run(3)
    run(4)
    return sim, outs


@pytest.mark.parametrize("mock,n,seed", [(True, 7, 40), (False, 4, 41)], ids=["mock-n7", "real-n4"])
def test_churn_cycle_matches_reference(mock, n, seed):
    rsim, ref = _cycle("ref", mock, n, seed)
    psim, port = _cycle("port", mock, n, seed)
    assert port == ref
    assert [o[2] for o in port] == [0, 1, 1, 2, 2]
    assert _keys("port", psim) == _keys("ref", rsim)
    assert psim.era == 2 and psim.epoch == rsim.epoch == 5
    assert psim.last_dkg.engine == "host"
    if not mock:
        assert isinstance(psim.sim.netinfos[0].secret_key_share, PT.SecretKeyShare)
        assert {"dkg", "dkg_dealing", "dkg_generation", "key_rebuild"} <= set(psim.last_switch_phases)


def test_stale_era_votes_dropped_as_reference():
    outs = {}
    for side in SIDES:
        mod, C = SIDES[side][0], SIDES[side][1]
        sim = mod.VectorizedDynamicSim(7, random.Random(42), mock=True, **_kw(side))
        sim.vote_for(3, C.Remove(0))  # goes stale: 3 is dead this epoch
        for v in (1, 2, 4):
            sim.vote_for(v, C.Remove(6))
        r1 = sim.run_epoch({i: [b"a%d" % i] for i in range(7) if i != 3}, dead={3})
        r2 = sim.run_epoch({i: [b"b%d" % i] for i in sim.validators})
        outs[side] = [_outcome(side, r1), _outcome(side, r2)]
    assert outs["port"] == outs["ref"]
    assert outs["port"][0][2] == 1 and outs["port"][1][4] == []


def _queueing(side, mock, n, seed, batch, vote_count):
    mod, C = SIDES[side][0], SIDES[side][1]
    q = mod.VectorizedDynamicQueueingSim(n, random.Random(seed), batch_size=batch, mock=mock, **_kw(side))
    txs = [b"t-%02d" % i for i in range(batch)]
    q.input_all(txs)
    outs = [_outcome(side, q.run_epoch())]
    for v in q.validators[:vote_count]:
        q.vote_for(v, C.Remove(n - 1))
    for _ in range(12):
        outs.append(_outcome(side, q.run_epoch()))
        if not any(len(qq) for qq in q.queues.values()):
            break
    return q, outs


@pytest.mark.parametrize(
    "mock,n,seed,batch,votes", [(True, 7, 50, 16, 3), (False, 4, 52, 8, 2)], ids=["mock-n7", "real-n4"]
)
def test_queueing_with_churn_matches_reference(mock, n, seed, batch, votes):
    rq, ref = _queueing("ref", mock, n, seed, batch, votes)
    pq, port = _queueing("port", mock, n, seed, batch, votes)
    assert port == ref
    assert pq.era == 1 and (n - 1) not in pq.validators
    assert not any(len(qq) for qq in pq.queues.values())
    assert _keys("port", pq.dyn) == _keys("ref", rq.dyn)


def test_join_plan_and_observer_match_reference():
    plans = {}
    for side in SIDES:
        mod, C = SIDES[side][0], SIDES[side][1]
        dumps = SIDES[side][2]
        sim = mod.VectorizedDynamicSim(4, random.Random(70), mock=False, **_kw(side))
        p0 = sim.join_plan()
        for v in (0, 1):
            sim.vote_for(v, C.Remove(3))
        r = sim.run_epoch({i: [b"j%d" % i] for i in range(4)})
        p1 = sim.join_plan()
        assert p1.epoch == sim.epoch and p1.pub_key_set is sim.sim.pk_set
        obs = sim.observer_from_plan(p1)
        shares = {i: sim.sim.netinfos[i].secret_key_share.sign(b"post-churn") for i in (0, 1)}
        sig = sim.sim.netinfos[0].public_key_set.combine_signatures(shares)
        r2 = sim.run_epoch({i: [b"k%d" % i] for i in sim.validators}, observe=True)
        plans[side] = (dumps(p0), dumps(p1), _outcome(side, r), _outcome(side, r2), dumps(sig))
        if side == "port":
            assert sorted(p0.pub_keys) == [0, 1, 2, 3] and sorted(p1.pub_keys) == [0, 1, 2]
            assert p1.change == PC.Complete(PC.Remove(3))
            assert not obs.is_validator
            assert obs.public_key_set.verify_signature(sig, b"post-churn")
            assert pdumps(r2.inner.observer_batch) == pdumps(r2.inner.batch)
    assert plans["port"] == plans["ref"]


def test_churn_with_the_device_dealing_plane(monkeypatch):
    """The DKG's device engine forced on both sides (the port's through
    ``fr_matmul``'s plain version): the era switches on sampled keys
    that sign and verify, launches no kernel on a CPU device, and the
    rng stays aligned with the reference, so every epoch commits the
    same contributions with the same membership."""
    import jax

    from hbbft_tpu.ops import pallas_ec

    monkeypatch.setattr(
        pallas_ec, "cached_compiled", lambda name, fn, *args, key_parts=None, donate=(): jax.jit(fn)(*args)
    )
    monkeypatch.setenv("HBBFT_TPU_DKG_DEVICE", "1")
    monkeypatch.setattr(PDKG.VectorizedDkg, "_device_auto", lambda self: True)
    outs = {}
    for side in SIDES:
        mod, C = SIDES[side][0], SIDES[side][1]
        sim = mod.VectorizedDynamicSim(4, random.Random(43), mock=False, verify_honest=False, **_kw(side))
        rows = []
        cuda_ec.reset_launches()
        for tag in range(3):
            if tag == 0:
                for v in (0, 1):
                    sim.vote_for(v, C.Remove(3))
            res = sim.run_epoch({i: [b"d-%d-%d" % (i, tag)] for i in sim.validators})
            rows.append((res.batch.contributions, type(res.change).__name__, res.era, list(res.validators)))
        outs[side] = rows
        if side == "port":
            assert sim.last_dkg.engine == "device"
            assert not any(cuda_ec.LAUNCHES.values())
            pk_set = sim.sim.pk_set
            shares = {i: sim.sim.netinfos[i].secret_key_share.sign(b"dev") for i in (0, 2)}
            assert pk_set.verify_signature(pk_set.combine_signatures(shares), b"dev")
    assert outs["port"] == outs["ref"]
    assert [r[2] for r in outs["port"]] == [1, 1, 1]


def _div_schedule(side, classes=None):
    """tests/test_epoch_vec.py's multi-epoch schedule at n = 11 on instance
    6: class {0..4} decides at agreement epoch 0, class {5, 6, 7} at 1;
    8-10 equivocate."""
    from hbbft_tpu.harness import epoch as RE
    from hbbft_tpu_torch.harness import epoch as PE

    E = PE if side == "port" else RE
    return E.DivergentSchedule(
        classes=classes or (frozenset(range(5)), frozenset({5, 6, 7})),
        equiv={e: (True, False) for e in (8, 9, 10)},
        equiv_aux=True,
        directives={0: (
            E.ClassDirective(withhold=False, aux_counted=((True, 8),)),
            E.ClassDirective(withhold=True, aux_counted=((False, 6), (True, 2))),
        )},
        instances=frozenset({6}),
    )


def test_left_out_options_raise():
    """The dynamic drivers pass ``div_schedule=`` through to the epoch
    driver: a valid schedule gives the reference's epochs, an invalid one
    the reference's ``ValueError``."""
    outs = {}
    for side, (mod, C, dumps) in SIDES.items():
        sim = mod.VectorizedDynamicSim(11, random.Random(0xD5), mock=True, **_kw(side))
        q = mod.VectorizedDynamicQueueingSim(11, random.Random(0xD6), batch_size=22, mock=True, **_kw(side))
        q.input_all([b"dq-%02d" % i for i in range(33)])
        late = {6: {0, 1, 2, 3}}
        rows = []
        for tag in range(2):
            res = sim.run_epoch({i: [b"dv-%d-%d" % (i, tag)] for i in sim.validators},
                                late_subset=late, div_schedule=_div_schedule(side))
            rows.append(_outcome(side, res))
            rows.append(_outcome(side, q.run_epoch(late_subset=late, div_schedule=_div_schedule(side))))
        assert 6 in res.inner.accepted
        bad = _div_schedule(side, classes=(frozenset(range(5)), frozenset({5, 6})))
        with pytest.raises(ValueError, match="partition") as a:
            sim.run_epoch({i: [b"x"] for i in sim.validators}, div_schedule=bad)
        with pytest.raises(ValueError, match="partition") as b:
            q.run_epoch(div_schedule=bad)
        outs[side] = rows, str(a.value), str(b.value)
    assert outs["port"] == outs["ref"]


def test_wire_tags_match_reference():
    from hbbft_tpu.core.serialize import loads as rloads
    from hbbft_tpu.protocols.votes import SignedVote as RSV, Vote as RV
    from hbbft_tpu_torch.core.serialize import loads as ploads
    from hbbft_tpu_torch.protocols.votes import SignedVote as PSV, Vote as PV

    for rc, pc in [
        (RC.Complete(RC.Remove(3)), PC.Complete(PC.Remove(3))),
        (RC.InProgress(RC.Add(2, b"k")), PC.InProgress(PC.Add(2, b"k"))),
        (RC.NoChange(), PC.NoChange()),
        (RSV(RV(RC.Remove(1), 2, 3), 4, b"sig"), PSV(PV(PC.Remove(1), 2, 3), 4, b"sig")),
        (RD.DynContrib([b"u"], ()), PD.DynContrib([b"u"], ())),
    ]:
        assert pdumps(pc) == rdumps(rc)
        assert ploads(rdumps(rc)) == pc and rloads(pdumps(pc)) == rc
