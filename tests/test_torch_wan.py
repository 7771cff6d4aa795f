"""The WAN model in the port (``hbbft_tpu_torch/harness/wan.py``) against
the reference's (``hbbft_tpu/harness/wan.py``).

Both are numpy; tolerance 0 everywhere: every epoch view's arrays are
compared element for element and every float with ``==`` (the port
computes the same expressions in the same order).  Covered: the views of
epochs 0–3 (reach, src_ok, dst_ok, crashed, arrival_factor) of
test_cosim's model at n = 13 and 64 and of a straggler model (whose
per-node draws follow the reach draws), ``assign``'s largest remainder,
the ``late_prob`` closed forms, ``twin_kwargs``, ``pair_late_prob``, the
bind-time fault bound, and the ``SeededDelaySchedule`` sampler seam: one
draw per decision, the same decisions and the same rng state after.
"""

import random

import numpy as np
import pytest

from hbbft_tpu.harness import wan as RW
from hbbft_tpu.harness.network import SeededDelaySchedule as RSched
from hbbft_tpu_torch.harness import wan as PW
from hbbft_tpu_torch.harness.network import SeededDelaySchedule as PSched


def _wan_model(W, seed=11, alpha=1.5, straggler_p=0.0):
    """tests/test_cosim.py's model, built from module ``W``."""
    topo = W.GeoTopology(
        zones=("a", "b", "c"),
        delay_ms=((2, 80, 250), (80, 2, 120), (250, 120, 2)),
        weights=(6, 4, 3),
    )
    return W.WanModel(
        seed=seed,
        topology=topo,
        latency=W.LatencyModel("pareto", alpha=alpha),
        deadline_ms=200.0,
        straggler_p=straggler_p,
        partitions=(W.PartitionWindow(1, 2, ((0, 1), (2,))),),
        failures=(W.CorrelatedFailure(2, 3, 2),),
        flash_crowds=(W.FlashCrowd(1, 2, 4.0),),
    )


def _default_model(W, seed):
    return W.WanModel(seed=seed, topology=W.DEFAULT_TOPOLOGY,
                      latency=W.LatencyModel("lognormal"), deadline_ms=400.0)


MODELS = {
    "cosim": lambda W: _wan_model(W),
    "stragglers": lambda W: _wan_model(W, seed=0xBEEF, alpha=2.5, straggler_p=0.2),
    "default": lambda W: _default_model(W, 0xC052),
}


@pytest.mark.parametrize("n", [13, 64])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_epoch_views_match_reference(model, n):
    ref, port = MODELS[model](RW).bind(n), MODELS[model](PW).bind(n)
    assert port.Z == ref.Z and port.f == ref.f
    assert np.array_equal(port.zone, ref.zone) and port.zone.dtype == ref.zone.dtype
    for e in range(4):
        a, b = ref.epoch_view(e), port.epoch_view(e)
        assert b.epoch == a.epoch
        for name in ("reach", "src_ok", "dst_ok", "crashed"):
            x, y = getattr(a, name), getattr(b, name)
            assert y.dtype == x.dtype and np.array_equal(y, x), (model, n, e, name)
        assert b.arrival_factor == a.arrival_factor
        assert port.arrival_factor(e) == ref.arrival_factor(e)
        assert port.crashed_set(e) == ref.crashed_set(e)
        assert port.epoch_view(e) is b  # cached


@pytest.mark.parametrize(
    "weights,n",
    [((4.0, 3.0, 3.0), 10), ((6, 4, 3), 13), ((6, 4, 3), 64), ((1, 1, 1, 1, 1), 7), ((), 1000),
     ((0.5, 0.25, 0.125, 0.125), 17)],
)
def test_assign_largest_remainder_matches_reference(weights, n):
    z = max(len(weights), 3)
    delays = ((2.0,) * z,) * z
    got = PW.GeoTopology(zones=tuple("abcde"[:z]), delay_ms=delays, weights=weights).assign(n)
    want = RW.GeoTopology(zones=tuple("abcde"[:z]), delay_ms=delays, weights=weights).assign(n)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert len(got) == n and (np.sort(got) == got).all()  # contiguous blocks
    if weights == (4.0, 3.0, 3.0):
        assert np.bincount(got, minlength=3).tolist() == [4, 3, 3]


def test_late_prob_closed_forms_match_reference():
    for dist in ("uniform", "lognormal", "pareto"):
        for kw in ({}, {"sigma": 0.8, "alpha": 1.5}):
            p, r = PW.LatencyModel(dist, **kw), RW.LatencyModel(dist, **kw)
            for base in (0.0, 2.0, 35.0, 100.0, 140.0, 250.0):
                for deadline in (-1.0, 0.0, 50.0, 150.0, 200.0, 400.0):
                    assert p.late_prob(base, deadline) == r.late_prob(base, deadline)
    assert PW.LatencyModel("pareto", alpha=2.0).late_prob(100.0, 200.0) == pytest.approx(0.25)
    assert PW.LatencyModel("pareto", alpha=2.0).late_prob(100.0, 50.0) == 1.0
    assert PW.LatencyModel("lognormal", sigma=0.6).late_prob(100.0, 100.0) == pytest.approx(0.5)
    assert PW.LatencyModel("uniform").late_prob(100.0, 400.0) == 0.0
    with pytest.raises(ValueError):
        PW.LatencyModel("gamma")


@pytest.mark.parametrize("n", [13, 64])
def test_twin_kwargs_and_pair_late_prob_match_reference(n):
    for model in ("cosim", "stragglers"):
        ref, port = MODELS[model](RW).bind(n), MODELS[model](PW).bind(n)
        for e in range(4):
            for proposers, dead in ((range(n), None), (range(1, n, 2), {0, 3})):
                got = port.twin_kwargs(e, list(proposers), dead=dead)
                assert got == ref.twin_kwargs(e, list(proposers), dead=dead), (model, e)
        for s, r in ((0, n - 1), (n - 1, 0), (5, 6), ("observer", 2), (1, "observer"), (-1, n)):
            assert port.pair_late_prob(s, r) == ref.pair_late_prob(s, r)


def test_correlated_failure_past_f_raises_like_the_reference():
    topo = dict(zones=("a", "b"), delay_ms=((2.0, 50.0), (50.0, 2.0)), weights=(1.0, 3.0))
    for W in (RW, PW):
        model = W.WanModel(seed=1, topology=W.GeoTopology(**topo),
                           failures=(W.CorrelatedFailure(0, 2, 1),))
        with pytest.raises(ValueError):
            model.bind(13)
    with pytest.raises(ValueError):
        PW.GeoTopology(zones=("a",), delay_ms=((1.0, 2.0),))


def test_sampler_one_draw_per_decision_through_the_delay_schedule():
    for model in ("cosim", "default"):
        p_sampler = MODELS[model](PW).bind(10).delay_sampler()
        r_sampler = MODELS[model](RW).bind(10).delay_sampler()
        port = PSched(random.Random(4), p_delay=0.25, sampler=p_sampler)
        ref = RSched(random.Random(4), p_delay=0.25, sampler=r_sampler)
        flat = random.Random(4)
        for s in range(5):
            for r in range(5):
                assert port(s, r, None) == ref(s, r, None)
                flat.random()
        assert port.held_count == ref.held_count
        # exactly one draw a decision: the three rngs are in lockstep
        assert port.rng.random() == ref.rng.random() == flat.random()
        for s in range(10):
            for r in range(10):
                for p_delay in (None, 0.25, 0.9):
                    u = random.Random(s * 10 + r)
                    v = random.Random(s * 10 + r)
                    assert p_sampler(u, s, r, None, p_delay=p_delay) == r_sampler(
                        v, s, r, None, p_delay=p_delay
                    )
