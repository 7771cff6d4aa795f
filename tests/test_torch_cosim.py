"""The packed co-simulation in the port against the reference's.

The port's ``PackedHoneyBadgerCosim`` / ``PackedQueueingCosim``
(``hbbft_tpu_torch/harness/cosim.py``, ``device="cpu"``: the
``cosim_hist`` / ``cosim_step`` kernels' plain versions) run epoch by
epoch beside the reference's packed sims (``hbbft_tpu/harness/cosim.py``
at ``mesh=None``) and the port's own dict plane
(``VectorizedHoneyBadgerSim(mock=True)`` / ``VectorizedQueueingSim`` on
``CudaBackend(device="cpu")``), all from equal seeds.  The reference's
step goes through ``pallas_ec.cached_compiled``, whose executable disk
cache fails under the tests' 8-device CPU mesh, so it runs here under
plain ``jax.jit``.

Tolerance 0 throughout: batches by their ``dumps`` bytes, accepted sets,
``compact()`` fault logs, coin flips, shares verified, agreement epochs,
rng lockstep, scale-mode stats, commit counters; the step against the
reference's ``_body`` byte for byte on random columns with padding.
"""

import random

import jax
import numpy as np
import pytest
import torch

from hbbft_tpu.core.serialize import dumps as rdumps
from hbbft_tpu.crypto.mock import MockDecryptionShare as RShare
from hbbft_tpu.harness import cosim as RC
from hbbft_tpu.harness import wan as RW
from hbbft_tpu.ops import pallas_ec
from hbbft_tpu.parallel import mesh as RM
from hbbft_tpu_torch.core.serialize import dumps as pdumps
from hbbft_tpu_torch.crypto.mock import MockDecryptionShare as PShare
from hbbft_tpu_torch.harness import cosim as PC
from hbbft_tpu_torch.harness import wan as PW
from hbbft_tpu_torch.harness.epoch import VectorizedHoneyBadgerSim as PSim
from hbbft_tpu_torch.harness.epoch import VectorizedQueueingSim as PQSim
from hbbft_tpu_torch.ops import cosim_step as CS
from hbbft_tpu_torch.ops import cuda_ec
from hbbft_tpu_torch.ops.backend_cuda import CudaBackend
from hbbft_tpu_torch.parallel import mesh as PMesh

torch.set_num_threads(1)

R_FORGED = RShare(b"\x00" * 32, b"\x00" * 32)
P_FORGED = PShare(b"\x00" * 32, b"\x00" * 32)


@pytest.fixture(autouse=True)
def _plain_jit(monkeypatch):
    monkeypatch.setattr(
        pallas_ec, "cached_compiled",
        lambda name, fn, *args, key_parts=None, donate=(): jax.jit(fn)(*args),
    )


def _contribs(n, e):
    return {i: [f"tx-{e}-{i}-{j}" for j in range(3)] for i in range(n)}


def _wan_model(W, seed=11, alpha=1.5):
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
        partitions=(W.PartitionWindow(1, 2, ((0, 1), (2,))),),
        failures=(W.CorrelatedFailure(2, 3, 2),),
        flash_crowds=(W.FlashCrowd(1, 2, 4.0),),
    )


def _row(res, dumps):
    """One epoch's outcome, comparable across packages."""
    return (
        dumps(res.batch),
        res.accepted,
        [x.compact() for x in res.fault_log],
        res.coin_flips,
        res.shares_verified,
        res.agreement_epochs,
    )


def _port(n, seed, **kw):
    return PC.PackedHoneyBadgerCosim(n, random.Random(seed), device="cpu", **kw)


def _dict(n, seed):
    return PSim(n, random.Random(seed), mock=True, ops=CudaBackend(device="cpu"))


def _forged(kw, share):
    out = dict(kw)
    if "forged_dec" in out:
        out["forged_dec"] = {s: {p: share for p in t} for s, t in out["forged_dec"].items()}
    return out


def _epoch_kw(e, n, f):
    """test_cosim's adversaries, with plain targets (shares filled per side)."""
    if e == 1 and f >= 1:
        return dict(dead={0}, forged_dec={n - 1: {1}})
    if e == 2 and n >= 13:
        return dict(late_subset={2: set(range(6))})
    if e == 3 and f >= 2:
        # enough forgers to push a proposer below t+1 valid
        return dict(forged_dec={s: {1} for s in range(f, n)})
    return {}


@pytest.mark.parametrize("n", [4, 13, 64])
@pytest.mark.parametrize("seed", [42, 7])
def test_matches_reference_packed_and_own_dict_plane(n, seed):
    rr, rp, rd = random.Random(seed), random.Random(seed), random.Random(seed)
    ref = RC.PackedHoneyBadgerCosim(n, rr)
    port = PC.PackedHoneyBadgerCosim(n, rp, device="cpu")
    twin = PSim(n, rd, mock=True, ops=CudaBackend(device="cpu"))
    for e in range(4):
        kw = _epoch_kw(e, n, port.num_faulty)
        a = ref.run_epoch(_contribs(n, e), **_forged(kw, R_FORGED))
        b = port.run_epoch(_contribs(n, e), **_forged(kw, P_FORGED))
        c = twin.run_epoch(_contribs(n, e), **_forged(kw, P_FORGED))
        assert _row(b, pdumps) == _row(a, rdumps) == _row(c, pdumps), (n, seed, e)
    # rng lockstep held across all epochs — every draw matched
    assert rr.random() == rp.random() == rd.random()
    assert np.array_equal(port.commit_counts(), ref.commit_counts())


def test_nondef_coin_path():
    # n = 13, f = 4: a 6-live late_subset gives c1 = 6 ≥ f+1 and c0 = 7 ≥
    # f+1 — the non-definite branch that flips a real coin
    n = 13
    kw = dict(late_subset={2: set(range(6))})
    a = RC.PackedHoneyBadgerCosim(n, random.Random(7)).run_epoch(_contribs(n, 0), **kw)
    b = _port(n, 7).run_epoch(_contribs(n, 0), **kw)
    c = _dict(n, 7).run_epoch(_contribs(n, 0), **kw)
    assert b.coin_flips == 1 and b.agreement_epochs[2] in (2, 3)
    assert _row(b, pdumps) == _row(a, rdumps) == _row(c, pdumps)


def test_decryption_collapse():
    # 9 of 13 senders forge their share of proposer 1: valid = 13 - 9 =
    # 4 ≤ f, so decryption fails and pid 1 leaves the batch
    n = 13
    kw = dict(forged_dec={s: {1} for s in range(4, n)})
    a = RC.PackedHoneyBadgerCosim(n, random.Random(9)).run_epoch(_contribs(n, 0), **_forged(kw, R_FORGED))
    b = _port(n, 9).run_epoch(_contribs(n, 0), **_forged(kw, P_FORGED))
    c = _dict(n, 9).run_epoch(_contribs(n, 0), **_forged(kw, P_FORGED))
    assert any("SHARE_DECRYPTION_FAILED" in x.compact() for x in b.fault_log)
    assert 1 not in b.batch.contributions
    assert _row(b, pdumps) == _row(a, rdumps) == _row(c, pdumps)


def test_unsupported_adversaries_raise():
    packed = _port(4, 0)
    with pytest.raises(ValueError):
        packed.run_epoch(_contribs(4, 0), corrupt_shards={0: {1}})
    # the divergent view classes run on the dict plane only, as in the
    # reference's packed co-sim
    for k in ("divergent", "div_schedule"):
        with pytest.raises(ValueError, match=k):
            packed.run_epoch(_contribs(4, 0), **{k: object()})
    with pytest.raises(TypeError):
        packed.run_epoch(_contribs(4, 0), bogus_adversary=1)
    with pytest.raises(ValueError):
        PC.PackedHoneyBadgerCosim(4, random.Random(0), mock=False, device="cpu")
    with pytest.raises(ValueError):
        packed.run_epoch(_contribs(4, 0), dead={0, 1})  # past f = 1


def test_dirty_buffers_do_not_carry_over():
    """An epoch with override rows and forged counts, then one without:
    the second must see cleared columns, as the reference's zeroed
    leases give it."""
    n = 13
    ref = RC.PackedHoneyBadgerCosim(n, random.Random(5))
    port = _port(n, 5)
    plans = [
        dict(late_subset={2: set(range(6)), 7: {0, 1}}, forged_dec={s: {1, 3} for s in range(4, n)}),
        {},
        dict(forged_dec={12: {0}}),
        {},
    ]
    for e, kw in enumerate(plans):
        a = ref.run_epoch(_contribs(n, e), **_forged(kw, R_FORGED))
        b = port.run_epoch(_contribs(n, e), **_forged(kw, P_FORGED))
        assert _row(b, pdumps) == _row(a, rdumps), e
    assert b.fault_log.is_empty() and b.coin_flips == 0
    assert np.array_equal(port.commit_counts(), ref.commit_counts())


def test_wan_twin_matches_reference_and_dict_planes():
    """One WanModel (partition window, correlated zone failure, pareto
    tails) drives the reference's packed sim, the port's packed sim and
    the port's and the reference's dict planes (``wan=``)."""
    from hbbft_tpu.harness.epoch import VectorizedHoneyBadgerSim as RSim

    n = 13
    rm, pm = _wan_model(RW), _wan_model(PW)
    rngs = [random.Random(5) for _ in range(4)]
    ref = RC.PackedHoneyBadgerCosim(n, rngs[0], wan=rm)
    port = PC.PackedHoneyBadgerCosim(n, rngs[1], wan=pm, device="cpu")
    rdict = RSim(n, rngs[2], mock=True)
    pdict = PSim(n, rngs[3], mock=True, ops=CudaBackend(device="cpu"))
    for e in range(4):
        a = ref.run_epoch(_contribs(n, e))
        b = port.run_epoch(_contribs(n, e))
        c = pdict.run_epoch(_contribs(n, e), wan=pm)
        d = rdict.run_epoch(_contribs(n, e), wan=rm)
        assert _row(b, pdumps) == _row(a, rdumps) == _row(c, pdumps) == _row(d, rdumps), e
    assert len({r.random() for r in rngs}) == 1
    # a late_subset passed beside wan= wins over the model's entry
    kw = dict(late_subset={4: set(range(n))})
    c = pdict.run_epoch(_contribs(n, 4), wan=pm, **kw)
    d = rdict.run_epoch(_contribs(n, 4), wan=rm, **kw)
    assert _row(c, pdumps) == _row(d, rdumps)


def test_queueing_lockstep():
    n = 13
    rngs = [random.Random(21) for _ in range(3)]
    rq = RC.PackedQueueingCosim(n, rngs[0], batch_size=20)
    pq = PC.PackedQueueingCosim(n, rngs[1], batch_size=20, device="cpu")
    dq = PQSim(n, rngs[2], batch_size=20, mock=True, ops=CudaBackend(device="cpu"))
    txs = [b"t%03d" % i for i in range(200)]
    for q in (rq, pq, dq):
        q.input_all(txs)
    for e in range(4):
        kw = dict(dead={0}) if e == 2 else {}
        a, b, c = rq.run_epoch(**kw), pq.run_epoch(**kw), dq.run_epoch(**kw)
        assert _row(b, pdumps) == _row(a, rdumps) == _row(c, pdumps), e
        assert len(pq.queue) == len(rq.queue) == len(dq.queue)
    assert len({r.random() for r in rngs}) == 1


def test_queueing_wan_twin():
    from hbbft_tpu.harness.epoch import VectorizedQueueingSim as RQSim

    n = 13
    rm, pm = _wan_model(RW, seed=23), _wan_model(PW, seed=23)
    rngs = [random.Random(31) for _ in range(4)]
    rq = RC.PackedQueueingCosim(n, rngs[0], batch_size=20, wan=rm)
    pq = PC.PackedQueueingCosim(n, rngs[1], batch_size=20, wan=pm, device="cpu")
    dq = PQSim(n, rngs[2], batch_size=20, mock=True, ops=CudaBackend(device="cpu"))
    rdq = RQSim(n, rngs[3], batch_size=20, mock=True)
    txs = [b"w%03d" % i for i in range(200)]
    for q in (rq, pq, dq, rdq):
        q.input_all(txs)
    for e in range(4):
        assert pq.arrival_factor() == rq.arrival_factor()
        a, b = rq.run_epoch(), pq.run_epoch()
        c, d = dq.run_epoch(wan=pm), rdq.run_epoch(wan=rm)
        assert _row(b, pdumps) == _row(a, rdumps) == _row(c, pdumps) == _row(d, rdumps), e
        assert len(pq.queue) == len(rq.queue) == len(dq.queue) == len(rdq.queue)
    assert len({r.random() for r in rngs}) == 1


def test_reach_is_copied_from_a_buffer_the_sim_owns():
    """The epoch's ``[Z, Z]`` reach goes to the step from one buffer the
    sim owns (pinned beside a card; copied in the ``to_card`` stage),
    refilled every epoch: the WAN partition epoch's reach, which cuts
    zones {0, 1} from zone 2, differs from the epoch before's and still
    gives the reference's epoch."""
    n = 13
    ref = RC.PackedHoneyBadgerCosim(n, random.Random(5), wan=_wan_model(RW))
    port = PC.PackedHoneyBadgerCosim(n, random.Random(5), wan=_wan_model(PW), device="cpu")
    buf = port._reach_h
    assert tuple(buf.shape) == (3, 3) and buf.dtype == torch.uint8
    seen = []
    for e in range(3):
        a, b = ref.run_epoch(_contribs(n, e)), port.run_epoch(_contribs(n, e))
        assert _row(b, pdumps) == _row(a, rdumps), e
        assert port._reach_h is buf
        assert np.array_equal(buf.numpy(), port.wan.epoch_view(e).reach)
        seen.append(buf.clone())
    assert not torch.equal(seen[0], seen[1])  # epoch 1 is the partition window
    assert seen[1][0, 2] == seen[1][1, 2] == seen[1][2, 0] == 0
    assert np.array_equal(port.commit_counts(), ref.commit_counts())


def _stats(s):
    return (s.epoch, s.n, s.accepted, s.coin_flips, s.bytes_per_validator, s.mesh_devices)


def test_scale_mode_stats_match_reference():
    rm, pm = _wan_model(RW), _wan_model(PW)
    for n, kw in ((64, {}), (64, {"wan": True}), (200, {"wan": True})):
        ref = RC.PackedHoneyBadgerCosim(n, random.Random(0), wan=rm if kw else None)
        port = _port(n, 0, wan=pm if kw else None)
        for dead in (None, {0}, set(range(n - n // 50, n)), None):
            a, b = ref.run_epoch_packed(dead=dead), port.run_epoch_packed(dead=dead)
            assert _stats(b) == _stats(a)
            assert b.wall_s > 0 and b.peak_rss_bytes > 0
        assert np.array_equal(port.commit_counts(), ref.commit_counts())
    sim = _port(64, 0)
    s = sim.run_epoch_packed()
    assert s.n == 64 and s.accepted == 64 and s.coin_flips == 0
    assert s.bytes_per_validator == 8.0 and s.mesh_devices == 1
    s2 = sim.run_epoch_packed(dead={0})
    assert s2.epoch == 1 and s2.accepted == 63
    counts = sim.commit_counts()
    assert counts[1] == 2 and counts[0] == 1
    assert set(sim.last_phases) == {"masks", "to_card", "step", "from_card", "wan_view"}


@pytest.mark.parametrize("n", [13, 64])
def test_mesh_of_four_cpu_shards_equals_one(n):
    """``make_mesh(4, device="cpu")``: the instance axis padded to four
    equal blocks, the [Z] histograms ring-reduced; every epoch and the
    commit counters equal the single device's."""
    pm = _wan_model(PW)
    single = _port(n, 3, wan=pm)
    shard = PC.PackedHoneyBadgerCosim(n, random.Random(3), wan=pm, mesh=PMesh.make_mesh(4, device="cpu"))
    assert shard.mesh_devices == 4 and single.mesh_devices == 1
    for e in range(3):
        kw = dict(late_subset={5: set(range(n // 2))}) if e == 1 else {}
        a = single.run_epoch(_contribs(n, e), **kw)
        b = shard.run_epoch(_contribs(n, e), **kw)
        assert _row(b, pdumps) == _row(a, pdumps), e
    for _ in range(2):
        assert _stats(shard.run_epoch_packed(dead={1}))[2:4] == _stats(single.run_epoch_packed(dead={1}))[2:4]
    assert np.array_equal(single.commit_counts(), shard.commit_counts())


def _random_columns(rng, n, n_pad, Z):
    """Random step columns, the rows past n zero (cosim_pad's padding)."""
    cols = {
        "prop_on": rng.integers(0, 2, n, dtype=np.int8),
        "dst_on": (rng.random(n) < 0.9).astype(np.int8),
        "zone": np.sort(rng.integers(0, Z, n)).astype(np.int32),
        "ovr_mask": (rng.random(n) < 0.1).astype(np.int8),
        "ovr_c1": rng.integers(0, n + 1, n, dtype=np.int32),
        "forged_cnt": np.where(rng.random(n) < 0.1, rng.integers(0, n + 1, n), 0).astype(np.int32),
        "commit": rng.integers(0, 100, n, dtype=np.int32),
    }
    for k, v in cols.items():
        cols[k] = np.concatenate([v, np.zeros(n_pad - n, dtype=v.dtype)])
    reach = (rng.random((Z, Z)) < 0.7).astype(np.uint8)
    return cols, reach


ORDER = ("prop_on", "dst_on", "zone", "ovr_mask", "ovr_c1", "forged_cnt", "commit")


@pytest.mark.parametrize(
    "n,Z",
    [(n, Z) for n in (13, 64, 301) for Z in (1, 3, 5)]
    # the kernels' tail shapes: no row, one, a chunk of 16 and one more, a
    # partial block; Z = 257 takes a second 256-zone window
    + [(n, 257) for n in (0, 1, 17, 4097)],
)
def test_step_matches_reference_body(n, Z):
    """The port's step (``packed_cosim_step_fn``, one CPU device and a
    4-shard CPU mesh) against the reference's ``_body`` under
    ``jax.jit``, on random columns padded to four shards: every output
    byte and the advanced commit column."""
    rng = np.random.default_rng(Z * 1000 + n)
    n_pad = RM.cosim_pad(n, 4)
    assert PMesh.cosim_pad(n, 4) == n_pad
    cols, reach = _random_columns(rng, n, n_pad, Z)
    f = (n - 1) // 3
    for n_live in (n, n - f, n - f - 1):
        params = np.asarray([n_live, f], dtype=np.int32)
        want = RM.packed_cosim_step_fn(None, Z)(
            *(cols[k] for k in ORDER[:3]), reach, *(cols[k] for k in ORDER[3:]), params
        )
        want = [np.asarray(w) for w in want]
        assert want[0].dtype == np.int8 and want[3].dtype == np.int32
        if n_live >= n - f:  # inside the fault bound, padding rows are definite-0
            assert not want[0][n:].any() and not want[1][n:].any()
        t = {k: torch.from_numpy(v.copy()) for k, v in cols.items()}
        got = PMesh.packed_cosim_step_fn(None, Z)(
            *(t[k] for k in ORDER[:3]), torch.from_numpy(reach), *(t[k] for k in ORDER[3:]),
            (n_live, f),
        )
        assert got[3] is t["commit"]  # advanced in place
        for g, w in zip(got, want):
            assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w)
        mesh = PMesh.make_mesh(4, device="cpu")
        b = n_pad // 4
        shards = {k: [torch.from_numpy(v[j * b : (j + 1) * b].copy()) for j in range(4)]
                  for k, v in cols.items()}
        got = PMesh.packed_cosim_step_fn(mesh, Z)(
            *(shards[k] for k in ORDER[:3]), torch.from_numpy(reach),
            *(shards[k] for k in ORDER[3:]), (n_live, f),
        )
        for g, w in zip(got, want):
            assert np.array_equal(torch.cat(g).numpy(), w)
    with pytest.raises(ValueError):  # a reach of another Z
        PMesh.packed_cosim_step_fn(None, Z + 1)(
            *(t[k] for k in ORDER[:3]), torch.from_numpy(reach), *(t[k] for k in ORDER[3:]),
            (n, f),
        )


@pytest.mark.parametrize("Z", [1, 5, 300])
def test_step_matches_reference_body_in_every_decision_class(Z):
    """chip_smoke.py's step columns (the ones its card check uses) at
    n = 3,001 on a 4-shard CPU mesh against the reference's ``_body``
    byte for byte, Z = 300 included (past the kernels' 256 shared zone
    counters); the rows without an override come out definite-0, nondef
    and definite-1 (no definite-1 at Z = 1, where all see one count)."""
    import chip_smoke as cs

    n = 3001
    n_pad = PMesh.cosim_pad(n, 4)
    cols, reach = cs.cosim_columns(np.random.default_rng(Z), n, Z, n_pad)
    n_live, f = n - n // 50, (n - 1) // 3
    want = RM.packed_cosim_step_fn(None, Z)(
        *(cols[k] for k in ORDER[:3]), reach, *(cols[k] for k in ORDER[3:]),
        np.asarray([n_live, f], dtype=np.int32),
    )
    want = [np.asarray(w) for w in want]
    classes = cs.cosim_classes(want[0], want[1], cols["ovr_mask"], n)
    assert min(classes[: 2 if Z == 1 else 3]) >= 1, classes
    mesh = PMesh.make_mesh(4, device="cpu")
    b = n_pad // 4
    shards = {k: [torch.from_numpy(v[j * b : (j + 1) * b].copy()) for j in range(4)]
              for k, v in cols.items()}
    got = PMesh.packed_cosim_step_fn(mesh, Z)(
        *(shards[k] for k in ORDER[:3]), torch.from_numpy(reach),
        *(shards[k] for k in ORDER[3:]), (n_live, f),
    )
    for g, w in zip(got, want):
        assert np.array_equal(torch.cat(g).numpy(), w)


def test_step_wrappers_check_their_columns_and_count_no_launch_on_the_cpu():
    cols, reach = _random_columns(np.random.default_rng(1), 10, 12, 3)
    t = {k: torch.from_numpy(v) for k, v in cols.items()}
    before = dict(cuda_ec.LAUNCHES)
    a = CS.cosim_hist(t["dst_on"], t["zone"], 3)
    assert a.dtype == torch.int32 and a.tolist() == np.bincount(
        cols["zone"], weights=cols["dst_on"], minlength=3).astype(int).tolist()
    assert cuda_ec.LAUNCHES == before  # CPU tensors never count a launch
    with pytest.raises(ValueError):
        CS.cosim_hist(t["dst_on"].to(torch.int32), t["zone"], 3)
    with pytest.raises(ValueError):
        CS.cosim_decide(t["prop_on"], t["zone"], torch.from_numpy(reach), t["ovr_mask"],
                        t["ovr_c1"], t["forged_cnt"], t["commit"][:5], a, 10, 3)
    with pytest.raises(ValueError):
        CS.cosim_hist(t["dst_on"], t["zone"], 0)
    # zones outside [0, Z) add nothing, and their reach row is clamped
    zone = torch.tensor([-1, 0, 5, 2], dtype=torch.int32)
    ones = torch.ones(4, dtype=torch.int8)
    assert CS.cosim_hist(ones, zone, 3).tolist() == [1, 0, 1]


def test_cosim_sweep_patches_apply():
    """scripts/torch_cosim_sweep.py's variants patch copies of
    csrc/cosim_step.cu by text: every anchor must be in the source once,
    and the row counts it builds are ones the source takes."""
    import importlib.util
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "torch_cosim_sweep", root / "scripts" / "torch_cosim_sweep.py")
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)
    src = (root / "hbbft_tpu_torch" / "csrc" / "cosim_step.cu").read_text()
    assert "ROWS == 4 || ROWS == 8 || ROWS == 16" in src
    for label, patches in sweep.VARIANTS.items():
        for old, _ in patches:
            assert src.count(old) == 1, (label, old)
