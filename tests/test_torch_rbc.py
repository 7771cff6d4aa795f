"""The reliable-broadcast plane on the card's route, against the reference.

``CudaBackend(device="cpu")`` with every size rule at its floor
(``chip_smoke.forced``) sends each codec product through ``gf_matmul``'s
route, each hash batch of 8 or more uniform items through ``sha256``'s
and each batch of trees of 8 or more leaves through ``merkle_forest``'s
(their plain versions, on CPU tensors):

- the port's ``Broadcast`` over its ``TestNetwork`` (n = 7 and 16) against
  the reference's on its ``CpuBackend``, from one seed: outputs, message
  counts and wire bytes equal;
- a mock ``VectorizedHoneyBadgerSim`` epoch against the reference's:
  batches byte-equal (the epoch's parity, decode and dead-row products and
  its forests on the card's route), and at n = 16 with dead nodes,
  corrupt echo shards, a forced re-root mismatch and a failed decode,
  batches and fault logs entry for entry, on the forced card route and
  on ``CpuBackend``;
- ``_codec_matmul``'s GF(2^16) branch against ``gf16_matmul_device``;
- ``chip_smoke.py``'s phase 7 drivers at small sizes.
"""

import hashlib
import pathlib
import random
import sys

import numpy as np
import pytest
import torch

from hbbft_tpu.core.serialize import dumps as rdumps
from hbbft_tpu.harness import network as RN
from hbbft_tpu.harness.epoch import VectorizedHoneyBadgerSim as RSim
from hbbft_tpu.protocols.broadcast import Broadcast as RBroadcast
from hbbft_tpu_torch.core.serialize import dumps as pdumps
from hbbft_tpu_torch.crypto.backend import CpuBackend
from hbbft_tpu_torch.harness import network as PN
from hbbft_tpu_torch.harness.epoch import VectorizedHoneyBadgerSim as PSim
from hbbft_tpu_torch.harness.rbc_probe import RbcProbe
from hbbft_tpu_torch.ops import gf256 as GF
from hbbft_tpu_torch.ops.backend_cuda import CudaBackend
from hbbft_tpu_torch.parallel.mesh import make_mesh
from hbbft_tpu_torch.protocols.broadcast import Broadcast as PBroadcast

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)


def _forced():
    return cs.forced(CudaBackend(device="cpu"))


def _broadcast(N, Broadcast, dumps, ops, nodes, payload, seed):
    """Node 0 broadcasts ``payload``; returns every good node's outputs,
    the delivered count and a digest of (sender, recipient, wire bytes)."""
    rng = random.Random(seed)
    digest, count = hashlib.sha256(), [0]

    def tally(sender, recipient, message):
        count[0] += 1
        digest.update(repr((sender, recipient)).encode() + dumps(message))
        return True

    faulty = (nodes - 1) // 3
    net = N.TestNetwork(
        nodes - faulty, faulty,
        lambda adv: N.SilentAdversary(N.MessageScheduler(N.MessageScheduler.RANDOM, rng)),
        lambda ni: Broadcast(ni, 0), rng, ops=ops, message_filter=tally,
    )
    net.input(0, payload)
    net.step_until(lambda: all(n.terminated() for n in net.nodes.values()))
    return [n.outputs for n in net.nodes.values()], count[0], digest.hexdigest()


@pytest.mark.parametrize("nodes,size", [(7, 300), (16, 2000)])
def test_broadcast_on_the_cards_route_matches_reference(nodes, size):
    payload = random.Random(size).randbytes(size)
    ops = _forced()
    with RbcProbe(ops) as probe:
        port = _broadcast(PN, PBroadcast, pdumps, ops, nodes, payload, nodes)
    ref = _broadcast(RN, RBroadcast, rdumps, None, nodes, payload, nodes)
    assert port == ref
    assert all(out == [payload] for out in port[0])
    sent = probe.sent
    assert sent["gf_matmul"] > 0  # every decode's products on the card's route
    if nodes >= 8:
        assert sent["merkle_forest"] > 0  # the trees too, a forest of one each


def test_broadcast_driver_on_the_cpu():
    """``chip_smoke.broadcast_1mb`` at a small size: forced and host runs
    deliver the same messages."""
    card = cs.broadcast_1mb(_forced(), nodes=10, payload_bytes=1500, seed=3)
    host = cs.broadcast_1mb(CpuBackend(), nodes=10, payload_bytes=1500, seed=3)
    assert (card["messages"], card["digest"]) == (host["messages"], host["digest"])
    assert card["good"] == host["good"] == 7


def test_mock_epoch_on_the_cards_route_matches_reference():
    n, dead = 10, {9}
    contribs = {i: [b"rbc-%d" % i] for i in range(n) if i not in dead}
    ops = _forced()
    port = PSim(n, random.Random(21), mock=True, ops=ops)
    ref = RSim(n, random.Random(21), mock=True)
    assert isinstance(port.codec, GF.ReedSolomonDevice)
    with RbcProbe(ops, port) as probe:
        p = port.run_epoch(contribs, dead=dead)
    r = ref.run_epoch(contribs, dead=dead)
    assert pdumps(p.batch) == rdumps(r.batch)
    assert p.accepted == r.accepted and p.coin_flips == r.coin_flips
    # one parity, one decode and one dead-row product a wave; one forest of
    # commitments and one roots-only forest of reconstructions
    assert probe.sent == {"gf_matmul": 3, "sha256": 0, "merkle_forest": 2}


def test_rbc_split_covers_the_epochs_rbc():
    n, dead = 10, {9}
    contribs = {i: [b"rbc-%d" % i] for i in range(n) if i not in dead}
    sim = PSim(n, random.Random(5), mock=True, ops=CudaBackend(device="cpu"))
    with RbcProbe(sim.ref.ops, sim) as split:
        sim.run_epoch(contribs, dead=dead)
    assert split.calls == {"parity": 1, "decode": 1, "dead_rows": 1, "trees": 2,
                           "reroot": len(contribs)}
    assert split.shapes["parity"][:2] == (6, 4) and split.shapes["dead_rows"][:2] == (1, 4)
    # the default rules send its two forests (9 trees of 10 leaves, then 8)
    # to the card's route and keep its products on the host
    assert split.sent == {"sha256": 0, "merkle_forest": 2, "gf_matmul": 0}
    # every wrapper went with the context, and no module global was rebound
    assert not {"_codec_matmul", "_rbc_phase", "_reroot"} & set(vars(sim))
    assert not {"merkle_tree", "sha256_many", "rs_codec"} & set(vars(sim.ref.ops))
    assert "matmul" not in vars(sim.codec) and sim._reroot is PSim._reroot


def test_probe_follows_the_era_switch():
    """A probe per epoch of a dynamic sim sees each era's codec (the new
    era's made by the wrapped ``rs_codec``) and leaves no wrapper behind."""
    from hbbft_tpu_torch.harness.dynamic import VectorizedDynamicSim
    from hbbft_tpu_torch.protocols.change import Complete, Remove

    ops = _forced()
    sim = VectorizedDynamicSim(7, random.Random(1), mock=True, ops=ops)
    for v in range(3):
        sim.vote_for(v, Remove(6))
    old = sim.sim
    with RbcProbe(sim.ops, sim.sim) as first:
        r1 = sim.run_epoch({i: [b"c%d" % i] for i in range(7)})
    assert r1.change == Complete(Remove(6)) and sim.sim is not old
    with RbcProbe(sim.ops, sim.sim) as second:
        sim.run_epoch({i: [b"d%d" % i] for i in sim.validators})
    # a parity and a decode product an epoch; trees of 7 and 6 leaves stay
    # below the reference's 8
    assert first.sent == second.sent == {"sha256": 0, "merkle_forest": 0, "gf_matmul": 2}
    assert "matmul" not in vars(old.codec) and "matmul" not in vars(sim.sim.codec)
    assert not {"merkle_tree", "sha256_many", "rs_codec"} & set(vars(ops))


def _faulty_epoch(sim, reroot_patch, contribs, dead, corrupt):
    """One epoch of ``sim`` with the wave's decode product corrupted in
    proposers 5's and 9's columns (their reconstructions' roots then miss
    their commitments) and the third proposer's independent re-root
    tampered (``reroot_patch`` installs it), so that it replays the
    per-instance path."""
    k = sim.data
    wave = sorted(p for p in contribs if p not in corrupt)
    codec_matmul = sim._codec_matmul

    def corrupted(rows, byte_mat):
        out = codec_matmul(rows, byte_mat)
        if rows.shape == (k, k):  # the decode (parity and dead rows are not square)
            out = out.copy()
            width = out.shape[1] // len(wave)
            for pid in (5, 9):
                out[0, wave.index(pid) * width] ^= 0x5A
        return out

    calls = [0]

    def tamper(tree_cls):
        def reroot(values):
            tree = tree_cls(values)
            calls[0] += 1
            if calls[0] == 3:
                tree.levels = tree.levels[:-1] + [[bytes(32)]]
            return tree

        return reroot

    sim._codec_matmul = corrupted
    reroot_patch(tamper)
    return sim.run_epoch(contribs, dead=dead, corrupt_shards=corrupt)


@pytest.mark.parametrize("backend", ["forced_cuda_cpu", "cpu"])
def test_faulty_wave_matches_reference_fault_order(backend, monkeypatch):
    import hbbft_tpu.harness.epoch as REpoch

    n, dead = 16, {14, 15}
    contribs = {i: [b"w-%d" % i] for i in range(n) if i not in dead}
    corrupt = {7: {1: b"\x00" * 4, 3: b"\x01" * 4}}
    ops = _forced() if backend == "forced_cuda_cpu" else CpuBackend()
    port = PSim(n, random.Random(16), mock=True, ops=ops)

    def port_patch(tamper):
        port._reroot = tamper(PSim._reroot)

    def ref_patch(tamper):
        monkeypatch.setattr(REpoch, "_PyMerkleTree", tamper(REpoch._PyMerkleTree))

    with RbcProbe(port.ref.ops, port) as probe:
        p = _faulty_epoch(port, port_patch, contribs, dead, corrupt)
    r = _faulty_epoch(RSim(n, random.Random(16), mock=True), ref_patch, contribs, dead, corrupt)
    faults = [(f.node_id, f.kind.name) for f in p.fault_log]
    assert faults == [(f.node_id, f.kind.name) for f in r.fault_log]
    assert faults == [(5, "BROADCAST_DECODING_FAILED"), (9, "BROADCAST_DECODING_FAILED"),
                      (1, "INVALID_PROOF"), (3, "INVALID_PROOF")]
    assert pdumps(p.batch) == rdumps(r.batch) and p.accepted == r.accepted
    assert 2 in p.batch.contributions and 5 not in p.batch.contributions
    # the wave: a forest of 13 commitments, one dead-rows product and a
    # roots-only forest of the 12 that passed the re-root
    assert probe.calls["dead_rows"] == 1 and probe.shapes["dead_rows"][2] == 12 * probe.shapes[
        "parity"][2] // 13
    if backend == "forced_cuda_cpu":
        assert probe.sent["merkle_forest"] >= 2


def test_merkle_trees_equal_a_loop_of_merkle_tree():
    gen = np.random.default_rng(3)
    arr = gen.integers(0, 256, size=(4, 9, 5), dtype=np.uint8)
    groups = [[row.tobytes() for row in g] for g in arr]
    for be in (_forced(), CudaBackend(device="cpu"), CpuBackend()):
        loop = [be.merkle_tree(g) for g in groups]
        for batch in (groups, arr):
            trees = be.merkle_trees(batch)
            assert [t.levels for t in trees] == [t.levels for t in loop]
            assert [t.values for t in trees] == groups
            assert be.merkle_trees(batch, roots_only=True) == [t.root_hash for t in loop]
        assert all(t.proof(i).validate(9) for t in be.merkle_trees(arr) for i in range(9))
    # trees of different shapes are no forest: the host builds them
    mixed = [groups[0], groups[1][:8], [b"x" * 7] * 8]
    assert [t.levels for t in _forced().merkle_trees(mixed)] == [
        t.levels for t in CpuBackend().merkle_trees(mixed)]


def test_codec_matmul_gf16_branch_matches_gf16_matmul_device():
    k, m = 102, 198  # n = 300: the GF(2^16) codec
    sim = PSim.__new__(PSim)
    sim.codec = GF.ReedSolomonDevice16(k, m, device="cpu", rule=lambda *_: True)
    gen = np.random.default_rng(7)
    rows = sim._codec_mat()[k:k + 5]
    byte_mat = gen.integers(0, 256, size=(k, 2 * 9), dtype=np.uint8)
    got = sim._codec_matmul(rows, byte_mat)
    want = GF.gf16_matmul_device(rows, byte_mat.view("<u2"), device="cpu").numpy()
    assert np.array_equal(got, want.view(np.uint8))
    host = sim.codec._host_matmul(rows, byte_mat.view("<u2"))
    assert np.array_equal(got.view("<u2"), host)


def test_phase_7_checks_on_the_cpu():
    """``chip_smoke.py``'s kernel checks at small sizes, the kernels'
    plain versions standing in for them."""
    seen = set()

    def record_err(name, got, plain, what):
        assert torch.equal(got, plain), what
        seen.add(name)

    cs.sha_check(record_err, lengths=(0, 55, 64, 120), batches=(1, 7, 20), device="cpu")
    cs.merkle_check(record_err, leaves=(1, 2, 3, 11), lengths=(2, 100), forests=((3, 20, 2),),
                    big_leaves=40, device="cpu")
    cs.gf_check(record_err, 20, device="cpu", nodes8=7, payload=1000, nodes16=300, dead16=10)
    assert seen == {"sha256", "merkle_forest", "gf_matmul"}


def test_mesh_programs_driver_on_the_cpu():
    launches = cs.mesh_programs_check(make_mesh(2, device="cpu"), k=2, nbits=16)
    assert launches == dict.fromkeys(launches, {})  # CPU shards launch nothing
    assert len(launches) == 5
