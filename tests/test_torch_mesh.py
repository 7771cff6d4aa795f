"""The mesh-sharded product flush of the port (``parallel/mesh.py``).

On CPU shards (``make_mesh(4, device="cpu")``) every kernel runs its
plain version, and the reference runs on the conftest's virtual 8-device
CPU mesh.  Held exactly:

- ``ring_permute_plain`` against ``jax.lax.ppermute`` under
  ``shard_map`` (the bit-identical CPU form of the Pallas
  ``ring_permute``, ``pallas_ec.py:908-917``);
- ``_ring_reduce``'s limbs on every shard against the reference's
  ``_ring_reduce(..., "ppermute")``;
- ``_put_shard_blocks`` against the reference's, gathered;
- the mesh product and flat MSMs against ``CpuBackend`` of both
  packages, by wire bytes;
- the routing (1-shard collapse, non-uniform groups, the ring's
  launches) and a whole ``BatchingBackend`` flush with one corrupted
  share against the reference's verdicts and attribution.
"""

import random

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from hbbft_tpu.crypto import curve as RC
from hbbft_tpu.crypto import fields as RF
from hbbft_tpu.crypto.backend import CpuBackend as RefCpu
from hbbft_tpu.harness import batching as RB
from hbbft_tpu.ops import ec_jax as RE
from hbbft_tpu.ops import packed_msm as RP
from hbbft_tpu.parallel import mesh as RM
from hbbft_tpu_torch import state
from hbbft_tpu_torch.crypto import curve as PC
from hbbft_tpu_torch.crypto.backend import CpuBackend as PortCpu
from hbbft_tpu_torch.harness import batching as PB
from hbbft_tpu_torch.ops import cuda_ec
from hbbft_tpu_torch.ops import ec as PE
from hbbft_tpu_torch.ops import packed_msm as PP
from hbbft_tpu_torch.ops.backend_cuda import CudaBackend
from hbbft_tpu_torch.parallel import mesh as PM

# small tensors: intra-op threads only add contention beside the other
# test workers
torch.set_num_threads(1)

N_DEV = 4


def _ref_sharded(body):
    """``body`` under the reference's ``shard_map`` over 4 virtual CPU
    devices, every shard's output stacked on the leading axis."""
    spec = P(RM.AXIS)
    return jax.jit(
        RM.shard_map(body, mesh=RM.make_mesh(N_DEV), in_specs=(spec,), out_specs=spec)
    )


def _split(x: np.ndarray):
    return [torch.from_numpy(b.copy()) for b in np.split(x, N_DEV)]


@pytest.mark.parametrize("rows", [64, 5])
def test_ring_permute_plain_matches_ppermute(rows):
    x = np.random.default_rng(rows).integers(
        -(2**31), 2**31, size=(N_DEV * rows, 3, 38), dtype=np.int32
    )
    perm = [(i, (i + 1) % N_DEV) for i in range(N_DEV)]
    want = np.asarray(_ref_sharded(lambda b: jax.lax.ppermute(b, RM.AXIS, perm))(x))
    mesh = PM.make_mesh(N_DEV, device="cpu")
    got = cuda_ec.ring_permute(_split(x), mesh)
    assert all(g.device == torch.device("cpu") for g in got)
    assert np.array_equal(torch.cat(got).numpy(), want)
    assert np.array_equal(
        torch.cat(cuda_ec.ring_permute_plain(_split(x), mesh)).numpy(), want
    )


@pytest.mark.parametrize(
    "cards,want",
    [
        ([0, 0, 0, 0], [[0, 1, 2, 3]]),  # one card: one launch a round
        ([0, 1, 2, 3], [[0], [1], [2], [3]]),  # four cards: one launch each
        ([0, 1, 0, 1], [[0, 2], [1, 3]]),  # mixed: each card its own senders
        ([1, 1, 0, 0, 1], [[0, 1, 4], [2, 3]]),  # cards in order of their first shard
        ([0] * 10, [list(range(8)), [8, 9]]),  # past the job table: split
        ([0], [[0]]),
    ],
    ids=["one-card", "four-cards", "interleaved", "first-shard-order", "split", "one-shard"],
)
def test_ring_plan_groups_copies_by_sending_card(cards, want):
    """The batched ring's job plan on a mesh of fake cards (no CUDA
    needed): one launch per sending card per round, each with at most
    RING_MAX_JOBS copies, every shard sending exactly once."""
    devices = [torch.device("cuda", c) for c in cards]
    plan = cuda_ec.ring_plan(devices)
    assert plan == want
    assert sorted(j for launch in plan for j in launch) == list(range(len(cards)))
    for launch in plan:
        assert len(launch) <= cuda_ec.RING_MAX_JOBS
        assert len({devices[j] for j in launch}) == 1


def test_ring_copies_take_only_cuda_tensors():
    """The ring's copies never fall back: CPU tensors are refused, as is a
    job list that does not pair up."""
    with pytest.raises(ValueError, match="cuda"):
        cuda_ec.ring_copy(torch.zeros(3), torch.zeros(3), None)
    with pytest.raises(ValueError, match="destinations"):
        cuda_ec.ring_copies([torch.zeros(3)], [], None)


def test_ring_copies_take_at_most_one_job_table():
    """One call is one launch: more copies than the kernel's job table
    holds are refused, not split (ring_plan splits a round)."""
    n = cuda_ec.RING_MAX_JOBS + 1
    with pytest.raises(ValueError, match="at most"):
        cuda_ec.ring_copies([torch.zeros(3)] * n, [torch.zeros(3)] * n, None)


def test_ring_permute_rejects_a_buffer_off_its_shard():
    mesh = PM.Mesh([torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="2 shards"):
        cuda_ec.ring_permute([torch.zeros(3)], mesh)
    with pytest.raises(ValueError, match="shape or dtype"):
        cuda_ec.ring_permute([torch.zeros(3), torch.zeros(4)], mesh)


def _random_points(rng, k, curve, n_inf=1):
    ks = [rng.randrange(1, 1 << 64) for _ in range(k - n_inf)]
    return [curve.G1_GEN * s for s in ks] + [curve.G1.infinity()] * n_inf


def test_ring_reduce_limbs_match_reference():
    """G = 2 group partials a shard; each shard's accumulated limbs
    equal the reference's on that shard."""
    pts = _random_points(random.Random(0xB1), N_DEV * 2, PC)
    x = PE.g1_to_limbs(pts).reshape(N_DEV * 2, 3, 38)
    kern = RE.g1_kernel()
    want = np.asarray(
        _ref_sharded(lambda b: RM._ring_reduce(b, kern, N_DEV, "ppermute"))(x)
    )
    mesh = PM.make_mesh(N_DEV, device="cpu")
    got = PM._ring_reduce(_split(x), PE.g1_kernel().add, mesh)
    assert np.array_equal(torch.cat(got).numpy(), want)
    # replicated: every shard holds the same points
    sums = [[PE.g1_from_limbs(g[i].numpy()) for i in range(2)] for g in got]
    assert all(s == sums[0] for s in sums)
    assert sums[0][0] == pts[0] + pts[2] + pts[4] + pts[6]


@pytest.mark.parametrize("n", [8, 5, 3], ids=["n%4==0", "n=5", "n<n_dev"])
@pytest.mark.parametrize("width", [96, 12])
def test_put_shard_blocks_matches_reference(n, width):
    g_dev = 3
    rows = np.random.default_rng(n * width).integers(
        1, 256, size=(g_dev * n, width), dtype=np.uint8
    )
    want = np.asarray(
        RP._put_shard_blocks(rows, n, g_dev, N_DEV, "xla", RM.make_mesh(N_DEV), width=width)
    )
    blocks = PP._put_shard_blocks(rows, n, g_dev, PM.make_mesh(N_DEV, device="cpu"), width)
    assert len(blocks) == N_DEV
    assert all(b.shape == (g_dev * -(-n // N_DEV), width) for b in blocks)
    assert np.array_equal(torch.cat(blocks).numpy(), want)


@pytest.fixture(scope="module")
def batch():
    """The batch of tests/test_mesh_flush.py: 2 groups of 4, one
    infinity row, 96-bit s, full-width t, in both packages."""
    rng = random.Random(0x7E57)
    n_groups, n = 2, 4
    ks = [rng.randrange(1, RF.R) for _ in range(n_groups * n)]
    s = [rng.randrange(1, 1 << 96) for _ in range(n_groups * n)]
    t = [rng.randrange(1, RF.R) for _ in range(n_groups)]
    ref_pts = [RC.G1_GEN * k for k in ks]
    port_pts = [PC.G1_GEN * k for k in ks]
    ref_pts[3], port_pts[3] = RC.G1.infinity(), PC.G1.infinity()
    want = RefCpu().g1_msm_product_async(ref_pts, s, t, [n] * n_groups)().to_bytes()
    assert PortCpu().g1_msm_product_async(port_pts, s, t, [n] * n_groups)().to_bytes() == want
    return port_pts, s, t, [n] * n_groups, want


def _mesh_backend(n_dev):
    be = CudaBackend(device="cpu", mesh=PM.make_mesh(n_dev, device="cpu"))
    be.G1_PRODUCT_DEVICE_MIN = be.G1_DEVICE_MIN = 8
    return be


@pytest.fixture
def ring_spy(monkeypatch):
    """Counts the ring steps and the shards each step launches for."""
    calls = []
    real = cuda_ec.ring_permute

    def spy(bufs, mesh):
        calls.append(len(bufs))
        return real(bufs, mesh)

    monkeypatch.setattr(cuda_ec, "ring_permute", spy)
    return calls


def test_mesh_product_flush_matches_cpu_backends(batch, ring_spy):
    """g1_ship + g1_msm_product_async through the 4-shard engine: wire
    bytes of both packages' CpuBackend, 3 ring steps of 4 launches, and
    every shard's replicated group sums the same points."""
    pts, s, t, sizes, want = batch
    be = _mesh_backend(N_DEV)
    assert be._mesh_flush_active()
    shipped = be.g1_ship(pts, sizes)
    assert isinstance(shipped, PP.ShardedWires) and len(shipped.blocks) == N_DEV
    assert be.g1_msm_product_async(shipped, s, t, sizes)().to_bytes() == want
    assert ring_spy == [N_DEV] * (N_DEV - 1)
    sums = [[PE.g1_from_limbs(g[i].numpy()) for i in range(2)] for g in be.last_shard_sums]
    assert all(x == sums[0] for x in sums)


def test_mesh_product_unshipped_and_narrow_groups(batch):
    """An unshipped point list takes the mesh too, and a mesh of 8 has
    more shards than a group has points (trailing shards all padding)."""
    pts, s, t, sizes, want = batch
    for n_dev in (2, 8):
        mesh = PM.make_mesh(n_dev, device="cpu")
        fin = PP.g1_msm_product_async(pts, s, t, sizes, torch.device("cpu"), mesh)
        assert fin.shard_sums is not None and len(fin.shard_sums) == n_dev
        assert fin().to_bytes() == want


def test_one_shard_mesh_collapses(batch, ring_spy):
    pts, s, t, sizes, want = batch
    be = _mesh_backend(1)
    assert not be._mesh_flush_active()
    shipped = be.g1_ship(pts, sizes)
    assert isinstance(shipped, torch.Tensor)
    assert be.g1_msm_product_async(shipped, s, t, sizes)().to_bytes() == want
    assert ring_spy == [] and be.last_shard_sums is None


def test_non_uniform_groups_take_the_single_device_flat_path(batch, ring_spy):
    pts, s, t, _, _ = batch
    sizes = [3, 5]
    want = PortCpu().g1_msm_product_async(pts, s, t, sizes)()
    be = _mesh_backend(N_DEV)
    shipped = be.g1_ship(pts, sizes)
    assert isinstance(shipped, torch.Tensor)
    fin = be.g1_msm_product_async(shipped, s, t, sizes)
    assert fin.shard_sums is None and fin() == want
    assert ring_spy == []


def test_shipped_blocks_must_match_the_flush(batch):
    pts, s, t, sizes, _ = batch
    be = _mesh_backend(N_DEV)
    shipped = be.g1_ship(pts, sizes)
    with pytest.raises(ValueError):
        be.g1_msm_product_async(shipped, s, t[:1], [8])
    with pytest.raises(ValueError, match="not uniform"):
        PP.ship_shards(pts, [3, 5], be.mesh)


def test_sharded_flat_msm_matches_cpu_backend():
    """The flat MSM over the mesh (rows split 3/3/3/1 with padding) at
    128-bit scalars, and the size rule keeping small ones on the host."""
    rng = random.Random(0xF1A7)
    pts = _random_points(rng, 10, PC)
    ks = [rng.randrange(0, 1 << 128) for _ in pts]
    ks[2] = 0
    want = PortCpu().g1_msm(pts, ks)
    be = _mesh_backend(N_DEV)
    assert be.g1_msm(pts, ks) == want
    be.G1_DEVICE_MIN = 11
    assert be.g1_msm_async(pts, ks).__class__.__name__ == "EagerFinalizer"
    wires, sc = PP.g1_wires_batch(pts), PP.scalar_bytes_batch(ks, 16)
    total = PM.sharded_packed_msm(PM.make_mesh(3, device="cpu"), wires, sc)
    assert total.shape == (3, 38) and PE.g1_from_limbs(total.numpy()) == want


def test_make_mesh_on_cpu():
    mesh = PM.make_mesh(3, device="cpu")
    assert mesh.size == 3 and mesh.devices == [torch.device("cpu")] * 3
    assert mesh.streams == [None] * 3
    assert PM.make_mesh(device="cpu").size == 1
    with pytest.raises(ValueError):
        PM.make_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        CudaBackend(device="cpu", mesh=PM.Mesh([torch.device("meta")]))


N_SENDERS, N_GROUPS = 8, 4
BAD = 2 * N_SENDERS + 5


def _reference_obligations():
    from hbbft_tpu.crypto import threshold as RT

    rng = random.Random(0xF1A5)
    xs = [rng.randrange(1, RT.R) for _ in range(N_SENDERS)]
    pks = [RT.PublicKeyShare(RC.G2_GEN * x) for x in xs]
    master = RT.SecretKey.random(rng).public_key()
    obs = []
    for g in range(N_GROUPS):
        ct = master.encrypt(b"payload-%d" % g, rng)
        obs.extend(
            RB.DecObligation(pks[i], RT.DecryptionShare(ct.u * xs[i]), ct)
            for i in range(N_SENDERS)
        )
    ob = obs[BAD]
    obs[BAD] = RB.DecObligation(
        ob.pk_share, RT.DecryptionShare(ob.share.point * 7), ob.ciphertext
    )
    return obs


def test_mesh_flush_verdicts_match_reference(ring_spy):
    """``BatchingBackend(inner=CudaBackend(mesh=...))`` on 8 × 4 real
    shares with one corrupted share: the reference's verdicts, counts
    and attribution; the 32-share product ran on the 4-shard mesh."""
    ref_obs = _reference_obligations()
    port_obs = state.from_reference(state.to_arrays(ref_obs), device="cpu").obligations
    ref = RB.BatchingBackend(inner=RefCpu())
    ref.prefetch(ref_obs)
    inner = _mesh_backend(N_DEV)
    # the 32-share product runs on the mesh; the 8-share per-group
    # fallback checks stay on the host
    inner.G1_PRODUCT_DEVICE_MIN = inner.G1_DEVICE_MIN = 16
    port = PB.BatchingBackend(inner=inner)
    port.prefetch(port_obs)
    assert ring_spy == [N_DEV] * (N_DEV - 1)
    want = [ref.verify_dec_share(o.pk_share, o.share, o.ciphertext) for o in ref_obs]
    got = [port.verify_dec_share(o.pk_share, o.share, o.ciphertext) for o in port_obs]
    assert got == want and want.count(False) == 1 and got[BAD] is False
    for field in ("prefetched", "flushes", "cache_hits", "fallback_groups", "fallback_items"):
        assert getattr(port.stats, field) == getattr(ref.stats, field), field


# ---------------------------------------------------------------------------
# The sharded MSMs and the epoch's crypto step (reference mesh.py:89-141,
# :378-449), on tests/test_parallel.py's inputs
# ---------------------------------------------------------------------------


def _short_bits(scalars, nbits):
    return np.stack(
        [[(s >> (nbits - 1 - i)) & 1 for i in range(nbits)] for s in scalars]
    ).astype(np.int32)


def _g1_pair(rng, k, bound=RF.R):
    ks = [rng.randrange(1, bound) for _ in range(k)]
    return [RC.G1_GEN * s for s in ks], [PC.G1_GEN * s for s in ks]


@pytest.mark.parametrize("k,nbits", [(16, 16), (11, 12)])
def test_sharded_msm_fn_matches_reference_host(k, nbits):
    rng = random.Random(k)
    ref_pts, pts = _g1_pair(rng, k)
    scalars = [rng.randrange(1 << nbits) for _ in range(k)]
    run = PM.sharded_msm_fn(PM.make_mesh(N_DEV, device="cpu"))
    out = run(PE.g1_to_limbs(pts), _short_bits(scalars, nbits))
    assert out.shape == (3, 38)
    assert PE.g1_from_limbs(out).to_bytes() == RC.g1_multi_exp(ref_pts, scalars).to_bytes()


def test_sharded_msm_fn_g2_matches_reference_host():
    rng = random.Random(22)
    ks = [rng.randrange(1, RF.R) for _ in range(6)]
    scalars = [rng.randrange(1 << 12) for _ in range(6)]
    run = PM.sharded_msm_fn(PM.make_mesh(N_DEV, device="cpu"), g2=True)
    out = run(PE.g2_to_limbs([PC.G2_GEN * s for s in ks]), _short_bits(scalars, 12))
    want = RC.g2_multi_exp([RC.G2_GEN * s for s in ks], scalars)
    assert PE.g2_from_limbs(out).to_bytes() == want.to_bytes()


def test_sharded_windowed_and_bit_serial_host_msms_match_reference():
    rng = random.Random(24)
    ref_pts, pts = _g1_pair(rng, 24, 1 << 30)
    scalars = [rng.randrange(1, 1 << 16) for _ in range(24)]
    mesh = PM.make_mesh(N_DEV, device="cpu")
    want = RC.g1_multi_exp(ref_pts, scalars).to_bytes()
    assert PM.sharded_windowed_g1_msm(pts, scalars, mesh=mesh, nbits=16).to_bytes() == want
    # the host wrapper's 255-bit scalars, one point a shard
    assert PM.sharded_g1_msm(pts[:4], scalars[:4], mesh=mesh).to_bytes() == (
        RC.g1_multi_exp(ref_pts[:4], scalars[:4]).to_bytes())
    assert PM.sharded_g1_msm([], [], mesh=mesh).is_infinity()
    assert PM.sharded_windowed_g1_msm([], [], mesh=mesh).is_infinity()


def test_sharded_epoch_crypto_step_matches_reference_host():
    import hashlib

    from hbbft_tpu_torch.ops import sha256 as PS

    rng = random.Random(8)
    k, nbits = 8, 8
    sks = [rng.randrange(1, RF.R) for _ in range(k)]
    coeffs = [rng.randrange(1 << nbits) for _ in range(k)]
    msgs = [bytes([i]) * 20 for i in range(k)]
    step = PM.sharded_epoch_crypto_fn(PM.make_mesh(N_DEV, device="cpu"))
    agg1, agg2, digests = step(
        PE.g1_to_limbs([PC.G1_GEN * 7 * s for s in sks]),
        _short_bits(coeffs, nbits),
        PE.g2_to_limbs([PC.G2_GEN * s for s in sks]),
        PS.pad_messages(msgs)[:, 0, :],
    )
    assert PE.g1_from_limbs(agg1).to_bytes() == RC.g1_multi_exp(
        [RC.G1_GEN * 7 * s for s in sks], coeffs).to_bytes()
    assert PE.g2_from_limbs(agg2).to_bytes() == RC.g2_multi_exp(
        [RC.G2_GEN * s for s in sks], coeffs).to_bytes()
    assert digests.shape == (k, 8)
    assert PS.digests_to_bytes(digests) == [hashlib.sha256(m).digest() for m in msgs]


@pytest.mark.slow
def test_sharded_msm_fns_match_reference_sharded_programs():
    """Against the reference's own sharded XLA programs on 4 virtual CPU
    devices (they compile EC scans for minutes)."""
    import jax.numpy as jnp

    rng = random.Random(16)
    ref_pts, pts = _g1_pair(rng, 16)
    scalars = [rng.randrange(1 << 16) for _ in range(16)]
    bits = _short_bits(scalars, 16)
    want = RM.sharded_msm_fn(RM.make_mesh(N_DEV))(
        jnp.asarray(RE.g1_to_limbs(ref_pts)), jnp.asarray(bits))
    got = PM.sharded_msm_fn(PM.make_mesh(N_DEV, device="cpu"))(PE.g1_to_limbs(pts), bits)
    assert PE.g1_from_limbs(got).to_bytes() == RE.g1_from_limbs(want).to_bytes()
