"""The port's CUDA kernels on the card (marker ``cuda``).

These tests need a CUDA card, ``nvcc`` and the native host library; on
a host without a card they skip.  They import only torch and the port,
so they run on the GPU machine as they are:
``python -m pytest tests/test_torch_cuda.py -q``.

``win_g1``, ``win_g2`` and ``scan_g1`` must equal their plain PyTorch
versions at canonical values (``limbs.fq().canon``, tolerance 0) and
return canonical limbs, also on identity rows, zero scalars, digits
outside 0..15 and points given in non-canonical limbs.  All three must
equal native ``hb_g1_mul`` / ``hb_g2_mul`` canonically and count
exactly one launch per call; a small DKG with its fused MSM forced onto
the card must give the CPU run's keys.  ``ring_permute`` must equal its
plain version byte for byte on a 4-shard mesh, whichever shard's stream
runs late, and count one launch per sending card and round; the ring's
copies must also move misaligned and odd-sized buffers in one launch; a
small product flush over that mesh must give the host's point.
``fr_matmul`` must equal its plain version word for word and Python's
(acc + Σ a·b) mod r, on ragged shapes (paired tiles at m ≤ 2 among them)
and the worst cases at k = 971, the bound it takes, with one ``fr_matmul``
and two ``fr_planes`` launches a call; ``fr_planes`` must equal its plain
version byte for byte; and the clean elided DKG must take it by default
on the card and deal the CPU run's keys.  ``cosim_hist`` and
``cosim_step`` must equal their plain versions byte for byte at Z = 1, 5
and 300 (above the kernels' shared-memory zone counters), the whole step
one launch of ``cosim_step`` and none of ``cosim_hist``, with the 4-shard
mesh step equal to the one launch; so must the tail shapes n = 0, 1, 15,
16, 17, 4,097 at Z = 1, 5, 257 (the mesh step called twice, reusing its
scratch) and column views that are not 16-byte aligned; and the packed
co-sim on the card must equal its CPU run.  ``sha256`` (its words entry
and its raw-bytes entry, rows at every alignment), ``merkle_forest``
(every level and roots only, a tree above the shared-memory limit too)
and ``gf_matmul`` (W = 8 and 16, thin and one-column products too) must
equal their plain versions byte for byte and ``hashlib`` / ``MerkleTree``
/ the native products, with one launch a call (``merkle_levels_device``:
a forest of one), and a forced backend's broadcast must deliver the host
run's messages; ``sha256_many`` on the card pads nothing on the host.
"""

import random

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _assert_canonical_equal(got, plain):
    """The kernel's limbs are canonical and equal the plain version's
    canonical residues, coordinate by coordinate."""
    from hbbft_tpu_torch.ops import limbs as LB

    f = LB.fq()
    torch.cuda.synchronize()
    assert torch.equal(f.canon(got), got)
    assert torch.equal(got, f.canon(plain))


@pytest.mark.parametrize("bits", [96, 255])
def test_win_g1_kernel_matches_plain_and_native(dev, bits):
    from hbbft_tpu_torch import native as NT
    from hbbft_tpu_torch.crypto import fields as F
    from hbbft_tpu_torch.crypto.curve import G1_GEN
    from hbbft_tpu_torch.ops import cuda_ec, ec, packed_msm as PM

    rng = random.Random(bits)
    k = 300  # not a multiple of the 128-thread block
    wires = NT.g1_mul_many(NT.g1_wire(G1_GEN), [rng.randrange(1, F.R) for _ in range(k)])
    wires[7] = bytes(96)  # an identity row
    arr = np.frombuffer(b"".join(wires), dtype=np.uint8).reshape(k, 96).copy()
    pts = PM._wire_points_g1(torch.from_numpy(arr).to(dev))
    scalars = [rng.randrange(0, 1 << bits) % F.R for _ in range(k)]
    scalars[3] = 0
    sc = torch.from_numpy(PM.scalar_bytes_batch(scalars, (bits + 7) // 8)).to(dev)
    digits = PM._scalar_digits(sc)
    before = cuda_ec.LAUNCHES["win_g1"]
    got = cuda_ec.win_g1(pts, digits)
    assert cuda_ec.LAUNCHES["win_g1"] == before + 1
    _assert_canonical_equal(got, cuda_ec.windowed_plain(pts, digits))
    host = got.cpu().numpy()
    for i in range(k):
        assert NT.g1_wire(ec.g1_from_limbs(host[i])) == NT.g1_mul(wires[i], scalars[i])


def _g2_case(dev, rng, k):
    from hbbft_tpu_torch import native as NT
    from hbbft_tpu_torch.crypto import fields as F
    from hbbft_tpu_torch.crypto.curve import G2_GEN
    from hbbft_tpu_torch.ops import packed_msm as PM

    ks = PM.scalar_bytes_batch([rng.randrange(1, F.R) for _ in range(k)], 32)
    raw = NT.g2_mul_many_raw(NT.g2_wire(G2_GEN), ks).reshape(k, 192)
    raw[7] = 0  # an identity row
    wires = [raw[i].tobytes() for i in range(k)]
    return wires, PM._wire_points_g2(torch.from_numpy(raw.copy()).to(dev))


def test_win_g2_kernel_matches_plain_and_native(dev):
    from hbbft_tpu_torch import native as NT
    from hbbft_tpu_torch.crypto import fields as F
    from hbbft_tpu_torch.ops import cuda_ec, ec, packed_msm as PM

    rng = random.Random(0x62)
    k = 300  # not a multiple of the 128-thread block
    wires, pts = _g2_case(dev, rng, k)
    scalars = [rng.randrange(0, F.R) for _ in range(k)]
    scalars[3] = 0
    digits = PM._scalar_digits(torch.from_numpy(PM.scalar_bytes_batch(scalars, 32)).to(dev))
    before = cuda_ec.LAUNCHES["win_g2"]
    got = cuda_ec.win_g2(pts, digits)
    assert cuda_ec.LAUNCHES["win_g2"] == before + 1
    _assert_canonical_equal(got, cuda_ec.windowed_g2_plain(pts, digits))
    host = got.cpu().numpy()
    for i in range(k):
        assert NT.g2_wire(ec.g2_from_limbs(host[i])) == NT.g2_mul(wires[i], scalars[i])


def _non_canonical(limbs: np.ndarray, rng: random.Random) -> np.ndarray:
    """The same field values in other limbs, every limb in [−2^12, 2^12):
    per element one of v + p, a borrowed form (+2048 on limb i, −1 on
    limb i + 1: limbs in [−1, 4094], limb 37 = −1) and v + k·p just
    below 2^408."""
    from hbbft_tpu_torch.ops import limbs as LB

    f = LB.fq()
    flat = limbs.reshape(-1, LB.FQ_LIMBS).astype(np.int64)
    out = np.empty_like(flat)
    p_limbs = LB.int_to_limbs(f.p, LB.FQ_LIMBS).astype(np.int64)
    for r in range(flat.shape[0]):
        v = LB.limbs_to_int(flat[r])
        form = rng.randrange(3)
        if form == 0:
            out[r] = flat[r] + p_limbs
        elif form == 1:
            shift = np.full(LB.FQ_LIMBS, 2047, dtype=np.int64)
            shift[0], shift[-1] = 2048, -1
            out[r] = flat[r] + shift
        else:
            out[r] = LB.int_to_limbs(v + ((1 << 408) - 1 - v) // f.p * f.p, LB.FQ_LIMBS)
        assert LB.limbs_to_int(out[r]) % f.p == v % f.p
    assert np.abs(out).max() < 4096
    return out.reshape(limbs.shape).astype(np.int32)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_win_kernels_on_edge_inputs(dev, group):
    """Non-canonical input limbs (negative ones included), identity
    rows, zero scalars and digits outside 0..15 (which select the
    identity): the kernel's canonical limbs equal the plain version's
    canonical residues, and rows with in-range digits are native k·P."""
    from hbbft_tpu_torch import native as NT
    from hbbft_tpu_torch.crypto import fields as F
    from hbbft_tpu_torch.crypto.curve import G1_GEN
    from hbbft_tpu_torch.ops import cuda_ec, ec, packed_msm as PM

    rng = random.Random(0xED6E)
    k = 200
    if group == "g1":
        wires = NT.g1_mul_many(NT.g1_wire(G1_GEN), [rng.randrange(1, F.R) for _ in range(k)])
        wires[7] = bytes(96)
        arr = np.frombuffer(b"".join(wires), dtype=np.uint8).reshape(k, 96).copy()
        pts = PM._wire_points_g1(torch.from_numpy(arr).to(dev))
        kernel, plain, mul = cuda_ec.win_g1, cuda_ec.windowed_plain, NT.g1_mul
        to_wire, from_limbs = NT.g1_wire, ec.g1_from_limbs
    else:
        wires, pts = _g2_case(dev, rng, k)
        kernel, plain, mul = cuda_ec.win_g2, cuda_ec.windowed_g2_plain, NT.g2_mul
        to_wire, from_limbs = NT.g2_wire, ec.g2_from_limbs
    pts = torch.from_numpy(_non_canonical(pts.cpu().numpy(), rng)).to(dev)
    scalars = [rng.randrange(0, F.R) for _ in range(k)]
    scalars[3] = scalars[11] = 0
    digits = PM._scalar_digits(torch.from_numpy(PM.scalar_bytes_batch(scalars, 32)).to(dev))
    digits = digits.cpu()
    bad = [5, 9, 13]
    digits[5, 0], digits[9, 17], digits[13, -1] = 16, -1, 1 << 20
    digits = digits.to(dev)
    got = kernel(pts, digits)
    _assert_canonical_equal(got, plain(pts, digits))
    host = got.cpu().numpy()
    for i in range(k):
        if i not in bad:
            assert to_wire(from_limbs(host[i])) == mul(wires[i], scalars[i]), i


def test_scan_g1_kernel_matches_plain_and_native(dev):
    from hbbft_tpu_torch import native as NT
    from hbbft_tpu_torch.crypto import fields as F
    from hbbft_tpu_torch.crypto.curve import G1_GEN
    from hbbft_tpu_torch.ops import cuda_ec, ec, limbs as LB, packed_msm as PM

    rng = random.Random(0x5C)
    k = 300
    wires = NT.g1_mul_many(NT.g1_wire(G1_GEN), [rng.randrange(1, F.R) for _ in range(k)])
    wires[7] = bytes(96)
    arr = np.frombuffer(b"".join(wires), dtype=np.uint8).reshape(k, 96).copy()
    pts = PM._wire_points_g1(torch.from_numpy(arr).to(dev))
    scalars = [rng.randrange(0, F.R) for _ in range(k)]
    scalars[3] = 0
    bits = torch.from_numpy(LB.scalars_to_bits(scalars, 255)).to(dev)
    # the same points again in non-canonical limbs (negative ones included)
    odd = torch.from_numpy(_non_canonical(pts.cpu().numpy(), rng)).to(dev)
    for what, p in (("canonical", pts), ("non-canonical", odd)):
        before = cuda_ec.LAUNCHES["scan_g1"]
        got = cuda_ec.scan_g1(p, bits)
        assert cuda_ec.LAUNCHES["scan_g1"] == before + 1
        _assert_canonical_equal(got, cuda_ec.scan_plain(p, bits))
        host = got.cpu().numpy()
        for i in range(k):
            assert NT.g1_wire(ec.g1_from_limbs(host[i])) == NT.g1_mul(wires[i], scalars[i]), what


def test_dkg_on_the_card_matches_cpu(dev):
    """A DKG small enough for the CPU, with the fused MSM forced onto the
    card: the same keys as the CPU run, and win_g2 launched."""
    from hbbft_tpu_torch.harness.dkg import VectorizedDkg
    from hbbft_tpu_torch.ops import cuda_ec

    card = VectorizedDkg(range(7), 2, random.Random(5))
    card.G2_DEVICE_MIN = 0
    before = cuda_ec.LAUNCHES["win_g2"]
    got = card.run(verify_honest=True)
    assert cuda_ec.LAUNCHES["win_g2"] == before + 1
    want = VectorizedDkg(range(7), 2, random.Random(5), device="cpu").run(verify_honest=True)
    assert got.fault_log.is_empty() and got.msm_points == 7 * 9
    assert got.pk_set.public_key().to_bytes() == want.pk_set.public_key().to_bytes()
    assert all(got.shares[i].scalar == want.shares[i].scalar for i in range(7))


@pytest.mark.parametrize("rows", [64, 5])
def test_ring_permute_kernel_matches_plain(dev, rows):
    from hbbft_tpu_torch.ops import cuda_ec
    from hbbft_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(4)
    gen = np.random.default_rng(rows)
    bufs = [
        torch.from_numpy(
            gen.integers(-(2**31), 2**31, size=(rows, 3, 38), dtype=np.int32)
        ).to(d)
        for d in mesh.devices
    ]
    want = [w.cpu() for w in cuda_ec.ring_permute_plain(bufs, mesh)]
    # a long kernel on one shard's stream in turn: the result may not
    # depend on the order in which the shard streams run
    for late in [None, 0, 1, 2, 3]:
        if late is not None:
            with mesh.on(late):
                torch.cuda._sleep(2_000_000)
        before = cuda_ec.LAUNCHES["ring_permute"]
        got = cuda_ec.ring_permute(bufs, mesh)
        # one launch per sending card (1 on one card, 4 on four)
        assert cuda_ec.LAUNCHES["ring_permute"] == before + len(set(mesh.devices))
        torch.cuda.synchronize()
        for j in range(4):
            assert got[j].device == mesh.devices[j]
            assert torch.equal(got[j].cpu(), want[j]), (late, j)


def test_ring_copies_misaligned_and_odd_sizes_in_one_launch(dev):
    """One launch of three jobs: a misaligned pair (every byte on the
    byte path), an aligned job of 29 bytes (one int4 word and 13 bytes)
    and the flush's 29,184-byte message; the bytes around each
    destination stay as they were."""
    from hbbft_tpu_torch.ops import cuda_ec

    gen = np.random.default_rng(0xA116)
    src = torch.from_numpy(gen.integers(0, 256, size=40_000, dtype=np.uint8)).to(dev)
    dst = torch.zeros(40_000, dtype=torch.uint8, device=dev)
    jobs = [(3, 5, 517), (0, 1024, 29), (1536, 2048, 29_184)]  # (src at, dst at, bytes)
    before = cuda_ec.LAUNCHES["ring_permute"]
    cuda_ec.ring_copies(
        [src[a : a + n] for a, _, n in jobs],
        [dst[b : b + n] for _, b, n in jobs],
        torch.cuda.current_stream(dev),
    )
    assert cuda_ec.LAUNCHES["ring_permute"] == before + 1
    want = torch.zeros_like(dst)
    for a, b, n in jobs:
        want[b : b + n] = src[a : a + n]
    torch.cuda.synchronize()
    assert torch.equal(dst, want)


def test_mesh_product_flush_on_the_card(dev):
    from hbbft_tpu_torch.crypto import fields as F
    from hbbft_tpu_torch.crypto.backend import CpuBackend
    from hbbft_tpu_torch.crypto.curve import G1_GEN
    from hbbft_tpu_torch.ops import cuda_ec
    from hbbft_tpu_torch.ops.backend_cuda import CudaBackend
    from hbbft_tpu_torch.parallel.mesh import make_mesh

    rng = random.Random(0x7E57)
    pts = [G1_GEN * rng.randrange(1, F.R) for _ in range(24)]
    s = [rng.randrange(1, 1 << 96) for _ in pts]
    t = [rng.randrange(1, F.R) for _ in range(3)]
    sizes = [8, 8, 8]
    be = CudaBackend(mesh=make_mesh(4))
    be.G1_PRODUCT_DEVICE_MIN = 8
    before = dict(cuda_ec.LAUNCHES)
    got = be.g1_msm_product_async(be.g1_ship(pts, sizes), s, t, sizes)()
    assert cuda_ec.LAUNCHES["win_g1"] == before["win_g1"] + 4
    # 3 rounds, one launch per sending card each
    assert cuda_ec.LAUNCHES["ring_permute"] == before["ring_permute"] + 3 * len(set(be.mesh.devices))
    assert got == CpuBackend().g1_msm_product_async(pts, s, t, sizes)()


@pytest.mark.parametrize(
    "m,k,p,value",
    [(7, 5, 13, None), (1, 341, 40, None), (9, 971, 3, "r-1"), (2, 971, 33, "max256"), (1, 971, 2, "zero"),
     (2, 33, 25, None), (3, 352, 17, None)],
    ids=["odd", "lambda-row", "r-1-k971", "max256-k971", "zero-k971", "paired", "k352"],
)
def test_fr_matmul_kernel_matches_plain_and_bigint(dev, m, k, p, value):
    """fr_matmul on the card: word for word its plain version on the card,
    and Python's (acc + Σ a·b) mod r; one launch a call."""
    from hbbft_tpu_torch.crypto import fields as F
    from hbbft_tpu_torch.ops import cuda_ec, fr as FR

    rng = random.Random(k)
    full = {None: None, "r-1": F.R - 1, "max256": (1 << 256) - 1, "zero": 0}[value]

    def draw(n):
        return [rng.randrange(F.R) if full is None else full for _ in range(n)]

    A, B, ACC = draw(m * k), draw(k * p), draw(m * p)

    def words(vals, *shape):
        raw = b"".join(v.to_bytes(32, "little") for v in vals)
        return torch.from_numpy(np.frombuffer(raw, dtype="<i4").copy()).reshape(*shape, 8).to(dev)

    a, b, acc = words(A, m, k), words(B, k, p), words(ACC, m, p)
    before = dict(cuda_ec.LAUNCHES)
    got = FR.fr_matmul(a, b, acc)
    torch.cuda.synchronize()
    assert cuda_ec.LAUNCHES["fr_matmul"] == before["fr_matmul"] + 1
    assert cuda_ec.LAUNCHES["fr_planes"] == before["fr_planes"] + 2
    assert torch.equal(got, FR.fr_matmul_plain(a, b, acc))
    want = [
        (ACC[i * p + j] + sum(A[i * k + t] * B[t * p + j] for t in range(k))) % F.R
        for i in range(m)
        for j in range(p)
    ]
    assert FR.words_to_fr(got) == want


@pytest.mark.parametrize("m,k,p", [(5, 37, 11), (1, 2, 1000), (341, 341, 1023)],
                         ids=["ragged", "sampler", "values"])
def test_fr_planes_kernel_matches_plain(dev, m, k, p):
    """fr_planes on the card: byte for byte its plain version, both sides."""
    from hbbft_tpu_torch.ops import fr as FR

    g = torch.Generator(device=dev).manual_seed(m * k + p)
    a = torch.randint(-2**31, 2**31 - 1, (m, k, 8), dtype=torch.int32, device=dev, generator=g)
    b = torch.randint(-2**31, 2**31 - 1, (k, p, 8), dtype=torch.int32, device=dev, generator=g)
    for x, a_side in ((a, True), (b, False)):
        got = FR.fr_planes(x, a_side)
        torch.cuda.synchronize()
        assert torch.equal(got, FR.fr_planes_plain(x, a_side))


def test_dkg_device_engine_on_the_card_matches_cpu(dev):
    """The clean elided DKG routes to the device engine on the card by
    default and deals, with given coeffs, the CPU run's keys."""
    from hbbft_tpu_torch.harness.dkg import VectorizedDkg
    from hbbft_tpu_torch.ops import cuda_ec

    coeffs = VectorizedDkg(range(10), 3, random.Random(6), device="cpu")._dealer_coeffs(random.Random(7))
    cuda_ec.reset_launches()
    card = VectorizedDkg(range(10), 3, random.Random(6)).run(verify_honest=False, coeffs=coeffs)
    assert card.engine == "device" and cuda_ec.LAUNCHES["fr_matmul"] == 4 * 10
    cpu = VectorizedDkg(range(10), 3, random.Random(6), device="cpu").run(
        verify_honest=False, coeffs=coeffs, engine="device"
    )
    assert [card.shares[i].scalar for i in range(10)] == [cpu.shares[i].scalar for i in range(10)]
    assert card.pk_set.public_key().to_bytes() == cpu.pk_set.public_key().to_bytes()


@pytest.mark.parametrize("Z", [1, 5, 300])
def test_cosim_step_kernels_match_plain(dev, Z):
    """cosim_hist and cosim_step on the card: byte for byte their plain
    versions (the commit column advanced in place), the whole step one
    cosim_step launch and no cosim_hist, at a Z above the kernels' 256
    shared-memory zone counters too, with rows without an override in
    every decision class; and the 4-shard mesh step equal to the one
    launch."""
    import chip_smoke as cs
    from hbbft_tpu_torch.ops import cosim_step as CS
    from hbbft_tpu_torch.ops import cuda_ec
    from hbbft_tpu_torch.parallel.mesh import make_mesh, packed_cosim_step_fn

    n = 10_004
    cols, reach = cs.cosim_columns(np.random.default_rng(Z), n, Z, n)  # chip_smoke.py's columns
    t = {k: torch.from_numpy(v).to(dev) for k, v in cols.items()}
    order = ("prop_on", "dst_on", "zone", "ovr_mask", "ovr_c1", "forged_cnt")
    args = [t[k] for k in order[:3]] + [torch.from_numpy(reach).to(dev)] + [t[k] for k in order[3:]]
    ck, cp = t["commit"].clone(), t["commit"].clone()
    before = dict(cuda_ec.LAUNCHES)
    got = CS.cosim_step(*args, ck, n - 50, (n - 1) // 3)
    assert cuda_ec.LAUNCHES["cosim_hist"] == before["cosim_hist"]
    assert cuda_ec.LAUNCHES["cosim_step"] == before["cosim_step"] + 1
    want = CS.cosim_step_plain(*args, cp, n - 50, (n - 1) // 3)
    torch.cuda.synchronize()
    for g, w in zip(list(got) + [ck], list(want) + [cp]):
        assert torch.equal(g, w)
    a = CS.cosim_hist(t["dst_on"], t["zone"], Z)
    assert cuda_ec.LAUNCHES["cosim_hist"] == before["cosim_hist"] + 1
    assert torch.equal(a, CS.cosim_hist_plain(t["dst_on"], t["zone"], Z))
    classes = cs.cosim_classes(*(x.cpu().numpy() for x in got[:2]), cols["ovr_mask"], n)
    assert min(classes[: 2 if Z == 1 else 3]) >= 1, classes  # definite-0, nondef, definite-1
    mesh = make_mesh(4)
    b = n // 4
    shards = {k: [v[j * b : (j + 1) * b].clone().to(d) for j, d in enumerate(mesh.devices)]
              for k, v in t.items()}
    res = packed_cosim_step_fn(mesh, Z)(
        *(shards[k] for k in order[:3]), args[3], *(shards[k] for k in order[3:]), shards["commit"],
        (n - 50, (n - 1) // 3),
    )
    torch.cuda.synchronize()
    for g, w in zip(res, list(got) + [ck]):
        assert torch.equal(torch.cat([x.to(dev) for x in g]), w)
    assert cs.cosim_classes(*(torch.cat([x.cpu() for x in g]).numpy() for g in res[:2]),
                            cols["ovr_mask"], n) == classes


def test_packed_cosim_on_the_card_matches_cpu(dev):
    """The packed co-sim on the card (its columns, the kernel) and on the
    CPU (the plain versions) under one WAN model: equal epochs and
    commit counters, one cosim_step launch a step and no cosim_hist."""
    from hbbft_tpu_torch.harness import wan as W
    from hbbft_tpu_torch.harness.cosim import PackedHoneyBadgerCosim
    from hbbft_tpu_torch.ops import cuda_ec

    wan = W.WanModel(seed=0xC052, topology=W.DEFAULT_TOPOLOGY,
                     latency=W.LatencyModel("lognormal"), deadline_ms=400.0)
    card = PackedHoneyBadgerCosim(5000, random.Random(3), wan=wan)
    cpu = PackedHoneyBadgerCosim(5000, random.Random(3), wan=wan, device="cpu")
    cuda_ec.reset_launches()
    for e in range(3):
        dead = set(range(4900, 5000)) if e else None
        a, b = card.run_epoch_packed(dead=dead), cpu.run_epoch_packed(dead=dead)
        assert (a.accepted, a.coin_flips) == (b.accepted, b.coin_flips)
    assert (cuda_ec.LAUNCHES["cosim_hist"], cuda_ec.LAUNCHES["cosim_step"]) == (0, 3)
    assert np.array_equal(card.commit_counts(), cpu.commit_counts())
    contribs = {i: [b"c%d" % i] for i in range(5000)}
    a = card.run_epoch(contribs, late_subset={7: set(range(100))})
    b = cpu.run_epoch(contribs, late_subset={7: set(range(100))})
    assert (a.batch, a.accepted, a.coin_flips, a.agreement_epochs) == (
        b.batch, b.accepted, b.coin_flips, b.agreement_epochs)


COSIM_ORDER = ("prop_on", "dst_on", "zone", "ovr_mask", "ovr_c1", "forged_cnt", "commit")


def _cosim_args(t, reach_t):
    return [t[k] for k in COSIM_ORDER[:3]] + [reach_t] + [t[k] for k in COSIM_ORDER[3:6]]


@pytest.mark.parametrize("Z", [1, 5, 257])
@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 4097])
def test_cosim_step_tail_shapes_match_plain(dev, n, Z):
    """At no row, one row, 15, 16 and 17 rows (a partial 4-row chunk,
    whole chunks, one row past them) and a partial last block, and
    Z = 257 (a second 256-zone window): the
    one-launch step (one launch, none at n = 0) and cosim_hist byte for
    byte their plain versions; the 4-shard mesh step, called twice on one
    step function (its scratch and ticket reused), the plain step on the
    padded columns."""
    import chip_smoke as cs
    from hbbft_tpu_torch.ops import cosim_step as CS
    from hbbft_tpu_torch.ops import cuda_ec
    from hbbft_tpu_torch.parallel.mesh import cosim_pad, make_mesh, packed_cosim_step_fn

    mesh = make_mesh(4)
    n_pad = cosim_pad(n, 4)
    cols, reach = cs.cosim_columns(np.random.default_rng(n * 1000 + Z), n, Z, n_pad)
    n_live, f = n - n // 50, (n - 1) // 3
    reach_t = torch.from_numpy(reach).to(dev)
    t = {k: torch.from_numpy(v[:n].copy()).to(dev) for k, v in cols.items()}
    ck, cp = t["commit"].clone(), t["commit"].clone()
    before = dict(cuda_ec.LAUNCHES)
    got = CS.cosim_step(*_cosim_args(t, reach_t), ck, n_live, f)
    assert cuda_ec.LAUNCHES["cosim_step"] == before["cosim_step"] + (1 if n else 0)
    assert cuda_ec.LAUNCHES["cosim_hist"] == before["cosim_hist"]
    want = CS.cosim_step_plain(*_cosim_args(t, reach_t), cp, n_live, f)
    torch.cuda.synchronize()
    for g, w in zip(list(got) + [ck], list(want) + [cp]):
        assert torch.equal(g, w)
    assert torch.equal(CS.cosim_hist(t["dst_on"], t["zone"], Z),
                       CS.cosim_hist_plain(t["dst_on"], t["zone"], Z))
    full = {k: torch.from_numpy(v).to(dev) for k, v in cols.items()}
    b = n_pad // 4
    commit_m = [full["commit"][j * b : (j + 1) * b].clone() for j in range(4)]
    commit_p = full["commit"].clone()
    step = packed_cosim_step_fn(mesh, Z)
    for _ in range(2):
        shards = {k: [full[k][j * b : (j + 1) * b].clone() for j in range(4)]
                  for k in COSIM_ORDER[:6]}
        res = step(*(shards[k] for k in COSIM_ORDER[:3]), reach_t,
                   *(shards[k] for k in COSIM_ORDER[3:6]), commit_m, (n_live, f))
        want = CS.cosim_step_plain(*_cosim_args(full, reach_t), commit_p, n_live, f)
        torch.cuda.synchronize()
        for g, w in zip(res, list(want) + [commit_p]):
            assert torch.equal(torch.cat([x.to(dev) for x in g]), w)


@pytest.mark.parametrize("Z", [5, 257])
def test_cosim_step_on_misaligned_views_matches_plain(dev, Z):
    """Column views one row in (int8 ones one byte, int32 ones four bytes
    past a 16-byte boundary): the one-launch step and the mesh form's two
    kernels read and write them with scalar accesses and are right."""
    import chip_smoke as cs
    from hbbft_tpu_torch.ops import cosim_step as CS

    n = 4097
    cols, reach = cs.cosim_columns(np.random.default_rng(Z), n + 1, Z, n + 1)
    n_live, f = n - n // 50, (n - 1) // 3
    reach_t = torch.from_numpy(reach).to(dev)
    t = {k: torch.from_numpy(v).to(dev)[1:] for k, v in cols.items()}
    assert t["zone"].data_ptr() % 16 and t["prop_on"].data_ptr() % 16
    ck, cm = (torch.from_numpy(cols["commit"].copy()).to(dev)[1:] for _ in range(2))
    cp = ck.clone()
    got = CS.cosim_step(*_cosim_args(t, reach_t), ck, n_live, f)
    a = CS.cosim_hist(t["dst_on"], t["zone"], Z)
    mesh_form = CS.cosim_decide(t["prop_on"], t["zone"], reach_t, t["ovr_mask"], t["ovr_c1"],
                                t["forged_cnt"], cm, a, n_live, f)
    want = CS.cosim_step_plain(*_cosim_args(t, reach_t), cp, n_live, f)
    torch.cuda.synchronize()
    assert torch.equal(a, CS.cosim_hist_plain(t["dst_on"], t["zone"], Z))
    for g, m, w in zip(list(got) + [ck], list(mesh_form) + [cm], list(want) + [cp]):
        assert torch.equal(g, w) and torch.equal(m, w)


# ---------------------------------------------------------------------------
# The reliable-broadcast plane: sha256, merkle_forest, gf_matmul
# ---------------------------------------------------------------------------


def _smoke():
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import chip_smoke

    return chip_smoke


def _equal_bytes(got, plain):
    torch.cuda.synchronize()
    assert got.shape == plain.shape and torch.equal(got, plain)


def test_sha256_matches_plain_and_hashlib(dev):
    import hashlib

    from hbbft_tpu_torch.ops import cuda_ec
    from hbbft_tpu_torch.ops import sha256 as SH

    gen = np.random.default_rng(1)
    for length in (0, 1, 55, 56, 63, 64, 119, 120, 1000):
        msgs = [gen.integers(0, 256, size=length, dtype=np.uint8).tobytes() for _ in range(130)]
        blocks = torch.from_numpy(SH.pad_messages(msgs).view(np.int32)).to(dev)
        before = cuda_ec.LAUNCHES["sha256"]
        got = SH.sha256(blocks)
        assert cuda_ec.LAUNCHES["sha256"] == before + 1
        _equal_bytes(got, SH.sha256_plain(blocks))
        assert SH.digests_to_bytes(got) == [hashlib.sha256(m).digest() for m in msgs]
        assert SH.digests_to_bytes(SH.sha256(blocks[1:])) == SH.digests_to_bytes(got)[1:]


@pytest.mark.parametrize("offset", [0, 1, 3])
def test_sha256_raw_entry_matches_plain_and_hashlib(dev, offset):
    """The raw entry on rows back to back from ``offset`` bytes into their
    buffer, one launch a call, equal to its plain version (the 47,672-byte
    rows' compression replayed as chip_smoke.py does) and ``hashlib``."""
    import hashlib

    from hbbft_tpu_torch.ops import cuda_ec
    from hbbft_tpu_torch.ops import sha256 as SH

    gen = np.random.default_rng(10 + offset)
    for length, batch in ((0, 130), (1, 130), (55, 130), (56, 130), (63, 130), (64, 130),
                          (119, 130), (120, 130), (1000, 130), (47_672, 7)):
        raw = gen.integers(0, 256, size=(batch, length), dtype=np.uint8)
        buf = torch.zeros(raw.size + offset, dtype=torch.uint8, device=dev)
        buf[offset:] = torch.from_numpy(raw.reshape(-1)).to(dev)
        rows = buf[offset:].view(batch, length)
        before = cuda_ec.LAUNCHES["sha256"]
        got = SH.sha256_bytes(rows)
        assert cuda_ec.LAUNCHES["sha256"] == before + 1
        words = SH._message_words(rows)
        plain = (SH.sha256_plain(words) if length < 47_672
                 else _smoke().sha256_plain_replayed(words))
        _equal_bytes(got, plain)
        assert SH.digests_to_bytes(got) == [hashlib.sha256(r.tobytes()).digest() for r in raw]


def test_sha256_many_on_the_card_pads_nothing_on_the_host(dev, monkeypatch):
    import hashlib

    from hbbft_tpu_torch.ops import cuda_ec
    from hbbft_tpu_torch.ops import sha256 as SH

    def no_padding(msgs):
        raise AssertionError("sha256_many padded on the host")

    monkeypatch.setattr(SH, "pad_messages", no_padding)
    gen = np.random.default_rng(4)
    for length in (0, 11, 4096):
        msgs = [gen.integers(0, 256, size=length, dtype=np.uint8).tobytes() for _ in range(300)]
        before = cuda_ec.LAUNCHES["sha256"]
        assert SH.sha256_many(msgs, dev) == [hashlib.sha256(m).digest() for m in msgs]
        assert cuda_ec.LAUNCHES["sha256"] == before + 1


def test_merkle_levels_on_the_card_match_tree(dev):
    from hbbft_tpu_torch.crypto.merkle import MerkleTree
    from hbbft_tpu_torch.ops import cuda_ec
    from hbbft_tpu_torch.ops import sha256 as SH

    gen = np.random.default_rng(2)
    for n in (1, 2, 3, 11, 64, 1000):
        vals = [gen.integers(0, 256, size=33, dtype=np.uint8).tobytes() for _ in range(n)]
        cuda_ec.reset_launches()
        levels = SH.merkle_levels_device(vals, dev)
        assert levels == MerkleTree(vals).levels
        assert cuda_ec.LAUNCHES["merkle_forest"] == 1 and cuda_ec.LAUNCHES["sha256"] == 0


@pytest.mark.parametrize("T,n,length", [(974, 1024, 2), (3, 64, 47_663), (2, 4_097, 2),
                                        (5, 11, 56), (7, 3, 0)])
def test_merkle_forest_matches_plain(dev, T, n, length):
    from hbbft_tpu_torch.ops import cuda_ec
    from hbbft_tpu_torch.ops import sha256 as SH

    gen = np.random.default_rng(T + n + length)
    values = torch.from_numpy(gen.integers(0, 256, size=(T, n, length), dtype=np.uint8)).to(dev)
    for roots_only in (False, True):
        before = cuda_ec.LAUNCHES["merkle_forest"]
        got = SH.merkle_forest(values, roots_only)
        assert cuda_ec.LAUNCHES["merkle_forest"] == before + 1
        _equal_bytes(got, SH.merkle_forest_plain(values, roots_only,
                                                 sha=_smoke().sha256_plain_replayed))


@pytest.mark.parametrize("W", [8, 16])
def test_gf_matmul_matches_plain_and_native(dev, W):
    from hbbft_tpu_torch.crypto import rs as RS
    from hbbft_tpu_torch.ops import cuda_ec
    from hbbft_tpu_torch.ops import gf256 as GF

    gen = np.random.default_rng(W)
    dtype = np.uint8 if W == 8 else np.uint16
    host = RS._matmul if W == 8 else RS._matmul16
    for m, k, n in ((1, 1, 1), (3, 5, 7), (9, 33, 130), (42, 22, 4097), (17, 40, 3),
                    (50, 342, 1), (50, 342, 974), (682, 342, 974)):
        mat = gen.integers(0, 1 << W, size=(m, k), dtype=dtype)
        mat[0, 0] = 0
        data = gen.integers(0, 1 << W, size=(k, n), dtype=dtype)
        t = torch.from_numpy(data if W == 8 else data.view(np.int16)).to(dev)
        before = cuda_ec.LAUNCHES["gf_matmul"]
        got = GF.gf_matmul(mat, t)
        assert cuda_ec.LAUNCHES["gf_matmul"] == before + 1
        _equal_bytes(got, GF.gf_matmul_plain(mat, t))
        got_np = got.cpu().numpy()
        assert np.array_equal(got_np if W == 8 else got_np.view(np.uint16), host(mat, data))


def test_forced_broadcast_on_the_card_matches_host(dev):
    from hbbft_tpu_torch.crypto.backend import CpuBackend
    from hbbft_tpu_torch.ops import cuda_ec
    from hbbft_tpu_torch.ops.backend_cuda import CudaBackend

    cs = _smoke()
    from hbbft_tpu_torch.harness.rbc_probe import RbcProbe

    be = cs.forced(CudaBackend())
    cuda_ec.reset_launches()
    with RbcProbe(be) as probe:
        card = cs.broadcast_1mb(be, nodes=16, payload_bytes=20_000, seed=5)
    launched = {k: cuda_ec.LAUNCHES[k] for k in cuda_ec.RBC_KERNELS}
    host = cs.broadcast_1mb(CpuBackend(), nodes=16, payload_bytes=20_000, seed=5)
    assert (card["messages"], card["digest"]) == (host["messages"], host["digest"])
    # the trees hash their own leaves: no sha256 batch on this path
    assert launched == probe.sent and launched["merkle_forest"] and launched["gf_matmul"]
