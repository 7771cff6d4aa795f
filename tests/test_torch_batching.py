"""The slice as a whole: the port's fused share-verification flush.

Real BLS12-381 decryption shares for 8 senders × 4 ciphertexts are made
by the JAX package and carried over with ``state.to_arrays`` /
``state.from_reference``.  The port's
``BatchingBackend(inner=CudaBackend(device="cpu"))`` — the device path
with every kernel's plain version — must cache exactly the verdicts of
the reference's ``BatchingBackend(inner=CpuBackend())``, including a
corrupted share attributed to the same obligation (tolerance: identical
booleans and identical fallback counts).
"""

import random

import numpy as np
import pytest
import torch

from hbbft_tpu.crypto import threshold as RT
from hbbft_tpu.crypto.backend import CpuBackend as RefCpu
from hbbft_tpu.crypto.curve import G2_GEN as REF_G2
from hbbft_tpu.harness import batching as RB
from hbbft_tpu_torch import state
from hbbft_tpu_torch.crypto import threshold as PT
from hbbft_tpu_torch.crypto.curve import G2_GEN as PORT_G2
from hbbft_tpu_torch.harness import batching as PB
from hbbft_tpu_torch.harness.workload import DecryptionFlushWorkload
from hbbft_tpu_torch.ops import cuda_ec
from hbbft_tpu_torch.ops.backend_cuda import CudaBackend

# small tensors: intra-op threads only add contention beside the other
# test workers
torch.set_num_threads(1)

N_SENDERS, N_GROUPS = 8, 4
BAD = 2 * N_SENDERS + 5


def _reference_obligations(corrupt: bool):
    rng = random.Random(0xF1A5)
    xs = [rng.randrange(1, RT.R) for _ in range(N_SENDERS)]
    pks = [RT.PublicKeyShare(REF_G2 * x) for x in xs]
    master = RT.SecretKey.random(rng).public_key()
    obs = []
    for g in range(N_GROUPS):
        ct = master.encrypt(b"payload-%d" % g, rng)
        obs.extend(
            RB.DecObligation(pks[i], RT.DecryptionShare(ct.u * xs[i]), ct)
            for i in range(N_SENDERS)
        )
    if corrupt:
        ob = obs[BAD]
        obs[BAD] = RB.DecObligation(
            ob.pk_share, RT.DecryptionShare(ob.share.point * 7), ob.ciphertext
        )
    return obs


def _port_backend():
    inner = CudaBackend(device="cpu")
    # the 32-share product runs the device path; the 8-share per-group
    # fallback checks stay on the host
    inner.G1_PRODUCT_DEVICE_MIN = inner.G1_DEVICE_MIN = 16
    return PB.BatchingBackend(inner=inner)


@pytest.mark.parametrize("corrupt", [False, True], ids=["honest", "corrupted"])
def test_flush_verdicts_match_reference(corrupt):
    ref_obs = _reference_obligations(corrupt)
    port_obs = state.from_reference(state.to_arrays(ref_obs), device="cpu").obligations
    ref = RB.BatchingBackend(inner=RefCpu())
    ref.prefetch(ref_obs)
    port = _port_backend()
    before = cuda_ec.LAUNCHES["win_g1"]
    port.prefetch(port_obs)
    assert cuda_ec.LAUNCHES["win_g1"] == before  # CPU: the plain version
    want = [ref.verify_dec_share(o.pk_share, o.share, o.ciphertext) for o in ref_obs]
    got = [port.verify_dec_share(o.pk_share, o.share, o.ciphertext) for o in port_obs]
    assert got == want
    assert want.count(False) == (1 if corrupt else 0)
    if corrupt:
        assert got[BAD] is False
    for field in ("prefetched", "flushes", "cache_hits", "fallback_groups", "fallback_items"):
        assert getattr(port.stats, field) == getattr(ref.stats, field), field
    # the cache keys are the reference's bytes
    assert PB._dec_key(port_obs[3].pk_share, port_obs[3].share, port_obs[3].ciphertext) == (
        RB._dec_key(ref_obs[3].pk_share, ref_obs[3].share, ref_obs[3].ciphertext)
    )
    assert set(port.last_flush_phases) >= {"serialize", "launch", "g2", "finalize", "pairing"}


def test_device_fault_raises_instead_of_falling_back(monkeypatch):
    """A kernel failure must reach the caller: no silent host recompute,
    no False verdicts cached for honest shares."""
    port_obs = state.from_reference(
        state.to_arrays(_reference_obligations(False)), device="cpu"
    ).obligations

    def broken(pts, digits):
        raise RuntimeError("win_g1 launch failed")

    monkeypatch.setattr(cuda_ec, "win_g1", broken)
    port = _port_backend()
    with pytest.raises(RuntimeError, match="win_g1"):
        port.prefetch(port_obs)
    assert port.stats.fallback_groups == 0 and not port._cache


def test_signature_share_flush_matches_reference():
    """Coin-style signature shares (grouped by message, base point
    hash_to_g1) with one share signed over the wrong message: both
    packages, built from the same secret scalars, cache the same
    verdicts."""
    rng = random.Random(0x5161)
    xs = [rng.randrange(1, RT.R) for _ in range(4)]
    msgs = [b"nonce-A", b"nonce-B", b"nonce-C"]

    def obligations(T, mod, g2):
        obs = []
        for m in msgs:
            for x in xs:
                sign_over = b"other" if (m, x) == (msgs[1], xs[2]) else m
                share = T.SecretKeyShare(x).sign(sign_over)
                obs.append(mod.SigObligation(T.PublicKeyShare(g2 * x), share, m))
        return obs

    ref_obs = obligations(RT, RB, REF_G2)
    port_obs = obligations(PT, PB, PORT_G2)
    ref = RB.BatchingBackend(inner=RefCpu())
    ref.prefetch(ref_obs)
    port = PB.BatchingBackend(inner=CudaBackend(device="cpu"))
    port.inner.G1_PRODUCT_DEVICE_MIN = 8  # the 12-share product on the device path
    port.prefetch(port_obs)
    want = [ref.verify_sig_share(o.pk_share, o.share, o.msg) for o in ref_obs]
    got = [port.verify_sig_share(o.pk_share, o.share, o.msg) for o in port_obs]
    assert got == want and want.count(False) == 1
    assert port.stats.fallback_groups == ref.stats.fallback_groups == 1


def test_workload_flush_verifies():
    """The full-width flush's workload (chip_smoke.py) at a small size."""
    work = DecryptionFlushWorkload(4, random.Random(9))
    obs = work.obligations(b"t", 2)
    assert len(obs) == 8 and obs[5].ciphertext is obs[4].ciphertext
    port = _port_backend()
    port.prefetch(obs)
    assert all(port.verify_dec_share(o.pk_share, o.share, o.ciphertext) for o in obs)
    assert port.stats.fallback_items == 0


def test_state_round_trip_and_limbs():
    arrays = state.to_arrays(_reference_obligations(False))
    assert arrays["pk_wires"].shape == (N_SENDERS, 192)
    assert arrays["share_wires"].shape == (N_SENDERS * N_GROUPS, 96)
    arrays["point_limbs"] = np.zeros((N_SENDERS * N_GROUPS, 3, 38), dtype=np.int32)
    st = state.from_reference(arrays, device="cpu")
    assert st.point_limbs.device == torch.device("cpu")
    assert st.point_limbs.dtype == torch.int32
    again = state.to_arrays(st.obligations)
    for name, arr in again.items():
        assert np.array_equal(arr, arrays[name]), name
    # the carried ciphertexts keep their proofs of knowledge
    ct = st.ciphertexts[0]
    assert ct.verify()
    assert not PT.Ciphertext(ct.u, ct.v[:-1] + b"?", ct.c, ct.z).verify()


def test_backend_batch_verify_shares_device_path():
    """``CudaBackend.batch_verify_shares`` with its G1 MSM on the device
    path agrees with the reference's host batch verifier."""
    inner = CudaBackend(device="cpu")
    inner.G1_DEVICE_MIN = 0
    for lo, hi in ((0, 4), (4, 8)):  # a clean half-group, then one with the bad share
        ref_sel = _reference_obligations(True)[2 * N_SENDERS + lo : 2 * N_SENDERS + hi]
        port_sel = state.from_reference(state.to_arrays(ref_sel), device="cpu").obligations
        base_ref, base_port = ref_sel[0].ciphertext.u, port_sel[0].ciphertext.u
        want = RT.batch_verify_shares(
            [o.share.point for o in ref_sel], [o.pk_share.point for o in ref_sel], base_ref, b"ctx"
        )
        got = inner.batch_verify_shares(
            [o.share.point for o in port_sel], [o.pk_share.point for o in port_sel], base_port, b"ctx"
        )
        assert got is want
        assert want is (lo == 0)


def test_size_rules_route_flat_and_product_apart():
    """``G1_PRODUCT_DEVICE_MIN`` routes the product form and
    ``G1_DEVICE_MIN`` flat MSMs; both routes give the host's point."""
    from hbbft_tpu_torch.crypto.backend import CpuBackend, EagerFinalizer
    from hbbft_tpu_torch.crypto.curve import G1_GEN

    inner = CudaBackend(device="cpu")
    inner.G1_PRODUCT_DEVICE_MIN, inner.G1_DEVICE_MIN = 4, 16
    pts = [G1_GEN * (3 * i + 1) for i in range(8)]
    ks = [5 * i + 2 for i in range(8)]
    assert isinstance(inner.g1_ship(pts[:3]), list)
    assert isinstance(inner.g1_ship(pts), torch.Tensor)
    assert isinstance(inner.g1_msm_async(pts, ks), EagerFinalizer)
    want = CpuBackend().g1_msm(pts, ks)
    assert inner.g1_msm(pts, ks) == want
    inner.G1_DEVICE_MIN = 8
    fin = inner.g1_msm_async(pts, ks)
    assert not isinstance(fin, EagerFinalizer) and fin() == want
