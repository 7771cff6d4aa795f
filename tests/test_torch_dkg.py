"""The port's verified DKG against the reference's ``VectorizedDkg``.

Both run from the same ``random.Random(seed)``, so they deal the same
polynomials; the port (``device="cpu"``) must then give the same public
key set, shares, completion set, check counts, MSM size and fault log.
With ``G2_DEVICE_MIN`` lowered to 0 the fused check goes through the
port's packed-wire G2 path (``win_g2``'s plain version on CPU tensors)
and must reach the same verdict, and reject a perturbed row cell.
"""

import random

import pytest
import torch

from hbbft_tpu.crypto import poly as RP
from hbbft_tpu.harness.dkg import VectorizedDkg as RefDkg
from hbbft_tpu_torch.crypto import curve as PC
from hbbft_tpu_torch.crypto import poly as PP
from hbbft_tpu_torch.harness import dkg as PD

# small tensors: intra-op threads only add contention beside the other
# test workers
torch.set_num_threads(1)


def _faults(log):
    return [(f.node_id, f.kind.name) for f in log]


def _assert_same(ref, port):
    assert port.pk_set.public_key().to_bytes() == ref.pk_set.public_key().to_bytes()
    assert [c.to_bytes() for c in port.pk_set.commitment.coeffs] == [
        c.to_bytes() for c in ref.pk_set.commitment.coeffs
    ]
    assert port.pk_set.master_g1.to_bytes() == ref.pk_set.master_g1.to_bytes()
    assert sorted(port.shares) == sorted(ref.shares)
    assert all(port.shares[i].scalar == ref.shares[i].scalar for i in ref.shares)
    assert port.complete == ref.complete
    assert (port.row_checks, port.value_checks, port.msm_points) == (
        ref.row_checks,
        ref.value_checks,
        ref.msm_points,
    )
    assert _faults(port.fault_log) == _faults(ref.fault_log)
    for r, nid in enumerate(sorted(ref.shares)):
        pk_share = port.pk_set.public_key_share(r)
        assert pk_share.to_bytes() == ref.pk_set.public_key_share(r).to_bytes()
        assert pk_share.point == PC.G2_GEN * port.shares[nid].scalar


def _pair(n, t, seed, **kw):
    ids = list(range(n))
    ref = RefDkg(ids, t, random.Random(seed), mock=False).run(**kw)
    dkg = PD.VectorizedDkg(ids, t, random.Random(seed), device="cpu")
    return ref, dkg.run(**kw), dkg


@pytest.mark.parametrize(
    "n,t,verify", [(4, 1, True), (4, 1, False), (7, 2, True)], ids=["n4-verified", "n4-elided", "n7-verified"]
)
def test_matches_reference(n, t, verify):
    ref, port, _ = _pair(n, t, 9 + n, verify_honest=verify)
    _assert_same(ref, port)
    assert port.fault_log.is_empty()
    if verify:
        assert port.msm_points == n * (t + 1) ** 2
        assert port.row_checks == n * n and port.value_checks == n ** 3


@pytest.mark.parametrize("verify", [True, False], ids=["verified", "elided"])
def test_bad_row_and_value_attributed_as_reference(verify):
    ref, port, _ = _pair(4, 1, 11, verify_honest=verify, wrong_row={2: {0}}, wrong_value={(1, 3): {2}})
    _assert_same(ref, port)
    kinds = set(_faults(port.fault_log))
    assert (2, "INVALID_PART") in kinds and (3, "INVALID_ACK") in kinds
    # the generated keys work: each signature share verifies under its
    # public key share, and t + 1 of them combine and verify
    sig_shares = {i: port.shares[i].sign(b"adv") for i in (0, 2)}
    for i, s in sig_shares.items():
        assert port.pk_set.public_key_share(i).verify_signature_share(s, b"adv")
        assert not port.pk_set.public_key_share(i).verify_signature_share(s, b"other")
    sig = port.pk_set.combine_signatures(sig_shares)
    assert port.pk_set.verify_signature(sig, b"adv")
    assert not port.pk_set.verify_signature(sig, b"other")


def test_poly_and_commitment_match_reference():
    """Poly from the same rng stream: coefficients, degree, evaluation,
    and its G2 commitment and that commitment's evaluation."""
    ref = RP.Poly.random(3, random.Random(21))
    port = PP.Poly.random(3, random.Random(21))
    assert port.coeffs == ref.coeffs and port.degree == ref.degree == 3
    ref_c, port_c = ref.commitment(), port.commitment()
    assert [c.to_bytes() for c in port_c.coeffs] == [c.to_bytes() for c in ref_c.coeffs]
    assert port_c.degree == 3
    for x in (0, 1, 5, PP.R - 1, 1 << 200):
        assert port.evaluate(x) == ref.evaluate(x)
        assert port_c.evaluate(x).to_bytes() == ref_c.evaluate(x).to_bytes()
        assert port_c.evaluate(x) == PC.G2_GEN * port.evaluate(x)


def test_fused_check_through_the_packed_g2_path(monkeypatch):
    """G2_DEVICE_MIN = 0 routes the fused MSM through
    ``packed_msm.g2_msm_packed_wires`` (plain ``win_g2`` on CPU
    tensors): same result as the reference's host MSM, and one
    perturbed row cell makes ``_fused_check`` return False."""
    monkeypatch.setattr(PD.VectorizedDkg, "G2_DEVICE_MIN", 0)
    ref, port, dkg = _pair(4, 1, 15, verify_honest=True)
    _assert_same(ref, port)
    assert port.fault_log.is_empty()
    assert {"ship_unpack", "win_g2", "tree", "finalize"} <= set(dkg.last_phases)
    assert "host_msm" not in dkg.last_phases
    deal = dkg.last_dealing
    rows = list(deal.rows)
    rows[1] = PD._bump(rows[1], 5)
    ok, points = dkg._fused_check(rows, deal.vals, deal.commit_wires, deal.n_ackers)
    assert points == 16 and ok is False


def test_fault_log_subset_names_match_reference():
    from hbbft_tpu.core.fault import FaultKind as RefKind
    from hbbft_tpu_torch.core.fault import FaultKind

    for kind in FaultKind:
        assert RefKind[kind.name].value == kind.value


# ---------------------------------------------------------------------------
# The device dealing plane (``fr_matmul``), mock dealing and routing
# ---------------------------------------------------------------------------


def _ref_device_engine(monkeypatch):
    """The reference's device engine runs its grids through the
    executable disk cache, whose loader does not run on this host's JAX;
    plain ``jax.jit`` of the same programs stands in for it here."""
    import jax

    from hbbft_tpu.ops import pallas_ec

    monkeypatch.setattr(
        pallas_ec, "cached_compiled", lambda name, fn, *args, key_parts=None, donate=(): jax.jit(fn)(*args)
    )


def test_device_engine_with_coeffs_matches_reference_and_host(monkeypatch):
    """The same dealing matrices through the port's device engine (the
    plain versions of ``fr_matmul`` on a CPU device), the reference's
    device engine and the port's host engine: identical keys."""
    _ref_device_engine(monkeypatch)
    n, t = 7, 2
    coeffs = PD.VectorizedDkg(range(n), t, random.Random(0xD0), device="cpu")._dealer_coeffs(
        random.Random(0xC0FFEE)
    )
    kw = dict(verify_honest=False, coeffs=coeffs)
    ref = RefDkg(range(n), t, random.Random(0xD0), mock=False).run(engine="device", **kw)
    dkg = PD.VectorizedDkg(range(n), t, random.Random(0xD0), device="cpu")
    dev = dkg.run(engine="device", **kw)
    host = PD.VectorizedDkg(range(n), t, random.Random(0xD0), device="cpu").run(engine="host", **kw)
    assert ref.engine == dev.engine == "device" and host.engine == "host"
    _assert_same(ref, dev)
    _assert_same(host, dev)
    assert dev.fault_log.is_empty() and set(dkg.last_phases) == {"dealing", "generation"}


def test_device_engine_sampled_keys_work():
    """Sampled on the device: a t + 1 subset's signature shares combine
    into a signature the master key verifies, and every public key share
    is G2·share."""
    n, t = 7, 2
    res = PD.VectorizedDkg(range(n), t, random.Random(0xD1), device="cpu").run(
        verify_honest=False, engine="device"
    )
    assert res.engine == "device"
    shares = {i: res.shares[i].sign(b"dev-dkg") for i in range(t + 1)}
    sig = res.pk_set.combine_signatures(shares)
    assert res.pk_set.verify_signature(sig, b"dev-dkg")
    assert not res.pk_set.verify_signature(sig, b"other")
    for i in range(n):
        assert res.pk_set.public_key_share(i).point == PC.G2_GEN * res.shares[i].scalar
    # the same rng seed deals the same keys
    again = PD.VectorizedDkg(range(n), t, random.Random(0xD1), device="cpu").run(
        verify_honest=False, engine="device"
    )
    assert [again.shares[i].scalar for i in range(n)] == [res.shares[i].scalar for i in range(n)]


def test_device_engine_draws_what_the_reference_draws(monkeypatch):
    """Sampling takes eight ``getrandbits(32)`` from the caller's rng, as
    the reference's device engine does, so later draws stay aligned."""
    _ref_device_engine(monkeypatch)
    r_rng, p_rng = random.Random(0xD4), random.Random(0xD4)
    RefDkg(range(4), 1, r_rng).run(verify_honest=False, engine="device")
    PD.VectorizedDkg(range(4), 1, p_rng, device="cpu").run(verify_honest=False, engine="device")
    assert p_rng.getrandbits(64) == r_rng.getrandbits(64)


def test_routing(monkeypatch):
    n, t = 4, 1

    def mk(seed=0xD2):
        return PD.VectorizedDkg(range(n), t, random.Random(seed), device="cpu")

    # auto: the host engine on a CPU device, the device engine on a card
    assert mk().run(verify_honest=False).engine == "host"
    assert mk()._device_auto() is False
    dkg = mk()
    dkg.device = torch.device("cuda")
    assert dkg._device_auto() is True
    monkeypatch.setattr(PD.VectorizedDkg, "_device_auto", lambda self: True)
    assert mk().run(verify_honest=False).engine == "device"
    assert mk().run(verify_honest=False, engine="host").engine == "host"
    # an engine that is neither raises, where it would have routed silently
    for typo in ("cuda", "gpu", "Device"):
        with pytest.raises(ValueError, match="engine"):
            mk().run(verify_honest=False, engine=typo)
    # verified or adversarial runs never take the device
    assert mk().run(verify_honest=True, engine="device").engine == "host"
    adv = mk().run(verify_honest=False, wrong_row={0: {1}}, engine="device")
    assert adv.engine == "host"
    # t + 1 past the contraction bound routes to the host engine
    monkeypatch.setattr(PD.FR, "_MAX_K", 1)
    assert mk().run(verify_honest=False, engine="device").engine == "host"


def test_mock_run_matches_reference():
    ref = RefDkg(range(7), 2, random.Random(0xA1), mock=True).run()
    port = PD.VectorizedDkg(range(7), 2, random.Random(0xA1), mock=True).run()
    assert port.pk_set.seed == ref.pk_set.seed and port.pk_set.threshold == ref.pk_set.threshold
    assert [(s.seed, s.index) for s in port.shares.values()] == [
        (s.seed, s.index) for s in ref.shares.values()
    ]
    assert port.complete == ref.complete and port.fault_log.is_empty()
    assert (port.row_checks, port.value_checks, port.msm_points, port.engine) == (0, 0, 0, "host")
