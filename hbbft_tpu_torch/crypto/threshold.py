"""Threshold BLS objects of the decryption-share flush and the DKG.

The port's own copy of the subset of ``hbbft_tpu/crypto/threshold.py``
that the share-verification flush and the verified DKG need: individual
keys and the hybrid encryption that makes ciphertexts, secret/public
key shares, signatures and signature and decryption shares, the
ciphertext, the random-linear-combination batch verifier, and the
``PublicKeySet`` a DKG generates.  Same scheme, same wire names, same
bytes:

- decryption shares dᵢ = skᵢ·U ∈ G1; verify e(dᵢ, P₂) == e(U, pkᵢ);
- signatures live on G1 (``hash_to_g1``): σᵢ = skᵢ·H(m), combined by
  Lagrange interpolation of the lowest t+1 shares, verified against
  the master key pk = commitment(0);
- batch verification: k shares verify with ONE product-pairing check
  via deterministic (Fiat–Shamir) random linear combination.

``SecretKeySet`` (trusted dealing) is not part of the port: keys come
from the DKG.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

from . import fields as F
from .curve import G1, G1_GEN, G2, G2_GEN, g1_multi_exp, g2_multi_exp
from .hashing import DST_ENC, DST_POK, DST_SIG, hash_to_fr, hash_to_g1, sha256, xor_stream
from .pairing import pairing_check
from .poly import Commitment, lagrange_coefficients_at_zero
from ..core.serialize import dumps, wire

R = F.R


def _rand_fr(rng) -> int:
    return rng.randrange(R - 1) + 1


@wire("Sig")
@dataclasses.dataclass(frozen=True)
class Signature:
    """A (combined) BLS signature in G1."""

    point: G1

    def to_bytes(self) -> bytes:
        return self.point.to_bytes()


@wire("SigShare")
@dataclasses.dataclass(frozen=True)
class SignatureShare:
    point: G1

    def to_bytes(self) -> bytes:
        return self.point.to_bytes()


@wire("DecShare")
@dataclasses.dataclass(frozen=True)
class DecryptionShare:
    point: G1

    def to_bytes(self) -> bytes:
        return self.point.to_bytes()


@wire("Ciphertext")
@dataclasses.dataclass(frozen=True)
class Ciphertext:
    """Hybrid threshold ciphertext (U, V, Schnorr PoK (c, z)); see the
    reference module for the CCA argument behind ``verify``."""

    u: G1
    v: bytes
    c: int
    z: int

    def verify(self) -> bool:
        if self.u.is_infinity():
            return False
        if not (0 <= self.c < R and 0 <= self.z < R):
            return False
        a = G1_GEN * self.z - self.u * self.c
        c2 = hash_to_fr(
            DST_POK + self.u.to_bytes() + sha256(self.v) + a.to_bytes()
        )
        return c2 == self.c

    def to_bytes(self) -> bytes:
        # memoized: the batching layer keys caches by ciphertext bytes
        cached = getattr(self, "_bytes", None)
        if cached is None:
            cached = dumps(self)
            object.__setattr__(self, "_bytes", cached)
        return cached


@wire("PublicKey")
@dataclasses.dataclass(frozen=True)
class PublicKey:
    """Individual public key; pk1 = sk·P₁ (encryption target),
    pk2 = sk·P₂."""

    pk1: G1
    pk2: G2

    def encrypt(self, msg: bytes, rng) -> Ciphertext:
        r = _rand_fr(rng)
        u = G1_GEN * r
        key = sha256(DST_ENC + (self.pk1 * r).to_bytes())
        v = xor_stream(key, msg)
        a_r = _rand_fr(rng)
        a = G1_GEN * a_r
        c = hash_to_fr(DST_POK + u.to_bytes() + sha256(v) + a.to_bytes())
        z = (a_r + c * r) % R
        return Ciphertext(u, v, c, z)

    def to_bytes(self) -> bytes:
        return self.pk1.to_bytes() + self.pk2.to_bytes()


@wire("SecretKey")
@dataclasses.dataclass(frozen=True)
class SecretKey:
    scalar: int

    @classmethod
    def random(cls, rng) -> "SecretKey":
        return cls(_rand_fr(rng))

    def public_key(self) -> PublicKey:
        return PublicKey(G1_GEN * self.scalar, G2_GEN * self.scalar)


@wire("SecretKeyShare")
@dataclasses.dataclass(frozen=True)
class SecretKeyShare:
    """One node's share of the master secret."""

    scalar: int

    def sign(self, msg: bytes) -> SignatureShare:
        return SignatureShare(hash_to_g1(msg, DST_SIG) * self.scalar)

    def decrypt_share_no_verify(self, ct: Ciphertext) -> DecryptionShare:
        return DecryptionShare(ct.u * self.scalar)


@wire("PublicKeyShare")
@dataclasses.dataclass(frozen=True)
class PublicKeyShare:
    point: G2  # skᵢ·P₂

    def verify_signature_share(self, share: SignatureShare, msg: bytes) -> bool:
        h = hash_to_g1(msg, DST_SIG)
        return pairing_check([(share.point, G2_GEN), (-h, self.point)])

    def verify_decryption_share(self, share: DecryptionShare, ct: Ciphertext) -> bool:
        return pairing_check([(share.point, G2_GEN), (-ct.u, self.point)])

    def to_bytes(self) -> bytes:
        return self.point.to_bytes()


def _rlc_coeffs(context: bytes, items: Sequence[bytes]) -> List[int]:
    """Deterministic 128-bit random-linear-combination coefficients
    (Fiat–Shamir over all inputs) — reproducible across backends."""
    seed = sha256(context + b"".join(items))
    return [
        int.from_bytes(sha256(seed + i.to_bytes(4, "big"))[:16], "big") | 1
        for i in range(len(items))
    ]


def aggregate_by_point(points: Sequence, coeffs: Sequence[int]):
    """Collapse duplicate points by summing their coefficients:
    Σᵢ rᵢ·Pᵢ == Σ_distinct (Σ_{i: Pᵢ=P} rᵢ)·P (sums are not reduced
    mod r)."""
    agg: Dict[bytes, int] = {}
    first: Dict[bytes, Any] = {}
    for p, c in zip(points, coeffs):
        key = p.to_bytes()
        agg[key] = agg.get(key, 0) + c
        first.setdefault(key, p)
    keys = list(agg)
    return [first[k] for k in keys], [agg[k] for k in keys]


def batch_verify_shares(
    shares: Sequence[G1],
    pks: Sequence[G2],
    base: G1,
    context: bytes = b"",
) -> bool:
    """Check e(shareᵢ, P₂) == e(base, pkᵢ) for all i with one product
    pairing: e(Σrᵢ·shareᵢ, P₂) · e(−base, Σrᵢ·pkᵢ) == 1."""
    if not shares:
        return True
    coeffs = _rlc_coeffs(
        context, [s.to_bytes() for s in shares] + [p.to_bytes() for p in pks]
    )[: len(shares)]
    agg_share = g1_multi_exp(shares, coeffs)
    u_pks, u_coeffs = aggregate_by_point(pks, coeffs)
    agg_pk = g2_multi_exp(u_pks, u_coeffs)
    return pairing_check([(agg_share, G2_GEN), (-base, agg_pk)])


@wire("PublicKeySet")
@dataclasses.dataclass(frozen=True)
class PublicKeySet:
    """Master public key material: the G2 coefficient commitment (which
    yields every public key share) and the G1 master key (encryption
    target)."""

    commitment: Commitment
    master_g1: G1

    @property
    def threshold(self) -> int:
        return self.commitment.degree

    def public_key(self) -> PublicKey:
        return PublicKey(self.master_g1, self.commitment.evaluate(0))

    def public_key_share(self, i: int) -> PublicKeyShare:
        """Node i's key share: the commitment evaluated at i+1."""
        return PublicKeyShare(self.commitment.evaluate(i + 1))

    def combine_signatures(self, shares: Dict[int, SignatureShare]) -> Signature:
        """Lagrange-combine more than t shares; the deterministic subset
        is the lowest t+1 indices."""
        idxs = sorted(shares)[: self.threshold + 1]
        if len(idxs) <= self.threshold:
            raise ValueError("not enough signature shares")
        lams = lagrange_coefficients_at_zero([i + 1 for i in idxs])
        return Signature(g1_multi_exp([shares[i].point for i in idxs], lams))

    def verify_signature(self, sig: Signature, msg: bytes) -> bool:
        h = hash_to_g1(msg, DST_SIG)
        return pairing_check([(sig.point, G2_GEN), (-h, self.commitment.evaluate(0))])
