"""Threshold BLS objects of the flush, the DKG and the HoneyBadger epoch.

The port's own copy of the subset of ``hbbft_tpu/crypto/threshold.py``
that the share-verification flush, the verified DKG and the vectorized
epoch need: individual keys (and the signature check of the dynamic
layer's signed votes) and the hybrid encryption that makes
ciphertexts, secret/public key shares, signatures and signature and
decryption shares, the ciphertext, the random-linear-combination batch
verifier, the ``PublicKeySet`` with its share cache and its Lagrange
combines (per row, batched over rows, and the speculative
combine-and-check), and the trusted-dealer ``SecretKeySet`` of the test
and co-simulation key dealing.  Same scheme, same wire names, same
domain strings, same bytes:

- decryption shares dᵢ = skᵢ·U ∈ G1; verify e(dᵢ, P₂) == e(U, pkᵢ);
- signatures live on G1 (``hash_to_g1``): σᵢ = skᵢ·H(m), combined by
  Lagrange interpolation of the lowest t+1 shares, verified against
  the master key pk = commitment(0);
- batch verification: k shares verify with ONE product-pairing check
  via deterministic (Fiat–Shamir) random linear combination.

Batched combines (rows sharing one lowest-(t+1) index subset, four rows
or more) run in one native many-MSM call, as in the reference;
fewer rows, or no native library, take the per-row path — the same
bytes either way.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import fields as F
from .curve import G1, G1_GEN, G2, G2_GEN, g1_multi_exp, g2_multi_exp
from .hashing import DST_ENC, DST_POK, DST_SIG, hash_to_fr, hash_to_g1, sha256, xor_stream
from .pairing import pairing_check
from .poly import Commitment, Poly, lagrange_coefficients_at_zero
from ..core.serialize import dumps, wire

R = F.R


def _rand_fr(rng) -> int:
    return rng.randrange(R - 1) + 1


@wire("Sig")
@dataclasses.dataclass(frozen=True)
class Signature:
    """A (combined) BLS signature in G1."""

    point: G1

    def parity(self) -> bool:
        """Deterministic unpredictable bit — the common-coin value
        (reference ``Signature::parity``)."""
        return bool(sha256(self.point.to_bytes())[0] & 1)

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
    pk2 = sk·P₂ (signature verification: a validator's signed votes)."""

    pk1: G1
    pk2: G2

    def verify(self, sig: Signature, msg: bytes) -> bool:
        h = hash_to_g1(msg, DST_SIG)
        return pairing_check([(sig.point, G2_GEN), (-h, self.pk2)])

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

    def sign(self, msg: bytes) -> Signature:
        return Signature(hash_to_g1(msg, DST_SIG) * self.scalar)

    def decrypt(self, ct: Ciphertext) -> Optional[bytes]:
        if not ct.verify():
            return None
        key = sha256(DST_ENC + (ct.u * self.scalar).to_bytes())
        return xor_stream(key, ct.v)


@wire("SecretKeyShare")
@dataclasses.dataclass(frozen=True)
class SecretKeyShare:
    """One node's share of the master secret (poly evaluated at idx+1)."""

    scalar: int

    def sign(self, msg: bytes) -> SignatureShare:
        return SignatureShare(hash_to_g1(msg, DST_SIG) * self.scalar)

    def sign_g1(self, h: G1) -> SignatureShare:
        return SignatureShare(h * self.scalar)

    def decrypt_share(self, ct: Ciphertext) -> Optional[DecryptionShare]:
        if not ct.verify():
            return None
        return DecryptionShare(ct.u * self.scalar)

    def decrypt_share_no_verify(self, ct: Ciphertext) -> DecryptionShare:
        return DecryptionShare(ct.u * self.scalar)

    def decrypt_shares_no_verify_batch(self, cts) -> list:
        """Batch counterpart (interface parity with the mock twin)."""
        return [self.decrypt_share_no_verify(ct) for ct in cts]


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

    def _share_cache(self) -> Dict[int, PublicKeyShare]:
        # memoized per index (frozen dataclass → side table)
        cache = getattr(self, "_pks_cache", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_pks_cache", cache)
        return cache

    def public_key_share(self, i: int) -> PublicKeyShare:
        """Node i's key share: the commitment evaluated at i+1."""
        cache = self._share_cache()
        if i not in cache:
            cache[i] = PublicKeyShare(self.commitment.evaluate(i + 1))
        return cache[i]

    def precompute_shares(self, n: int) -> None:
        """Fill the share cache for indices 0..n−1 in one pass (native
        forward-difference range evaluation when available)."""
        from .. import native as NT

        cache = self._share_cache()
        missing = [i for i in range(n) if i not in cache]
        if not missing:
            return
        if NT.available() and n > len(self.commitment.coeffs):
            wires = NT.g2_poly_eval_range(
                [NT.g2_wire(c) for c in self.commitment.coeffs], n, R
            )
            for i in missing:
                cache[i] = PublicKeyShare(NT.g2_unwire(wires[i], G2))
            return
        for i in missing:
            self.public_key_share(i)

    def seed_share_cache_from_scalars(self, scalars) -> None:
        """Fill the share cache from KNOWN share scalars (index →
        scalar): for consistently generated keys
        ``commitment.evaluate(i+1) == G2·share_i``, so each cached point
        is one shared-base comb product.  Only the co-simulation, which
        deals the keys centrally, holds the scalars."""
        from .. import native as NT

        cache = self._share_cache()
        missing = sorted(i for i in scalars if i not in cache)
        if not missing:
            return
        if NT.available():
            import numpy as np

            ks = np.frombuffer(
                b"".join(int(scalars[i] % R).to_bytes(32, "big") for i in missing),
                dtype=np.uint8,
            )
            raw = NT.g2_mul_many_raw(NT.g2_wire(G2_GEN), ks).tobytes()
            for j, i in enumerate(missing):
                cache[i] = PublicKeyShare(NT.g2_unwire(raw[j * 192 : (j + 1) * 192], G2))
            return
        for i in missing:
            cache[i] = PublicKeyShare(G2_GEN * scalars[i])

    # -- combination ------------------------------------------------------

    def combine_signatures(self, shares: Dict[int, SignatureShare]) -> Signature:
        """Lagrange-combine more than t shares; the deterministic subset
        is the lowest t+1 indices."""
        idxs = sorted(shares)[: self.threshold + 1]
        if len(idxs) <= self.threshold:
            raise ValueError("not enough signature shares")
        lams = lagrange_coefficients_at_zero([i + 1 for i in idxs])
        return Signature(g1_multi_exp([shares[i].point for i in idxs], lams))

    def combine_decryption_shares(
        self, shares: Dict[int, DecryptionShare], ct: Ciphertext
    ) -> bytes:
        idxs = sorted(shares)[: self.threshold + 1]
        if len(idxs) <= self.threshold:
            raise ValueError("not enough decryption shares")
        lams = lagrange_coefficients_at_zero([i + 1 for i in idxs])
        s = g1_multi_exp([shares[i].point for i in idxs], lams)
        return xor_stream(sha256(DST_ENC + s.to_bytes()), ct.v)

    def _subset_groups(
        self, rows: Sequence[Dict[int, DecryptionShare]]
    ) -> Dict[Tuple[int, ...], List[int]]:
        """Row indices grouped by their lowest-(t+1) index subset."""
        groups: Dict[Tuple[int, ...], List[int]] = {}
        for i, row in enumerate(rows):
            idxs = tuple(sorted(row)[: self.threshold + 1])
            if len(idxs) <= self.threshold:
                raise ValueError("not enough decryption shares")
            groups.setdefault(idxs, []).append(i)
        return groups

    def _combine_decryption_points(
        self, rows: Sequence[Dict[int, DecryptionShare]]
    ) -> List[G1]:
        """Each row's combined point s·U: rows sharing one subset run as
        ONE native many-MSM call over the shared Lagrange weights when
        there are four or more of them, else per row."""
        from .. import native as NT

        out: List[Optional[G1]] = [None] * len(rows)
        for idxs, members in sorted(self._subset_groups(rows).items()):
            sample = rows[members[0]][idxs[0]]
            lams = lagrange_coefficients_at_zero([i + 1 for i in idxs])
            if (
                NT.available()
                and len(members) >= 4
                and isinstance(sample, DecryptionShare)
                and isinstance(sample.point, G1)
            ):
                import numpy as np

                kbuf = np.frombuffer(
                    b"".join(int(l % R).to_bytes(32, "big") for l in lams),
                    dtype=np.uint8,
                )
                pts = np.frombuffer(
                    b"".join(NT.g1_wire(rows[i][j].point) for i in members for j in idxs),
                    dtype=np.uint8,
                )
                raw = NT.g1_msm_many_raw(len(members), len(idxs), pts, kbuf).tobytes()
                for mi, i in enumerate(members):
                    out[i] = NT.g1_unwire(raw[mi * 96 : (mi + 1) * 96], G1)
            else:
                for i in members:
                    out[i] = g1_multi_exp([rows[i][j].point for j in idxs], lams)
        return out

    def combine_decryption_shares_many(
        self,
        rows: Sequence[Dict[int, DecryptionShare]],
        cts: Sequence[Ciphertext],
    ) -> List[bytes]:
        """Batched combine across proposers, bit-identical to mapping
        :meth:`combine_decryption_shares` over the rows."""
        return [
            xor_stream(sha256(DST_ENC + p.to_bytes()), ct.v)
            for p, ct in zip(self._combine_decryption_points(rows), cts)
        ]

    def combine_and_check_decryption_shares(
        self, shares: Dict[int, DecryptionShare], ct: Ciphertext
    ) -> Optional[bytes]:
        """Speculative combine-first decryption: Lagrange-combine the
        lowest t+1 shares unverified and check the one combined point
        against the master key, e(s, P₂) == e(U, mpk₂); ``None`` on a
        mismatch (the caller falls back to per-share verification)."""
        idxs = sorted(shares)[: self.threshold + 1]
        if len(idxs) <= self.threshold:
            raise ValueError("not enough decryption shares")
        lams = lagrange_coefficients_at_zero([i + 1 for i in idxs])
        s = g1_multi_exp([shares[i].point for i in idxs], lams)
        if not pairing_check([(s, G2_GEN), (-ct.u, self.commitment.evaluate(0))]):
            return None
        return xor_stream(sha256(DST_ENC + s.to_bytes()), ct.v)

    def combine_and_check_decryption_shares_many(
        self,
        rows: Sequence[Dict[int, DecryptionShare]],
        cts: Sequence[Ciphertext],
    ) -> List[Optional[bytes]]:
        """Batched speculative combine: every row combined, then ALL
        combined points checked with ONE two-pairing RLC check
        e(Σ rᵢ·sᵢ, P₂) == e(Σ rᵢ·Uᵢ, mpk₂); on a mismatch each row is
        re-checked alone, so exactly the bad rows come back ``None``."""
        if not rows:
            return []
        pts = self._combine_decryption_points(rows)
        mpk2 = self.commitment.evaluate(0)
        rs = _rlc_coeffs(
            b"hbbft_tpu spec combine",
            [p.to_bytes() for p in pts] + [ct.u.to_bytes() for ct in cts],
        )[: len(rows)]
        agg_s = g1_multi_exp(pts, rs)
        agg_u = g1_multi_exp([ct.u for ct in cts], rs)

        def _key(p: G1, ct: Ciphertext) -> bytes:
            return xor_stream(sha256(DST_ENC + p.to_bytes()), ct.v)

        if pairing_check([(agg_s, G2_GEN), (-agg_u, mpk2)]):
            return [_key(p, ct) for p, ct in zip(pts, cts)]
        return [
            _key(p, ct) if pairing_check([(p, G2_GEN), (-ct.u, mpk2)]) else None
            for p, ct in zip(pts, cts)
        ]

    def verify_signature(self, sig: Signature, msg: bytes) -> bool:
        h = hash_to_g1(msg, DST_SIG)
        return pairing_check([(sig.point, G2_GEN), (-h, self.commitment.evaluate(0))])


@wire("SecretKeySet")
@dataclasses.dataclass(frozen=True)
class SecretKeySet:
    """Trusted-dealer secret polynomial (test and co-simulation key
    dealing; the DKG replaces it in production)."""

    poly: Poly

    @classmethod
    def random(cls, threshold: int, rng) -> "SecretKeySet":
        return cls(Poly.random(threshold, rng))

    @property
    def threshold(self) -> int:
        return self.poly.degree

    def secret_key_share(self, i: int) -> SecretKeyShare:
        return SecretKeyShare(self.poly.evaluate(i + 1))

    def public_keys(self) -> PublicKeySet:
        return PublicKeySet(self.poly.commitment(), G1_GEN * self.poly.coeffs[0])
