"""Insecure hash-based mock crypto — fast protocol-logic testing.

The port's own copy of ``hbbft_tpu/crypto/mock.py`` (same wire names,
same tags, same bytes).  Drop-in interface twins of the real threshold
types in ``crypto/threshold.py`` with identical *functional* semantics:

- combining any > t verified shares yields the same deterministic result
  (like Lagrange interpolation does);
- forged or wrong shares fail share verification (so fault attribution
  paths behave exactly as with real BLS);
- threshold encryption round-trips and ``Ciphertext.verify`` rejects
  tampered ciphertexts.

None of the security: every key object carries the group seed.  This
exists so the adversarial protocol sweeps (reference test strategy,
SURVEY §4 — dozens of full network simulations per test file) run in
milliseconds, while the real-BLS path is exercised by dedicated crypto
tests and smaller real-crypto integration runs.  **Never use outside
tests/benchmarks.**
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from .hashing import sha256, xor_stream
from ..core.serialize import dumps, wire


def _tag_preimage(*parts: bytes) -> bytes:
    out = []
    for p in parts:
        out.append(len(p).to_bytes(4, "big"))
        out.append(p)
    return b"".join(out)


def _tag(*parts: bytes) -> bytes:
    return sha256(_tag_preimage(*parts))


def _idx(i: int) -> bytes:
    return i.to_bytes(8, "big")


_KEY_CACHE: dict = {}  # (seed, nonce) → symmetric key


def _enc_key(seed: bytes, nonce: bytes) -> bytes:
    """The per-ciphertext symmetric key — memoized because a co-simulated
    decryption round derives it once per (group, ciphertext) but calls
    ``decrypt_share_no_verify`` per *(sender, ciphertext)* (N× more)."""
    k = (seed, nonce)
    key = _KEY_CACHE.get(k)
    if key is None:
        if len(_KEY_CACHE) > 1 << 16:
            _KEY_CACHE.clear()
        key = _tag(b"KEY", seed, nonce)
        _KEY_CACHE[k] = key
    return key


@wire("MockSig")
@dataclasses.dataclass(frozen=True)
class MockSignature:
    tag: bytes

    def parity(self) -> bool:
        return bool(self.tag[0] & 1)

    def to_bytes(self) -> bytes:
        return self.tag


@wire("MockSigShare")
@dataclasses.dataclass(frozen=True)
class MockSignatureShare:
    tag: bytes
    combined: bytes  # the group signature this share contributes to

    def to_bytes(self) -> bytes:
        return self.tag + self.combined


@wire("MockDecShare")
@dataclasses.dataclass(frozen=True)
class MockDecryptionShare:
    tag: bytes
    key: bytes  # the symmetric key this share contributes to

    def to_bytes(self) -> bytes:
        return self.tag + self.key


@wire("MockCiphertext")
@dataclasses.dataclass(frozen=True)
class MockCiphertext:
    seed_id: bytes
    nonce: bytes
    v: bytes
    mac: bytes

    def verify(self) -> bool:
        return self.mac == _tag(b"CTMAC", self.seed_id, self.nonce, self.v)

    def to_bytes(self) -> bytes:
        # memoized — the batching layer keys caches by these bytes
        cached = getattr(self, "_bytes", None)
        if cached is None:
            cached = dumps(self)
            object.__setattr__(self, "_bytes", cached)
        return cached


@wire("MockPublicKey")
@dataclasses.dataclass(frozen=True)
class MockPublicKey:
    seed: bytes

    def verify(self, sig: MockSignature, msg: bytes) -> bool:
        return sig.tag == _tag(b"SIG", self.seed, msg)

    def encrypt(self, msg: bytes, rng) -> MockCiphertext:
        nonce = rng.randrange(2**128).to_bytes(16, "big")
        seed_id = _tag(b"SEEDID", self.seed)
        v = xor_stream(_enc_key(self.seed, nonce), msg)
        return MockCiphertext(
            seed_id, nonce, v, _tag(b"CTMAC", seed_id, nonce, v)
        )

    def to_bytes(self) -> bytes:
        return self.seed


@wire("MockSecretKey")
@dataclasses.dataclass(frozen=True)
class MockSecretKey:
    seed: bytes

    @classmethod
    def random(cls, rng) -> "MockSecretKey":
        return cls(rng.randrange(2**256).to_bytes(32, "big"))

    def public_key(self) -> MockPublicKey:
        return MockPublicKey(self.seed)

    def sign(self, msg: bytes) -> MockSignature:
        return MockSignature(_tag(b"SIG", self.seed, msg))

    def decrypt(self, ct: MockCiphertext) -> Optional[bytes]:
        if not ct.verify():
            return None
        return xor_stream(_enc_key(self.seed, ct.nonce), ct.v)


@wire("MockSecretKeyShare")
@dataclasses.dataclass(frozen=True)
class MockSecretKeyShare:
    seed: bytes
    index: int

    def sign(self, msg: bytes) -> MockSignatureShare:
        combined = _tag(b"SIG", self.seed, msg)
        return MockSignatureShare(
            _tag(b"SIGSHARE", self.seed, _idx(self.index), combined), combined
        )

    def decrypt_share(self, ct: MockCiphertext) -> Optional[MockDecryptionShare]:
        if not ct.verify():
            return None
        return self.decrypt_share_no_verify(ct)

    def decrypt_share_no_verify(self, ct: MockCiphertext) -> MockDecryptionShare:
        key = _enc_key(self.seed, ct.nonce)
        return MockDecryptionShare(
            _tag(b"DECSHARE", self.seed, _idx(self.index), key), key
        )

    def decrypt_shares_no_verify_batch(self, cts) -> list:
        """Batch of :meth:`decrypt_share_no_verify` — one batched hash
        call for all tags (the co-simulated decryption phase generates
        t+1 × P shares; the per-call ``_tag`` overhead dominated the
        mock epoch profile).  Preimages go through the same
        ``_tag_preimage`` as :func:`_tag`, so batch- and singly-built
        shares are byte-identical by construction."""
        from .backend import CpuBackend

        keys = [_enc_key(self.seed, ct.nonce) for ct in cts]
        # _tag_preimage concatenates independent per-part frames, so the
        # loop-invariant prefix hoists without any framing drift risk
        prefix = _tag_preimage(b"DECSHARE", self.seed, _idx(self.index))
        msgs = [prefix + _tag_preimage(k) for k in keys]
        tags = CpuBackend().sha256_many(msgs)
        return [
            MockDecryptionShare(t, k) for t, k in zip(tags, keys)
        ]


@wire("MockPublicKeyShare")
@dataclasses.dataclass(frozen=True)
class MockPublicKeyShare:
    seed: bytes
    index: int

    def verify_signature_share(self, share: MockSignatureShare, msg: bytes) -> bool:
        combined = _tag(b"SIG", self.seed, msg)
        return share.combined == combined and share.tag == _tag(
            b"SIGSHARE", self.seed, _idx(self.index), combined
        )

    def verify_decryption_share(
        self, share: MockDecryptionShare, ct: MockCiphertext
    ) -> bool:
        key = _enc_key(self.seed, ct.nonce)
        return share.key == key and share.tag == _tag(
            b"DECSHARE", self.seed, _idx(self.index), key
        )

    def to_bytes(self) -> bytes:
        return self.seed + _idx(self.index)


@wire("MockPublicKeySet")
@dataclasses.dataclass(frozen=True)
class MockPublicKeySet:
    seed: bytes
    threshold_: int

    @property
    def threshold(self) -> int:
        return self.threshold_

    def public_key(self) -> MockPublicKey:
        return MockPublicKey(self.seed)

    def public_key_share(self, i: int) -> MockPublicKeyShare:
        return MockPublicKeyShare(self.seed, i)

    def combine_signatures(
        self, shares: Dict[int, MockSignatureShare]
    ) -> MockSignature:
        if len(shares) <= self.threshold_:
            raise ValueError("not enough signature shares")
        # Deterministic, subset-independent — mirrors Lagrange combine.
        first = shares[sorted(shares)[0]]
        return MockSignature(first.combined)

    def combine_decryption_shares(
        self, shares: Dict[int, MockDecryptionShare], ct: MockCiphertext
    ) -> bytes:
        if len(shares) <= self.threshold_:
            raise ValueError("not enough decryption shares")
        first = shares[sorted(shares)[0]]
        return xor_stream(first.key, ct.v)

    def combine_and_check_decryption_shares(
        self, shares: Dict[int, MockDecryptionShare], ct: MockCiphertext
    ) -> Optional[bytes]:
        """Speculative combine-first twin of the real scheme: returns
        the plaintext if the lowest-(t+1) subset combines to a valid
        result, ``None`` on mismatch (caller falls back to per-share
        verification for fault attribution).  Real Lagrange combination
        depends on *every* subset share, so this checks each subset
        member against the group key — a bogus share anywhere in the
        subset fails the combined check exactly as it would perturb
        the real interpolation off the s·U ray."""
        if len(shares) <= self.threshold_:
            raise ValueError("not enough decryption shares")
        idxs = sorted(shares)[: self.threshold_ + 1]
        key = _enc_key(self.seed, ct.nonce)
        for i in idxs:
            share = shares[i]
            if share.key != key or share.tag != _tag(
                b"DECSHARE", self.seed, _idx(i), key
            ):
                return None
        return xor_stream(key, ct.v)

    def combine_and_check_decryption_shares_many(
        self, rows, cts
    ) -> list:
        return [
            self.combine_and_check_decryption_shares(row, ct)
            for row, ct in zip(rows, cts)
        ]

    def verify_signature(self, sig: MockSignature, msg: bytes) -> bool:
        return sig.tag == _tag(b"SIG", self.seed, msg)


@dataclasses.dataclass(frozen=True)
class MockSecretKeySet:
    seed: bytes
    threshold_: int

    @classmethod
    def random(cls, threshold: int, rng) -> "MockSecretKeySet":
        return cls(rng.randrange(2**256).to_bytes(32, "big"), threshold)

    @property
    def threshold(self) -> int:
        return self.threshold_

    def secret_key_share(self, i: int) -> MockSecretKeyShare:
        return MockSecretKeyShare(self.seed, i)

    def public_keys(self) -> MockPublicKeySet:
        return MockPublicKeySet(self.seed, self.threshold_)
