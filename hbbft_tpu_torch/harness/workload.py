"""The decryption-share flush workload of one HoneyBadger epoch.

N validators hold key shares xᵢ (public key shares xᵢ·P₂); every flush
verifies the decryption shares xᵢ·U_g of all N validators for G fresh
ciphertexts — N·G real BLS12-381 shares, the N² hot path of an epoch
(``bench.py``'s ``share_verify_throughput`` headline shape, N = 1024,
G = 64).  Every call makes fresh ciphertexts, so per-flush
serialization is paid as a real epoch pays it.
"""

from __future__ import annotations

import random
from typing import List

from .. import native as NT
from ..crypto import fields as F
from ..crypto import threshold as T
from ..crypto.curve import G1, G2_GEN
from .batching import DecObligation


class DecryptionFlushWorkload:
    def __init__(self, n_nodes: int, rng: random.Random):
        self.rng = rng
        self.xs = [rng.randrange(1, F.R) for _ in range(n_nodes)]
        self.pk_shares = [T.PublicKeyShare(G2_GEN * x) for x in self.xs]
        self.master = T.SecretKey.random(rng).public_key()

    def obligations(self, tag: bytes, groups: int) -> List[DecObligation]:
        """N·groups decryption obligations over ``groups`` fresh
        ciphertexts, group-major."""
        obs: List[DecObligation] = []
        for g in range(groups):
            ct = self.master.encrypt(tag + b"-%d" % g, self.rng)
            if NT.available():
                wires = NT.g1_mul_many(NT.g1_wire(ct.u), self.xs)
                shares = [T.DecryptionShare(NT.g1_unwire(w, G1)) for w in wires]
            else:
                shares = [T.SecretKeyShare(x).decrypt_share_no_verify(ct) for x in self.xs]
            obs.extend(
                DecObligation(pk, share, ct) for pk, share in zip(self.pk_shares, shares)
            )
        return obs
