"""Hashing utilities: SHA-256 helpers, hash-to-G1, keyed streams.

The port's own copy of ``hbbft_tpu/crypto/hashing.py``.  All curve
hashing targets G1 (cheap Fq square roots, ``p ≡ 3 mod 4``);
``hash_to_g1`` is try-and-increment with cofactor clearing, and the
domain separation tags keep signatures, encryption and proofs in
disjoint oracle domains — byte-identical to the reference.
"""

from __future__ import annotations

import hashlib

from . import fields as F
from .curve import G1

DST_SIG = b"HBBFT_TPU_BLS_SIG_V1_"
DST_ENC = b"HBBFT_TPU_ENC_V1_"
DST_POK = b"HBBFT_TPU_POK_V1_"


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def sha512(data: bytes) -> bytes:
    return hashlib.sha512(data).digest()


def hash_to_fq(data: bytes) -> int:
    """512-bit digest reduced mod p (negligible bias: 2^-131)."""
    return int.from_bytes(sha512(data), "big") % F.P


def hash_to_fr(data: bytes) -> int:
    return int.from_bytes(sha512(data), "big") % F.R


def hash_to_g1(msg: bytes, dst: bytes = DST_SIG) -> G1:
    """Deterministic hash onto the G1 subgroup (try-and-increment +
    cofactor clearing).  Expected 2 iterations; bounded at 256."""
    from .. import native as NT

    nt = NT.backend()
    if nt is not None:
        return nt.g1_unwire(nt.hash_to_g1_bytes(msg, dst), G1)
    for ctr in range(256):
        x = hash_to_fq(dst + len(dst).to_bytes(1, "big") + msg + bytes([ctr]))
        y = F.fq_sqrt((x * x % F.P * x + 4) % F.P)
        if y is None:
            continue
        # canonical sign: the lexicographically smaller root, then clear
        # the cofactor to land in the r-torsion subgroup
        if y > F.P - y:
            y = F.P - y
        pt = G1(G1.ops["mul_raw"](G1.from_affine((x, y)).jac, F.H1))
        if not pt.is_infinity():
            return pt
    raise RuntimeError("hash_to_g1 failed (probability ~2^-256)")


def xor_stream(key: bytes, data: bytes) -> bytes:
    """SHA-256-CTR keystream XOR — the symmetric half of the hybrid
    encryption."""
    out = bytearray(len(data))
    block = 0
    pos = 0
    while pos < len(data):
        pad = sha256(key + block.to_bytes(8, "big"))
        n = min(32, len(data) - pos)
        for i in range(n):
            out[pos + i] = data[pos + i] ^ pad[i]
        pos += n
        block += 1
    return bytes(out)
