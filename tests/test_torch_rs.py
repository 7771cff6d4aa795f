"""The broadcast plane and the codec of the port's epoch.

The port's ``core/serialize.py`` (``dumps``/``loads``), ``crypto/merkle.py``
and ``crypto/rs.py`` against the reference's on seeded inputs, tolerance
0 (byte equality): encodings, decodings across packages, Merkle levels,
roots and proofs (native and pure-Python builds), and the GF(2^8) and
GF(2^16) Reed–Solomon codecs' shards, reconstructions and decode
matrices.
"""

import random

import numpy as np
import pytest

from hbbft_tpu.core import serialize as RS_
from hbbft_tpu.crypto import merkle as RMK
from hbbft_tpu.crypto import mock as RM
from hbbft_tpu.crypto import rs as RRS
from hbbft_tpu.crypto import threshold as RT
from hbbft_tpu.crypto.curve import G1_GEN as RG1, G2_GEN as RG2
from hbbft_tpu.protocols.honey_badger import Batch as RBatch
from hbbft_tpu_torch import native as PN
from hbbft_tpu_torch.core import serialize as PS_
from hbbft_tpu_torch.crypto import merkle as PMK
from hbbft_tpu_torch.crypto import mock as PM
from hbbft_tpu_torch.crypto import rs as PRS
from hbbft_tpu_torch.crypto import threshold as PT
from hbbft_tpu_torch.crypto.curve import G1_GEN as PG1, G2_GEN as PG2
from hbbft_tpu_torch.protocols import broadcast as PB
from hbbft_tpu_torch.protocols.honey_badger import Batch as PBatch, ordered_batch_digest


def _objects(pkg):
    """One value of every shape the epoch serializes, built the same way
    in either package (``pkg``: ref or port modules)."""
    T, M, G1, G2, Batch = pkg
    rng = random.Random(0x5E)
    master = T.SecretKey.random(rng).public_key()
    ct = master.encrypt(b"contribution", rng)
    return [
        None,
        True,
        False,
        0,
        -1,
        2**300 + 7,
        b"",
        b"\x00\xff" * 200,
        "text ✓",
        [1, [2, (3, b"x")]],
        (None, "a"),
        {b"k": 1, 3: [b"v"], "s": {2: None}},
        list(range(300)),
        G1 * 12345,
        G2 * 678,
        ct,
        T.DecryptionShare(ct.u * 99),
        Batch(3, {0: [b"tx0", b"tx1"], 5: [7, 8]}),
        M.MockCiphertext(b"s" * 32, b"n" * 16, b"payload", b"m" * 32),
        M.MockDecryptionShare(b"\x00" * 32, b"\x01" * 32),
    ]


REF = (RT, RM, RG1, RG2, RBatch)
PORT = (PT, PM, PG1, PG2, PBatch)


@pytest.mark.parametrize("i", range(20))
def test_dumps_loads_agree_with_reference(i):
    r, p = _objects(REF)[i], _objects(PORT)[i]
    rb, pb = RS_.dumps(r), PS_.dumps(p)
    assert pb == rb
    # each package decodes the other's bytes and re-encodes them exactly
    assert PS_.dumps(PS_.loads(rb)) == rb
    assert RS_.dumps(RS_.loads(pb)) == pb


def test_loads_rejects_malformed_input_like_the_reference():
    good = RS_.dumps(_objects(REF)[15])
    for bad in (good[:-1], good + b"\x00", b"\x09\x03Foo\x00", b"\x7f", b"\x07" * 100):
        with pytest.raises(RS_.SerializationError):
            RS_.loads(bad)
        with pytest.raises(PS_.SerializationError):
            PS_.loads(bad)
    g1 = bytearray(RS_.dumps(RG1 * 5))
    g1[-1] ^= 1  # off the curve or out of the subgroup
    with pytest.raises(PS_.SerializationError):
        PS_.loads(bytes(g1))


def test_ordered_batch_digest_matches_reference():
    from hbbft_tpu.protocols.honey_badger import ordered_batch_digest as ref_digest

    r, p = _objects(REF), _objects(PORT)
    assert ordered_batch_digest(4, {0: p[15], 2: p[18]}) == ref_digest(4, {0: r[15], 2: r[18]})


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 33])
@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_merkle_levels_roots_and_proofs(n, native, monkeypatch):
    rng = random.Random(n)
    values = [bytes(rng.randrange(256) for _ in range(rng.randrange(0, 40))) for _ in range(n)]
    if not native:
        monkeypatch.setattr(PN, "available", lambda: False)
    rt, pt = RMK.MerkleTree(values), PMK.MerkleTree(values)
    assert pt.levels == rt.levels
    assert pt.root_hash == rt.root_hash
    for i in range(n):
        rp, pp = rt.proof(i), pt.proof(i)
        assert PS_.dumps(pp) == RS_.dumps(rp)
        assert pp.validate(n)
        forged = PMK.MerkleProof(pp.value + b"!", pp.index, pp.lemma, pp.root_hash)
        assert not forged.validate(n)


def _shards(codec_k, length, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, length, dtype=np.uint8).tobytes() for _ in range(codec_k)]


def test_reed_solomon_gf256_n7_f2():
    k, m = 3, 4  # n = 7, f = 2: N − 2f data shards, 2f parity
    r, p = RRS.ReedSolomon(k, m), PRS.ReedSolomon(k, m)
    assert np.array_equal(p.matrix, r.matrix)
    data = _shards(k, 37, 1)
    enc = p.encode(data)
    assert enc == r.encode(data)
    erased = [s if i not in (0, 2, 5, 6) else None for i, s in enumerate(enc)]
    assert p.reconstruct(list(erased)) == r.reconstruct(list(erased)) == enc
    assert np.array_equal(p.decode_matrix([1, 3, 4]), r.decode_matrix([1, 3, 4]))
    with pytest.raises(ValueError):
        p.reconstruct([enc[0]] + [None] * 6)


def test_reed_solomon_gf65536_300_shards_short():
    k, m = 102, 198  # n = 300, f = 99: past GF(2^8)'s 256-shard cap
    r, p = RRS.make_codec(k, m), PRS.make_codec(k, m)
    assert isinstance(p, PRS.ReedSolomon16) and p.symbol == 2
    assert np.array_equal(p.matrix, r.matrix)
    data = PB.frame_into_shards(b"short payload", k, p.symbol)
    assert all(len(s) == 2 for s in data)
    enc = p.encode(data)
    assert enc == r.encode(data)
    lost = set(range(0, 300, 3)) | {1, 2}
    erased = [None if i in lost else s for i, s in enumerate(enc)]
    assert p.reconstruct(list(erased)) == r.reconstruct(list(erased)) == enc
    assert PB.unframe_shards(enc[:k], k) == b"short payload"
