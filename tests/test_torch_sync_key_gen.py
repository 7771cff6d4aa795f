"""The port's sequential DKG (``SyncKeyGen``) against the reference's.

The scenarios of ``tests/test_sync_key_gen.py`` — t+1 Parts, 2t+1 Acks a
part, real and mock crypto, an observer, a faulty dealer — run through
the reference and the port from one seed: every Part and Ack ``dumps``
to the same bytes, every fault log is identical, and every node's key
set and secret key share have the reference's bytes (tolerance 0).  The
generated keys then sign, combine, encrypt and decrypt.  Also the
bivariate polynomial and its G2 commitment (``crypto/poly.py``).
"""

import random

import pytest

from torch_twin import twin


def _dkg(side, n, mock, seed, observer=False):
    rng = random.Random(seed)
    threshold = (n - 1) // 3
    key_cls = side.mock.MockSecretKey if mock else side.T.SecretKey
    sec_keys = {i: key_cls.random(rng) for i in range(n)}
    pub_keys = {i: sk.public_key() for i, sk in sec_keys.items()}
    nodes = {i: side.skg.SyncKeyGen(i, sec_keys[i], pub_keys, threshold, rng) for i in range(n)}
    if observer:
        nodes["observer"] = side.skg.SyncKeyGen("observer", key_cls.random(rng), pub_keys, threshold, rng)
        assert nodes["observer"].our_part is None
    parts, acks, faults = [], [], []
    for proposer in range(threshold + 1):
        part = nodes[proposer].our_part
        parts.append(part)
        for i, node in nodes.items():
            ack, fl = node.handle_part(proposer, part, rng)
            faults.append([f.compact() for f in fl])
            if i == "observer":
                assert ack is None
            elif i < 2 * threshold + 1:
                assert ack is not None
                acks.append((i, ack))
    for acker, ack in acks:
        for node in nodes.values():
            faults.append([f.compact() for f in node.handle_ack(acker, ack)])
    assert all(not f for f in faults)
    assert all(node.is_ready() for node in nodes.values())
    keys = {str(i): node.generate() for i, node in nodes.items()}
    return {"parts": parts, "acks": acks, "faults": faults, "keys": keys, "rng": rng.getrandbits(64)}


@pytest.mark.parametrize("n", [1, 2, 4, 7])
def test_dkg_mock_matches_reference(n):
    ref, port = twin(_dkg, n, True, 50 + n)
    pk_set = port["keys"]["0"][0]
    assert all(k[0] == pk_set for k in port["keys"].values())
    shares = {i: port["keys"][str(i)][1].sign(b"msg") for i in range(n)}
    assert pk_set.public_key().verify(pk_set.combine_signatures(shares), b"msg")


@pytest.mark.parametrize("n", [1, 4])
def test_dkg_real_bls_matches_reference(n):
    ref, port = twin(_dkg, n, False, 60 + n)
    threshold = (n - 1) // 3
    keys = port["keys"]
    pk = keys["0"][0]
    msg = b"Test message!"
    shares = {i: keys[str(i)][1].sign(msg) for i in range(n)}
    for i in range(n):
        assert pk.public_key_share(i).verify_signature_share(shares[i], msg)
    sig = pk.combine_signatures({i: shares[i] for i in range(threshold + 1)})
    assert pk.verify_signature(sig, msg)
    ct = pk.public_key().encrypt(b"post-dkg secret", random.Random(1))
    dec = {i: keys[str(i)][1].decrypt_share_no_verify(ct) for i in range(threshold + 1)}
    assert all(pk.public_key_share(i).verify_decryption_share(d, ct) for i, d in dec.items())
    assert pk.combine_decryption_shares(dec, ct) == b"post-dkg secret"


def test_dkg_observer_matches_reference():
    ref, port = twin(_dkg, 4, False, 70, observer=True)
    pk_obs, sks_obs = port["keys"]["observer"]
    assert sks_obs is None and pk_obs.commitment == port["keys"]["0"][0].commitment


def _faulty_dealer(side, seed):
    rng = random.Random(seed)
    sec_keys = {i: side.T.SecretKey.random(rng) for i in range(4)}
    pub_keys = {i: sk.public_key() for i, sk in sec_keys.items()}
    node = side.skg.SyncKeyGen(1, sec_keys[1], pub_keys, 1, rng)
    good = side.skg.SyncKeyGen(0, sec_keys[0], pub_keys, 1, rng)
    part = good.our_part
    rows = list(part.rows)
    rows[1], rows[2] = rows[2], rows[1]  # node 1 decrypts the wrong row
    swapped = side.skg.Part(part.commit, tuple(rows), part.master_g1)
    wrong_g1 = side.skg.Part(part.commit, part.rows, part.master_g1 + part.master_g1)
    out = []
    for bad in (swapped, wrong_g1, "junk"):
        fresh = side.skg.SyncKeyGen(1, sec_keys[1], pub_keys, 1, rng)
        ack, faults = fresh.handle_part(0, bad, rng)
        assert ack is None
        out.append([f.compact() for f in faults])
    ack, faults = node.handle_part(0, part, rng)
    out.append([f.compact() for f in faults])
    # an Ack whose value for node 2 is wrong, a duplicate, a bad index
    bad_ack = side.skg.Ack(0, tuple(reversed(ack.values)))
    node2 = side.skg.SyncKeyGen(2, sec_keys[2], pub_keys, 1, rng)
    node2.handle_part(0, part, rng)
    for a in (bad_ack, ack, ack, side.skg.Ack("x", ack.values), side.skg.Ack(7, ack.values)):
        out.append([f.compact() for f in node2.handle_ack(1, a)])
    return out


def test_dkg_faulty_dealer_and_acks_match_reference():
    ref, port = twin(_faulty_dealer, 71)
    assert port[0] == ["0:INVALID_PART"] and port[1] == ["0:INVALID_PART"]


def _bivar(side, seed):
    rng = random.Random(seed)
    P = side.poly
    bivar = P.BivarPoly.random(2, rng)
    commit = bivar.commitment()
    row = bivar.row(3)
    return {
        "bivar": bivar,
        "commit": commit,
        "eval": [bivar.evaluate(x, y) for x in range(4) for y in range(4)],
        "ceval": [commit.evaluate(x, y) for x in (0, 2, 5) for y in (1, 3)],
        "row": row,
        "crow": commit.row(3),
        "row_ok": [row.commitment() == commit.row(3), commit.is_symmetric()],
        "sum": commit.row(0) + commit.row(1),
    }


def test_bivariate_commitment_matches_reference():
    twin(_bivar, 72)
