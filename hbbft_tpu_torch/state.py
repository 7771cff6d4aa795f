"""State carried across from the reference, as numpy arrays.

Two kinds of state move between the JAX package and the port as plain
numpy arrays, so the two packages never import each other.

**A keyed validator set** — the "weights" of this system — exported by
:func:`validator_set_arrays` from ``NetworkInfo`` maps of either package
(real BLS keys) and rebuilt by :func:`netinfos_from_arrays` into the
port's ``NetworkInfo`` map, so ``VectorizedHoneyBadgerSim.from_netinfos``
runs over exactly the reference's keys:

- ``node_ids``          [N] int64    — the validators, sorted;
- ``sk_share_scalars``  [N, 32] uint8 — secret key shares, big-endian;
- ``sk_scalars``        [N, 32] uint8 — individual secret keys;
- ``commitment_wires``  [t+1, 192] uint8 — the public key set's G2
  coefficient commitment (native wire);
- ``master_g1_wire``    [96] uint8   — the public key set's G1 master key;
- ``pk_wires``          [N, 192] uint8 — individual public keys' G2 half
  (``pk2``; the G1 half is recomputed from the secret key and checked).

**A flush's material** — public key shares, decryption shares and the
ciphertexts they answer:

- ``pk_wires``     [N, 192] uint8 — G2 public key shares (native wire);
- ``share_wires``  [K, 96] uint8  — G1 decryption shares (native wire);
- ``share_sender`` [K] int64      — row of ``pk_wires`` each share answers to;
- ``share_group``  [K] int64      — ciphertext each share decrypts;
- ``ct_u_wires``   [G, 96] uint8  — each ciphertext's U (native wire);
- ``ct_v``         [G, Vmax] uint8 and ``ct_v_len`` [G] int64 — V bytes;
- ``ct_c``, ``ct_z`` [G, 32] uint8 — the proof scalars, big-endian;
- ``point_limbs``  [K, 3, 38] int32 (optional) — device limbs of points.

:func:`to_arrays` exports obligations of either package (it only reads
``.affine()``, ``.u``, ``.v``, ``.c``, ``.z`` duck-typed);
:func:`from_reference` rebuilds the port's objects from the arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .core.network_info import NetworkInfo, resolve_ops
from .crypto import threshold as T
from .crypto.curve import G1, G2
from .crypto.poly import Commitment
from .crypto.threshold import Ciphertext, DecryptionShare, PublicKeyShare
from .device import DeviceLike, resolve_device
from .harness.batching import DecObligation


@dataclasses.dataclass
class ReferenceState:
    pk_shares: List[PublicKeyShare]
    ciphertexts: List[Ciphertext]
    obligations: List[DecObligation]
    point_limbs: Optional[torch.Tensor] = None


def _g1_wire(pt) -> bytes:
    return G1._wire_affine(pt.affine())


def _g2_wire(pt) -> bytes:
    return G2._wire_affine(pt.affine())


def _rows(items: Sequence[bytes], width: int) -> np.ndarray:
    if not items:
        return np.zeros((0, width), dtype=np.uint8)
    return np.frombuffer(b"".join(items), dtype=np.uint8).reshape(len(items), width)


def to_arrays(obligations: Sequence[Any]) -> Dict[str, np.ndarray]:
    """Export decryption obligations (``pk_share.point``, ``share.point``,
    ``ciphertext``) of either package as the arrays above.  Public key
    shares and ciphertexts are deduplicated in first-seen order."""
    pk_index: Dict[bytes, int] = {}
    ct_index: Dict[bytes, int] = {}
    pks: List[bytes] = []
    cts: List[Any] = []
    shares: List[bytes] = []
    sender: List[int] = []
    group: List[int] = []
    for ob in obligations:
        pkw = _g2_wire(ob.pk_share.point)
        if pkw not in pk_index:
            pk_index[pkw] = len(pks)
            pks.append(pkw)
        ct = ob.ciphertext
        ckey = _g1_wire(ct.u) + bytes(ct.v) + int(ct.c).to_bytes(32, "big") + int(
            ct.z
        ).to_bytes(32, "big")
        if ckey not in ct_index:
            ct_index[ckey] = len(cts)
            cts.append(ct)
        shares.append(_g1_wire(ob.share.point))
        sender.append(pk_index[pkw])
        group.append(ct_index[ckey])
    vmax = max((len(ct.v) for ct in cts), default=0)
    ct_v = np.zeros((len(cts), vmax), dtype=np.uint8)
    for i, ct in enumerate(cts):
        ct_v[i, : len(ct.v)] = np.frombuffer(bytes(ct.v), dtype=np.uint8)
    return {
        "pk_wires": _rows(pks, 192),
        "share_wires": _rows(shares, 96),
        "share_sender": np.asarray(sender, dtype=np.int64),
        "share_group": np.asarray(group, dtype=np.int64),
        "ct_u_wires": _rows([_g1_wire(ct.u) for ct in cts], 96),
        "ct_v": ct_v,
        "ct_v_len": np.asarray([len(ct.v) for ct in cts], dtype=np.int64),
        "ct_c": _rows([int(ct.c).to_bytes(32, "big") for ct in cts], 32),
        "ct_z": _rows([int(ct.z).to_bytes(32, "big") for ct in cts], 32),
    }


def _g1_from_wire(w: bytes) -> G1:
    if not any(w):
        return G1.infinity()
    return G1.from_affine((int.from_bytes(w[:48], "big"), int.from_bytes(w[48:], "big")))


def _g2_from_wire(w: bytes) -> G2:
    if not any(w):
        return G2.infinity()
    v = [int.from_bytes(w[i * 48 : (i + 1) * 48], "big") for i in range(4)]
    return G2.from_affine(((v[0], v[1]), (v[2], v[3])))


def from_reference(
    arrays: Dict[str, np.ndarray], device: DeviceLike = None
) -> ReferenceState:
    """Rebuild the port's objects from exported arrays.  Points are
    checked to lie on their curves; ``point_limbs``, when present, lands
    on ``device`` (the card by default)."""
    pk_shares = [
        PublicKeyShare(_g2_from_wire(row.tobytes())) for row in arrays["pk_wires"]
    ]
    cts = [
        Ciphertext(
            _g1_from_wire(arrays["ct_u_wires"][g].tobytes()),
            arrays["ct_v"][g, : int(arrays["ct_v_len"][g])].tobytes(),
            int.from_bytes(arrays["ct_c"][g].tobytes(), "big"),
            int.from_bytes(arrays["ct_z"][g].tobytes(), "big"),
        )
        for g in range(arrays["ct_u_wires"].shape[0])
    ]
    obligations = [
        DecObligation(
            pk_shares[int(i)],
            DecryptionShare(_g1_from_wire(row.tobytes())),
            cts[int(g)],
        )
        for row, i, g in zip(
            arrays["share_wires"], arrays["share_sender"], arrays["share_group"]
        )
    ]
    limbs = arrays.get("point_limbs")
    if limbs is not None:
        limbs = torch.as_tensor(np.asarray(limbs, dtype=np.int32)).to(
            resolve_device(device)
        )
    return ReferenceState(pk_shares, cts, obligations, limbs)


# ---------------------------------------------------------------------------
# A keyed validator set
# ---------------------------------------------------------------------------


def _scalar_rows(xs: Sequence[int]) -> np.ndarray:
    return _rows([int(x).to_bytes(32, "big") for x in xs], 32)


def validator_set_arrays(netinfos: Dict[Any, Any]) -> Dict[str, np.ndarray]:
    """Export a real-BLS ``NetworkInfo`` map of either package (duck
    typed: ``secret_key_share.scalar``, ``secret_key.scalar``,
    ``public_key_set.commitment.coeffs`` / ``.master_g1``,
    ``public_key(nid).pk2``) as the arrays above.  Node ids must be
    integers."""
    ids = sorted(netinfos)
    ref = netinfos[ids[0]]
    pk_set = ref.public_key_set
    return {
        "node_ids": np.asarray(ids, dtype=np.int64),
        "sk_share_scalars": _scalar_rows(
            [netinfos[nid].secret_key_share.scalar for nid in ids]
        ),
        "sk_scalars": _scalar_rows([netinfos[nid].secret_key.scalar for nid in ids]),
        "commitment_wires": _rows(
            [_g2_wire(c) for c in pk_set.commitment.coeffs], 192
        ),
        "master_g1_wire": np.frombuffer(_g1_wire(pk_set.master_g1), dtype=np.uint8).copy(),
        "pk_wires": _rows([_g2_wire(ref.public_key(nid).pk2) for nid in ids], 192),
    }


def netinfos_from_arrays(
    arrays: Dict[str, np.ndarray], ops: Any = None
) -> Dict[int, NetworkInfo]:
    """Rebuild the port's ``NetworkInfo`` map from
    :func:`validator_set_arrays`: points are checked to lie on their
    curves, every public key's G2 half must equal the secret key's, and
    every share scalar's G2 key must equal the commitment evaluated at
    its index + 1; the share cache is then the one ``generate_map``
    fills.  ``ops`` as ``core.network_info.resolve_ops`` (the card by
    default)."""
    ops = resolve_ops(ops)
    ids = [int(i) for i in arrays["node_ids"]]
    commitment = Commitment(
        [_g2_from_wire(row.tobytes()) for row in arrays["commitment_wires"]]
    )
    master_g1 = _g1_from_wire(
        np.asarray(arrays["master_g1_wire"], dtype=np.uint8).tobytes()
    )
    pk_set = T.PublicKeySet(commitment, master_g1)
    shares = [
        T.SecretKeyShare(int.from_bytes(row.tobytes(), "big"))
        for row in arrays["sk_share_scalars"]
    ]
    pk_set.seed_share_cache_from_scalars({i: ks.scalar for i, ks in enumerate(shares)})
    published = T.PublicKeySet(commitment, master_g1)
    published.precompute_shares(len(shares))
    for i, nid in enumerate(ids):
        got = pk_set.public_key_share(i).point
        if _g2_wire(got) != _g2_wire(published.public_key_share(i).point):
            raise ValueError(
                f"key share of node {nid} does not match the commitment"
            )
    sec_keys, pub_keys = {}, {}
    for nid, sk_row, pk_row in zip(ids, arrays["sk_scalars"], arrays["pk_wires"]):
        sk = T.SecretKey(int.from_bytes(sk_row.tobytes(), "big"))
        pk = sk.public_key()
        if _g2_wire(pk.pk2) != pk_row.tobytes():
            raise ValueError(f"public key of node {nid} does not match its secret key")
        sec_keys[nid], pub_keys[nid] = sk, pk
    return {
        nid: NetworkInfo(nid, shares[i], sec_keys[nid], pk_set, pub_keys, ops=ops)
        for i, nid in enumerate(ids)
    }
