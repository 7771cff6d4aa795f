"""Vectorized decryption phase — every validator's shares, one flush.

The port's own copy of the parts of ``hbbft_tpu/harness/vectorized.py``
that the vectorized HoneyBadger epoch (``harness/epoch.py``) runs:

- ``batch_sign_shares``: every sender's coin signature share on one
  nonce in one native shared-base call;
- ``_stage_real_shares``: the epoch's whole decryption-share matrix
  (x_i·U for every sender and ciphertext) in one native call, each
  share's wire memoized so the flush ships exactly these bytes;
- ``decrypt_round``: emission, the optional speculative
  combine-and-check, ONE grouped verification flush through the
  batching façade (``BatchingBackend.prefetch`` → the card), lookups
  with per-sender fault attribution, and the Lagrange combines;
- ``decrypt_rounds_deferred``: the same for several ordered-but-
  unrevealed epochs with the crypto fused across them;
- ``packed_decrypt_attribution``: the packed co-simulation's replay of
  ``decrypt_round``'s fault attribution from counts.

Equivalence (the reference's argument): Lagrange interpolation yields
the unique result from any t+1 valid shares, and each distinct share is
verified once, so outcomes and fault attribution equal the sequential
protocol's.  The single-phase round classes are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Any, Dict, List, Optional, Set

import numpy as np

from .. import native as NT
from ..core.fault import FaultKind, FaultLog
from ..core.network_info import NetworkInfo
from ..crypto import threshold as T
from ..crypto.curve import G1
from ..crypto.hashing import DST_SIG, hash_to_g1
from .batching import BatchingBackend, DecObligation


@dataclasses.dataclass
class DecryptionRound:
    """Outcome of one vectorized HoneyBadger decryption phase."""

    contributions: Dict[Any, bytes]  # proposer → decrypted plaintext
    fault_log: FaultLog
    shares_verified: int  # verifications actually performed (after the
    # verify_honest elision this excludes self-generated honest shares)
    emitted: Dict[Any, Dict[Any, Any]] = dataclasses.field(
        default_factory=dict
    )  # proposer → {sender → share}: the network-visible share traffic
    # (honest + forged) — what an observer sees on the wire
    phases: Dict[str, float] = dataclasses.field(
        default_factory=dict
    )  # wall seconds: staging / emit / flush / lookup / combine
    spec: Dict[str, int] = dataclasses.field(
        default_factory=dict
    )  # speculative combine counters: hits / misses (empty when eager)


def batch_sign_shares(
    netinfos: Dict[Any, NetworkInfo],
    senders,
    nonce: bytes,
    base=None,
) -> Dict[Any, Any]:
    """The co-simulation's sign phase: every sender signs the SAME
    nonce, i.e. x_i·H(nonce) over one shared base — a single native
    fixed-base-comb call for all products (``hb_g1_mul_many``),
    bit-identical to ``SecretKeyShare.sign``.  Falls back to per-sender
    ``sign`` internally (mock crypto, no native library), so callers
    never branch.  ``base``: the caller's precomputed
    ``hash_to_g1(nonce, DST_SIG)`` (avoids a second hash-to-curve)."""
    if not senders:
        return {}
    sk0 = netinfos[senders[0]].secret_key_share
    if NT.available() and isinstance(sk0, T.SecretKeyShare):
        if base is None:
            base = hash_to_g1(nonce, DST_SIG)
        wires = NT.g1_mul_many(
            NT.g1_wire(base),
            [netinfos[nid].secret_key_share.scalar for nid in senders],
        )
        return {
            nid: T.SignatureShare(NT.g1_unwire(w, G1))
            for nid, w in zip(senders, wires)
        }
    return {
        nid: netinfos[nid].secret_key_share.sign(nonce) for nid in senders
    }


def _stage_real_shares(
    netinfos, sorted_cts, dead, forged, emit_senders
) -> Optional[Dict[Any, Dict[Any, Any]]]:
    """Real-BLS fast staging: each ciphertext's decryption shares are
    x_i·U for ONE shared base U, so all senders' shares of one
    ciphertext batch into a single native shared-base call
    (``hb_g1_mul_many``) instead of a ctypes crossing + wire decode
    per (sender, ciphertext) product.  Bit-identical to
    ``decrypt_share_no_verify`` (same scalar, same base, same wire
    math).  Returns None when the fast path does not apply (mock
    crypto, no native library) — the per-sender batch generator in the
    emission loop then handles it."""
    if not sorted_cts or not NT.available():
        return None
    if not isinstance(sorted_cts[0][1], T.Ciphertext):
        return None
    senders = [
        nid
        for nid in sorted(netinfos)
        if nid not in dead
        and (emit_senders is None or nid in emit_senders or nid in forged)
    ]
    if not senders:
        return None
    # ONE native call for the whole staging matrix (not a ctypes
    # crossing, scalar re-marshal and output slicing per ciphertext):
    # every sender's share of every ciphertext, base-major wires out
    kbuf = np.frombuffer(
        b"".join(
            int(netinfos[nid].secret_key_share.scalar).to_bytes(32, "big")
            for nid in senders
        ),
        dtype=np.uint8,
    )
    bases = b"".join(NT.g1_wire(ct.u) for _, ct in sorted_cts)
    buf = NT.g1_mul_outer_raw(bases, kbuf).tobytes()
    cls = type(sorted_cts[0][1].u)
    staged: Dict[Any, Dict[Any, Any]] = {nid: {} for nid in senders}
    off = 0
    for pid, _ct in sorted_cts:
        for nid in senders:
            w = buf[off : off + 96]
            pt = NT.g1_unwire(w, cls)
            try:
                pt._wire = w  # the flush ships these exact bytes
            except AttributeError:
                pass
            staged[nid][pid] = T.DecryptionShare(pt)
            off += 96
    return staged


def decrypt_round(
    netinfos: Dict[Any, NetworkInfo],
    ciphertexts: Dict[Any, Any],
    dead: Optional[Set[Any]] = None,
    forged: Optional[Dict[Any, Dict[Any, Any]]] = None,
    be: Optional[BatchingBackend] = None,
    verify_honest: bool = True,
    emit_minimal: bool = False,
    shares: Optional[Dict[Any, Dict[Any, Any]]] = None,
    speculative: bool = False,
) -> DecryptionRound:
    """One epoch's decryption: every live node emits a share per
    proposer; each distinct (sender, proposer) share is verified
    once via the batching façade's grouped RLC flush; every
    proposer's contribution is combined from the lowest t+1 valid
    shares (the deterministic subset rule of
    ``PublicKeySet.combine_decryption_shares``).

    ``forged``: sender → {proposer → bogus share}.

    ``verify_honest=False`` skips verification of the shares this
    co-simulation itself just generated honestly (they verify by
    construction — the secret key share that made them is the one the
    public key share checks), verifying only adversarial entries.
    Outcome-equivalent: the valid/invalid partition and all fault
    attributions are identical; only provably-redundant checks are
    elided.  Called by the full-epoch driver (``harness/epoch.py``).

    ``emit_minimal=True`` emits honest shares only from the lowest
    t+1 live non-forging senders (plus every forged entry).  Also
    outcome-equivalent: ``combine_decryption_shares`` uses the lowest
    t+1 *valid* indices (``crypto/threshold.py:284``), forged shares
    are invalid under either emission, so the combined subset — and
    hence every plaintext — is identical; the elided shares are the
    redundant deliveries a real network sends for liveness against
    senders that might be slow, which the synchronous co-simulation
    schedule never needs.

    ``speculative=True`` (arXiv:2407.12172) combines each proposer's
    lowest t+1 *emitted* shares unverified and validates the combined
    result with one check per proposer (batched across proposers for
    real BLS: two pairings total).  On a hit, the subset's per-share
    obligations are dropped from the verification flush; emitted
    shares *outside* the subset are still audited by the flush, so a
    forger past the window is flagged exactly as eagerly.  On a miss
    (a bad share inside the window) the proposer falls through to the
    eager per-share path — same valid/invalid partition, same
    ``INVALID_DECRYPTION_SHARE`` attribution, bit-identical
    plaintexts (a hit proves the subset valid, and the lowest t+1
    emitted-and-valid indices are the lowest t+1 valid indices the
    eager combine would pick).
    """
    dead = dead or set()
    forged = forged or {}
    ref = netinfos[sorted(netinfos)[0]]
    num_faulty = ref.num_faulty
    pk_set = ref.public_key_set
    if be is None:
        be = BatchingBackend(inner=ref.ops)

    emit_senders: Optional[Set[Any]] = None
    if emit_minimal:
        honest_live = [
            nid
            for nid in sorted(netinfos)
            if nid not in dead and nid not in forged
        ]
        emit_senders = set(honest_live[: num_faulty + 1])

    phases: Dict[str, float] = {}
    _t0 = _time.perf_counter()
    sorted_cts = sorted(ciphertexts.items())
    if shares is None:
        shares = _stage_real_shares(
            netinfos, sorted_cts, dead, forged, emit_senders
        )
    phases["staging"] = _time.perf_counter() - _t0

    # 1. share emission (per-node local work)
    _t0 = _time.perf_counter()
    faults = FaultLog()
    emitted: Dict[Any, Dict[Any, Any]] = {}
    valid: Dict[Any, Dict[Any, Any]] = {}
    flagged: Set[Any] = set()
    n_verified = 0
    entries: List = []  # (proposer, sender, DecObligation) — to verify
    for nid, ni in sorted(netinfos.items()):
        if nid in dead:
            continue
        if (
            emit_senders is not None
            and nid not in emit_senders
            and nid not in forged
        ):
            continue
        pk = ni.public_key_share(nid)
        pre = (shares or {}).get(nid, {})
        node_forged = forged.get(nid, {})
        # honest shares not staged by the caller: one batched generation
        # call per sender (``shares``: pre-generated honest shares — the
        # per-node local signing work, embarrassingly parallel in a real
        # deployment; benchmarks stage it outside the timed phase)
        gen_pids = [
            pid
            for pid, _ in sorted_cts
            if node_forged.get(pid) is None and pre.get(pid) is None
        ]
        if gen_pids:
            generated = ni.secret_key_share.decrypt_shares_no_verify_batch(
                [ciphertexts[pid] for pid in gen_pids]
            )
            pre = dict(pre)
            pre.update(zip(gen_pids, generated))
        for pid, ct in sorted_cts:
            share = node_forged.get(pid)
            if share is None:
                share = pre[pid]
                emitted.setdefault(pid, {})[nid] = share
                if not verify_honest:
                    # self-generated: valid by construction (module doc);
                    # no obligation object, no cache traffic
                    valid.setdefault(pid, {})[nid] = share
                    continue
            else:
                emitted.setdefault(pid, {})[nid] = share
            entries.append((pid, nid, DecObligation(pk, share, ct)))

    phases["emit"] = _time.perf_counter() - _t0

    # 1b. speculative combine-first: one combined check per proposer
    # instead of t+1 share verifies (see docstring for the
    # attribution-parity argument)
    _t0 = _time.perf_counter()
    spec_out: Dict[Any, bytes] = {}
    spec_stats: Dict[str, int] = {}
    if speculative:
        spec_hits = spec_misses = 0
        spec_rows: List[Dict[int, Any]] = []
        spec_cts: List[Any] = []
        spec_pids: List[Any] = []
        spec_senders: List[Set[Any]] = []
        for pid, ct in sorted_cts:
            by_idx = {
                ref.node_index(nid): (nid, s)
                for nid, s in emitted.get(pid, {}).items()
            }
            if len(by_idx) <= num_faulty:
                continue
            idxs = sorted(by_idx)[: num_faulty + 1]
            spec_rows.append({i: by_idx[i][1] for i in idxs})
            spec_cts.append(ct)
            spec_pids.append(pid)
            spec_senders.append({by_idx[i][0] for i in idxs})
        results: List[Optional[bytes]] = []
        if spec_rows:
            many = getattr(
                pk_set, "combine_and_check_decryption_shares_many", None
            )
            if many is not None:
                try:
                    results = many(spec_rows, spec_cts)
                except Exception:
                    results = [None] * len(spec_rows)
            else:
                one = getattr(
                    pk_set, "combine_and_check_decryption_shares", None
                )
                for row, ct in zip(spec_rows, spec_cts):
                    try:
                        pt = one(row, ct) if one is not None else None
                    except Exception:
                        pt = None
                    results.append(pt)
        consumed: Set = set()
        for pid, senders_sub, pt in zip(spec_pids, spec_senders, results):
            if pt is not None:
                spec_hits += 1
                spec_out[pid] = pt
                consumed.update((pid, nid) for nid in senders_sub)
            else:
                spec_misses += 1
        if consumed:
            entries = [
                e for e in entries if (e[0], e[1]) not in consumed
            ]
        spec_stats = {"hits": spec_hits, "misses": spec_misses}
    phases["spec"] = _time.perf_counter() - _t0

    # 2. one grouped verification flush for everything still in question
    _t0 = _time.perf_counter()
    be.prefetch(ob for _, _, ob in entries)
    phases["flush"] = _time.perf_counter() - _t0
    n_verified = len(entries)
    _t0 = _time.perf_counter()
    for pid, nid, ob in entries:
        if be.verify_dec_share(ob.pk_share, ob.share, ob.ciphertext):
            valid.setdefault(pid, {})[nid] = ob.share
        elif nid not in flagged:
            flagged.add(nid)
            faults.add(nid, FaultKind.INVALID_DECRYPTION_SHARE)
    phases["lookup"] = _time.perf_counter() - _t0

    # 3. combine per proposer (unique result from any t+1 shares) —
    # batched across proposers when the key set supports it (real BLS:
    # one native call per shared valid-index subset)
    _t0 = _time.perf_counter()
    out: Dict[Any, bytes] = {}
    rows, row_cts, row_pids = [], [], []
    for pid, ct in sorted_cts:
        if pid in spec_out:
            # speculative hit: ≥ t+1 shares proven valid by the
            # combined check, plaintext already derived
            out[pid] = spec_out[pid]
            continue
        by_idx = {
            ref.node_index(nid): s for nid, s in valid.get(pid, {}).items()
        }
        if len(by_idx) <= num_faulty:
            faults.add(pid, FaultKind.SHARE_DECRYPTION_FAILED)
            continue
        rows.append(by_idx)
        row_cts.append(ct)
        row_pids.append(pid)
    if rows:
        many = getattr(pk_set, "combine_decryption_shares_many", None)
        if many is not None:
            for pid, pt in zip(row_pids, many(rows, row_cts)):
                out[pid] = pt
        else:  # mock key sets: per-row combine, same semantics
            for pid, by_idx, ct in zip(row_pids, rows, row_cts):
                out[pid] = pk_set.combine_decryption_shares(by_idx, ct)
    phases["combine"] = _time.perf_counter() - _t0
    return DecryptionRound(
        contributions=out,
        fault_log=faults,
        shares_verified=n_verified,
        emitted=emitted,
        phases=phases,
        spec=spec_stats,
    )


@dataclasses.dataclass
class RevealRequest:
    """One ordered-but-unrevealed epoch's decryption inputs, queued by
    the order-then-reveal driver (``epoch.py``) until the fused reveal
    flush."""

    epoch: int
    ciphertexts: Dict[Any, Any]
    dead: Set[Any]
    forged: Dict[Any, Dict[Any, Any]]


def decrypt_rounds_deferred(
    netinfos: Dict[Any, NetworkInfo],
    requests: List[RevealRequest],
    be: Optional[BatchingBackend] = None,
    verify_honest: bool = True,
    emit_minimal: bool = False,
    speculative: bool = False,
) -> List[DecryptionRound]:
    """Cross-epoch batched reveal: run :func:`decrypt_round` semantics
    for SEVERAL pending epochs at once, with the expensive crypto
    fused across epochs (order-then-reveal tentpole):

    - the speculative combine-and-check subsets of *all* epochs go
      through ONE :meth:`BatchingBackend.reveal_combine` call — two
      pairings total for real BLS regardless of epoch count (the RLC
      coefficients are per-row, so batching across epochs is row-wise
      identical to per-epoch calls);
    - every remaining share-verification obligation of all epochs
      ships in ONE ``prefetch`` flush (one product-pairing check);
    - the final combines of all epochs collapse into one
      ``combine_decryption_shares_many`` call.

    Outcome parity: each returned :class:`DecryptionRound` is
    **byte-identical** to calling ``decrypt_round`` on that epoch alone
    — same plaintexts, same valid/invalid partitions, and the same
    per-epoch fault attribution in the same order (each forging sender
    is flagged once *per epoch*, exactly as the per-epoch path flags
    it; misses fall back to per-share verification inside their own
    epoch).  The port's ordered epochs are held against its inline
    ones and against the reference's in ``tests/test_torch_epoch.py``.

    Phase walls: the fused stages are shared across epochs, so each
    request's ``phases`` carries the full shared wall (callers treat
    them as flush-level, not per-epoch, attribution)."""
    if not requests:
        return []
    dead_sets = [set(r.dead or set()) for r in requests]
    forged_maps = [dict(r.forged or {}) for r in requests]
    ref = netinfos[sorted(netinfos)[0]]
    num_faulty = ref.num_faulty
    pk_set = ref.public_key_set
    if be is None:
        be = BatchingBackend(inner=ref.ops)

    phases: Dict[str, float] = {}

    # 1. per-epoch staging + share emission (exactly decrypt_round's
    # phase 1, per request)
    _t0 = _time.perf_counter()
    per_sorted_cts: List[List] = []
    per_entries: List[List] = []  # (proposer, sender, DecObligation)
    per_emitted: List[Dict[Any, Dict[Any, Any]]] = []
    per_valid: List[Dict[Any, Dict[Any, Any]]] = []
    for req, req_dead, req_forged in zip(requests, dead_sets, forged_maps):
        emit_senders: Optional[Set[Any]] = None
        if emit_minimal:
            honest_live = [
                nid
                for nid in sorted(netinfos)
                if nid not in req_dead and nid not in req_forged
            ]
            emit_senders = set(honest_live[: num_faulty + 1])
        sorted_cts = sorted(req.ciphertexts.items())
        shares = _stage_real_shares(
            netinfos, sorted_cts, req_dead, req_forged, emit_senders
        )
        emitted: Dict[Any, Dict[Any, Any]] = {}
        valid: Dict[Any, Dict[Any, Any]] = {}
        entries: List = []
        for nid, ni in sorted(netinfos.items()):
            if nid in req_dead:
                continue
            if (
                emit_senders is not None
                and nid not in emit_senders
                and nid not in req_forged
            ):
                continue
            pk = ni.public_key_share(nid)
            pre = (shares or {}).get(nid, {})
            node_forged = req_forged.get(nid, {})
            gen_pids = [
                pid
                for pid, _ in sorted_cts
                if node_forged.get(pid) is None and pre.get(pid) is None
            ]
            if gen_pids:
                generated = (
                    ni.secret_key_share.decrypt_shares_no_verify_batch(
                        [req.ciphertexts[pid] for pid in gen_pids]
                    )
                )
                pre = dict(pre)
                pre.update(zip(gen_pids, generated))
            for pid, ct in sorted_cts:
                share = node_forged.get(pid)
                if share is None:
                    share = pre[pid]
                    emitted.setdefault(pid, {})[nid] = share
                    if not verify_honest:
                        valid.setdefault(pid, {})[nid] = share
                        continue
                else:
                    emitted.setdefault(pid, {})[nid] = share
                entries.append((pid, nid, DecObligation(pk, share, ct)))
        per_sorted_cts.append(sorted_cts)
        per_entries.append(entries)
        per_emitted.append(emitted)
        per_valid.append(valid)
    phases["staging"] = _time.perf_counter() - _t0

    # 1b. speculative combine-first, fused across epochs: all epochs'
    # lowest-t+1 subsets in one reveal_combine call
    _t0 = _time.perf_counter()
    per_spec_out: List[Dict[Any, bytes]] = [dict() for _ in requests]
    per_spec_stats: List[Dict[str, int]] = [dict() for _ in requests]
    if speculative:
        all_rows: List[Dict[int, Any]] = []
        all_cts: List[Any] = []
        all_epochs: List[int] = []
        row_meta: List = []  # (request index, proposer, sender subset)
        for ri, (req, sorted_cts, emitted) in enumerate(
            zip(requests, per_sorted_cts, per_emitted)
        ):
            for pid, ct in sorted_cts:
                by_idx = {
                    ref.node_index(nid): (nid, s)
                    for nid, s in emitted.get(pid, {}).items()
                }
                if len(by_idx) <= num_faulty:
                    continue
                idxs = sorted(by_idx)[: num_faulty + 1]
                all_rows.append({i: by_idx[i][1] for i in idxs})
                all_cts.append(ct)
                all_epochs.append(req.epoch)
                row_meta.append((ri, pid, {by_idx[i][0] for i in idxs}))
        results: List[Optional[bytes]] = []
        if all_rows:
            results = be.reveal_combine(
                pk_set, all_rows, all_cts, epochs=all_epochs
            )
        per_consumed: List[Set] = [set() for _ in requests]
        per_hits = [0] * len(requests)
        per_misses = [0] * len(requests)
        for (ri, pid, senders_sub), pt in zip(row_meta, results):
            if pt is not None:
                per_hits[ri] += 1
                per_spec_out[ri][pid] = pt
                per_consumed[ri].update((pid, nid) for nid in senders_sub)
            else:
                per_misses[ri] += 1
        for ri in range(len(requests)):
            if per_consumed[ri]:
                per_entries[ri] = [
                    e
                    for e in per_entries[ri]
                    if (e[0], e[1]) not in per_consumed[ri]
                ]
            per_spec_stats[ri] = {
                "hits": per_hits[ri],
                "misses": per_misses[ri],
            }
    phases["spec"] = _time.perf_counter() - _t0

    # 2. ONE grouped verification flush for every epoch's remaining
    # obligations (the cross-epoch fused flush), then per-epoch lookup
    # so fault attribution stays per-epoch, in decrypt_round's order
    _t0 = _time.perf_counter()
    be.prefetch(
        ob for entries in per_entries for _, _, ob in entries
    )
    phases["flush"] = _time.perf_counter() - _t0
    _t0 = _time.perf_counter()
    per_faults: List[FaultLog] = []
    for ri, entries in enumerate(per_entries):
        faults = FaultLog()
        flagged: Set[Any] = set()
        valid = per_valid[ri]
        for pid, nid, ob in entries:
            if be.verify_dec_share(ob.pk_share, ob.share, ob.ciphertext):
                valid.setdefault(pid, {})[nid] = ob.share
            elif nid not in flagged:
                flagged.add(nid)
                faults.add(nid, FaultKind.INVALID_DECRYPTION_SHARE)
        per_faults.append(faults)
    phases["lookup"] = _time.perf_counter() - _t0

    # 3. per-proposer combine, all epochs in one many() call (row-wise
    # independent — grouping across epochs changes nothing)
    _t0 = _time.perf_counter()
    per_out: List[Dict[Any, bytes]] = [dict() for _ in requests]
    rows, row_cts, row_keys = [], [], []
    for ri, sorted_cts in enumerate(per_sorted_cts):
        valid = per_valid[ri]
        for pid, ct in sorted_cts:
            if pid in per_spec_out[ri]:
                per_out[ri][pid] = per_spec_out[ri][pid]
                continue
            by_idx = {
                ref.node_index(nid): s
                for nid, s in valid.get(pid, {}).items()
            }
            if len(by_idx) <= num_faulty:
                per_faults[ri].add(pid, FaultKind.SHARE_DECRYPTION_FAILED)
                continue
            rows.append(by_idx)
            row_cts.append(ct)
            row_keys.append((ri, pid))
    if rows:
        many = getattr(pk_set, "combine_decryption_shares_many", None)
        if many is not None:
            for (ri, pid), pt in zip(row_keys, many(rows, row_cts)):
                per_out[ri][pid] = pt
        else:  # mock key sets: per-row combine, same semantics
            for (ri, pid), by_idx, ct in zip(row_keys, rows, row_cts):
                per_out[ri][pid] = pk_set.combine_decryption_shares(
                    by_idx, ct
                )
    phases["combine"] = _time.perf_counter() - _t0

    return [
        DecryptionRound(
            contributions=per_out[ri],
            fault_log=per_faults[ri],
            shares_verified=len(per_entries[ri]),
            emitted=per_emitted[ri],
            phases=dict(phases),
            spec=per_spec_stats[ri],
        )
        for ri in range(len(requests))
    ]


def packed_decrypt_attribution(
    accepted: List[Any],
    forged: Dict[Any, Dict[Any, Any]],
    dead: Set[Any],
    faults: FaultLog,
    failed,
) -> None:
    """Replay :func:`decrypt_round`'s fault attribution from aggregate
    counts — the packed co-simulation's O(adversaries) mirror of the
    per-share loop above, kept next to it so the two orderings can
    never drift apart.

    The per-share loop walks entries nid-major (sorted senders × sorted
    proposers) and flags each forging sender ONCE at its first invalid
    share, so: (1) every live forger with at least one forged share
    aimed at an accepted ciphertext gets ``INVALID_DECRYPTION_SHARE``
    in sorted-sender order; then (2) every accepted proposer whose
    valid-share count collapsed to ≤ f gets ``SHARE_DECRYPTION_FAILED``
    in sorted-proposer order (``failed(pid) -> bool``, the caller's
    count check).  ``accepted`` must already be sorted."""
    acc = set(accepted)
    for nid in sorted(forged):
        if nid in dead:
            continue
        if any(pid in acc for pid in forged[nid]):
            faults.add(nid, FaultKind.INVALID_DECRYPTION_SHARE)
    for pid in accepted:
        if failed(pid):
            faults.add(pid, FaultKind.SHARE_DECRYPTION_FAILED)
