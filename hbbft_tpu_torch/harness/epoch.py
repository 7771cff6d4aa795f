"""Vectorized full HoneyBadger epochs — whole epochs at north-star scale.

The port's own copy of the static epoch driver of
``hbbft_tpu/harness/epoch.py``: encrypt → N reliable broadcasts → N
binary agreements (common subset) → threshold decryption → batch, every
correct node advanced through one synchronous all-at-once delivery
schedule (one of the schedules the asynchronous adversary could choose,
so every safety property must and does hold on it), with the per-round
crypto batched:

- **Reliable broadcast**: all uncorrupted instances in one wave — one
  parity matmul, one cached decode matrix, one reconstruction matmul,
  one forest of every proposer's Merkle commitment checked against an
  independent rebuild, one product of the dead nodes' rows and one
  roots-only forest of the reconstructions.  The RS products and Merkle
  trees run where the backend's size rules send them: ``CudaBackend``'s
  ``gf_matmul`` and ``merkle_forest`` kernels, or the native host
  (``CpuBackend``).
- **Binary agreement** (``VectorizedAgreement``): per-instance state
  uniform across correct nodes, per-node estimates ([P, N] array), the
  reference's coin schedule; every real threshold coin pending in a
  round is verified in ONE fused flush through the batching façade
  (``SigObligation``), then combined per instance.
- **Decryption**: ``harness/vectorized.decrypt_round`` — every share of
  the epoch in one grouped flush (``BatchingBackend.prefetch``, whose
  product-form G1 aggregate runs the ``win_g1`` kernel on the card, or
  sharded over a mesh with ``ring_permute``), fault attribution per
  share, batched Lagrange combines.

Byzantine surfaces mirror the reference adversaries: ``dead`` (silent),
per-proposer echo-shard corruption, forged decryption shares, forged
coin shares, withheld (``late``, ``late_subset``) broadcasts, and
Byzantine BVal/Aux vote injection.  ``wan=`` (``harness/wan.py``)
materializes a WAN model's epoch view as crashed nodes and per-proposer
timely subsets, the view the packed co-sim (``harness/cosim.py``)
contracts zone-wise.  ``hw=`` (``harness/simulation.HwQuality``) adds
an analytic virtual-time account to every result
(:class:`VirtualEpochTime`).  ``reveal_mode="ordered"`` returns at
ordered-commit and reveals later in one cross-epoch flush.

Divergent view classes: ``run_epoch(divergent=DivergentEpoch0(...))``
splits the correct nodes' epoch-0 agreement views in two under
equivocating senders, and ``div_schedule=DivergentSchedule(...)``
carries several view classes' state across agreement epochs, so that
classes may decide one instance at different epochs.

Not ported yet: the staged deep pipeline (``pipeline="deep"`` raises
``ValueError``); the trace recorder's events and the process-wide
environment defaults of ``speculative``, ``reveal_mode`` and the coin
batching (the keyword arguments and ``be`` are the one switch).  A
device or kernel failure raises out of ``run_epoch``; nothing falls back
to the host.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time as _time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core.fault import FaultKind, FaultLog
from ..core.network_info import NetworkInfo
from ..core.serialize import dumps, loads
from ..crypto import rs as RS
from ..crypto import threshold as T
from ..crypto.curve import G2_GEN
from ..crypto.hashing import DST_SIG, hash_to_g1
from ..crypto.merkle import MerkleTree as _PyMerkleTree
from ..crypto.pairing import pairing_check
from ..ops import gf256 as GF
from ..protocols.broadcast import frame_into_shards, unframe_shards
from ..protocols.common_coin import make_nonce
from ..protocols.honey_badger import Batch
from ..protocols.transaction_queue import TransactionQueue
from .batching import BatchingBackend, SigObligation
from .vectorized import (
    RevealRequest,
    batch_sign_shares,
    decrypt_round,
    decrypt_rounds_deferred,
)
from .wan import crashed_with


# ---------------------------------------------------------------------------
# Vectorized multi-instance binary agreement
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AgreementResult:
    """All P instances' outcomes."""

    decisions: Dict[Any, bool]  # instance id → decided bit
    epochs_used: Dict[Any, int]  # instance id → deciding epoch (the
    # LAST class's, under a divergent schedule)
    coin_flips: int  # real threshold-coin flips executed
    crypto_flushes: int
    fault_log: FaultLog
    diverged: bool = False  # a divergent schedule executed
    class_epochs: Dict[Any, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict
    )  # instance id → per-view-class deciding epochs
    # (``DivergentSchedule`` instances only)


@dataclasses.dataclass(frozen=True)
class DivergentEpoch0:
    """A two-view-class asynchronous schedule for agreement epoch 0 —
    the delivery power of the reference's adversary
    (``tests/network/mod.rs:151-173``): the network partitions the
    correct nodes into classes A and B that receive epoch-0 ``BVal``
    traffic in different orders, while ≤ f Byzantine ``equivocators``
    send ``BVal(to_a)`` to class A and ``BVal(to_b)`` to class B and
    stay silent otherwise.

    Wave template (per affected instance; all delays are finite, so
    this is a legal asynchronous schedule):

    - W1: class A promptly receives every honest ``BVal(est)`` plus the
      equivocators' ``to_a`` votes; relays fire; A's first
      ``bin_values`` entry fixes its ``Aux`` value.
    - W2: class B first receives every ``to_b``-valued ``BVal`` (honest
      est and equivocator alike) plus its own members' est votes; the
      opposite-valued votes from outside B are withheld; relays fire;
      B's first ``bin_values`` entry (= ``to_b``) fixes its ``Aux``.
    - W3: everything else is delivered (including the cross-class relay
      waves) and the BVal relay rule runs to fixpoint in both views.
    - W4: the ``Aux`` messages are delivered; each class terminates its
      SBV instance against its fixpoint ``bin_values``.

    Between W1 and W3 correct nodes in different classes hold
    *different* ``bin_values`` — the state the uniform engine cannot
    represent.  Epoch 0's coin is fixed ``true``
    (``agreement.rs:314``), so no Conf exchange occurs and the epoch
    outcome is decided per class from its SBV output; from epoch 1 the
    schedule reverts to prompt uniform delivery with per-node
    estimates (already supported by the array engine).
    """

    class_a: frozenset  # correct node ids in class A (rest of live = B)
    equiv: Any  # Dict[sender id → (bool to_a, bool to_b)]
    instances: frozenset  # affected instance ids


@dataclasses.dataclass(frozen=True)
class ClassDirective:
    """One view-class's delivery schedule for one agreement epoch
    (``DivergentSchedule``).

    ``withhold``: a BVal value whose epoch traffic (est votes and
    relays alike, from every sender but the node itself) the adversary
    delays past this class's early wave — the class's first
    ``bin_values`` entry is then forced by the visible cascade.  All
    delayed messages still arrive within the epoch (the full wave), so
    this is a legal asynchronous schedule, not message loss.

    ``aux_counted``: the Aux prefix this class's members count toward
    SBV termination, as ``((value, n_senders), ...)`` — the adversary
    delivers exactly these first, so ``vals`` is their value set even
    when later auxes would have widened it.  Validated against
    availability (senders must exist), ``bin_values`` membership, and
    the N−f threshold.  ``None`` = prompt full delivery."""

    withhold: Optional[bool] = None
    aux_counted: Optional[Tuple[Tuple[bool, int], ...]] = None


@dataclasses.dataclass(frozen=True)
class DivergentSchedule:
    """A MULTI-EPOCH multi-class asynchronous schedule — the carried-
    state generalization of :class:`DivergentEpoch0`: view-classes keep
    their own ``bin_values``, sent-sets and Aux counts as engine state
    ACROSS agreement epochs, and may decide the same instance at different epochs.  The
    reference surface is the adversary's full per-message delivery
    power (``tests/network/mod.rs:151-173``) exercised through the
    threshold-relevant degrees of freedom: which BVal wave a class
    sees first, which Aux prefix it counts, and when Terms arrive.

    ``classes``: partition of the correct live nodes into view
    classes (any count ≥ 2).
    ``equiv``: Byzantine equivocators — node id → one epoch-0 BVal
    value PER CLASS (silent from epoch 1, like ``DivergentEpoch0``).
    ``equiv_aux``: equivocators also send the matching per-class Aux
    at epoch 0 (a Byzantine Aux counts only where its value entered
    that class's ``bin_values`` — exactly the sequential rule).
    ``directives``: epoch → per-class :class:`ClassDirective` row;
    epochs without a row run prompt uniform delivery.  Classes that
    DECIDE broadcast ``Term``s, which count as BVal+Aux+Conf for the
    still-running classes and trigger expedited termination at f+1
    (``agreement.rs:213-228``) — the mechanism that lets a slow class
    decide at a LATER epoch than a fast one without a coin.
    ``instances``: affected instance ids (the rest of the epoch rides
    the uniform array path unchanged).

    Residual scope limits (raised, never silently mis-modeled):
    undecided classes advance in lockstep (divergent decision TIMING
    comes from per-class decisions, not per-class epoch counters), and
    a real-coin epoch (≡ 2 mod 3) requires the undecided classes to
    have re-converged to one view."""

    classes: Tuple[frozenset, ...]
    equiv: Any  # Mapping[node id → Tuple[bool, ...]] (one per class)
    instances: frozenset
    equiv_aux: bool = False
    directives: Any = dataclasses.field(default_factory=dict)
    # Mapping[int epoch → Tuple[Optional[ClassDirective], ...]]


class _DivState:
    """Carried per-instance view-class state (``DivergentSchedule``):
    per-class decisions and Term sets persist across agreement epochs;
    sent/bin/aux state is rebuilt each epoch from the carried
    estimates exactly as ``SbvBroadcast.clear`` re-seeds the
    sequential instance."""

    __slots__ = ("classes", "est", "decided", "decided_at", "terms",
                 "epoch")

    def __init__(self, classes: List[List[Any]], est: Dict[Any, bool]):
        self.classes = classes
        self.est = dict(est)
        self.decided: List[Optional[bool]] = [None] * len(classes)
        self.decided_at: List[int] = [-1] * len(classes)
        self.terms: Dict[Any, bool] = {}
        self.epoch = 0

    def done(self) -> bool:
        return all(d is not None for d in self.decided)

    def value(self) -> bool:
        vs = {d for d in self.decided if d is not None}
        if len(vs) != 1:
            raise RuntimeError(
                "agreement safety violated across view classes: %r"
                % (self.decided,)
            )
        return vs.pop()



class VectorizedAgreement:
    """P binary-agreement instances advanced in fixed-shape masked
    rounds (reference per-instance loop: ``agreement/agreement.rs:291-407``;
    coin schedule ``:314-328``: epoch ≡ 0 → true, ≡ 1 → false, ≡ 2 →
    real ``CommonCoin``).

    All correct nodes share one view per round, so received-state is
    one row per instance; estimates are per-node ([P, N]) so
    non-unanimous inputs drive the protocol through the Conf round and
    the real coin exactly as the sequential machine.

    With a batching façade (``be``), the real coins of all instances
    that reach an ≡ 2 epoch in the same round verify in ONE fused flush
    (:meth:`_flip_coins_batched`); without one, one flush a call
    (:meth:`_flip_coins`).
    """

    MAX_EPOCHS = 64  # termination is expected-constant; this is a backstop

    def __init__(
        self,
        netinfos: Dict[Any, NetworkInfo],
        session_id: int,
        instance_ids: Sequence[Any],
        dead: Optional[Set[Any]] = None,
        mock: Optional[bool] = None,
        be: Optional[BatchingBackend] = None,
    ):
        self.netinfos = netinfos
        self.node_ids = sorted(netinfos)
        ref = netinfos[self.node_ids[0]]
        self.ref = ref
        self.session_id = session_id
        self.instance_ids = list(instance_ids)
        self.P = len(self.instance_ids)
        self.N = ref.num_nodes
        self.f = ref.num_faulty
        self.dead = set(dead or set())
        self.live = [nid for nid in self.node_ids if nid not in self.dead]
        if len(self.live) < ref.num_correct:
            raise ValueError(
                f"{len(self.dead)} dead nodes exceeds the f={self.f} bound"
            )
        if mock is None:
            mock = not isinstance(ref.secret_key_share, T.SecretKeyShare)
        self.mock = mock
        self.be = be
        self.coin_batch = be is not None

    def _divergent_epoch0(self, est0, div: DivergentEpoch0, live):
        """Evaluate one instance's epoch 0 under the two-class wave
        template (class docstring), with exact SBV thresholds.

        Returns ``(decided, est1)``: ``decided`` is the bool every
        correct node decided at epoch 0 (or None), ``est1`` the
        per-node epoch-1 estimates otherwise.  Raises ``ValueError``
        when the schedule is invalid, non-divergent, or would leave
        the two classes with different decision *timing* (a state the
        scalar per-instance bookkeeping cannot represent)."""
        f, N = self.f, self.N
        equiv = dict(div.equiv)
        honest = list(live)  # caller's run-local live, minus equiv
        A = [nid for nid in honest if nid in div.class_a]
        B = [nid for nid in honest if nid not in div.class_a]
        if not A or not B:
            raise ValueError("divergent classes must both be non-empty")
        v_bs = {bool(tb) for _, tb in equiv.values()}
        if len(v_bs) != 1:
            raise ValueError("equivocators must share one to_b value")
        v_b = v_bs.pop()
        v_a = not v_b
        estv = {
            nid: bool(est0[nid]) if isinstance(est0, dict) else bool(est0)
            for nid in honest
        }

        # sent_bval state: est counts as sent (sbv_broadcast.rs dedup)
        sent: Dict[Any, Set[bool]] = {nid: {estv[nid]} for nid in honest}

        def cnt(equiv_val_for_class):
            """#distinct senders of each value visible: honest nodes
            whose sent-set holds it + the equivocator votes this class
            sees."""
            return {
                v: sum(1 for nid in honest if v in sent[nid])
                + sum(
                    1
                    for votes in equiv.values()
                    if equiv_val_for_class(votes) == v
                )
                for v in (False, True)
            }

        # -- W1: class A prompt view (v_b-valued relays withheld) -------
        # visible: every honest est vote + equiv to_a votes + A's own
        # v_a relays.  Guard: no A-member may want to relay v_b (its
        # relay would be visible only to itself — per-node divergence
        # inside a class, which the template forbids).
        def cnt_a():
            return cnt(lambda votes: bool(votes[0]))

        changed = True
        while changed:
            changed = False
            c = cnt_a()
            if c[v_b] >= f + 1:
                raise ValueError(
                    "schedule invalid: class A reaches the relay "
                    "threshold for the withheld value in wave 1"
                )
            if c[v_a] >= f + 1:
                for nid in A:
                    if v_a not in sent[nid]:
                        sent[nid].add(v_a)
                        changed = True
        c = cnt_a()
        if not (c[v_a] >= 2 * f + 1 and c[v_b] < 2 * f + 1):
            raise ValueError(
                "schedule non-divergent: class A's first bin_values "
                "entry is not the prompt value"
            )
        aux_a = v_a

        # -- W2: class B early view.  The template withholds EVERY
        # v_a-valued BVal addressed to a B member (including B→B
        # copies — the sequential partition filter holds them too), so
        # the only v_a count any B node holds is its own self-handled
        # est vote: 1 < f+1 ≤ 2f+1 for every f ≥ 1.  v_a can therefore
        # never relay or enter bin_values early in B, no symmetric W1
        # guard is needed, and B's first entry is v_b by construction
        # (asserted below by the cascade check).
        def cnt_b_early():
            return sum(
                1 for nid in honest if v_b in sent[nid]
            ) + len(equiv)

        changed = True
        while changed:
            changed = False
            if cnt_b_early() >= f + 1:
                for nid in B:
                    if v_b not in sent[nid]:
                        sent[nid].add(v_b)
                        changed = True
        if cnt_b_early() < 2 * f + 1:
            raise ValueError(
                "schedule non-divergent: class B's early cascade "
                "never reaches bin_values"
            )
        aux_b = v_b

        # -- W3: full delivery (equiv cross-votes excepted), joint
        # relay fixpoint over both views ------------------------------
        def cnt_x(is_a: bool):
            return cnt(
                (lambda votes: bool(votes[0]))
                if is_a
                else (lambda votes: v_b)
            )

        changed = True
        while changed:
            changed = False
            for is_a, members in ((True, A), (False, B)):
                c = cnt_x(is_a)
                for v in (False, True):
                    if c[v] >= f + 1:
                        for nid in members:
                            if v not in sent[nid]:
                                sent[nid].add(v)
                                changed = True
        bins = {}
        for is_a in (True, False):
            c = cnt_x(is_a)
            bins[is_a] = {v for v in (False, True) if c[v] >= 2 * f + 1}

        # -- W4: Aux delivery and SBV termination ----------------------
        aux_senders = {v: 0 for v in (False, True)}
        aux_senders[aux_a] += len(A)
        aux_senders[aux_b] += len(B)
        outcome = {}
        for is_a in (True, False):
            bv = bins[is_a]
            count = sum(aux_senders[v] for v in bv if aux_senders[v])
            if count < N - f:
                raise ValueError(
                    "schedule stalls: SBV cannot terminate in class "
                    + ("A" if is_a else "B")
                )
            vals = {v for v in bv if aux_senders[v]}
            definite = next(iter(vals)) if len(vals) == 1 else None
            # epoch 0 coin is fixed true; no Conf round
            # (agreement.rs:314, _handle_sbvb_step with decided coin)
            if definite is True:
                outcome[is_a] = ("decide", True)
            else:
                outcome[is_a] = (
                    "continue",
                    definite if definite is not None else True,
                )
        kinds = {k for k, _ in outcome.values()}
        if kinds == {"decide"}:
            return True, None
        if "decide" in kinds:
            raise ValueError(
                "schedule leads to per-class decision divergence at "
                "epoch 0 — not representable by the scalar per-"
                "instance epoch bookkeeping"
            )
        est1 = {}
        for nid in honest:
            est1[nid] = outcome[nid in div.class_a][1]
        return None, est1

    def _div_round(
        self,
        vs: _DivState,
        sched: DivergentSchedule,
        coin: Optional[bool],
    ) -> None:
        """Advance one :class:`DivergentSchedule` instance by ONE
        agreement epoch, mutating the carried state ``vs``.

        Exact threshold evaluation per class (relay f+1, bin_values
        2f+1, SBV termination at N−f counted Auxes — the
        ``sbv_broadcast.py`` constants), with decided classes
        contributing Terms as permanent BVal+Aux senders and the f+1
        expedited-termination rule checked first
        (``agreement.rs:213-228``).  Every infeasible directive raises
        rather than silently executing an impossible schedule."""
        f, N = self.f, self.N
        epoch = vs.epoch
        C = len(vs.classes)
        # -- expedited termination on queued Terms (epoch ≥ 1) ---------
        if epoch >= 1:
            for v in (False, True):
                if sum(1 for tv in vs.terms.values() if tv is v) >= f + 1:
                    for c in range(C):
                        if vs.decided[c] is None:
                            vs.decided[c] = v
                            vs.decided_at[c] = epoch
        if vs.done():
            return
        und = [c for c in range(C) if vs.decided[c] is None]
        honest = [nid for c in und for nid in vs.classes[c]]
        equiv = dict(sched.equiv) if epoch == 0 else {}
        row = dict(sched.directives).get(epoch)
        directives: List[Optional[ClassDirective]] = [
            row[c] if row is not None else None for c in range(C)
        ]
        if coin is None:
            raise ValueError(
                "real-coin epoch %d reached without a coin value "
                "(fewer than f+1 undecided honest senders?)" % epoch
            )

        def term_cnt(v: bool) -> int:
            return sum(1 for tv in vs.terms.values() if tv is v)

        def equiv_cnt(c: int, v: bool) -> int:
            return sum(
                1 for votes in equiv.values() if bool(votes[c]) is v
            )

        sent: Dict[Any, Set[bool]] = {
            nid: {vs.est[nid]} for nid in honest
        }

        def cnt(c: int, v: bool, withheld: Optional[bool]) -> Dict[Any, int]:
            """Per-node visible sender count of BVal(v) for class c
            members (the withheld value is visible only from the node
            itself)."""
            if withheld is not None and v is withheld:
                return {
                    nid: (1 if v in sent[nid] else 0)
                    for nid in vs.classes[c]
                }
            base = (
                sum(1 for j in honest if v in sent[j])
                + term_cnt(v)
                + equiv_cnt(c, v)
            )
            return {nid: base for nid in vs.classes[c]}

        def relay_fixpoint(cs, withhelds):
            changed = True
            while changed:
                changed = False
                for c in cs:
                    for v in (False, True):
                        per = cnt(c, v, withhelds[c])
                        for nid in vs.classes[c]:
                            if per[nid] >= f + 1 and v not in sent[nid]:
                                sent[nid].add(v)
                                changed = True

        def bins_of(c: int, withheld: Optional[bool]) -> Set[bool]:
            out = set()
            for v in (False, True):
                per = cnt(c, v, withheld)
                if per and max(per.values()) >= 2 * f + 1:
                    out.add(v)
            return out

        # -- early wave: per class, in class order, with withholds -----
        aux: Dict[Any, bool] = {}
        for c in und:
            w = directives[c].withhold if directives[c] else None
            if w is None:
                continue
            relay_fixpoint([c], {c: w})
            early = bins_of(c, w)
            if not early:
                raise ValueError(
                    "withhold directive leaves class %d with empty "
                    "early bin_values at epoch %d" % (c, epoch)
                )
            for nid in vs.classes[c]:
                aux[nid] = (
                    vs.est[nid]
                    if vs.est[nid] in early
                    else min(early)
                )

        # -- full wave: joint relay fixpoint, everything delivered -----
        relay_fixpoint(und, {c: None for c in und})
        bins = {c: bins_of(c, None) for c in und}
        for c in und:
            if not bins[c]:
                raise ValueError(
                    "class %d reaches no bin_values entry at epoch %d "
                    "— SBV cannot terminate" % (c, epoch)
                )
            for nid in vs.classes[c]:
                if nid not in aux:
                    aux[nid] = (
                        vs.est[nid]
                        if vs.est[nid] in bins[c]
                        else min(bins[c])
                    )

        # -- Aux counting / SBV termination per class ------------------
        vals: Dict[int, Set[bool]] = {}
        for c in und:
            avail = {
                v: sum(1 for nid in honest if aux[nid] is v)
                + term_cnt(v)
                + (
                    equiv_cnt(c, v)
                    if (sched.equiv_aux and epoch == 0)
                    else 0
                )
                for v in (False, True)
            }
            counted = (
                directives[c].aux_counted if directives[c] else None
            )
            if counted is not None:
                total = 0
                vset: Set[bool] = set()
                for v, k in counted:
                    v = bool(v)
                    if k > avail[v]:
                        raise ValueError(
                            "aux_counted wants %d Aux(%s) for class %d "
                            "but only %d senders exist" % (k, v, c, avail[v])
                        )
                    if v not in bins[c]:
                        raise ValueError(
                            "aux_counted value %s not in class %d "
                            "bin_values %r" % (v, c, bins[c])
                        )
                    total += k
                    if k > 0:
                        vset.add(v)
                if total < N - f:
                    raise ValueError(
                        "aux_counted prefix (%d) below the N-f=%d SBV "
                        "termination threshold" % (total, N - f)
                    )
                vals[c] = vset
            else:
                total = sum(avail[v] for v in bins[c])
                if total < N - f:
                    raise ValueError(
                        "class %d counts %d Auxes in bin_values — SBV "
                        "cannot reach N-f=%d" % (c, total, N - f)
                    )
                vals[c] = {v for v in bins[c] if avail[v] > 0}

        # -- real-coin epochs require a re-converged view --------------
        if epoch % 3 == 2 and len({frozenset(vals[c]) for c in und}) > 1:
            raise ValueError(
                "real-coin epoch %d with divergent vals across classes "
                "— the Conf exchange is not modeled for that state"
                % epoch
            )

        # -- decide / continue (two-phase: Terms visible next epoch) ---
        for c in und:
            vset = vals[c]
            definite = next(iter(vset)) if len(vset) == 1 else None
            if definite is not None and definite is coin:
                vs.decided[c] = definite
                vs.decided_at[c] = epoch
                for nid in vs.classes[c]:
                    vs.terms[nid] = definite
            else:
                nxt = definite if definite is not None else coin
                for nid in vs.classes[c]:
                    vs.est[nid] = nxt
        dec_vals = {d for d in vs.decided if d is not None}
        if len(dec_vals) > 1:
            raise RuntimeError(
                "agreement safety violated across view classes: %r"
                % (vs.decided,)
            )
        vs.epoch += 1

    def run(
        self,
        est0: Dict[Any, Any],
        adv_bval: Optional[Dict[Any, Tuple[int, int]]] = None,
        adv_aux: Optional[Dict[Any, Tuple[int, int]]] = None,
        forged_coin: Optional[Set[Any]] = None,
        divergent: Optional[DivergentEpoch0] = None,
        div_schedule: Optional[DivergentSchedule] = None,
    ) -> AgreementResult:
        """Run every instance to its decision.

        ``est0``: instance id → initial estimate — a single bool
        (unanimous, the ACS common case) or a per-node mapping
        {node id → bool} (split inputs).
        ``adv_bval``/``adv_aux``: instance id → (#Byzantine votes for
        false, #for true) injected into every round — the vote-stuffing
        shape of the reference's ``RandomAdversary`` (≤ f each; counted
        once per round like a Byzantine sender's single allowed vote).
        ``forged_coin``: live Byzantine senders whose threshold-coin
        signature shares are forged (a wrong G1 point) on every real
        coin flip — drives the grouped-RLC verification into its
        per-share fallback, which must attribute
        ``INVALID_SIGNATURE_SHARE`` to exactly these senders and still
        land every coin (reference: a bad ``CommonCoin`` share is
        dropped and logged, ``common_coin.rs:149-161``; ≥ f+1 honest
        shares always remain).  Real BLS only (mock shares carry no
        verifiable structure for the fallback to reject).
        ``divergent``: a two-class epoch-0 schedule
        (:class:`DivergentEpoch0`); ``div_schedule``: a multi-epoch
        multi-class one (:class:`DivergentSchedule`), mutually
        exclusive.  Their equivocators are silent senders after their
        epoch-0 votes; an invalid or unrepresentable schedule raises
        ``ValueError``.
        """
        forged_coin = set(forged_coin or set())
        if forged_coin:
            if self.mock:
                raise ValueError("forged_coin requires real BLS crypto")
            if forged_coin - set(self.live):
                raise ValueError("forged_coin senders must be live")
            if len(self.dead | forged_coin) > self.f:
                raise ValueError(
                    "dead + forged_coin Byzantine nodes exceed the "
                    f"f={self.f} bound"
                )
        diverged = False
        live = list(self.live)  # run-local: never mutate instance state
        div_states: Dict[int, _DivState] = {}
        class_epochs: Dict[Any, Tuple[int, ...]] = {}
        if div_schedule is not None:
            if divergent is not None:
                raise ValueError(
                    "divergent and div_schedule are mutually exclusive"
                )
            sch = div_schedule
            equiv_ids = set(sch.equiv)
            if equiv_ids & self.dead:
                raise ValueError("equivocators cannot also be dead")
            if len(self.dead | equiv_ids | forged_coin) > self.f:
                raise ValueError(
                    "dead + equivocating + coin-forging Byzantine "
                    f"nodes exceed the f={self.f} bound"
                )
            if set(sch.instances) - set(self.instance_ids):
                raise ValueError("divergent instances unknown")
            if any(len(votes) != len(sch.classes) for votes in
                   dict(sch.equiv).values()):
                raise ValueError(
                    "each equivocator needs one BVal value per class"
                )
            if any(
                len(row) != len(sch.classes)
                for row in dict(sch.directives).values()
            ):
                raise ValueError(
                    "each directive row needs one entry per class "
                    "(None for prompt delivery)"
                )
            live = [nid for nid in live if nid not in equiv_ids]
            members = [m for cl in sch.classes for m in cl]
            if sorted(members) != sorted(live) or any(
                not cl for cl in sch.classes
            ):
                raise ValueError(
                    "classes must partition the correct live nodes "
                    "into non-empty sets"
                )
            cls_lists = [sorted(cl) for cl in sch.classes]
            for p, iid in enumerate(self.instance_ids):
                if iid not in sch.instances:
                    continue
                v = est0[iid]
                est = {
                    nid: bool(v[nid]) if isinstance(v, dict) else bool(v)
                    for nid in live
                }
                div_states[p] = _DivState(cls_lists, est)
            diverged = True
        div_pre: Dict[Any, Tuple[Optional[bool], Optional[Dict]]] = {}
        if divergent is not None:
            equiv_ids = set(divergent.equiv)
            if equiv_ids & self.dead:
                raise ValueError("equivocators cannot also be dead")
            if len(self.dead | equiv_ids | forged_coin) > self.f:
                raise ValueError(
                    "dead + equivocating + coin-forging Byzantine "
                    f"nodes exceed the f={self.f} bound"
                )
            if set(divergent.instances) - set(self.instance_ids):
                raise ValueError("divergent instances unknown")
            # Equivocators speak only through their epoch-0 equivocation
            # and are silent otherwise — for the rest of this run they
            # are absent senders, exactly like SilentAdversary nodes.
            live = [nid for nid in live if nid not in equiv_ids]
            for iid in sorted(divergent.instances):
                div_pre[iid] = self._divergent_epoch0(
                    est0[iid], divergent, live
                )
            diverged = True
        P, N, f = self.P, self.N, self.f
        n_live = len(live)
        live_idx = {nid: i for i, nid in enumerate(live)}

        # est[p, j]: estimate of live node j in instance p
        est = np.zeros((P, n_live), dtype=np.int8)
        for p, iid in enumerate(self.instance_ids):
            if iid in div_pre:
                _, est1 = div_pre[iid]
                if est1 is not None:
                    for nid, b in est1.items():
                        est[p, live_idx[nid]] = 1 if b else 0
                continue
            v = est0[iid]
            if isinstance(v, dict):
                for nid, b in v.items():
                    if nid in live_idx:
                        est[p, live_idx[nid]] = 1 if b else 0
            else:
                est[p, :] = 1 if v else 0
        ab = np.zeros((P, 2), dtype=np.int64)
        aa = np.zeros((P, 2), dtype=np.int64)
        for src, dst in ((adv_bval, ab), (adv_aux, aa)):
            if src:
                for iid, (v0, v1) in src.items():
                    if v0 > f or v1 > f:
                        raise ValueError(
                            "Byzantine vote injection exceeds the f="
                            f"{f} bound: {iid!r} -> ({v0}, {v1})"
                        )
                    p = self.instance_ids.index(iid)
                    dst[p, 0], dst[p, 1] = v0, v1

        epoch = np.zeros(P, dtype=np.int64)
        decided = np.full(P, -1, dtype=np.int8)
        decided_at = np.zeros(P, dtype=np.int64)
        for p, iid in enumerate(self.instance_ids):
            if iid in div_pre:
                dec, _ = div_pre[iid]
                if dec is not None:  # decided by every class at epoch 0
                    decided[p] = 1 if dec else 0
                else:  # rejoin the uniform engine at epoch 1
                    epoch[p] = 1
        coin_flips = 0
        flushes = 0
        faults = FaultLog()
        is_div = np.zeros(P, dtype=bool)
        for p in div_states:
            is_div[p] = True

        for _ in range(self.MAX_EPOCHS):
            active = decided < 0
            if not active.any():
                break
            arr_active = active & ~is_div
            # --- SBV broadcast round (sbv_broadcast.py thresholds) ----
            # Initial BVal counts: each live node multicasts BVal(est).
            cnt = np.zeros((P, 2), dtype=np.int64)
            cnt[:, 1] = est.sum(axis=1)
            cnt[:, 0] = n_live - cnt[:, 1]
            cnt += ab
            # relay at ≥ f+1 senders: every correct node then also sends
            # BVal(b), lifting the count to all live + Byzantine.
            relayed = cnt >= (f + 1)
            cnt = np.where(relayed, n_live + ab, cnt)
            bin_vals = cnt >= (2 * f + 1)  # [P, 2]
            # Aux: each node sends Aux(est) if est ∈ bin_values, else
            # the (unique, because its own est failed) bin value.  All
            # live auxes arrive, all lie in bin_values ⇒ N−f reached.
            est_in_bin = np.take_along_axis(
                bin_vals.astype(np.int8), est.astype(np.int64), axis=1
            ).astype(bool)  # [P, n_live]
            other = bin_vals[:, 0][:, None] & ~est_in_bin  # falls back to 0
            aux_val = np.where(est_in_bin, est, np.where(other, 0, 1))
            # vals = union of live aux values within bin, plus Byzantine
            # Aux injections for values already in bin_values.
            has1 = (aux_val == 1).any(axis=1) | (bin_vals[:, 1] & (aa[:, 1] > 0))
            has0 = (aux_val == 0).any(axis=1) | (bin_vals[:, 0] & (aa[:, 0] > 0))
            # (Conf round, epochs ≡ 2 mod 3: every correct node confs
            # this same uniform vals set, trivially ⊇ N−f — uniformity
            # makes the Conf exchange a no-op in this schedule.)

            # --- the coin (agreement.rs:314-328) ----------------------
            sched = epoch % 3
            coin = np.zeros(P, dtype=np.int8)
            coin[sched == 0] = 1
            need_real = arr_active & (sched == 2)
            arr_reqs: List[Tuple[int, bytes, List[Any]]] = []
            if need_real.any():
                real_ps = np.flatnonzero(need_real)
                arr_reqs = [
                    (
                        int(p),
                        make_nonce(
                            self.ref.invocation_id(),
                            self.session_id,
                            self.ref.node_index(self.instance_ids[p])
                            if self.ref.node_index(self.instance_ids[p])
                            is not None
                            else int(p),
                            int(epoch[p]),
                        ),
                        live,
                    )
                    for p in real_ps
                ]
            # divergent instances' coin needs, collected up front: with
            # the coin-batching plane their shares ride the SAME fused
            # flush as the array path's instead of one flush each
            div_coin: Dict[int, Optional[bool]] = {}
            div_reqs: List[Tuple[int, bytes, List[Any]]] = []
            for p, vs in sorted(div_states.items()):
                if vs.done():
                    continue
                e = vs.epoch
                if e % 3 == 0:
                    div_coin[p] = True
                elif e % 3 == 1:
                    div_coin[p] = False
                else:
                    # real coin: shares come from the still-running
                    # honest nodes only (decided classes terminated
                    # this instance; equivocators are Byzantine)
                    senders = [
                        nid
                        for ci in range(len(vs.classes))
                        if vs.decided[ci] is None
                        for nid in vs.classes[ci]
                    ]
                    div_coin[p] = None
                    if len(senders) >= self.f + 1:
                        iid = self.instance_ids[p]
                        idx = self.ref.node_index(iid)
                        nonce = make_nonce(
                            self.ref.invocation_id(),
                            self.session_id,
                            idx if idx is not None else int(p),
                            e,
                        )
                        div_reqs.append((int(p), nonce, senders))
            if self.coin_batch:
                reqs = arr_reqs + div_reqs
                if reqs:
                    values, nfl = self._flip_coins_batched(
                        reqs, faults, forged=forged_coin
                    )
                    flushes += nfl
                    coin_flips += len(reqs)
                    for p, _nonce, _l in arr_reqs:
                        coin[p] = 1 if values[p] else 0
                    for p, _nonce, _l in div_reqs:
                        div_coin[p] = values[p]
            else:
                if arr_reqs:
                    values, nfl = self._flip_coins(
                        [(p, nonce) for p, nonce, _l in arr_reqs],
                        faults,
                        forged=forged_coin,
                        live=live,
                    )
                    flushes += nfl
                    coin_flips += len(arr_reqs)
                    for p, v in values.items():
                        coin[p] = 1 if v else 0
                for p, nonce, senders in div_reqs:
                    values, nfl = self._flip_coins(
                        [(p, nonce)],
                        faults,
                        forged=forged_coin,
                        live=senders,
                    )
                    flushes += nfl
                    coin_flips += 1
                    div_coin[p] = values.get(p)

            # --- decide or next epoch (agreement.rs:291-310) ----------
            definite = has1 ^ has0  # exactly one value in vals
            def_val = np.where(has1 & ~has0, 1, 0).astype(np.int8)
            decide_now = arr_active & definite & (def_val == coin)
            decided[decide_now] = def_val[decide_now]
            decided_at[decide_now] = epoch[decide_now]
            cont = arr_active & ~decide_now
            # est' = the definite value, else the coin
            new_est = np.where(definite, def_val, coin)  # [P]
            est[cont, :] = new_est[cont, None]
            epoch[cont] += 1

            # --- divergent view-class instances (carried state) -------
            for p, vs in sorted(div_states.items()):
                if vs.done():
                    continue
                self._div_round(vs, div_schedule, div_coin[p])
                if vs.done():
                    val = vs.value()
                    decided[p] = 1 if val else 0
                    decided_at[p] = max(vs.decided_at)
                    class_epochs[self.instance_ids[p]] = tuple(
                        vs.decided_at
                    )

        if (decided < 0).any():
            raise RuntimeError(
                "agreement instances failed to decide within "
                f"{self.MAX_EPOCHS} epochs"
            )
        return AgreementResult(
            decisions={
                iid: bool(decided[p])
                for p, iid in enumerate(self.instance_ids)
            },
            epochs_used={
                iid: int(decided_at[p])
                for p, iid in enumerate(self.instance_ids)
            },
            coin_flips=coin_flips,
            crypto_flushes=flushes,
            fault_log=faults,
            diverged=diverged,
            class_epochs=class_epochs,
        )

    # -- batched real coin --------------------------------------------------

    def _flip_coins(
        self,
        nonces: List[Tuple[int, bytes]],
        faults: FaultLog,
        forged: Optional[Set[Any]] = None,
        live: Optional[List[Any]] = None,
    ) -> Tuple[Dict[int, bool], int]:
        """One coin flip per (instance, nonce) — all instances' share
        verifications fused into a single RLC flush (grouped by nonce
        base point, ``harness/batching.py``); one combine per instance
        (any t+1 valid shares give the unique signature).  ``forged``
        senders submit a wrong G1 point instead of their signature
        share (``run(forged_coin=...)``)."""
        forged = forged or set()
        live = self.live if live is None else live
        pk_set = self.ref.public_key_set
        out: Dict[int, bool] = {}
        if self.mock:
            for p, nonce in nonces:
                shares = {
                    self.ref.node_index(nid): self.netinfos[
                        nid
                    ].secret_key_share.sign(nonce)
                    for nid in live
                }
                sig = pk_set.combine_signatures(shares)
                out[p] = sig.parity()
            return out, 0

        all_shares: List[Any] = []
        all_pks: List[Any] = []
        per_inst: Dict[int, Dict[int, Any]] = {}
        bases: List[Any] = []
        for p, nonce in nonces:
            base = hash_to_g1(nonce, DST_SIG)
            signed = batch_sign_shares(
                self.netinfos, live, nonce, base=base
            )
            shares = {}
            for nid in live:
                s = signed[nid]
                if nid in forged:
                    # a wrong point on the curve: passes deserialization
                    # everywhere, fails verification against pkᵢ
                    s = T.SignatureShare(base * 0xBAD)
                shares[self.ref.node_index(nid)] = s
                all_shares.append(s.point)
                all_pks.append(self.ref.public_key_share(nid).point)
                bases.append(base)
            per_inst[p] = shares
        # grouped RLC: Σ over instances of e(Σrᵢσᵢ, P₂)·e(−base_g, Σrᵢpkᵢ)
        ok = self._grouped_batch_verify(all_shares, all_pks, bases)
        if not ok:  # a forged share broke the batch: per-share fallback
            for p, nonce in nonces:
                valid = {}
                for nid in live:
                    s = per_inst[p][self.ref.node_index(nid)]
                    pk = self.ref.public_key_share(nid)
                    if self.ref.ops.verify_sig_share(pk, s, nonce):
                        valid[self.ref.node_index(nid)] = s
                    else:
                        faults.add(nid, FaultKind.INVALID_SIGNATURE_SHARE)
                per_inst[p] = valid
        for p, nonce in nonces:
            sig = pk_set.combine_signatures(per_inst[p])
            if not pk_set.verify_signature(sig, nonce):
                raise RuntimeError("combined coin signature invalid")
            out[p] = sig.parity()
        return out, 1

    def _flip_coins_batched(
        self,
        requests: List[Tuple[int, bytes, List[Any]]],
        faults: FaultLog,
        forged: Optional[Set[Any]] = None,
    ) -> Tuple[Dict[int, bool], int]:
        """The coin-batching plane: every (instance, nonce, senders)
        request pending this round verifies in ONE fused flush through
        the batching façade (``SigObligation`` groups by nonce, exactly
        like the decryption-share plane groups by ciphertext), so the
        G1 aggregate runs on the card with the epoch's other flushes.  Eager
        twin: :meth:`_flip_coins` per call group.  Per-share decisions
        come out of the flush cache, so the valid set, the combined
        signatures, and the ``INVALID_SIGNATURE_SHARE`` attribution
        are identical to the eager path's."""
        forged = forged or set()
        pk_set = self.ref.public_key_set
        out: Dict[int, bool] = {}
        if self.mock:
            for p, nonce, req_live in requests:
                shares = {
                    self.ref.node_index(nid): self.netinfos[
                        nid
                    ].secret_key_share.sign(nonce)
                    for nid in req_live
                }
                sig = pk_set.combine_signatures(shares)
                out[p] = sig.parity()
            return out, 0

        entries: List[Tuple[int, Any, SigObligation]] = []
        for p, nonce, req_live in requests:
            base = hash_to_g1(nonce, DST_SIG)
            signed = batch_sign_shares(
                self.netinfos, req_live, nonce, base=base
            )
            for nid in req_live:
                s = signed[nid]
                if nid in forged:
                    # a wrong point on the curve: passes deserialization
                    # everywhere, fails verification against pkᵢ
                    s = T.SignatureShare(base * 0xBAD)
                entries.append(
                    (
                        p,
                        nid,
                        SigObligation(
                            self.ref.public_key_share(nid), s, nonce
                        ),
                    )
                )
        self.be.prefetch(ob for _, _, ob in entries)
        valid: Dict[int, Dict[int, Any]] = {p: {} for p, _, _ in requests}
        for p, nid, ob in entries:
            if self.be.verify_sig_share(ob.pk_share, ob.share, ob.msg):
                valid[p][self.ref.node_index(nid)] = ob.share
            else:
                faults.add(nid, FaultKind.INVALID_SIGNATURE_SHARE)
        for p, nonce, _req_live in requests:
            sig = pk_set.combine_signatures(valid[p])
            if not pk_set.verify_signature(sig, nonce):
                raise RuntimeError("combined coin signature invalid")
            out[p] = sig.parity()
        return out, 1

    def _grouped_batch_verify(self, shares, pks, bases) -> bool:
        """e(Σrᵢσᵢ, P₂) · Π_g e(−base_g, Σ_{i∈g} rᵢ·pkᵢ) == 1 over all
        instances at once (the ``batching.py`` fused equation)."""
        ops = self.ref.ops
        coeffs = T._rlc_coeffs(
            b"hbbft_tpu vec agreement coins",
            [s.to_bytes() for s in shares] + [p.to_bytes() for p in pks],
        )[: len(shares)]
        # async launch: a device backend's G1 MSM overlaps the host G2
        # MSMs below (same pattern as the fused flush, batching.py)
        if hasattr(ops, "g1_msm_async"):
            agg_share_fin = ops.g1_msm_async(shares, coeffs)
            # drain on its own thread so the fetch overlaps the host
            # G2 MSMs below (double-buffered finalize)
            getattr(agg_share_fin, "start_drain", lambda: None)()
        else:
            agg_share = ops.g1_msm(shares, coeffs)
            agg_share_fin = lambda: agg_share  # noqa: E731
        pairs = []
        by_base: Dict[bytes, Tuple[Any, List, List]] = {}
        for s_pk, c, b in zip(pks, coeffs, bases):
            key = b.to_bytes()
            if key not in by_base:
                by_base[key] = (b, [], [])
            by_base[key][1].append(s_pk)
            by_base[key][2].append(c)
        for key in sorted(by_base):
            b, g_pks, g_cs = by_base[key]
            u_pks, u_cs = T.aggregate_by_point(g_pks, g_cs)
            pairs.append((-b, ops.g2_msm(u_pks, u_cs)))
        return pairing_check([(agg_share_fin(), G2_GEN)] + pairs)


# ---------------------------------------------------------------------------
# Full HoneyBadger epoch
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class VirtualEpochTime:
    """Analytic virtual-time account of one synchronous epoch under
    the ``HwQuality`` model (batched flushes feeding back into
    virtual-time accounting — the epoch-latency statistic the
    event-driven simulator cannot produce at north-star scale).

    Model, mirroring ``examples/simulation.rs:183-223`` semantics on
    the synchronous round structure: every protocol round costs each
    node its upstream serialization (bytes × inv_bw) plus one network
    latency, and each crypto/bookkeeping phase costs the co-simulated
    wall time scaled by the cpu factor (the deduplicated batch work IS
    one node's per-epoch work for the verification phases — every real
    node checks all distinct shares/proofs).  All correct nodes are
    symmetric under this schedule, so min and max epoch latency
    coincide."""

    total_s: float  # simulated seconds for the epoch
    rounds: int  # protocol rounds (one latency each)
    per_node_msgs: int  # messages each node sent
    per_node_bytes: int  # upstream bytes each node serialized
    network_s: float  # serialization + latency share
    cpu_s: float  # scaled compute share
    breakdown: Dict[str, float]


@dataclasses.dataclass
class _PendingReveal:
    """One ordered-but-unrevealed epoch queued by the order-then-reveal
    driver: everything :func:`~.vectorized.decrypt_rounds_deferred`
    needs to reveal it later, plus the :class:`EpochResult` (already
    returned to the caller) that the flush fills in place."""

    epoch: int
    seq: int
    cts: Dict[Any, Any]
    dead: Set[Any]
    forged_dec: Dict[Any, Dict[Any, Any]]
    result: "EpochResult"
    t_ordered: float  # perf_counter at ordered-commit (reveal-lag base)


@dataclasses.dataclass
class EpochResult:
    """One full co-simulated HoneyBadger epoch.

    Under ``reveal_mode="ordered"`` the result is returned at
    *ordered-commit* time with ``batch=None``; the next
    ``flush_reveals()`` (automatic at the backpressure bound and at the
    end of ``run_epochs``) fills ``batch``, merges decryption faults
    into ``fault_log`` and stamps the reveal phases — in place."""

    batch: Optional[Batch]  # identical at every correct node
    accepted: List[Any]  # proposers in the common subset
    fault_log: FaultLog
    coin_flips: int
    shares_verified: int
    agreement_epochs: Dict[Any, int]
    observer_batch: Optional[Batch] = None  # the non-validator lane's
    # independently derived batch (``run_epoch(observe=True)``)
    virtual: Optional[VirtualEpochTime] = None  # when hw= is set
    phases: Optional[Dict[str, float]] = None  # wall seconds per epoch
    # phase: propose / rbc / agreement / decrypt / assembly, the decrypt
    # round's (dec_*) and the flush's (flush_*) stages, commit_latency
    diverged: bool = False  # the agreement ran a divergent schedule
    class_epochs: Dict[Any, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict
    )  # ``AgreementResult.class_epochs`` (``div_schedule`` instances)


def _forest(shards: np.ndarray, trees: int, width: int) -> np.ndarray:
    """``[n, trees·width]`` shard bytes (tree j's shard i is row i's j-th
    ``width`` bytes) → the ``[trees, n, width]`` leaf values of a forest."""
    return np.ascontiguousarray(shards.reshape(shards.shape[0], trees, width).transpose(1, 0, 2))


class VectorizedHoneyBadgerSim:
    """Full-stack HoneyBadger co-simulation: encrypt → N reliable
    broadcasts → N binary agreements (common subset) → threshold
    decryption → batch, with all per-round crypto batched.

    ``ops``: the backend every node shares (see
    ``core.network_info.resolve_ops``) — the card's ``CudaBackend()``
    unless the caller passes another, such as
    ``CudaBackend(device="cpu")`` or ``CpuBackend()``.
    ``mock`` substitutes the hash-based mock crypto;
    ``verify_honest=False`` elides provably-redundant verification of
    self-generated honest shares and proofs; ``emit_minimal=True``
    emits honest decryption shares only from the lowest t+1 live
    senders; ``speculative=True`` combines first and verifies the
    combined result (``decrypt_round``); ``reveal_mode="ordered"``
    decouples ordered-commit from the reveal (at most
    ``max_outstanding_reveals`` epochs wait before a forced flush);
    ``hw`` (a ``harness.simulation.HwQuality``) adds the virtual-time
    account ``EpochResult.virtual`` (incompatible with ordered reveals).
    """

    # the independent tree the RBC commitments are checked against; an
    # attribute, so that ``harness.rbc_probe`` can time it on one instance
    _reroot = _PyMerkleTree

    def __init__(
        self,
        n: int,
        rng,
        mock: bool = False,
        ops: Any = None,
        verify_honest: bool = True,
        emit_minimal: bool = False,
        hw: Any = None,
        speculative: bool = False,
        reveal_mode: str = "inline",
        max_outstanding_reveals: int = 4,
    ):
        netinfos = NetworkInfo.generate_map(list(range(n)), rng, mock=mock, ops=ops)
        self._bind(
            netinfos,
            rng,
            mock,
            verify_honest,
            emit_minimal,
            hw,
            speculative,
            reveal_mode,
            max_outstanding_reveals,
        )

    @classmethod
    def from_netinfos(
        cls,
        netinfos: Dict[Any, NetworkInfo],
        rng,
        mock: bool = False,
        verify_honest: bool = True,
        emit_minimal: bool = False,
        hw: Any = None,
        speculative: bool = False,
        reveal_mode: str = "inline",
        max_outstanding_reveals: int = 4,
    ) -> "VectorizedHoneyBadgerSim":
        """Build over an existing keyed validator set (keys from a DKG,
        or carried across with ``state.netinfos_from_arrays``); the
        backend is the netinfos' ``ops``."""
        sim = cls.__new__(cls)
        sim._bind(
            dict(netinfos),
            rng,
            mock,
            verify_honest,
            emit_minimal,
            hw,
            speculative,
            reveal_mode,
            max_outstanding_reveals,
        )
        return sim

    def _bind(
        self,
        netinfos,
        rng,
        mock,
        verify_honest,
        emit_minimal,
        hw,
        speculative,
        reveal_mode,
        max_outstanding_reveals,
    ):
        if reveal_mode not in ("inline", "ordered"):
            raise ValueError(f"unknown reveal_mode {reveal_mode!r}")
        self.n = len(netinfos)
        self.rng = rng
        self.mock = mock
        self.verify_honest = verify_honest
        self.emit_minimal = emit_minimal
        self.speculative = speculative
        self.reveal_mode = reveal_mode
        self.max_outstanding_reveals = max(1, int(max_outstanding_reveals))
        self._pending_reveals: List[_PendingReveal] = []
        self._ordered_seq = 0
        self.hw = hw  # Optional[simulation.HwQuality]: virtual time
        self.netinfos = netinfos
        ref = netinfos[sorted(netinfos)[0]]
        self.ref = ref
        self.num_faulty = ref.num_faulty
        self.pk_set = ref.public_key_set
        self.parity = 2 * ref.num_faulty
        self.data = self.n - self.parity
        self.epoch = 0
        self.be = BatchingBackend(inner=ref.ops)
        self.codec = ref.ops.rs_codec(self.data, self.parity)

    # -- one epoch ---------------------------------------------------------

    def run_epoch(
        self,
        contributions: Dict[Any, Any],
        dead: Optional[Set[Any]] = None,
        corrupt_shards: Optional[Dict[Any, Dict[Any, bytes]]] = None,
        forged_dec: Optional[Dict[Any, Dict[Any, Any]]] = None,
        late: Optional[Set[Any]] = None,
        observe: bool = False,
        adv_bval: Optional[Dict[Any, Tuple[int, int]]] = None,
        adv_aux: Optional[Dict[Any, Tuple[int, int]]] = None,
        forged_coin: Optional[Set[Any]] = None,
        late_subset: Optional[Dict[Any, Set[Any]]] = None,
        divergent: Optional[DivergentEpoch0] = None,
        div_schedule: Optional[DivergentSchedule] = None,
        wan: Optional[Any] = None,
    ) -> EpochResult:
        """Advance every correct node through one complete epoch.

        ``contributions``: proposer → contribution (any wire-serializable
        value).  ``dead``: silent nodes.  ``corrupt_shards``: proposer →
        {node → bytes} echo tampering.  ``forged_dec``: sender →
        {proposer → bogus decryption share}.  ``late``: live proposers
        whose broadcasts the adversary delays past the agreement phase
        (their agreements decide false: accepted ⊊ live).  ``observe``:
        also derive the batch on a non-validator observer lane
        (``EpochResult.observer_batch``).  ``adv_bval``/``adv_aux``/
        ``forged_coin``: ``VectorizedAgreement.run`` semantics.
        ``late_subset``: proposer → the nodes whose copy of that
        proposer's broadcast completes before the agreement phase.
        ``divergent``/``div_schedule``: a divergent view-class schedule
        for the agreement phase (``VectorizedAgreement.run``); its
        equivocators are silent in every later phase (decryption treats
        them like ``dead``).
        ``wan``: a ``harness.wan.WanModel`` / bound ``WanSchedule`` —
        materialized for this epoch as crashed nodes (merged into
        ``dead``) and per-proposer timely-delivery subsets (merged into
        ``late_subset``, the caller's entries winning), the same epoch
        view the packed co-sim (``harness/cosim.py``) consumes
        zone-factored; equal-seeded runs of the two planes under one
        model are byte-identical.
        """
        dead = set(dead or set())
        if wan is not None:
            if hasattr(wan, "bind"):
                wan = wan.bind(self.n)
            wan_dead, wan_subset = wan.twin_kwargs(
                self.epoch,
                [pid for pid in sorted(self.netinfos) if pid in contributions],
                dead=dead,
            )
            dead = wan_dead
            merged = dict(wan_subset)
            merged.update(late_subset or {})
            late_subset = merged or None
        late = set(late or set())
        corrupt_shards = corrupt_shards or {}
        forged_dec = forged_dec or {}
        if len(dead) > self.num_faulty:
            raise ValueError(
                f"{len(dead)} dead nodes exceeds the f={self.num_faulty} bound"
            )
        faults = FaultLog()
        diag: Dict[str, bool] = {}
        _t0 = _time.perf_counter()
        payloads = self._propose_phase(contributions, dead)
        _t_prop = _time.perf_counter()
        delivered = self._broadcast_phase(
            payloads, dead, corrupt_shards, late, faults, diag
        )
        _t_rbc = _time.perf_counter()
        # 3. common subset: one agreement per validator; est₀ =
        # delivered-mask (undelivered instances receive ``false`` from
        # every correct node, ``common_subset.rs:271-289``)
        return self._finish_epoch(
            payloads,
            delivered,
            faults,
            dead,
            forged_dec=forged_dec,
            observe=observe,
            adv_bval=adv_bval,
            adv_aux=adv_aux,
            forged_coin=forged_coin,
            late_subset=late_subset,
            divergent=divergent,
            div_schedule=div_schedule,
            walls_head={"propose": _t_prop - _t0, "rbc": _t_rbc - _t_prop},
            diag=diag,
            commit_t0=_t0,
        )

    def _finish_epoch(
        self,
        payloads: Dict[Any, bytes],
        delivered: Dict[Any, bytes],
        faults: FaultLog,
        dead: Set[Any],
        corrupt_shards: Optional[Dict[Any, Dict[Any, bytes]]] = None,
        forged_dec: Optional[Dict[Any, Dict[Any, Any]]] = None,
        late: Optional[Set[Any]] = None,
        observe: bool = False,
        adv_bval: Optional[Dict[Any, Tuple[int, int]]] = None,
        adv_aux: Optional[Dict[Any, Tuple[int, int]]] = None,
        forged_coin: Optional[Set[Any]] = None,
        late_subset: Optional[Dict[Any, Set[Any]]] = None,
        divergent: Optional[DivergentEpoch0] = None,
        div_schedule: Optional[DivergentSchedule] = None,
        walls_head: Optional[Dict[str, float]] = None,
        diag: Optional[Dict[str, bool]] = None,
        commit_t0: Optional[float] = None,
    ) -> EpochResult:
        """Phases 3-7 (common subset → decryption → batch → observer):
        everything after the broadcast wave.  ``corrupt_shards`` and
        ``late`` were consumed by the broadcast phase — accepted here so
        the pipelined driver can forward one uniform kwargs dict.
        ``diag``: THIS epoch's broadcast diagnostics.  ``commit_t0``:
        the wall instant this epoch's commit interval started, stamped
        into ``phases['commit_latency']``."""
        forged_dec = forged_dec or {}
        if self.reveal_mode == "ordered":
            if observe:
                raise ValueError(
                    "reveal_mode='ordered' does not support the observer "
                    "lane (the observer derives its batch from decryption "
                    "shares, which have not been emitted at ordered-commit "
                    "time)"
                )
            if self.hw is not None:
                raise ValueError(
                    "reveal_mode='ordered' is incompatible with "
                    "virtual-time accounting (hw=): the deferred "
                    "decrypt wall belongs to a later flush"
                )
            # backpressure: ordering stalls — by revealing — once
            # max_outstanding_reveals epochs are ordered but unrevealed
            if len(self._pending_reveals) >= self.max_outstanding_reveals:
                self.flush_reveals()

        _t_rbc = _time.perf_counter()
        if len(delivered) < self.ref.num_correct:
            hint = (
                "the codec found no invertible decode window — a "
                "backend/coding-matrix defect, not a schedule problem"
                if (diag or {}).get("decode_exhausted")
                else "more than f dead/corrupt/late proposers"
            )
            raise RuntimeError(
                "fewer than N−f broadcasts delivered — common subset "
                f"cannot terminate on this schedule ({hint})"
            )
        late_subset = late_subset or {}
        if set(late_subset) - set(delivered):
            raise ValueError(
                "late_subset proposers must have completed their "
                "broadcast (they deliver late, not never)"
            )
        est0: Dict[Any, Any] = {}
        for pid in self.netinfos:
            if pid in late_subset:
                subset = late_subset[pid]
                est0[pid] = {nid: (nid in subset) for nid in self.netinfos}
            else:
                est0[pid] = pid in delivered
        ag = VectorizedAgreement(
            self.netinfos,
            self.epoch,
            sorted(self.netinfos),
            dead=dead,
            mock=self.mock,
            be=self.be,
        )
        res = ag.run(
            est0,
            adv_bval=adv_bval,
            adv_aux=adv_aux,
            forged_coin=forged_coin,
            divergent=divergent,
            div_schedule=div_schedule,
        )
        faults.merge(res.fault_log)
        # divergent equivocators are Byzantine: silent in every later
        # phase, exactly like dead nodes
        if divergent is not None:
            dead = dead | set(divergent.equiv)
        if div_schedule is not None:
            dead = dead | set(div_schedule.equiv)
        accepted = sorted(pid for pid, yes in res.decisions.items() if yes)

        _t_agree = _time.perf_counter()
        # 4. deserialize + validity-check each accepted ciphertext once
        # (honey_badger.rs:351-418; invalid ⇒ proposer attributed, skipped)
        cts: Dict[Any, Any] = {}
        for pid in accepted:
            try:
                ct = loads(delivered[pid])
                valid = ct.verify()
            except Exception:
                valid = False
            if not valid:
                faults.add(pid, FaultKind.INVALID_CIPHERTEXT)
                continue
            cts[pid] = ct

        if self.reveal_mode == "ordered":
            # ORDERED-COMMIT: the ciphertext batch is pinned the moment
            # ACS finishes; decryption waits for a later cross-epoch
            # fused flush, so the commit interval ends HERE
            _t_ordered = _time.perf_counter()
            phases = dict(walls_head or {})
            phases["agreement"] = _t_agree - _t_rbc
            if commit_t0 is not None:
                phases["commit_latency"] = _t_ordered - commit_t0
            seq = self._ordered_seq
            self._ordered_seq += 1
            result = EpochResult(
                batch=None,
                accepted=accepted,
                fault_log=faults,
                coin_flips=res.coin_flips,
                shares_verified=0,
                agreement_epochs=res.epochs_used,
                phases=phases,
                diverged=res.diverged,
                class_epochs=res.class_epochs,
            )
            self._pending_reveals.append(
                _PendingReveal(
                    epoch=self.epoch,
                    seq=seq,
                    cts=cts,
                    dead=set(dead),
                    forged_dec=forged_dec,
                    result=result,
                    t_ordered=_t_ordered,
                )
            )
            self.epoch += 1
            return result

        # 5. decryption phase — one grouped flush (vectorized.decrypt_round).
        # With an observer attached, honest-share checks are no longer
        # redundant (the observer holds no key share), so they ride the
        # same cache-filling flush and the observer's checks are hits.
        dec = decrypt_round(
            self.netinfos,
            cts,
            dead=dead,
            forged=forged_dec,
            be=self.be,
            verify_honest=self.verify_honest or observe,
            emit_minimal=self.emit_minimal,
            speculative=self.speculative,
        )
        faults.merge(dec.fault_log)

        _t_dec = _time.perf_counter()
        phases: Dict[str, float] = dict(walls_head or {})
        phases["agreement"] = _t_agree - _t_rbc
        phases["decrypt"] = _t_dec - _t_agree
        for k, v in (dec.phases or {}).items():
            phases["dec_" + k] = v
        if dec.spec:
            phases["spec_hits"] = float(dec.spec.get("hits", 0))
            phases["spec_misses"] = float(dec.spec.get("misses", 0))
        for k, v in (self.be.last_flush_phases or {}).items():
            phases["flush_" + k] = v
        mesh = getattr(self.be.inner, "mesh", None)
        if mesh is not None and mesh.size > 1:
            phases["mesh_devices"] = float(mesh.size)
        # 6. batch assembly (honey_badger.rs:296-317)
        out_contribs: Dict[Any, Any] = {}
        for pid in sorted(dec.contributions):
            try:
                out_contribs[pid] = loads(dec.contributions[pid])
            except Exception:  # malformed plaintext ⇒ proposer's fault
                faults.add(pid, FaultKind.BATCH_DESERIALIZATION_FAILED)
        batch = Batch(self.epoch, out_contribs)
        phases["assembly"] = _time.perf_counter() - _t_dec
        virtual = None
        if self.hw is not None:
            walls = {
                k: phases[k]
                for k in ("propose", "rbc", "agreement", "decrypt", "assembly")
                if k in phases
            }
            virtual = self._virtual_account(payloads, res, cts, walls=walls)

        # 7. observer lane (optional): derive the batch again from
        # public traffic only, with no secret key share
        observer_batch = None
        if observe:
            _t0 = _time.perf_counter()
            observer_batch = self._observer_epoch(
                delivered, res.decisions, dec.emitted
            )
            phases["observer"] = _time.perf_counter() - _t0
            for k, v in (getattr(self, "_obs_phases", None) or {}).items():
                phases["observer_" + k] = v
        if commit_t0 is not None:
            phases["commit_latency"] = _time.perf_counter() - commit_t0
        self.epoch += 1
        return EpochResult(
            batch=batch,
            accepted=accepted,
            fault_log=faults,
            coin_flips=res.coin_flips,
            shares_verified=dec.shares_verified,
            agreement_epochs=res.epochs_used,
            observer_batch=observer_batch,
            virtual=virtual,
            phases=phases,
            diverged=res.diverged,
            class_epochs=res.class_epochs,
        )

    # -- order-then-reveal: the deferred reveal plane -----------------------

    def flush_reveals(self) -> List["EpochResult"]:
        """Reveal every ordered-but-unrevealed epoch in ONE cross-epoch
        fused decryption flush (``vectorized.decrypt_rounds_deferred``:
        all pending epochs' share verifications ride a single RLC
        batch, all combines one native call).

        Each queued epoch's :class:`EpochResult` — already returned to
        the caller at ordered-commit time — is filled IN PLACE:
        ``batch``, merged decryption faults, ``shares_verified`` and
        the reveal-side phase walls.  Called automatically at the
        backpressure bound and at the end of ``run_epochs``; idempotent
        when nothing is pending.  Byte-identity of the filled batches
        with ``reveal_mode="inline"`` is asserted in
        ``tests/test_torch_epoch.py``."""
        if not self._pending_reveals:
            return []
        pending, self._pending_reveals = self._pending_reveals, []
        decs = decrypt_rounds_deferred(
            self.netinfos,
            [
                RevealRequest(
                    epoch=p.epoch,
                    ciphertexts=p.cts,
                    dead=p.dead,
                    forged=p.forged_dec,
                )
                for p in pending
            ],
            be=self.be,
            verify_honest=self.verify_honest,
            emit_minimal=self.emit_minimal,
            speculative=self.speculative,
        )
        _t_done = _time.perf_counter()
        out: List[EpochResult] = []
        for p, dec in zip(pending, decs):
            p.result.fault_log.merge(dec.fault_log)
            contribs: Dict[Any, Any] = {}
            for pid in sorted(dec.contributions):
                try:
                    contribs[pid] = loads(dec.contributions[pid])
                except Exception:  # malformed plaintext ⇒ proposer's fault
                    p.result.fault_log.add(
                        pid, FaultKind.BATCH_DESERIALIZATION_FAILED
                    )
            p.result.batch = Batch(p.epoch, contribs)
            p.result.shares_verified = dec.shares_verified
            lag = _t_done - p.t_ordered
            phases = p.result.phases
            if phases is not None:
                phases["reveal_lag"] = lag
                for k, v in (dec.phases or {}).items():
                    phases["dec_" + k] = v
                if dec.spec:
                    phases["spec_hits"] = float(dec.spec.get("hits", 0))
                    phases["spec_misses"] = float(dec.spec.get("misses", 0))
                for k, v in (
                    getattr(self.be, "last_flush_phases", None) or {}
                ).items():
                    phases["flush_" + k] = v
            out.append(p.result)
        return out

    # -- epoch phases -------------------------------------------------------

    def _propose_phase(
        self, contributions: Dict[Any, Any], dead: Set[Any]
    ) -> Dict[Any, bytes]:
        """1. propose: serialize + threshold-encrypt
        (``honey_badger.rs:101-122``).  The only phase that draws from
        ``self.rng`` — calling it for epoch e+1 before epoch e's
        decryption (the pipelined driver) preserves the exact rng
        sequence of the sequential loop."""
        payloads: Dict[Any, bytes] = {}
        for pid in sorted(self.netinfos):
            if pid in dead or pid not in contributions:
                continue
            ct = self.pk_set.public_key().encrypt(
                dumps(contributions[pid]), self.rng
            )
            payloads[pid] = dumps(ct)
        return payloads

    def _broadcast_phase(
        self,
        payloads: Dict[Any, bytes],
        dead: Set[Any],
        corrupt_shards: Dict[Any, Dict[Any, bytes]],
        late: Set[Any],
        faults: FaultLog,
        diag: Optional[Dict[str, bool]] = None,
    ) -> Dict[Any, bytes]:
        """2. reliable broadcast per live proposer (``broadcast.rs``
        semantics, deduplicated: each echoed proof checked once, one
        decode per instance, re-rooted against equivocation).
        Uncorrupted instances batch: one parity matmul and one decode
        matmul across ALL proposers, instead of a Gauss-Jordan and GF
        matmuls per instance.  ``late`` proposers' RBC waves are
        withheld by the adversary's schedule: nothing delivers before
        agreement.

        Pure host compute over its arguments (no rng, no epoch
        counter) — safe to run for epoch e+1 on the pipeline worker
        thread while epoch e's decryption flush waits on the device.
        """
        delivered: Dict[Any, bytes] = {}
        timely = {
            pid: v for pid, v in payloads.items() if pid not in late
        }
        plain = {
            pid: v for pid, v in timely.items() if pid not in corrupt_shards
        }
        delivered.update(self._rbc_phase(plain, dead, faults, diag))
        for pid in sorted(set(timely) - set(plain)):
            value = self._rbc(
                pid, payloads[pid], dead, corrupt_shards.get(pid), faults
            )
            if value is not None:
                delivered[pid] = value
        return delivered

    def _stage_epoch(
        self,
        contributions: Dict[Any, Any],
        dead: Set[Any],
        corrupt_shards: Dict[Any, Dict[Any, bytes]],
        late: Set[Any],
        faults: FaultLog,
        diag: Dict[str, bool],
    ) -> Tuple[Dict[Any, bytes], Dict[Any, bytes]]:
        """Propose THEN broadcast one epoch, as a single unit of
        pipeline-worker work.  Running the proposer encryption on the
        worker (rather than the calling thread) lets epoch e+1's
        threshold encryptions overlap epoch e's
        agreement + decryption flush too — and stays deterministic
        because the single FIFO worker executes stage tasks in
        submission (= epoch) order, so ``_propose_phase``'s rng draws
        happen in exactly the sequential loop's sequence.  Nothing on
        the calling thread touches ``self.rng`` (``_finish_epoch`` is
        rng-free), so there is no interleaving to race."""
        payloads = self._propose_phase(contributions, dead)
        delivered = self._broadcast_phase(
            payloads, dead, corrupt_shards, late, faults, diag
        )
        return payloads, delivered

    # -- pipelined multi-epoch driver ---------------------------------------

    def run_epochs(
        self,
        contributions_seq: Sequence[Dict[Any, Any]],
        dead: Optional[Set[Any]] = None,
        pipeline: Any = True,
        **epoch_kwargs,
    ) -> List[EpochResult]:
        """Run consecutive epochs with TWO in flight — the vectorized
        mirror of the reference's ``max_future_epochs`` window
        (``honey_badger.rs:30-34``).

        Epoch e+1's proposer encryption and broadcast matmuls run as
        one staged task (:meth:`_stage_epoch`) on a single FIFO worker
        thread — which preserves the sequential rng order — while this
        thread completes epoch e's agreement and decryption flush.
        Outcomes are bit-identical to the sequential loop
        (``pipeline=False``).  ``epoch_kwargs`` are forwarded to every
        epoch.  With a virtual-time ``hw`` model the driver runs the
        epochs one after another: overlapped wall clocks would corrupt
        the measured-phase account.  ``pipeline="deep"`` (the
        reference's staging-FIFO driver) is not ported and raises
        ``ValueError``."""
        if pipeline == "deep":
            raise ValueError("pipeline='deep' (the staged driver) is not ported")
        seq = list(contributions_seq)
        dead = set(dead or set())
        if not pipeline or len(seq) <= 1 or self.hw is not None:
            results = [self.run_epoch(c, dead=dead, **epoch_kwargs) for c in seq]
            if self.reveal_mode == "ordered":
                self.flush_reveals()  # results are filled in place
            return results
        corrupt_shards = epoch_kwargs.get("corrupt_shards") or {}
        late = set(epoch_kwargs.get("late") or set())
        if len(dead) > self.num_faulty:
            raise ValueError(
                f"{len(dead)} dead nodes exceeds the f={self.num_faulty} bound"
            )
        results: List[EpochResult] = []
        with ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="hbbft-epoch-stage"
        ) as ex:
            faults_next = FaultLog()
            diag_next: Dict[str, bool] = {}
            fut = ex.submit(
                self._stage_epoch,
                seq[0],
                dead,
                corrupt_shards,
                late,
                faults_next,
                diag_next,
            )
            # pipelined commit latency = inter-commit gap
            commit_t0 = _time.perf_counter()
            for e in range(len(seq)):
                (payloads, delivered), faults, diag = (
                    fut.result(),
                    faults_next,
                    diag_next,
                )
                if e + 1 < len(seq):
                    faults_next = FaultLog()
                    diag_next = {}
                    fut = ex.submit(
                        self._stage_epoch,
                        seq[e + 1],
                        dead,
                        corrupt_shards,
                        late,
                        faults_next,
                        diag_next,
                    )
                results.append(
                    self._finish_epoch(
                        payloads,
                        delivered,
                        faults,
                        dead,
                        diag=diag,
                        commit_t0=commit_t0,
                        **epoch_kwargs,
                    )
                )
                commit_t0 = _time.perf_counter()
        if self.reveal_mode == "ordered":
            self.flush_reveals()  # results are filled in place
        return results

    # -- virtual-time accounting -------------------------------------------

    def _virtual_account(
        self,
        payloads: Dict[Any, bytes],
        res: AgreementResult,
        cts: Dict[Any, Any],
        walls: Dict[str, float],
    ) -> VirtualEpochTime:
        """Simulated epoch latency under ``self.hw`` (see
        :class:`VirtualEpochTime` for the model)."""
        hw = self.hw
        n = self.n
        P = len(payloads)  # broadcast instances
        k = self.data
        max_payload = max((len(v) for v in payloads.values()), default=0) + 4
        sym = getattr(self.codec, "symbol", 1)
        shard = max(-(-max_payload // k), 1)
        shard = -(-shard // sym) * sym
        proof = 32 * (math.ceil(math.log2(max(n, 2))) + 1) + 8
        s_value = shard + proof
        s_ready = 48
        s_bool = 24
        s_share = 80  # decryption/signature share + tag/nonce overhead

        rounds = []  # (label, per-node upstream bytes, per-node msgs)
        # Value: each proposer unicasts one proof per node
        rounds.append(("value", (n - 1) * s_value, n - 1))
        # Echo: every node multicasts its proof for every instance
        rounds.append(("echo", P * (n - 1) * s_value, P * (n - 1)))
        # Ready: every node multicasts a root hash per instance
        rounds.append(("ready", P * (n - 1) * s_ready, P * (n - 1)))
        # Agreement epochs: BVal + Aux from the instances still ACTIVE
        # at that epoch (decided instances stop sending — counted from
        # the per-instance deciding epochs), plus Conf + coin-share
        # rounds before each real coin (schedule epochs ≡ 2 mod 3,
        # agreement.rs:314-328)
        ag_epochs = max(res.epochs_used.values(), default=0) + 1
        for e in range(ag_epochs):
            active = sum(1 for v in res.epochs_used.values() if v >= e)
            rounds.append(("bval-%d" % e, active * (n - 1) * s_bool, active * (n - 1)))
            rounds.append(("aux-%d" % e, active * (n - 1) * s_bool, active * (n - 1)))
            if e % 3 == 2 and active:
                rounds.append(("conf-%d" % e, active * (n - 1) * s_bool, active * (n - 1)))
                rounds.append(("coin-%d" % e, active * (n - 1) * s_share, active * (n - 1)))
        # Decryption: one share per accepted ciphertext to every node
        rounds.append(("decshares", len(cts) * (n - 1) * s_share, len(cts) * (n - 1)))

        network_s = sum(b * hw.inv_bw + hw.latency for _, b, _ in rounds)
        # cpu: verification/bookkeeping phases are replicated per node
        # (every real node checks all distinct shares/proofs — the
        # batch wall IS one node's work); the PROPOSE phase is
        # per-proposer (each node encrypts only its own contribution),
        # so its wall is divided by the proposer count
        scale = 100.0 / hw.cpu_factor
        cpu_parts = {}
        for kk, v in walls.items():
            if kk == "propose":
                cpu_parts["cpu:" + kk] = v * scale / max(P, 1)
            else:
                cpu_parts["cpu:" + kk] = v * scale
        cpu_s = sum(cpu_parts.values())
        breakdown = {label: b * hw.inv_bw + hw.latency for label, b, _ in rounds}
        breakdown.update(cpu_parts)
        return VirtualEpochTime(
            total_s=network_s + cpu_s,
            rounds=len(rounds),
            per_node_msgs=sum(m for _, _, m in rounds),
            per_node_bytes=sum(b for _, b, _ in rounds),
            network_s=network_s,
            cpu_s=cpu_s,
            breakdown=breakdown,
        )

    # -- observer lane ------------------------------------------------------

    def _observer_epoch(
        self,
        delivered: Dict[Any, bytes],
        decisions: Dict[Any, bool],
        emitted: Dict[Any, Dict[Any, Any]],
    ) -> Batch:
        """The non-validator lane (reference ``tests/network/mod.rs:
        402-420``): from ``Target::All`` traffic alone — delivered RBC
        payloads, the public agreement decisions, and the emitted
        decryption shares — an observer holding NO secret key share
        derives the identical batch.  Every share it uses is verified
        through the public batched path (an observer cannot elide
        ``verify_honest``: it has no way to know which shares are
        honest), then combined with the same lowest-t+1-valid rule.

        The verifications themselves ran in the epoch's MAIN decryption
        flush (``run_epoch`` forces the cache-filling path when an
        observer is attached), so the per-share checks here are cache
        hits — one flush serves both lanes instead of the observer
        doubling the epoch's dominant cost at scale."""
        ph: Dict[str, float] = {}
        self._obs_phases = ph
        _t0 = _time.perf_counter()
        obs_ni = self.ref.observer_view("observer")
        assert not obs_ni.is_validator
        ph["view"] = _time.perf_counter() - _t0
        _t0 = _time.perf_counter()
        accepted = sorted(pid for pid, yes in decisions.items() if yes)
        cts: Dict[Any, Any] = {}
        for pid in accepted:
            try:
                ct = loads(delivered[pid])
                if ct.verify():
                    cts[pid] = ct
            except Exception:
                pass
        ph["cts"] = _time.perf_counter() - _t0
        _t0 = _time.perf_counter()
        # The observer verifies every share it uses through the PUBLIC
        # cached seam — one pass, no obligation objects and no second
        # prefetch sweep: the epoch's main flush already filled the
        # cache (run_epoch forces the cache-filling path when an
        # observer is attached), and verify_dec_share falls back to an
        # inline check on any miss, so correctness never depends on
        # that assumption.
        valid: Dict[Any, Dict[int, Any]] = {}
        for pid in sorted(cts):
            ct = cts[pid]
            row = valid.setdefault(pid, {})
            for nid, share in sorted(emitted.get(pid, {}).items()):
                if self.be.verify_dec_share(
                    obs_ni.public_key_share(nid), share, ct
                ):
                    row[obs_ni.node_index(nid)] = share
        ph["verify"] = _time.perf_counter() - _t0
        _t0 = _time.perf_counter()
        contribs: Dict[Any, Any] = {}
        pk_set = obs_ni.public_key_set
        rows, row_cts, row_pids = [], [], []
        for pid in sorted(cts):
            by_idx = valid.get(pid, {})
            if len(by_idx) <= self.num_faulty:
                continue
            rows.append(by_idx)
            row_cts.append(cts[pid])
            row_pids.append(pid)
        if rows:
            # batched combines (one native call per shared subset);
            # a failing BATCH degrades to per-row combines so one bad
            # proposer can only ever drop itself, exactly like the
            # per-pid path it replaced
            many = getattr(pk_set, "combine_decryption_shares_many", None)
            plains: Optional[List[Any]] = None
            if many is not None:
                try:
                    plains = many(rows, row_cts)
                except Exception:
                    plains = None
            if plains is None:
                plains = []
                for r, c in zip(rows, row_cts):
                    try:
                        plains.append(
                            pk_set.combine_decryption_shares(r, c)
                        )
                    except Exception:
                        plains.append(None)
            for pid, plain in zip(row_pids, plains):
                try:
                    if plain is not None:
                        contribs[pid] = loads(plain)
                except Exception:
                    pass
        ph["combine"] = _time.perf_counter() - _t0
        return Batch(self.epoch, contribs)


    # -- reliable broadcast (batched across uncorrupted instances) ---------

    def _codec_mat(self) -> np.ndarray:
        mat = getattr(self.codec, "matrix", None)
        if mat is None:  # a device codec wraps the host matrix
            mat = self.codec._host.matrix
        return mat

    def _codec_matmul(self, rows: np.ndarray, byte_mat: np.ndarray) -> np.ndarray:
        """Constant coding matrix × byte matrix in the codec's field,
        dispatched to the codec's engine: the device codecs' products
        (``gf16_matmul_device`` / ``gf_matmul_device``, each by the
        backend's size rule), the native host product otherwise."""
        if isinstance(self.codec, GF.ReedSolomonDevice16):
            syms = np.ascontiguousarray(byte_mat).view("<u2")
            out = self.codec.matmul(rows, syms)
            return np.ascontiguousarray(out.astype("<u2")).view(np.uint8)
        if isinstance(self.codec, GF.ReedSolomonDevice):
            return self.codec.matmul(rows, byte_mat)
        if getattr(self.codec, "symbol", 1) == 2:
            syms = np.ascontiguousarray(byte_mat).view("<u2")
            out = RS._matmul16(rows, syms)
            return np.ascontiguousarray(out.astype("<u2")).view(np.uint8)
        return RS._matmul(rows, byte_mat)

    def _rbc_phase(
        self,
        payloads: Dict[Any, bytes],
        dead: Set[Any],
        faults: FaultLog,
        diag: Optional[Dict[str, bool]] = None,
    ) -> Dict[Any, bytes]:
        """All uncorrupted broadcast instances in one wave: a single
        parity matmul over [k, P·L], one cached decode matrix for the
        shared erasure pattern, a single reconstruction matmul, every
        instance's Merkle commitment in one forest (``ops.merkle_trees``),
        and unless elided the re-root self-check per instance, one
        product of the dead nodes' rows over the instances that passed it
        and one roots-only forest of their reconstructions; the outcomes
        (values, the per-instance replay, faults) then follow in proposer
        order, as a loop over the instances would give them.  Shard width
        is uniform across instances (the framing's length header makes
        padding invisible to the decoded value).
        ``diag``: per-epoch diagnostics sink (``decode_exhausted``).
        The only instance state touched is ``_decode_start``, a
        window-retry hint where a pipelined-thread race costs at most
        one extra decode attempt."""
        if not payloads:
            return {}
        ops, codec = self.ref.ops, self.codec
        sym = getattr(codec, "symbol", 1)
        k, n = self.data, self.n
        pids = sorted(payloads)
        P = len(pids)
        max_payload = max(len(payloads[p]) for p in pids) + 4
        L = max(-(-max_payload // k), 1)
        L = -(-L // sym) * sym
        data_all = np.zeros((k, P * L), dtype=np.uint8)
        for j, pid in enumerate(pids):
            framed = len(payloads[pid]).to_bytes(4, "big") + bytes(
                payloads[pid]
            )
            buf = np.frombuffer(framed.ljust(k * L, b"\x00"), dtype=np.uint8)
            data_all[:, j * L : (j + 1) * L] = buf.reshape(k, L)

        dead_idx = {self.ref.node_index(nid) for nid in dead}
        if self.parity:
            mat = self._codec_mat()
            parity_all = self._codec_matmul(mat[k:], data_all)
            encoded = np.vstack([data_all, parity_all])  # [n, P·L]
            present = [i for i in range(n) if i not in dead_idx]
            # Every k-row submatrix of the shipped systematic matrix is
            # invertible (M = V·V_top⁻¹ from a true Vandermonde at
            # distinct points, so det(M_S) = det(V_S)/det(V_top) ≠ 0) —
            # this retry loop is defensive for custom ops codecs whose
            # coding matrices lack that property: slide to a different
            # k-subset of the present rows until one decodes.
            dec = use = None
            n_starts = len(present) - k + 1
            first = getattr(self, "_decode_start", 0) % n_starts
            for start in [first] + [
                s for s in range(n_starts) if s != first
            ]:
                try:
                    use = present[start : start + k]
                    dec = codec.decode_matrix(use)
                    self._decode_start = start  # skip bad windows next wave
                    break
                except ValueError:
                    continue
            if dec is None:
                # no invertible subset among the sliding windows — a
                # backend defect, not proposer misbehavior: fail closed
                # with nothing delivered (matching the per-instance
                # path, which records no fault on reconstruct failure);
                # flagged so run_epoch's guard names the real culprit
                if diag is not None:
                    diag["decode_exhausted"] = True
                return {}
            data_rec = self._codec_matmul(dec, encoded[use])
        else:
            encoded = data_all
            data_rec = data_all

        # every proposer's commitment tree in one forest: tree j's leaf i is
        # encoded[i, jL:(j+1)L]
        trees = ops.merkle_trees(_forest(encoded, P, L))
        replay: Set[int] = set()
        roots: Dict[int, bytes] = {}
        if self.verify_honest:
            # echo-proof validation, FUSED (a per-proof Python loop would
            # build ~N² proof objects and chain walks an epoch): the N
            # proofs of one tree share their internal chain nodes, so
            # validating all of them, deduplicated, IS one rebuild of every
            # internal node from the shard values.  The rebuild goes through
            # the INDEPENDENT pure-Python tree assembly (not a second call
            # of the same ops builder, which would compare a deterministic
            # function to itself) and is compared level-by-level against
            # the ops-built commitment — the same cross-implementation power
            # the per-proof chain recompute had, at N hashes instead of
            # N·log N Python objects.  Any mismatch (backend bug, exotic ops
            # codec) replays the exact per-instance path so fault
            # attribution matches the sequential semantics.
            for j in range(P):
                sl = slice(j * L, (j + 1) * L)
                rebuilt = self._reroot([encoded[i, sl].tobytes() for i in range(n)]).levels
                same = getattr(trees[j], "levels_equal", None)
                if not (same(rebuilt) if same is not None else rebuilt == trees[j].levels):
                    replay.add(j)
            passed = [j for j in range(P) if j not in replay]
            if passed:
                # each passing proposer's shards as reconstructed: the
                # decoded data rows, the parity rows as encoded, and the
                # dead nodes' rows recomputed from the decoded data, all
                # proposers' in one product
                cols = (slice(None) if len(passed) == P
                        else np.concatenate([np.arange(j * L, (j + 1) * L) for j in passed]))
                rec = np.vstack([data_rec, encoded[k:]])[:, cols]
                if self.parity and dead_idx:
                    dead_rows = sorted(dead_idx)
                    rec[dead_rows, :] = self._codec_matmul(
                        self._codec_mat()[dead_rows, :], data_rec[:, cols]
                    )
                rec_roots = ops.merkle_trees(_forest(rec, len(passed), L), roots_only=True)
                roots = dict(zip(passed, rec_roots))

        # outcomes in pid order, so that the fault log's order is the
        # per-proposer loop's
        out: Dict[Any, bytes] = {}
        for j, pid in enumerate(pids):
            if j in replay:
                value = self._rbc(pid, payloads[pid], dead, None, faults)
                if value is not None:
                    out[pid] = value
                continue
            if self.verify_honest and roots[j] != trees[j].root_hash:
                faults.add(pid, FaultKind.BROADCAST_DECODING_FAILED)
                continue
            payload = data_rec[:, j * L : (j + 1) * L].tobytes()
            shard_list = [
                payload[i * L : (i + 1) * L] for i in range(k)
            ]
            value = unframe_shards(shard_list, k)
            if value is None:
                faults.add(pid, FaultKind.BROADCAST_DECODING_FAILED)
            else:
                out[pid] = value
        return out

    # -- reliable broadcast (one instance, deduplicated) -------------------

    def _rbc(
        self,
        proposer: Any,
        value: bytes,
        dead: Set[Any],
        corrupt: Optional[Dict[Any, bytes]],
        faults: FaultLog,
    ) -> Optional[bytes]:
        ops = self.ref.ops
        codec = self.codec
        data = frame_into_shards(
            value, self.data, getattr(codec, "symbol", 1)
        )
        shards = codec.encode(data)
        mtree = ops.merkle_tree(shards)
        root = mtree.root_hash

        corrupt = corrupt or {}
        echoed: List[Optional[bytes]] = [None] * self.n
        for nid in sorted(self.netinfos):
            if nid in dead:
                continue
            idx = self.ref.node_index(nid)
            if nid in corrupt:
                # a tampered echo proof fails validation exactly as the
                # sequential ``_validate_proof`` (broadcast.rs:555-575)
                proof = dataclasses.replace(
                    mtree.proof(idx), value=corrupt[nid]
                )
                if proof.validate(self.n) and proof.root_hash == root:
                    echoed[idx] = proof.value  # (forgery would need SHA-256 break)
                else:
                    faults.add(nid, FaultKind.INVALID_PROOF)
            else:
                # proofs we just generated from the committed tree are
                # valid by construction (verify_honest elision argument)
                if self.verify_honest and not (
                    mtree.proof(idx).validate(self.n)
                ):
                    faults.add(nid, FaultKind.INVALID_PROOF)
                    continue
                echoed[idx] = shards[idx]
        if sum(s is not None for s in echoed) < self.data:
            return None
        try:
            full = codec.reconstruct(list(echoed))
        except ValueError:
            return None
        if ops.merkle_tree(full).root_hash != root:
            faults.add(proposer, FaultKind.BROADCAST_DECODING_FAILED)
            return None
        out = unframe_shards(full, self.data)
        if out is None:
            faults.add(proposer, FaultKind.BROADCAST_DECODING_FAILED)
        return out



# ---------------------------------------------------------------------------
# Queueing layer: multi-epoch runs with transaction queues
# ---------------------------------------------------------------------------


class TransactionQueueMixin:
    """Copy-on-diverge per-node transaction queues (the reference's
    normal operating mode: each node holds its own queue and proposes
    from it, ``queueing_honey_badger.rs:188-204``).

    While every injection is uniform (``input_all``, the harness/bench
    scenario) all per-node queues are provably identical — ``choose``
    never mutates and every node removes the same committed set — so
    ONE shared deque stands for all of them; the first divergent
    ``input_node`` call materializes real per-node copies.  Per-node
    proposals always draw independent random samples, exactly the
    reference's duplicate-avoidance scheme
    (``queueing_honey_badger.rs:13-23``).

    Users provide ``_queue_ids()`` (the current validator set) and the
    ``rng``/``batch_size`` attributes."""

    def _init_queues(self) -> None:
        self.queue = TransactionQueue()  # shared while uniform
        self._per_node: Optional[Dict[Any, Any]] = None

    def _queue_ids(self) -> List[Any]:  # pragma: no cover - abstract
        raise NotImplementedError

    @property
    def diverged(self) -> bool:
        return self._per_node is not None

    @property
    def queues(self) -> Dict[Any, Any]:
        """Each node's queue (the uniform view maps every node to the
        one shared queue; after divergence, the real per-node ones)."""
        if self._per_node is not None:
            return self._per_node
        return {nid: self.queue for nid in self._queue_ids()}

    def _materialize(self) -> None:
        """Copy-on-diverge: split the shared queue into real per-node
        copies (identical until now by the uniformity argument)."""
        if self._per_node is None:
            self._per_node = {
                nid: TransactionQueue(self.queue.queue)
                for nid in self._queue_ids()
            }

    def input_all(self, txs: Sequence[Any]) -> None:
        if self._per_node is None:
            for tx in txs:
                self.queue.push(tx)
        else:
            for q in self._per_node.values():
                for tx in txs:
                    q.push(tx)

    def input_node(self, nid: Any, txs: Sequence[Any]) -> None:
        """Divergent injection: transactions only node ``nid`` has
        heard of (the reference's normal mode — queues differ across
        nodes until commits drain them)."""
        self._materialize()
        q = self._per_node[nid]
        for tx in txs:
            q.push(tx)

    def _sample_contribs(self, dead: Set[Any]) -> Dict[Any, List[Any]]:
        """Every live validator's B/N random proposal from its queue."""
        ids = self._queue_ids()
        amount = max(1, self.batch_size // len(ids))
        if self._per_node is None:
            # uniform fast path: materialize the shared head ONCE;
            # every live node samples from it independently
            # (semantically equal to per-node queue.choose)
            head = list(
                itertools.islice(
                    self.queue.queue, min(self.batch_size, len(self.queue))
                )
            )
            return {
                nid: (
                    list(head)
                    if len(head) <= amount
                    else self.rng.sample(head, amount)
                )
                for nid in ids
                if nid not in dead
            }
        for nid in ids:
            if nid not in self._per_node:
                # a joining validator synchronizes the backlog from a
                # sponsor (JoinPlan semantics): seed from a live queue
                sponsor = next(iter(self._per_node.values()))
                self._per_node[nid] = TransactionQueue(sponsor.queue)
        return {
            nid: self._per_node[nid].choose(
                amount, self.batch_size, self.rng
            )
            for nid in ids
            if nid not in dead
        }

    def _drain(self, committed: List[Any]) -> None:
        if self._per_node is None:
            self.queue.remove_all(committed)
        else:
            for q in self._per_node.values():
                q.remove_all(committed)



class VectorizedQueueingSim(TransactionQueueMixin):
    """QueueingHoneyBadger co-simulation over the static epoch driver:
    transaction queues, random B/N proposals, committed-transaction
    removal (reference ``queueing_honey_badger.rs:188-268``)."""

    def __init__(
        self,
        n: int,
        rng,
        batch_size: int = 100,
        mock: bool = False,
        ops: Any = None,
        verify_honest: bool = True,
        emit_minimal: bool = False,
        hw: Any = None,
    ):
        # the queue drains each epoch's committed txs immediately, so the
        # batch must exist at run_epoch return: inline reveals
        self.sim = VectorizedHoneyBadgerSim(
            n,
            rng,
            mock=mock,
            ops=ops,
            verify_honest=verify_honest,
            emit_minimal=emit_minimal,
            hw=hw,
            reveal_mode="inline",
        )
        self.rng = rng
        self.batch_size = batch_size
        self._init_queues()

    def _queue_ids(self) -> List[Any]:
        return sorted(self.sim.netinfos)

    def run_epoch(self, dead: Optional[Set[Any]] = None, **adv) -> EpochResult:
        # a WAN-crashed node draws no proposal: the crash set is merged
        # BEFORE queue sampling, so the rng sequence matches the packed
        # co-sim's (which samples post-merge)
        wan, dead = crashed_with(adv.get("wan"), self.sim.n, self.sim.epoch, dead)
        if wan is not None:
            adv["wan"] = wan
        contribs = self._sample_contribs(dead)
        result = self.sim.run_epoch(contribs, dead=dead, **adv)
        self._drain(list(result.batch.tx_iter()))
        return result
