"""DynamicHoneyBadger — HoneyBadger with dynamic validator membership.

The port's own copy of ``hbbft_tpu/protocols/dynamic_honey_badger.py``
(reference ``src/dynamic_honey_badger/``).  Wraps an inner
``HoneyBadger`` whose contributions bundle the user's data with signed
votes and signed DKG messages (``InternalContrib``).  Votes and
``Part``/``Ack`` messages are committed *on-chain* — ordered by
HoneyBadger batches — before being counted or fed into ``SyncKeyGen``,
which makes the synchronous DKG safe on an asynchronous network.

A change wins at f+1 committed votes → DKG (re)starts; DKG completion
swaps ``NetworkInfo`` (keeping its ``ops``) and restarts the inner
HoneyBadger in a new *era* (``start_epoch``).  Each change-bearing batch
carries a ``JoinPlan`` from which a fresh node can join as an observer
at the next epoch boundary.  Wire names are the reference's.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Any, Dict, List, Optional, Tuple

from ..core.algorithm import DistAlgorithm, UnknownSenderError
from ..core.fault import FaultKind, FaultLog
from ..core.network_info import NetworkInfo
from ..core.serialize import dumps, wire
from ..core.step import Step
from .change import Add, Change, ChangeState, Complete, InProgress, NoChange, Remove
from .honey_badger import HoneyBadger
from .sync_key_gen import Ack, Part, SyncKeyGen
from .votes import SignedVote, VoteCounter


# -- inputs -----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class UserInput:
    contribution: Any


@dataclasses.dataclass(frozen=True)
class ChangeInput:
    change: Change


# -- on-chain payloads -------------------------------------------------------


@wire("KgPart")
@dataclasses.dataclass(frozen=True)
class KgPart:
    part: Part


@wire("KgAck")
@dataclasses.dataclass(frozen=True)
class KgAck:
    ack: Ack


@wire("SignedKgMsg")
@dataclasses.dataclass(frozen=True)
class SignedKeyGenMsg:
    era: int
    node_id: Any
    kg_msg: Any  # KgPart | KgAck
    sig: Any


@wire("InternalContrib")
@dataclasses.dataclass(frozen=True)
class InternalContrib:
    contrib: Any
    key_gen_messages: Tuple
    votes: Tuple


# -- wire messages ----------------------------------------------------------


@wire("DhbHb")
@dataclasses.dataclass(frozen=True)
class DhbHoneyBadger:
    start_epoch: int
    msg: Any


@wire("DhbKeyGen")
@dataclasses.dataclass(frozen=True)
class DhbKeyGen:
    era: int
    kg_msg: Any
    sig: Any


@wire("DhbVote")
@dataclasses.dataclass(frozen=True)
class DhbSignedVote:
    signed_vote: SignedVote


def _message_era(message) -> Optional[int]:
    if isinstance(message, DhbHoneyBadger):
        era = message.start_epoch
    elif isinstance(message, DhbKeyGen):
        era = message.era
    elif isinstance(message, DhbSignedVote):
        era = getattr(message.signed_vote, "era", None)
    else:
        return None
    # off-wire fields can hold anything; a non-int era would raise in
    # the caller's comparisons — treat it as no era (invalid message)
    if not isinstance(era, int) or isinstance(era, bool):
        return None
    return era


# -- batch ------------------------------------------------------------------


@wire("JoinPlan")
@dataclasses.dataclass(frozen=True)
class JoinPlan:
    """Everything a fresh observer needs to join at an epoch boundary
    (reference ``mod.rs:136-145``); ``harness/dynamic.py`` emits it too."""

    epoch: int
    change: ChangeState
    pub_key_set: Any
    pub_keys: Dict[Any, Any]


class DhbBatch:
    """One epoch's output incl. membership-change state (reference
    ``dynamic_honey_badger/batch.rs``)."""

    def __init__(self, epoch: int):
        self.epoch = epoch
        self.contributions: Dict[Any, Any] = {}
        self.change: ChangeState = NoChange()
        self.pub_netinfo: Optional[Tuple[Any, Dict[Any, Any]]] = None

    def set_change(self, change: ChangeState, netinfo: NetworkInfo) -> None:
        self.change = change
        if not isinstance(change, NoChange):
            self.pub_netinfo = (
                netinfo.public_key_set,
                netinfo.public_key_map,
            )

    def join_plan(self) -> Optional[JoinPlan]:
        if self.pub_netinfo is None:
            return None
        pk_set, pub_keys = self.pub_netinfo
        return JoinPlan(self.epoch + 1, self.change, pk_set, pub_keys)

    def tx_iter(self):
        for _, contrib in sorted(self.contributions.items(), key=lambda kv: str(kv[0])):
            yield from contrib

    def __len__(self) -> int:
        return sum(len(c) for c in self.contributions.values())

    def __repr__(self) -> str:
        return (
            f"DhbBatch(epoch={self.epoch}, n={len(self.contributions)}, "
            f"change={self.change!r})"
        )


# -- key generation state ----------------------------------------------------


class _KeyGenState:
    """Ongoing DKG + the change it applies to (reference
    ``mod.rs:147-181``)."""

    def __init__(self, key_gen: SyncKeyGen, change: Change):
        self.key_gen = key_gen
        self.change = change
        self.candidate_msg_count = 0

    def is_ready(self) -> bool:
        if not self.key_gen.is_ready():
            return False
        candidate = self.change.candidate()
        return candidate is None or self.key_gen.is_node_ready(candidate)

    def candidate_key(self, node_id):
        if isinstance(self.change, Add) and self.change.node_id == node_id:
            return self.change.pub_key
        return None


class DynamicHoneyBadger(DistAlgorithm):
    def __init__(
        self,
        netinfo: NetworkInfo,
        max_future_epochs: int = 3,
        rng: Optional[random.Random] = None,
        start_epoch: int = 0,
    ):
        self.netinfo = netinfo
        self.max_future_epochs = max_future_epochs
        # deterministic per-node default (NetworkInfo.default_rng)
        self.rng = (
            rng if rng is not None else netinfo.default_rng("dynamic_honey_badger")
        )
        self.start_epoch = start_epoch
        self.vote_counter = VoteCounter(netinfo, start_epoch)
        self.key_gen_msg_buffer: List[SignedKeyGenMsg] = []
        self.honey_badger = HoneyBadger(
            netinfo, max_future_epochs=max_future_epochs, rng=self.rng
        )
        self.key_gen_state: Optional[_KeyGenState] = None
        self.incoming_queue: List[Tuple[Any, Any]] = []

    # -- DistAlgorithm -----------------------------------------------------

    def handle_input(self, input) -> Step:
        if isinstance(input, UserInput):
            return self.propose(input.contribution)
        if isinstance(input, ChangeInput):
            return self.vote_for(input.change)
        # bare contribution convenience
        return self.propose(input)

    def handle_message(self, sender_id, message) -> Step:
        era = _message_era(message)
        if era is None:
            return Step.from_fault(sender_id, FaultKind.INVALID_MESSAGE)
        if era < self.start_epoch:
            return Step()  # obsolete
        if era > self.start_epoch:
            self.incoming_queue.append((sender_id, message))
            return Step()
        if isinstance(message, DhbHoneyBadger):
            return self._handle_honey_badger_message(sender_id, message.msg)
        if isinstance(message, DhbKeyGen):
            faults = self._handle_key_gen_message(
                sender_id, message.kg_msg, message.sig
            )
            return Step.from_fault_log(faults)
        if isinstance(message, DhbSignedVote):
            faults = self.vote_counter.add_pending_vote(
                sender_id, message.signed_vote
            )
            return Step.from_fault_log(faults)
        return Step.from_fault(sender_id, FaultKind.INVALID_MESSAGE)

    def terminated(self) -> bool:
        return False

    def our_id(self):
        return self.netinfo.our_id

    # -- input paths -------------------------------------------------------

    def has_input(self) -> bool:
        return self.honey_badger.has_input()

    def propose(self, contrib) -> Step:
        internal = InternalContrib(
            contrib,
            tuple(self.key_gen_msg_buffer),
            tuple(self.vote_counter.pending_votes()),
        )
        hb_step = self.honey_badger.handle_input(internal)
        return self._process_output(hb_step)

    def vote_for(self, change: Change) -> Step:
        if not self.netinfo.is_validator:
            return Step()
        signed_vote = self.vote_counter.sign_vote_for(change)
        step: Step = Step()
        step.send_all(DhbSignedVote(signed_vote))
        return step

    def should_propose(self) -> bool:
        """Anti-stall rule (reference ``dynamic_honey_badger.rs:145-165``):
        propose even without content if a correct node wants to advance,
        or we have pending votes/DKG messages to commit."""
        if self.has_input():
            return False
        if self.honey_badger.received_proposals() > self.netinfo.num_faulty:
            return True
        if any(
            sv.voter == self.netinfo.our_id
            for sv in self.vote_counter.pending_votes()
        ):
            return True
        kgs = self.key_gen_state
        if kgs is None:
            return False
        candidate = kgs.change.candidate()
        return any(
            m.node_id == self.netinfo.our_id or m.node_id == candidate
            for m in self.key_gen_msg_buffer
        )

    # -- message handling --------------------------------------------------

    def _handle_honey_badger_message(self, sender_id, hb_msg) -> Step:
        if not self.netinfo.is_node_validator(sender_id):
            raise UnknownSenderError(f"unknown sender {sender_id!r}")
        hb_step = self.honey_badger.handle_message(sender_id, hb_msg)
        return self._process_output(hb_step)

    def _handle_key_gen_message(self, sender_id, kg_msg, sig) -> FaultLog:
        """Buffer a signed DKG message for on-chain commitment; it is
        only *handled* once output in a batch."""
        faults = FaultLog()
        if not self._verify_signature(sender_id, sig, kg_msg):
            faults.add(sender_id, FaultKind.INVALID_KEY_GEN_MESSAGE_SIGNATURE)
            return faults
        kgs = self.key_gen_state
        if kgs is None:
            faults.add(sender_id, FaultKind.UNEXPECTED_KEY_GEN_MESSAGE)
            return faults
        if sender_id == kgs.change.candidate():
            n = self.netinfo.num_nodes + 1
            if kgs.candidate_msg_count > n * n:
                faults.add(sender_id, FaultKind.KEY_GEN_MESSAGE_SPAM)
                return faults
            kgs.candidate_msg_count += 1
        self.key_gen_msg_buffer.append(
            SignedKeyGenMsg(self.start_epoch, sender_id, kg_msg, sig)
        )
        return faults

    # -- batch processing --------------------------------------------------

    def _process_output(self, hb_step) -> Step:
        step: Step = Step()
        start_epoch = self.start_epoch
        output = step.extend_with(
            hb_step, lambda m: DhbHoneyBadger(start_epoch, m)
        )
        for hb_batch in output:
            batch = DhbBatch(hb_batch.epoch + self.start_epoch)
            for nid in sorted(hb_batch.contributions, key=str):
                int_contrib = hb_batch.contributions[nid]
                if not isinstance(int_contrib, InternalContrib):
                    step.add_fault(
                        nid, FaultKind.BATCH_DESERIALIZATION_FAILED
                    )
                    continue
                step.fault_log.merge(
                    self.vote_counter.add_committed_votes(
                        nid, int_contrib.votes
                    )
                )
                batch.contributions[nid] = int_contrib.contrib
                committed = int_contrib.key_gen_messages
                self.key_gen_msg_buffer = [
                    m for m in self.key_gen_msg_buffer if m not in committed
                ]
                for skgm in int_contrib.key_gen_messages:
                    if not isinstance(skgm, SignedKeyGenMsg):
                        step.add_fault(nid, FaultKind.INVALID_MESSAGE)
                        continue
                    if skgm.era < self.start_epoch:
                        continue  # obsolete
                    if not self._verify_signature(
                        skgm.node_id, skgm.sig, skgm.kg_msg
                    ):
                        step.add_fault(
                            nid, FaultKind.INVALID_KEY_GEN_MESSAGE_SIGNATURE
                        )
                        continue
                    if isinstance(skgm.kg_msg, KgPart):
                        step.extend(
                            self._handle_part(skgm.node_id, skgm.kg_msg.part)
                        )
                    elif isinstance(skgm.kg_msg, KgAck):
                        step.fault_log.merge(
                            self._handle_ack(skgm.node_id, skgm.kg_msg.ack)
                        )
            kgs = self._take_ready_key_gen()
            if kgs is not None:
                # DKG complete: swap keys, restart inner HB in a new era
                self.netinfo = kgs.key_gen.into_network_info(
                    ops=self.netinfo.ops
                )
                self._restart_honey_badger(batch.epoch + 1)
                batch.set_change(Complete(kgs.change), self.netinfo)
            else:
                winner = self.vote_counter.compute_winner()
                if winner is not None:
                    step.extend(self._update_key_gen(batch.epoch + 1, winner))
                    batch.set_change(InProgress(winner), self.netinfo)
            step.output.append(batch)
        if start_epoch < self.start_epoch:
            queue, self.incoming_queue = self.incoming_queue, []
            for sender_id, msg in queue:
                step.extend(self.handle_message(sender_id, msg))
        return step

    # -- DKG lifecycle -----------------------------------------------------

    def _update_key_gen(self, epoch: int, change: Change) -> Step:
        if (
            self.key_gen_state is not None
            and self.key_gen_state.change == change
        ):
            return Step()  # same change: continue current DKG
        pub_keys = self.netinfo.public_key_map
        if isinstance(change, Remove):
            pub_keys.pop(change.node_id, None)
        elif isinstance(change, Add):
            pub_keys[change.node_id] = change.pub_key
        self._restart_honey_badger(epoch)
        threshold = (len(pub_keys) - 1) // 3
        key_gen = SyncKeyGen(
            self.netinfo.our_id,
            self.netinfo.secret_key,
            pub_keys,
            threshold,
            self.rng,
        )
        self.key_gen_state = _KeyGenState(key_gen, change)
        if key_gen.our_part is not None:
            return self._send_transaction(KgPart(key_gen.our_part))
        return Step()

    def _restart_honey_badger(self, epoch: int) -> None:
        self.start_epoch = epoch
        self.key_gen_msg_buffer = [
            m for m in self.key_gen_msg_buffer if m.era >= epoch
        ]
        self.vote_counter = VoteCounter(self.netinfo, epoch)
        self.honey_badger = HoneyBadger(
            self.netinfo,
            max_future_epochs=self.max_future_epochs,
            rng=self.rng,
        )

    def _handle_part(self, sender_id, part: Part) -> Step:
        kgs = self.key_gen_state
        if kgs is None:
            return Step()
        ack, faults = kgs.key_gen.handle_part(sender_id, part, self.rng)
        step = Step.from_fault_log(faults)
        if ack is not None:
            step.extend(self._send_transaction(KgAck(ack)))
        return step

    def _handle_ack(self, sender_id, ack: Ack) -> FaultLog:
        if self.key_gen_state is None:
            return FaultLog()
        return self.key_gen_state.key_gen.handle_ack(sender_id, ack)

    def _send_transaction(self, kg_msg) -> Step:
        """Sign, buffer and multicast a DKG message for on-chain
        commitment (reference ``:360-372``)."""
        sig = self.netinfo.secret_key.sign(dumps(kg_msg))
        step: Step = Step()
        if self.netinfo.is_validator:
            self.key_gen_msg_buffer.append(
                SignedKeyGenMsg(
                    self.start_epoch, self.netinfo.our_id, kg_msg, sig
                )
            )
        step.send_all(DhbKeyGen(self.start_epoch, kg_msg, sig))
        return step

    def _take_ready_key_gen(self) -> Optional[_KeyGenState]:
        kgs = self.key_gen_state
        if kgs is not None and kgs.is_ready():
            self.key_gen_state = None
            return kgs
        return None

    def _verify_signature(self, node_id, sig, kg_msg) -> bool:
        pk = self.netinfo.public_key(node_id)
        if pk is None and self.key_gen_state is not None:
            pk = self.key_gen_state.candidate_key(node_id)
        if pk is None:
            return False
        try:
            return pk.verify(sig, dumps(kg_msg))
        except Exception:
            return False


class DynamicHoneyBadgerBuilder:
    """Reference ``dynamic_honey_badger/builder.rs``: ``build``,
    ``build_first_node`` and ``build_joining``."""

    def __init__(self):
        self._max_future_epochs = 3
        self._rng: Optional[random.Random] = None

    def max_future_epochs(self, value: int) -> "DynamicHoneyBadgerBuilder":
        self._max_future_epochs = value
        return self

    def rng(self, rng: random.Random) -> "DynamicHoneyBadgerBuilder":
        self._rng = rng
        return self

    def build(self, netinfo: NetworkInfo) -> DynamicHoneyBadger:
        return DynamicHoneyBadger(
            netinfo,
            max_future_epochs=self._max_future_epochs,
            rng=self._rng,
        )

    def build_first_node(self, our_id, mock: bool = False, ops=None) -> DynamicHoneyBadger:
        """Start a new network as its single validator; ``ops`` is the
        node's backend (the card's ``CudaBackend()`` when not given)."""
        from ..crypto import mock as M
        from ..crypto import threshold as T

        # fresh OS-entropy keys are REQUIRED here: this generates the
        # network's first secret key set, so a derivable seed would let
        # anyone reconstruct it
        rng = self._rng if self._rng is not None else random.Random()
        if mock:
            sk_set = M.MockSecretKeySet.random(0, rng)
            sk = M.MockSecretKey.random(rng)
        else:
            sk_set = T.SecretKeySet.random(0, rng)
            sk = T.SecretKey.random(rng)
        netinfo = NetworkInfo(
            our_id,
            sk_set.secret_key_share(0),
            sk,
            sk_set.public_keys(),
            {our_id: sk.public_key()},
            ops=ops,
        )
        return self.build(netinfo)

    def build_joining(
        self, our_id, secret_key, join_plan: JoinPlan, ops=None
    ) -> Tuple[DynamicHoneyBadger, Step]:
        """Join a running network as an observer from a ``JoinPlan``."""
        netinfo = NetworkInfo(
            our_id,
            None,
            secret_key,
            join_plan.pub_key_set,
            join_plan.pub_keys,
            ops=ops,
        )
        dhb = DynamicHoneyBadger(
            netinfo,
            max_future_epochs=self._max_future_epochs,
            rng=self._rng,
            start_epoch=join_plan.epoch,
        )
        step: Step = Step()
        if isinstance(join_plan.change, InProgress):
            step = dhb._update_key_gen(join_plan.epoch, join_plan.change.change)
        return dhb, step
