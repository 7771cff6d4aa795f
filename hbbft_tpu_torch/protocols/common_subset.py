"""Asynchronous Common Subset (ACS) — N broadcasts + N agreements.

The port's own copy of ``hbbft_tpu/protocols/common_subset.py``
(reference ``src/common_subset.rs``).  One Reliable Broadcast and one
Binary Agreement per validator:

- own input → our Broadcast instance;
- Broadcast_j delivers ⇒ input ``true`` to Agreement_j (if still open);
- once N−f Agreements decided ``true`` ⇒ input ``false`` to the rest;
- when all N Agreements have decided and every yes-voted broadcast has
  delivered, output ``{proposer: value}`` for the yes set, in canonical
  proposer order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from ..core.algorithm import DistAlgorithm, HbbftError
from ..core.fault import FaultKind
from ..core.network_info import NetworkInfo
from ..core.serialize import wire
from ..core.step import Step
from .agreement import Agreement, AgreementMessage
from .broadcast import Broadcast


@wire("CsBc")
@dataclasses.dataclass(frozen=True)
class CsBroadcast:
    proposer_id: Any
    msg: Any


@wire("CsAba")
@dataclasses.dataclass(frozen=True)
class CsAgreement:
    proposer_id: Any
    msg: AgreementMessage


class CommonSubsetError(HbbftError):
    pass


class CommonSubset(DistAlgorithm):
    def __init__(self, netinfo: NetworkInfo, session_id: int):
        self.netinfo = netinfo
        self.session_id = session_id
        self.broadcast_instances: Dict[Any, Broadcast] = {
            pid: Broadcast(netinfo, pid) for pid in netinfo.all_ids
        }
        self.agreement_instances: Dict[Any, Agreement] = {
            pid: Agreement(netinfo, session_id, pid)
            for pid in netinfo.all_ids
        }
        self.broadcast_results: Dict[Any, bytes] = {}
        self.agreement_results: Dict[Any, bool] = {}
        self.decided = False

    # -- DistAlgorithm -----------------------------------------------------

    def handle_input(self, value: bytes) -> Step:
        if not self.netinfo.is_validator:
            return Step()
        return self._process_broadcast(
            self.netinfo.our_id, lambda bc: bc.handle_input(value)
        )

    def handle_message(self, sender_id, message) -> Step:
        if isinstance(message, CsBroadcast):
            # the wire can carry an unhashable proposer_id (e.g. a list),
            # which would TypeError the membership test
            try:
                known = message.proposer_id in self.broadcast_instances
            except TypeError:
                return Step.from_fault(sender_id, FaultKind.INVALID_MESSAGE)
            if not known:
                return Step.from_fault(
                    sender_id, FaultKind.UNEXPECTED_PROPOSER
                )
            return self._process_broadcast(
                message.proposer_id,
                lambda bc: bc.handle_message(sender_id, message.msg),
            )
        if isinstance(message, CsAgreement):
            try:
                known = message.proposer_id in self.agreement_instances
            except TypeError:
                return Step.from_fault(sender_id, FaultKind.INVALID_MESSAGE)
            if not known:
                return Step.from_fault(
                    sender_id, FaultKind.UNEXPECTED_PROPOSER
                )
            return self._process_agreement(
                message.proposer_id,
                lambda ag: ag.handle_message(sender_id, message.msg),
            )
        return Step.from_fault(sender_id, FaultKind.INVALID_MESSAGE)

    def terminated(self) -> bool:
        return all(
            ag.terminated() for ag in self.agreement_instances.values()
        )

    def our_id(self):
        return self.netinfo.our_id

    def received_proposals(self) -> int:
        return len(self.broadcast_results)

    # -- internals ---------------------------------------------------------

    def _process_broadcast(self, proposer_id, fn) -> Step:
        step: Step = Step()
        bc = self.broadcast_instances[proposer_id]
        output = step.extend_with(
            fn(bc), lambda m: CsBroadcast(proposer_id, m)
        )
        if not output:
            return step
        self.broadcast_results[proposer_id] = output[0]

        def set_input(ag: Agreement):
            if ag.accepts_input():
                return ag.handle_input(True)
            return Step()

        step.extend(self._process_agreement(proposer_id, set_input))
        return step

    def _process_agreement(self, proposer_id, fn) -> Step:
        step: Step = Step()
        ag = self.agreement_instances[proposer_id]
        if ag.terminated():
            return step
        output = step.extend_with(
            fn(ag), lambda m: CsAgreement(proposer_id, m)
        )
        if not output:
            return step
        if proposer_id in self.agreement_results:
            raise CommonSubsetError("multiple agreement results")
        value = output[0]
        self.agreement_results[proposer_id] = value

        if value and self._count_true() == self.netinfo.num_correct:
            # N − f yes votes: input false into every open agreement
            # (reference ``common_subset.rs:271-289``)
            for pid in self.netinfo.all_ids:
                other = self.agreement_instances[pid]
                if other.accepts_input():
                    outs = step.extend_with(
                        other.handle_input(False),
                        lambda m, pid=pid: CsAgreement(pid, m),
                    )
                    for out in outs:
                        if pid in self.agreement_results:
                            raise CommonSubsetError(
                                "multiple agreement results"
                            )
                        self.agreement_results[pid] = out
        result = self._try_agreement_completion()
        if result is not None:
            step.output.append(result)
        return step

    def _count_true(self) -> int:
        return sum(1 for v in self.agreement_results.values() if v)

    def _try_agreement_completion(self):
        if self.decided or self._count_true() < self.netinfo.num_correct:
            return None
        if len(self.agreement_results) < self.netinfo.num_nodes:
            return None
        delivered_1 = {
            pid for pid, v in self.agreement_results.items() if v
        }
        # broadcast_results is keyed in arrival order; emit the decided
        # set in canonical proposer order so the output dict (and the
        # ciphertext-decrypt walk it seeds) is schedule-independent
        results = {
            pid: self.broadcast_results[pid]
            for pid in sorted(delivered_1, key=repr)
            if pid in self.broadcast_results
        }
        if len(results) == len(delivered_1):
            self.decided = True
            return results
        return None
