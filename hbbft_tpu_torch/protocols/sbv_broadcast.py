"""Synchronized Binary Value Broadcast — the BVal/Aux phase of Agreement.

The port's own copy of ``hbbft_tpu/protocols/sbv_broadcast.py``
(reference ``src/agreement/sbv_broadcast.rs``).  Thresholds: BVal relay
at f+1, insert into ``bin_values`` at 2f+1 (first entry triggers
``Aux``), output when ≥ N−f ``Aux`` messages carry values inside
``bin_values``.  ``clear(init)`` re-seeds the next epoch's instance from
``Term`` senders.
"""

from __future__ import annotations

import dataclasses

from ..core.algorithm import DistAlgorithm
from ..core.fault import FaultKind
from ..core.network_info import NetworkInfo
from ..core.serialize import wire
from ..core.step import Step
from .bool_set import BoolMultimap, BoolSet


@wire("SbvBVal")
@dataclasses.dataclass(frozen=True)
class BVal:
    value: bool


@wire("SbvAux")
@dataclasses.dataclass(frozen=True)
class Aux:
    value: bool


class SbvBroadcast(DistAlgorithm):
    def __init__(self, netinfo: NetworkInfo):
        self.netinfo = netinfo
        self.bin_values = BoolSet.none()
        self.received_bval = BoolMultimap()
        self.sent_bval = BoolSet.none()
        self.received_aux = BoolMultimap()
        self._terminated = False

    # -- DistAlgorithm -----------------------------------------------------

    def handle_input(self, value: bool) -> Step:
        return self.send_bval(bool(value))

    def handle_message(self, sender_id, msg) -> Step:
        # a deserialized BVal/Aux can carry a non-bool value, which would
        # KeyError the {False, True} multimaps below
        if isinstance(msg, BVal):
            if not isinstance(msg.value, bool):
                return Step.from_fault(sender_id, FaultKind.INVALID_MESSAGE)
            return self.handle_bval(sender_id, msg.value)
        if isinstance(msg, Aux):
            if not isinstance(msg.value, bool):
                return Step.from_fault(sender_id, FaultKind.INVALID_MESSAGE)
            return self.handle_aux(sender_id, msg.value)
        return Step.from_fault(sender_id, FaultKind.INVALID_MESSAGE)

    def terminated(self) -> bool:
        return self._terminated

    def our_id(self):
        return self.netinfo.our_id

    # -- epoch reset -------------------------------------------------------

    def clear(self, init: BoolMultimap) -> None:
        """Reset for the next epoch; ``init`` values (from ``Term``
        senders) count as already-received BVal and Aux
        (reference ``sbv_broadcast.rs:102-108``)."""
        self.bin_values = BoolSet.none()
        self.received_bval = init.copy()
        self.sent_bval = BoolSet.none()
        self.received_aux = init.copy()
        self._terminated = False

    # -- handlers ----------------------------------------------------------

    def handle_bval(self, sender_id, b: bool) -> Step:
        if sender_id in self.received_bval[b]:
            return Step.from_fault(sender_id, FaultKind.DUPLICATE_BVAL)
        self.received_bval[b].add(sender_id)
        count = len(self.received_bval[b])
        step: Step = Step()
        if count == 2 * self.netinfo.num_faulty + 1:
            self.bin_values.insert(b)
            if len(self.bin_values) == 1:
                step.extend(self._send(Aux(b)))  # first entry: send Aux
            else:
                step.extend(self._try_output())
        if count == self.netinfo.num_faulty + 1:
            step.extend(self.send_bval(b))
        return step

    def handle_aux(self, sender_id, b: bool) -> Step:
        if sender_id in self.received_aux[b]:
            return Step.from_fault(sender_id, FaultKind.DUPLICATE_AUX)
        self.received_aux[b].add(sender_id)
        return self._try_output()

    # -- sending -----------------------------------------------------------

    def send_bval(self, b: bool) -> Step:
        if not self.sent_bval.insert(b):
            return Step()
        return self._send(BVal(b))

    def _send(self, msg) -> Step:
        if not self.netinfo.is_validator:
            return Step()
        step: Step = Step()
        step.send_all(msg)
        step.extend(self.handle_message(self.netinfo.our_id, msg))
        return step

    # -- output ------------------------------------------------------------

    def _try_output(self) -> Step:
        if self._terminated or self.bin_values == BoolSet.none():
            return Step()
        count, vals = self._count_aux()
        if count < self.netinfo.num_correct:
            return Step()
        self._terminated = True
        return Step.with_output(vals)

    def _count_aux(self):
        """Count Aux messages whose values lie inside ``bin_values``
        (reference ``count_aux``, ``sbv_broadcast.rs:193-203``)."""
        values = BoolSet.none()
        count = 0
        for b in self.bin_values:
            if self.received_aux[b]:
                values.insert(b)
                count += len(self.received_aux[b])
        return count, values
