"""QueueingHoneyBadger — DynamicHoneyBadger with a built-in tx queue.

The port's own copy of ``hbbft_tpu/protocols/queueing_honey_badger.py``
(reference ``src/queueing_honey_badger.rs``).  On every input and
message, while ``can_propose`` (previous epoch done ∧ (queue non-empty ∨
the anti-stall rule says we must)), proposes a random sample of
``max(1, B/N)`` transactions from the first B queued; committed
transactions are removed from the queue on batch output.  Default batch
size: 100.
"""

from __future__ import annotations

import random
from typing import Iterable, Optional, Tuple

from ..core.algorithm import DistAlgorithm
from ..core.network_info import NetworkInfo
from ..core.step import Step
from .change import Change
from .dynamic_honey_badger import ChangeInput, DynamicHoneyBadger, UserInput
from .transaction_queue import TransactionQueue


class QueueingHoneyBadger(DistAlgorithm):
    def __init__(
        self,
        dyn_hb: DynamicHoneyBadger,
        batch_size: int = 100,
        txs: Iterable = (),
        rng: Optional[random.Random] = None,
    ):
        self.dyn_hb = dyn_hb
        self.batch_size = batch_size
        self.queue = TransactionQueue(txs)
        # deterministic per-node default (NetworkInfo.default_rng):
        # proposal sampling stays unpredictable to peers via the
        # secret-key-folded seed, and identical across re-runs
        self.rng = (
            rng
            if rng is not None
            else dyn_hb.netinfo.default_rng("queueing_honey_badger")
        )

    @classmethod
    def builder(cls, dyn_hb: DynamicHoneyBadger) -> "QueueingHoneyBadgerBuilder":
        return QueueingHoneyBadgerBuilder(dyn_hb)

    # -- DistAlgorithm -----------------------------------------------------

    def handle_input(self, input) -> Step:
        """A transaction to queue, or a `ChangeInput` vote."""
        if isinstance(input, ChangeInput):
            step = self.dyn_hb.handle_input(input)
        else:
            tx = input.contribution if isinstance(input, UserInput) else input
            self.queue.push(tx)
            step = Step()
        step.extend(self.propose())
        return step

    def handle_message(self, sender_id, message) -> Step:
        step = self.dyn_hb.handle_message(sender_id, message)
        for batch in step.output:
            self.queue.remove_all(batch.tx_iter())
        step.extend(self.propose())
        return step

    def terminated(self) -> bool:
        return False

    def our_id(self):
        return self.dyn_hb.our_id()

    # -- proposing ---------------------------------------------------------

    def can_propose(self) -> bool:
        if self.dyn_hb.has_input():
            return False  # previous epoch still in progress
        return len(self.queue) > 0 or self.dyn_hb.should_propose()

    def propose(self) -> Step:
        step: Step = Step()
        while self.can_propose():
            amount = max(
                1, self.batch_size // self.dyn_hb.netinfo.num_nodes
            )
            proposal = self.queue.choose(amount, self.batch_size, self.rng)
            inner = self.dyn_hb.handle_input(UserInput(proposal))
            for batch in inner.output:
                self.queue.remove_all(batch.tx_iter())
            step.extend(inner)
        return step


class QueueingHoneyBadgerBuilder:
    """Reference ``queueing_honey_badger.rs:97-157``."""

    def __init__(self, dyn_hb: DynamicHoneyBadger):
        self.dyn_hb = dyn_hb
        self._batch_size = 100
        self._rng: Optional[random.Random] = None

    def batch_size(self, value: int) -> "QueueingHoneyBadgerBuilder":
        self._batch_size = value
        return self

    def rng(self, rng: random.Random) -> "QueueingHoneyBadgerBuilder":
        self._rng = rng
        return self

    def build(self) -> Tuple[QueueingHoneyBadger, Step]:
        return self.build_with_transactions(())

    def build_with_transactions(
        self, txs: Iterable
    ) -> Tuple[QueueingHoneyBadger, Step]:
        qhb = QueueingHoneyBadger(
            self.dyn_hb, self._batch_size, txs, rng=self._rng
        )
        step = qhb.propose()
        return qhb, step
