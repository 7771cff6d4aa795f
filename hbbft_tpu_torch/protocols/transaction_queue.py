"""Pending-transaction queue with random batch sampling.

The port's own copy of ``hbbft_tpu/protocols/transaction_queue.py``.
Reference: ``src/transaction_queue.rs`` (35 LoC).  ``choose`` samples
``amount`` transactions uniformly from the first ``batch_size`` queued —
random disjoint-ish per-node contributions give expected O(1) duplicate
redundancy across proposers (``queueing_honey_badger.rs:13-23``).
"""

from __future__ import annotations

import collections
import itertools
from typing import Deque, Iterable, List


class TransactionQueue:
    def __init__(self, txs: Iterable = ()):  # FIFO of pending transactions
        self.queue: Deque = collections.deque(txs)

    def push(self, tx) -> None:
        self.queue.append(tx)

    def remove_all(self, txs: Iterable) -> None:
        """Drop every committed transaction from the queue in one pass.

        Builds the committed set once — O(n + m) with hashable
        transactions instead of the O(n·m) scan this used to be, which
        dominated the per-epoch commit path at gateway load.  Batches
        may carry unhashable foreign transactions injected by other
        proposers; those fall back to list membership rather than
        raising TypeError out of the commit path."""
        committed = list(txs)
        try:
            lookup = set(committed)
            self.queue = collections.deque(
                tx for tx in self.queue if tx not in lookup
            )
            return
        except TypeError:
            pass  # unhashable tx in the batch or the queue
        self.queue = collections.deque(
            tx for tx in self.queue if tx not in committed
        )

    def choose(self, amount: int, batch_size: int, rng) -> List:
        """Random sample of ``amount`` from the first ``batch_size``
        entries; the queue is unchanged.  (``islice`` — indexing a
        deque is O(distance from an end), so per-index access made
        large batch sizes quadratic.)"""
        head = list(itertools.islice(self.queue, min(batch_size, len(self.queue))))
        if len(head) <= amount:
            return head
        return rng.sample(head, amount)

    def __len__(self) -> int:
        return len(self.queue)
