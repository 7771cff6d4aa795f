"""The distributed-algorithm interface every protocol implements.

The port's own copy of ``hbbft_tpu/core/algorithm.py`` (reference
``src/messaging.rs:186-218``, the ``DistAlgorithm`` trait).  Broadcast,
CommonCoin, Agreement, CommonSubset, HoneyBadger, DynamicHoneyBadger and
QueueingHoneyBadger are deterministic, single-threaded state machines:
the caller feeds them inputs and sourced messages, and each call returns
a :class:`~hbbft_tpu_torch.core.step.Step` whose messages the caller
delivers.  The reference's state fingerprint, ``snapshot`` and
``restore`` belong to checkpointing and are not part of the port.
"""

from __future__ import annotations

import abc
from typing import Generic, Hashable, TypeVar

from .step import Step

NodeId = TypeVar("NodeId", bound=Hashable)
Input = TypeVar("Input")
Output = TypeVar("Output")
Message = TypeVar("Message")


class DistAlgorithm(abc.ABC, Generic[NodeId, Input, Output, Message]):
    """A distributed algorithm that defines a message flow.

    Associated types of the reference trait map to the generic
    parameters ``NodeId / Input / Output / Message``; errors are raised
    as exceptions (subclasses of :class:`HbbftError`).
    """

    @abc.abstractmethod
    def handle_input(self, input: Input) -> Step[Output, Message]:
        """Handle user input and return the resulting step.

        (Reference ``DistAlgorithm::input``; renamed because ``input`` is
        a Python builtin.)
        """

    @abc.abstractmethod
    def handle_message(self, sender_id: NodeId, message: Message) -> Step[Output, Message]:
        """Handle a message received from ``sender_id``."""

    @abc.abstractmethod
    def terminated(self) -> bool:
        """Whether the algorithm has terminated (no further input/messages)."""

    @abc.abstractmethod
    def our_id(self) -> NodeId:
        """This node's own identifier."""


class HbbftError(Exception):
    """Base class for protocol errors (unrecoverable local conditions —
    Byzantine *remote* behaviour is reported via FaultLog, never raised)."""


class UnknownSenderError(HbbftError):
    pass


class CryptoError(HbbftError):
    pass
