"""Message envelopes and the ``Step`` transition result.

The port's own copy of ``hbbft_tpu/core/step.py`` (reference
``src/messaging.rs:9-183``):

- ``Target`` / ``TargetedMessage`` / ``SourcedMessage`` — the whole
  interface between a protocol instance and its transport; delivery is
  the caller's job (the in-memory ``harness.network.TestNetwork`` here).
- ``Step`` — the result of one deterministic state transition:
  ``output`` values, a ``FaultLog`` of observed Byzantine behaviour, and
  outgoing ``messages`` the *caller* must deliver.

Everything here is plain data: protocol instances stay sans-IO state
machines, which is what lets ``harness.batching.BatchingBackend`` collect
the share checks of a whole network and verify them in one flush.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Generic, Iterable, List, Optional, TypeVar

from .fault import Fault, FaultLog

M = TypeVar("M")
M2 = TypeVar("M2")
O = TypeVar("O")


class Target:
    """Message routing target: every node, or one specific node.

    Reference: ``src/messaging.rs:22-42`` (``Target::{All, Node}``).
    """

    __slots__ = ("node",)

    def __init__(self, node: Any = None):
        self.node = node

    @classmethod
    def all(cls) -> "Target":
        return _TARGET_ALL

    @classmethod
    def to(cls, node: Any) -> "Target":
        if node is None:
            raise ValueError("Target.to(None) is invalid; use Target.all()")
        return cls(node)

    @property
    def is_all(self) -> bool:
        return self.node is None

    def message(self, message: M) -> "TargetedMessage":
        return TargetedMessage(self, message)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Target) and self.node == other.node

    def __hash__(self) -> int:
        return hash(("Target", self.node))

    def __repr__(self) -> str:
        return "Target.all()" if self.is_all else f"Target.to({self.node!r})"


_TARGET_ALL = Target(None)


@dataclasses.dataclass
class TargetedMessage(Generic[M]):
    """A message annotated with its routing target.

    Reference: ``src/messaging.rs:36-52``.
    """

    target: Target
    message: M

    def map(self, fn: Callable[[M], M2]) -> "TargetedMessage[M2]":
        return TargetedMessage(self.target, fn(self.message))


@dataclasses.dataclass
class SourcedMessage(Generic[M]):
    """A message annotated with the node it came from.

    Reference: ``src/messaging.rs:9-20``.
    """

    source: Any
    message: M


class Step(Generic[O, M]):
    """Result of a single call to a ``DistAlgorithm``'s handler.

    The caller **must** deliver ``messages`` and surface ``fault_log``;
    dropping a Step loses protocol messages (the reference enforces this
    with ``#[must_use]``, ``src/messaging.rs:54-66``; here the test
    harness enforces it by construction — handlers feed steps straight
    into the router).
    """

    __slots__ = ("output", "fault_log", "messages")

    def __init__(
        self,
        output: Optional[Iterable[O]] = None,
        fault_log: Optional[FaultLog] = None,
        messages: Optional[Iterable[TargetedMessage[M]]] = None,
    ):
        self.output: List[O] = list(output) if output else []
        self.fault_log: FaultLog = fault_log if fault_log is not None else FaultLog()
        self.messages: List[TargetedMessage[M]] = list(messages) if messages else []

    # -- constructors ------------------------------------------------------

    @classmethod
    def with_output(cls, output: O) -> "Step[O, M]":
        return cls(output=[output])

    @classmethod
    def from_fault(cls, node_id: Any, kind: Any) -> "Step[O, M]":
        return cls(fault_log=FaultLog.init(node_id, kind))

    @classmethod
    def from_fault_log(cls, fault_log: FaultLog) -> "Step[O, M]":
        return cls(fault_log=fault_log)

    @classmethod
    def from_msg(cls, msg: TargetedMessage[M]) -> "Step[O, M]":
        return cls(messages=[msg])

    # -- combinators (reference ``Step::map/extend_with/extend``) ----------

    def map_messages(self, fn: Callable[[M], M2]) -> "Step[O, M2]":
        """Return a new Step with every message payload mapped by ``fn``."""
        step: Step[O, M2] = Step(output=self.output, fault_log=self.fault_log)
        step.messages = [tm.map(fn) for tm in self.messages]
        return step

    def map_output(self, fn: Callable[[O], Any]) -> "Step[Any, M]":
        step: Step[Any, M] = Step(fault_log=self.fault_log, messages=self.messages)
        step.output = [fn(o) for o in self.output]
        return step

    def extend(self, other: "Step[O, M]") -> "Step[O, M]":
        """Merge ``other`` into self (same message type)."""
        self.output.extend(other.output)
        self.fault_log.merge(other.fault_log)
        self.messages.extend(other.messages)
        return self

    def extend_with(
        self, child: "Step[Any, Any]", msg_fn: Callable[[Any], M]
    ) -> List[Any]:
        """Absorb a child algorithm's step, wrapping its messages with
        ``msg_fn`` into our own namespace; returns the child's output for
        the parent to act on.

        Reference: ``src/messaging.rs:107-130`` — this is how every parent
        protocol consumes its children's transitions.
        """
        self.fault_log.merge(child.fault_log)
        self.messages.extend(tm.map(msg_fn) for tm in child.messages)
        return child.output

    def add_fault(self, node_id: Any, kind: Any) -> "Step[O, M]":
        self.fault_log.append(Fault(node_id, kind))
        return self

    def send_all(self, message: M) -> "Step[O, M]":
        self.messages.append(Target.all().message(message))
        return self

    def send_to(self, node: Any, message: M) -> "Step[O, M]":
        self.messages.append(Target.to(node).message(message))
        return self

    def is_empty(self) -> bool:
        return not self.output and not self.messages and self.fault_log.is_empty()

    def __repr__(self) -> str:
        return (
            f"Step(output={self.output!r}, faults={len(self.fault_log)}, "
            f"messages={len(self.messages)})"
        )
