"""Validator-set change actions and their status.

The port's own copy of ``hbbft_tpu/protocols/change.py`` (reference
``src/dynamic_honey_badger/change.rs``), whole.  Wire names are the
reference's, so a vote on a change ``dumps`` to the same signed bytes in
both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from ..core.serialize import wire


class Change:
    """Base: a node change action (add or remove a validator)."""

    def candidate(self) -> Optional[Any]:
        return None


@wire("ChangeAdd")
@dataclasses.dataclass(frozen=True)
class Add(Change):
    """Add a node; the public key is used (only) for key generation."""

    node_id: Any
    pub_key: Any

    def candidate(self):
        return self.node_id


@wire("ChangeRemove")
@dataclasses.dataclass(frozen=True)
class Remove(Change):
    node_id: Any


class ChangeState:
    """Whether a change is pending, in progress, or completed."""


@wire("CsNone")
@dataclasses.dataclass(frozen=True)
class NoChange(ChangeState):
    pass


@wire("CsInProgress")
@dataclasses.dataclass(frozen=True)
class InProgress(ChangeState):
    change: Change


@wire("CsComplete")
@dataclasses.dataclass(frozen=True)
class Complete(ChangeState):
    change: Change
