"""DynamicHoneyBadger's join plan.

The port's own copy of the one record of ``hbbft_tpu/protocols/
dynamic_honey_badger.py`` that the vectorized dynamic harness
(``harness/dynamic.py``) needs: ``JoinPlan`` (reference ``mod.rs:136-145``),
everything a fresh observer needs to join at an epoch boundary.  The
sequential ``DynamicHoneyBadger`` state machine and its message types are
not part of the port yet; they come with the sequential engines.  The
wire name is the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from ..core.serialize import wire
from .change import ChangeState


@wire("JoinPlan")
@dataclasses.dataclass(frozen=True)
class JoinPlan:
    """Everything a fresh observer needs to join at an epoch boundary
    (reference ``mod.rs:136-145``)."""

    epoch: int
    change: ChangeState
    pub_key_set: Any
    pub_keys: Dict[Any, Any]
