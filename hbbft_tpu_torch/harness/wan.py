"""WAN-realism layer for the co-simulation harness.

The port's copy of ``hbbft_tpu/harness/wan.py``, whole but for its
trace event.  The event-driven ``SeededDelaySchedule`` models one flat
delay probability; real deployments live on a planet.  This module
provides seeded-deterministic wide-area network models that plug into
every simulation plane:

- the **packed co-simulation** (``harness/cosim.py``) consumes the
  zone-factored per-epoch product directly — a ``reach[Z, Z]``
  zone-reachability matrix plus per-node on-time/crash masks — which
  is exactly the rank the ``cosim_step`` kernel contracts at n = 100k
  (the full per-(proposer, receiver) timeliness relation is O(n²) and
  never materializes);
- the **dict-based sims** (``harness/epoch.py`` /
  ``harness/dynamic.py``) receive the same epoch view materialized as
  ``dead`` / ``late_subset`` adversary kwargs (``twin_kwargs``), so a
  small-n run of either plane under the same model is byte-identical
  (``tests/test_torch_cosim.py``);
- the **event-driven TestNetwork** plugs in through the
  ``SeededDelaySchedule`` sampling seam (:meth:`WanSchedule.delay_sampler`).

Everything derives from ``(model.seed, epoch)`` through
``np.random.default_rng`` — two binds of the same model produce
bit-identical schedules, and every latency draw is attributable to a
zone pair.

Model surface:

- **heavy-tail latency**: lognormal (body + moderate tail) and Pareto
  (power-law tail) distributions over a geo-zone base-delay matrix,
  reduced per epoch to the probability that a zone-pair message misses
  the epoch deadline (closed-form tail functions — no per-message
  sampling at 100k × 100k scale);
- **geo-zone topology**: named zones, node→zone assignment by weight,
  inter-zone base delays (:data:`DEFAULT_TOPOLOGY`: 5 continental
  zones with real-ish RTTs);
- **zone-partition schedules**: windows during which zone groups are
  mutually unreachable, healing at the window end;
- **correlated failures**: whole-zone crash windows (bounded by f at
  bind time — the sim's fault bound is a model-validity condition);
- **flash-crowd arrivals**: per-epoch multipliers on transaction
  arrival rate, consumed by the queueing layers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np



# ---------------------------------------------------------------------------
# geo-zone topology
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GeoTopology:
    """Named zones, per-zone node weights, inter-zone base delays (ms).

    ``delay_ms[i][j]`` is the *typical* (distribution-location) one-way
    latency between zones i and j; the latency model puts a tail on it.
    """

    zones: Tuple[str, ...]
    delay_ms: Tuple[Tuple[float, ...], ...]
    weights: Tuple[float, ...] = ()

    def __post_init__(self):
        z = len(self.zones)
        if len(self.delay_ms) != z or any(len(r) != z for r in self.delay_ms):
            raise ValueError("delay_ms must be a ZxZ matrix")
        if self.weights and len(self.weights) != z:
            raise ValueError("weights must have one entry per zone")

    def assign(self, n: int) -> np.ndarray:
        """Deterministic node→zone assignment: contiguous id blocks
        sized by weight (largest-remainder rounding).  Contiguous
        blocks keep zone membership shard-local-ish under the packed
        sim's node-axis sharding."""
        z = len(self.zones)
        w = np.asarray(self.weights or [1.0] * z, dtype=np.float64)
        w = w / w.sum()
        counts = np.floor(w * n).astype(np.int64)
        rem = n - int(counts.sum())
        if rem:
            frac = w * n - np.floor(w * n)
            for i in np.argsort(-frac, kind="stable")[:rem]:
                counts[i] += 1
        return np.repeat(np.arange(z, dtype=np.int32), counts)


#: Five continental zones with real-ish inter-region one-way delays.
DEFAULT_TOPOLOGY = GeoTopology(
    zones=("us-east", "us-west", "eu-west", "ap-east", "sa-east"),
    delay_ms=(
        (2.0, 35.0, 45.0, 100.0, 60.0),
        (35.0, 2.0, 70.0, 60.0, 90.0),
        (45.0, 70.0, 2.0, 110.0, 95.0),
        (100.0, 60.0, 110.0, 2.0, 140.0),
        (60.0, 90.0, 95.0, 140.0, 2.0),
    ),
)


# ---------------------------------------------------------------------------
# heavy-tail latency models
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    """A latency distribution located at a zone pair's base delay.

    ``late_prob(base, deadline)`` is the closed-form tail probability
    P(latency > deadline) — the only reduction the epoch-synchronous
    sims need (a message is "late" iff it misses the epoch deadline).

    - ``lognormal``: median = base, shape ``sigma`` (body + moderate
      tail — ordinary jitter);
    - ``pareto``: scale = base, tail index ``alpha`` (power-law tail —
      the long-haul stragglers WAN measurement studies report);
    - ``uniform``: U(0, 2·base) (no tail — the legacy flat regime).
    """

    distribution: str = "lognormal"
    sigma: float = 0.6
    alpha: float = 2.2

    def __post_init__(self):
        if self.distribution not in ("uniform", "lognormal", "pareto"):
            raise ValueError(
                f"unknown latency distribution {self.distribution!r}"
            )

    def late_prob(self, base_ms: float, deadline_ms: float) -> float:
        if deadline_ms <= 0:
            return 1.0
        if base_ms <= 0:
            return 0.0
        if self.distribution == "uniform":
            return min(1.0, max(0.0, 1.0 - deadline_ms / (2.0 * base_ms)))
        if self.distribution == "lognormal":
            x = math.log(deadline_ms / base_ms) / (
                self.sigma * math.sqrt(2.0)
            )
            return 0.5 * math.erfc(x)
        # pareto
        if deadline_ms < base_ms:
            return 1.0
        return (base_ms / deadline_ms) ** self.alpha


# ---------------------------------------------------------------------------
# schedule windows
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PartitionWindow:
    """Zones in different ``groups`` are mutually unreachable for
    epochs in ``[start, end)``; the partition heals at ``end``."""

    start: int
    end: int
    groups: Tuple[Tuple[int, ...], ...]  # zone-index groups

    def active(self, epoch: int) -> bool:
        return self.start <= epoch < self.end


@dataclasses.dataclass(frozen=True)
class CorrelatedFailure:
    """Every node of ``zone`` is crashed for epochs in
    ``[start, end)`` — the correlated whole-datacenter outage."""

    start: int
    end: int
    zone: int

    def active(self, epoch: int) -> bool:
        return self.start <= epoch < self.end


@dataclasses.dataclass(frozen=True)
class FlashCrowd:
    """Transaction arrivals multiply by ``boost`` for epochs in
    ``[start, end)`` (optionally only from one zone's clients)."""

    start: int
    end: int
    boost: float
    zone: Optional[int] = None

    def active(self, epoch: int) -> bool:
        return self.start <= epoch < self.end


# ---------------------------------------------------------------------------
# the model + its bound schedule
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EpochWan:
    """One epoch's materialized WAN state, zone-factored.

    ``reach[zi, zj]`` — a zone-pair's messages arrive before the epoch
    deadline; ``src_ok`` / ``dst_ok`` — per-node straggler masks on the
    send/receive side; ``crashed`` — correlated-failure victims.  The
    per-(proposer, receiver) timeliness relation is the rank-1-per-zone
    product ``src_ok[p] & dst_ok[j] & reach[zone[p], zone[j]]`` — never
    materialized at scale.
    """

    epoch: int
    reach: np.ndarray  # [Z, Z] uint8
    src_ok: np.ndarray  # [n] bool
    dst_ok: np.ndarray  # [n] bool
    crashed: np.ndarray  # [n] bool
    arrival_factor: float


@dataclasses.dataclass(frozen=True)
class WanModel:
    """A seeded WAN scenario: topology + latency tail + schedules.

    Frozen and cheap — bind it to a network size with :meth:`bind` to
    get per-epoch views."""

    seed: int
    topology: GeoTopology = DEFAULT_TOPOLOGY
    latency: LatencyModel = LatencyModel()
    deadline_ms: float = 400.0
    straggler_p: float = 0.0  # per-node per-epoch straggler probability
    partitions: Tuple[PartitionWindow, ...] = ()
    failures: Tuple[CorrelatedFailure, ...] = ()
    flash_crowds: Tuple[FlashCrowd, ...] = ()

    def bind(self, n: int) -> "WanSchedule":
        return WanSchedule(self, n)


class WanSchedule:
    """A :class:`WanModel` bound to a network size: node→zone
    assignment fixed, per-epoch views derived deterministically from
    ``(seed, epoch)`` and cached."""

    def __init__(self, model: WanModel, n: int):
        self.model = model
        self.n = n
        self.f = (n - 1) // 3
        self.zone = model.topology.assign(n)
        self.Z = len(model.topology.zones)
        self._views: Dict[int, EpochWan] = {}
        # correlated failures must respect the sim's fault bound — a
        # model that crashes > f nodes is invalid, not "very Byzantine"
        for fl in model.failures:
            sz = int((self.zone == fl.zone).sum())
            if sz > self.f:
                raise ValueError(
                    f"correlated failure of zone {fl.zone} crashes "
                    f"{sz} nodes > f={self.f}"
                )

    # -- per-epoch views ---------------------------------------------------

    def epoch_view(self, epoch: int) -> EpochWan:
        view = self._views.get(epoch)
        if view is None:
            view = self._build_view(epoch)
            self._views[epoch] = view
        return view

    def _build_view(self, epoch: int) -> EpochWan:
        m = self.model
        rng = np.random.default_rng(
            np.random.SeedSequence((m.seed & 0xFFFFFFFF, epoch))
        )
        # zone-pair reachability: one tail-probability draw per ordered
        # pair (zone-level weather, not per-message coin flips)
        late_p = np.empty((self.Z, self.Z), dtype=np.float64)
        for i in range(self.Z):
            for j in range(self.Z):
                late_p[i, j] = m.latency.late_prob(
                    m.topology.delay_ms[i][j], m.deadline_ms
                )
        reach = (rng.random((self.Z, self.Z)) >= late_p).astype(np.uint8)
        np.fill_diagonal(
            reach, (np.diagonal(late_p) < 1.0).astype(np.uint8)
        )
        for win in m.partitions:
            if win.active(epoch):
                side = np.zeros(self.Z, dtype=np.int64)
                for g, zones in enumerate(win.groups):
                    for z in zones:
                        side[z] = g
                cut = side[:, None] != side[None, :]
                reach[cut] = 0
        # per-node stragglers (send and receive side independently)
        if m.straggler_p > 0:
            src_ok = rng.random(self.n) >= m.straggler_p
            dst_ok = rng.random(self.n) >= m.straggler_p
        else:
            src_ok = np.ones(self.n, dtype=bool)
            dst_ok = np.ones(self.n, dtype=bool)
        crashed = np.zeros(self.n, dtype=bool)
        for fl in m.failures:
            if fl.active(epoch):
                crashed |= self.zone == fl.zone
        if int(crashed.sum()) > self.f:
            raise ValueError(
                f"epoch {epoch}: {int(crashed.sum())} correlated "
                f"crashes exceed the f={self.f} bound"
            )
        factor = 1.0
        for fc in m.flash_crowds:
            if fc.active(epoch):
                factor *= fc.boost
        return EpochWan(
            epoch=epoch,
            reach=reach,
            src_ok=src_ok,
            dst_ok=dst_ok,
            crashed=crashed,
            arrival_factor=factor,
        )

    def arrival_factor(self, epoch: int) -> float:
        return self.epoch_view(epoch).arrival_factor

    # -- legacy-sim twin materialization -----------------------------------

    def crashed_set(self, epoch: int) -> Set[int]:
        return set(np.flatnonzero(self.epoch_view(epoch).crashed).tolist())

    def twin_kwargs(
        self,
        epoch: int,
        proposers: Sequence[int],
        dead: Optional[Set[int]] = None,
    ) -> Tuple[Set[int], Dict[int, Set[int]]]:
        """Materialize this epoch's view as the legacy sims' adversary
        kwargs: ``(dead, late_subset)``.

        ``late_subset[pid]`` is the set of nodes whose copy of pid's
        broadcast lands before the agreement phase — exactly
        ``src_ok[pid] & dst_ok[j] & reach[zone_pid, zone_j]`` over live
        j, the relation the packed sim contracts zone-wise.  Proposers
        every live node hears on time are omitted (the normal case).
        O(n·|proposers|) — the small-n equivalence twin only; the
        packed plane never materializes this."""
        view = self.epoch_view(epoch)
        dead_all = set(dead or set()) | self.crashed_set(epoch)
        live = np.ones(self.n, dtype=bool)
        for nid in dead_all:
            if 0 <= nid < self.n:
                live[nid] = False
        on_dst = live & view.dst_ok
        late_subset: Dict[int, Set[int]] = {}
        for pid in sorted(proposers):
            if pid in dead_all:
                continue
            if view.src_ok[pid]:
                mask = on_dst & view.reach[self.zone[pid]][self.zone].astype(
                    bool
                )
            else:
                mask = np.zeros(self.n, dtype=bool)
            if bool((mask == live).all()):
                continue  # delivered on time everywhere — not late
            late_subset[pid] = set(np.flatnonzero(mask).tolist())
        return dead_all, late_subset

    # -- event-driven network seam -----------------------------------------

    def pair_late_prob(self, sender: Any, recipient: Any) -> float:
        """P(a sender→recipient message misses the deadline) under the
        bound model (zone-pair tail; non-validator ids map to zone 0)."""
        zi = (
            int(self.zone[sender])
            if isinstance(sender, int) and 0 <= sender < self.n
            else 0
        )
        zj = (
            int(self.zone[recipient])
            if isinstance(recipient, int) and 0 <= recipient < self.n
            else 0
        )
        return self.model.latency.late_prob(
            self.model.topology.delay_ms[zi][zj], self.model.deadline_ms
        )

    def delay_sampler(self):
        """A sampler for ``SeededDelaySchedule(sampler=...)``: rescales
        the schedule's uniform draw so a message is held with its
        zone-pair tail probability instead of the flat ``p_delay``
        (draw < p_delay ⟺ u < pair_late_prob).  Exactly one
        ``rng.random()`` per decision — the same draw budget as the
        legacy flat sampler, so schedules stay reproducible."""

        def sample(rng, sender, recipient, _message, p_delay=None):
            u = rng.random()
            p = self.pair_late_prob(sender, recipient)
            if p <= 0.0:
                return 1.0  # never held
            if p >= 1.0:
                return -1.0  # always held
            # map so that P(sample < threshold) == p for any threshold
            # the schedule compares against (it passes its own)
            scale = (p_delay if p_delay else 1.0) / p
            return u * scale

        return sample


def crashed_with(
    wan: Any, n: int, epoch: int, dead: Optional[Set[Any]]
) -> Tuple[Optional[WanSchedule], Set[Any]]:
    """``wan`` bound to ``n`` nodes (a :class:`WanModel`; a
    :class:`WanSchedule` or None as given) and ``dead`` joined by its
    crash set for ``epoch``: WAN-crashed nodes are dead for the whole
    epoch, merged before a queueing driver samples proposals."""
    dead = set(dead or set())
    if wan is None:
        return None, dead
    if hasattr(wan, "bind"):
        wan = wan.bind(n)
    return wan, dead | wan.crashed_set(epoch)


__all__ = [
    "GeoTopology",
    "DEFAULT_TOPOLOGY",
    "LatencyModel",
    "PartitionWindow",
    "CorrelatedFailure",
    "FlashCrowd",
    "EpochWan",
    "WanModel",
    "WanSchedule",
    "crashed_with",
]
