"""DynamicHoneyBadger co-simulation at scale — votes, on-chain DKG and
era switches over the vectorized epoch driver: the era change.

The port of ``hbbft_tpu/harness/dynamic.py`` (reference
``src/dynamic_honey_badger/``):

- **Votes ride on-chain**: each epoch's contributions bundle the
  proposers' pending signed votes (the reference's ``InternalContrib``,
  ``dynamic_honey_badger/mod.rs:187-194``); only *committed* votes —
  those inside the agreed batch — are counted, era-scoped, one active
  vote per voter, and f+1 committed votes pick a winner
  (``votes.rs:137-148``, via ``protocols/votes.VoteCounter``).
- **On-chain DKG, atomically**: the schedule is synchronous — every
  correct node sees the identical batch sequence — so the key generation
  runs as one :class:`VectorizedDkg` session at the winning epoch's
  boundary.  Its clean elided dealing (``dkg_verify_honest=False``) runs
  on the backend's device: on the card, ``fr_matmul`` deals every grid.
- **Era restart**: the new ``NetworkInfo`` set (the DKG's keys) replaces
  the old, the epoch driver restarts with epoch numbering continuing,
  and the epoch's result carries ``ChangeState.Complete(change)`` (the
  reference's ``restart_honey_badger``,
  ``dynamic_honey_badger.rs:275-296``).

A removed validator keeps observing; an added validator must have
registered its individual key pair (``register_candidate``), mirroring
``Change::Add(id, pub_key)``.

``wan=`` (a ``harness.wan`` model) makes its crashed nodes dead for the
epoch before the contributions are wrapped (their pending votes stay
queued) and is forwarded to the epoch driver; ``hw=`` (a
``harness.simulation.HwQuality``) gives every epoch its virtual-time
account, and the era-switch epoch's account gains the on-chain DKG's
Part and Ack rounds and its wall (``_add_dkg_virtual``).

The epoch driver's adversarial options (``late_subset=``, ``divergent=``,
``div_schedule=`` and the rest) flow through ``run_epoch(**adv)`` into
``VectorizedHoneyBadgerSim.run_epoch``, which validates them.  The
backend every node shares is ``ops``, the card's ``CudaBackend()`` by
default; a device or kernel error raises out of ``run_epoch``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Set

import torch

from ..core.fault import FaultLog
from ..core.network_info import NetworkInfo, resolve_ops
from ..core.serialize import dumps, wire
from ..crypto import mock as M
from ..crypto import threshold as T
from ..protocols.change import Add, Change, ChangeState, Complete, NoChange, Remove
from ..protocols.dynamic_honey_badger import JoinPlan
from ..protocols.honey_badger import Batch
from ..protocols.votes import SignedVote, Vote, VoteCounter
from .dkg import DkgResult, VectorizedDkg
from .epoch import EpochResult, TransactionQueueMixin, VectorizedHoneyBadgerSim
from .wan import crashed_with


@wire("DynContrib")
@dataclasses.dataclass(frozen=True)
class DynContrib:
    """One proposer's epoch contribution: user payload + the signed
    votes riding on-chain (reference ``InternalContrib``)."""

    user: Any
    votes: tuple


@dataclasses.dataclass
class DynamicEpochResult:
    """One dynamic epoch: the inner result plus membership state."""

    batch: Batch  # user-facing contributions (votes stripped)
    inner: EpochResult
    era: int
    change: ChangeState
    validators: List[Any]
    fault_log: FaultLog


class VectorizedDynamicSim:
    """Era-aware co-simulation: vectorized HoneyBadger epochs with
    on-chain votes and DKG-backed membership changes at scale.

    After an era switch, :attr:`last_dkg` holds the DKG's result (its
    ``engine`` says which dealing plane ran) and
    :attr:`last_switch_phases` the switch's walls: ``dkg`` (the whole
    session), its stages ``dkg_dealing`` / ``dkg_generation`` and
    ``key_rebuild`` (share cache, ``NetworkInfo`` set, epoch driver)."""

    def __init__(
        self,
        n: int,
        rng,
        mock: bool = False,
        ops: Any = None,
        verify_honest: bool = True,
        emit_minimal: bool = False,
        dkg_verify_honest: Optional[bool] = None,
        hw: Any = None,
    ):
        self.rng = rng
        self.mock = mock
        self.ops = resolve_ops(ops)
        self.verify_honest = verify_honest
        self.emit_minimal = emit_minimal
        self.hw = hw
        # DKG honest-check elision defaults to the epoch driver's flag
        self.dkg_verify_honest = verify_honest if dkg_verify_honest is None else dkg_verify_honest
        self.era = 0
        self.epoch = 0
        self.last_dkg: Optional[DkgResult] = None
        self.last_switch_phases: Dict[str, float] = {}
        # initial era: centrally dealt keys (reference test harness
        # bootstrap, messaging.rs:359-400); later eras use the DKG
        netinfos = NetworkInfo.generate_map(list(range(n)), rng, mock=mock, ops=self.ops)
        ref = netinfos[sorted(netinfos)[0]]
        self.sec_keys: Dict[Any, Any] = {nid: ni.secret_key for nid, ni in netinfos.items()}
        self.pub_keys: Dict[Any, Any] = ref.public_key_map
        self.validators: List[Any] = sorted(netinfos)
        self._vote_num: Dict[Any, int] = {}
        self.pending: Dict[Any, List[SignedVote]] = {}
        self._last_change: ChangeState = NoChange()
        self._attach(netinfos)

    # -- era plumbing ------------------------------------------------------

    def _attach(self, netinfos: Dict[Any, NetworkInfo]) -> None:
        # the dynamic layer consumes each epoch's batch (votes, era
        # changes) synchronously: inline reveals
        self.sim = VectorizedHoneyBadgerSim.from_netinfos(
            netinfos,
            self.rng,
            mock=self.mock,
            verify_honest=self.verify_honest,
            emit_minimal=self.emit_minimal,
            hw=self.hw,
            reveal_mode="inline",
        )
        self.sim.epoch = self.epoch
        self.counter = VoteCounter(netinfos[sorted(netinfos)[0]], self.era)

    def register_candidate(self, nid: Any, sec_key: Any = None) -> Any:
        """Register a joiner's individual key pair (the co-simulation
        plays every node); returns its public key for ``Add``."""
        if sec_key is None:
            sec_key = M.MockSecretKey.random(self.rng) if self.mock else T.SecretKey.random(self.rng)
        self.sec_keys[nid] = sec_key
        self.pub_keys[nid] = sec_key.public_key()
        return self.pub_keys[nid]

    # -- join plans (reference mod.rs:136-145 / builder.rs:82-114) ---------

    def join_plan(self) -> JoinPlan:
        """Everything a fresh observer needs to synchronize with the
        CURRENT era: the next epoch number (which anchors the era), the
        membership change that produced this era (``Complete(...)``
        right after a switch), the validators' public keys and the
        threshold public key set."""
        return JoinPlan(
            epoch=self.epoch,
            change=self._last_change,
            pub_key_set=self.sim.pk_set,
            pub_keys={nid: self.pub_keys[nid] for nid in self.validators},
        )

    def observer_from_plan(self, plan: JoinPlan, observer_id: Any = "observer") -> NetworkInfo:
        """A non-validator ``NetworkInfo`` from a join plan: it verifies
        everything but holds no key share (``builder.rs:82-114``)."""
        return NetworkInfo(observer_id, None, None, plan.pub_key_set, plan.pub_keys, ops=self.ops)

    # -- voting ------------------------------------------------------------

    def vote_for(self, voter: Any, change: Change) -> None:
        """Sign a vote with the voter's individual key and queue it to
        ride in the voter's next contribution (``votes.rs:45-61``)."""
        if voter not in self.sim.netinfos:
            raise ValueError(f"{voter!r} is not a current validator")
        num = self._vote_num.get(voter, -1) + 1
        self._vote_num[voter] = num
        vote = Vote(change, self.era, num)
        sig = self.sec_keys[voter].sign(dumps(vote))
        self.pending.setdefault(voter, []).append(SignedVote(vote, voter, sig))

    # -- epochs ------------------------------------------------------------

    def run_epoch(
        self, contributions: Dict[Any, Any], dead: Optional[Set[Any]] = None, **adv
    ) -> DynamicEpochResult:
        """One epoch: wrap contributions with pending votes, run the
        vectorized epoch, count the committed votes, and switch eras if
        a change wins (f+1 committed votes)."""
        # WAN-correlated crashes are dead for the whole epoch — their
        # pending votes stay queued, like any silent node
        wan, dead = crashed_with(adv.get("wan"), self.sim.n, self.sim.epoch, dead)
        if wan is not None:
            adv["wan"] = wan
        wrapped = {}
        for pid in sorted(self.sim.netinfos):
            if pid in dead:
                continue
            votes = tuple(self.pending.get(pid, ()))
            if pid not in contributions and not votes:
                continue
            wrapped[pid] = DynContrib(contributions.get(pid), votes)

        res = self.sim.run_epoch(wrapped, dead=dead, **adv)
        faults = res.fault_log

        # committed (batch-ordered) votes only — the on-chain rule that
        # makes every correct node count identically
        user_contribs: Dict[Any, Any] = {}
        for pid in sorted(res.batch.contributions):
            contrib = res.batch.contributions[pid]
            if not isinstance(contrib, DynContrib):
                continue
            for sv in contrib.votes:
                faults.merge(self.counter.add_committed_vote(pid, sv))
            if pid in self.pending:
                committed = set(contrib.votes)
                self.pending[pid] = [sv for sv in self.pending[pid] if sv not in committed]
            if contrib.user is not None:
                user_contribs[pid] = contrib.user
        batch = Batch(res.batch.epoch, user_contribs)
        self.epoch = self.sim.epoch

        winner = self.counter.compute_winner()
        change_state: ChangeState = NoChange()
        if winner is not None:
            change_state = Complete(winner)
            t0 = time.perf_counter()
            self._switch_era(winner)
            # recorded only once the switch happened: a failed switch
            # must not leave the join plan advertising it
            self._last_change = change_state
            if self.hw is not None and res.virtual is not None:
                self._add_dkg_virtual(res.virtual, time.perf_counter() - t0)
        return DynamicEpochResult(
            batch=batch,
            inner=res,
            era=self.era,
            change=change_state,
            validators=list(self.validators),
            fault_log=faults,
        )

    def _add_dkg_virtual(self, virtual, dkg_wall: float) -> None:
        """Fold the on-chain DKG's traffic and compute into the
        era-switch epoch's virtual-time account: one Part round (every
        dealer multicasts its bivariate commitment + N encrypted rows)
        and one Ack round (every node multicasts one Ack per dealer,
        each with N encrypted values) — message sizes per
        ``sync_key_gen.rs:268-349`` shapes — plus the switch's wall as
        the cpu term (dealing is per-dealer work but verification
        dominates and is replicated per node, as for the epoch phases).
        ``total_s`` is set to ``network_s + cpu_s`` afterwards, the
        account's invariant; the reference adds each term to it in turn,
        which can leave it one ulp away."""
        hw = self.hw
        n = len(self.validators)
        t = (n - 1) // 3
        enc = 32 + 150  # one encrypted Fr value (ciphertext overhead)
        part_size = (t + 1) ** 2 * 192 + n * ((t + 1) * 32 + 150)
        ack_size = n * enc + 8
        rounds = [
            ("dkg-part", (n - 1) * part_size, n - 1),
            ("dkg-ack", n * (n - 1) * ack_size, n * (n - 1)),
        ]
        cpu = dkg_wall * 100.0 / hw.cpu_factor
        for label, bytes_, msgs in rounds:
            secs = bytes_ * hw.inv_bw + hw.latency
            virtual.breakdown[label] = secs
            virtual.network_s += secs
            virtual.rounds += 1
            virtual.per_node_msgs += msgs
            virtual.per_node_bytes += bytes_
        virtual.breakdown["cpu:dkg"] = cpu
        virtual.cpu_s += cpu
        virtual.total_s = virtual.network_s + virtual.cpu_s

    # -- the era switch ----------------------------------------------------

    def _dkg_device(self) -> torch.device:
        """The DKG's device: the backend's (a host backend has none)."""
        return getattr(self.ops, "device", torch.device("cpu"))

    def _switch_era(self, change: Change) -> None:
        if isinstance(change, Remove):
            new_set = [v for v in self.validators if v != change.node_id]
        elif isinstance(change, Add):
            if change.node_id in self.validators:
                new_set = list(self.validators)
            else:
                if change.node_id not in self.sec_keys:
                    raise ValueError(
                        f"candidate {change.node_id!r} has no registered "
                        "key pair (register_candidate)"
                    )
                new_set = sorted(self.validators + [change.node_id])
        else:  # pragma: no cover - defensive
            raise TypeError(f"unknown change {change!r}")

        t0 = time.perf_counter()
        threshold = (len(new_set) - 1) // 3
        dkg = VectorizedDkg(
            new_set, threshold, self.rng, mock=self.mock,
            device=None if self.mock else self._dkg_device(),
        )
        out = dkg.run(verify_honest=self.dkg_verify_honest)
        t1 = time.perf_counter()
        if not self.mock:
            # the co-simulation holds every dealt share scalar, so the N
            # commitment evaluations the NetworkInfo rebuild would
            # trigger collapse to one shared-base comb pass
            ordered = sorted(new_set)
            out.pk_set.seed_share_cache_from_scalars(
                {i: out.shares[nid].scalar for i, nid in enumerate(ordered)}
            )
        pub_keys = {nid: self.pub_keys[nid] for nid in new_set}
        netinfos = {
            nid: NetworkInfo(nid, out.shares[nid], self.sec_keys[nid], out.pk_set, pub_keys,
                             ops=self.ops)
            for nid in new_set
        }
        self.validators = list(new_set)
        self.era += 1
        # pending votes are era-scoped (the era restart builds a fresh
        # VoteCounter and old-era pending votes die with it,
        # votes.rs:64-85)
        self.pending.clear()
        self._vote_num.clear()
        self._attach(netinfos)
        self.last_dkg = out
        self.last_switch_phases = {"dkg": t1 - t0}
        self.last_switch_phases.update({"dkg_" + k: v for k, v in dkg.last_phases.items()})
        self.last_switch_phases["key_rebuild"] = time.perf_counter() - t1


class VectorizedDynamicQueueingSim(TransactionQueueMixin):
    """The reference's QueueingHoneyBadger over the DYNAMIC stack — QHB =
    DHB + queue (``queueing_honey_badger.rs:161-176``): validators
    propose random B/N samples from their queues each epoch, committed
    transactions drain from every queue, and votes, the DKG and era
    switches run as in :class:`VectorizedDynamicSim`.  Queues follow the
    validator set: a joiner copies the backlog from a sponsor."""

    def __init__(
        self,
        n: int,
        rng,
        batch_size: int = 100,
        mock: bool = False,
        ops: Any = None,
        verify_honest: bool = True,
        emit_minimal: bool = False,
        dkg_verify_honest: Optional[bool] = None,
        hw: Any = None,
    ):
        self.dyn = VectorizedDynamicSim(
            n,
            rng,
            mock=mock,
            ops=ops,
            verify_honest=verify_honest,
            emit_minimal=emit_minimal,
            dkg_verify_honest=dkg_verify_honest,
            hw=hw,
        )
        self.rng = rng
        self.batch_size = batch_size
        self._init_queues()

    def _queue_ids(self) -> List[Any]:
        return list(self.dyn.validators)

    def vote_for(self, voter: Any, change: Change) -> None:
        self.dyn.vote_for(voter, change)

    def register_candidate(self, nid: Any, sec_key: Any = None) -> Any:
        return self.dyn.register_candidate(nid, sec_key)

    @property
    def validators(self) -> List[Any]:
        return self.dyn.validators

    @property
    def era(self) -> int:
        return self.dyn.era

    def run_epoch(self, dead: Optional[Set[Any]] = None, **adv) -> DynamicEpochResult:
        # crashes merge BEFORE queue sampling (crashed nodes draw no
        # proposal) — the same order the packed co-sim uses
        wan, dead = crashed_with(adv.get("wan"), self.dyn.sim.n, self.dyn.sim.epoch, dead)
        if wan is not None:
            adv["wan"] = wan
        contribs = self._sample_contribs(dead)
        res = self.dyn.run_epoch(contribs, dead=dead, **adv)
        self._drain(list(res.batch.tx_iter()))
        return res
