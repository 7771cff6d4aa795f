"""Packed 100k-validator co-simulation — struct-of-arrays sim state, one
step an epoch on the card.

The port of ``hbbft_tpu/harness/cosim.py``.  ``VectorizedHoneyBadgerSim``
(``harness/epoch.py``) batches the crypto, but its *protocol* state is
Python dicts keyed by node id — O(n) to O(n²) host objects an epoch,
which tops out around n = 1024.  Here the whole network's per-epoch
protocol state lives in packed ``[n]`` columns (struct-of-arrays), one
step (``parallel/mesh.py::packed_cosim_step_fn``: one ``cosim_step``
launch on one card; a ``cosim_hist`` and a ``cosim_step`` launch a shard
on a mesh) resolves every agreement instance's decision, and
the Python side holds O(1) objects whatever n is.

The move that makes this exact rather than approximate: under the mock
crypto the entire crypto plane is algebraically transparent —

- encryption round-trips (``xor_stream`` twice with the same derived
  key), so committed plaintexts ARE the proposed contributions;
- the real common coin is subset-independent (``combine_signatures``
  returns the group tag), so a coin value is ``sha256``-parity of
  ``(group seed, nonce)`` — computable per instance without any share
  exchange;
- decryption-share validity collapses to counting (an honest share is
  valid by construction, a forged one invalid), so fault attribution is
  a deterministic replay from counts
  (``vectorized.packed_decrypt_attribution``).

What remains per instance is the honest-schedule binary-agreement
decision algebra of ``VectorizedAgreement.run`` — a closed form over two
counts (yes votes c1, no votes c0 = live − c1), evaluated for all n
instances at once, with the n² vote relation factored through the WAN
layer's zone product.  Equivalence is not asymptotic:
``tests/test_torch_cosim.py`` pins batches, fault logs, coin flips and
agreement epochs byte-identical to the dict-based sim (the port's and
the reference's) at every n where both run.

Supported adversary surface: ``dead`` (silent nodes), ``late`` (whole
broadcasts delayed past agreement), ``late_subset`` (per-proposer
partial timely delivery), ``forged_dec`` (forged decryption shares),
plus the WAN models of ``harness/wan.py`` (zone partitions, heavy-tail
lateness, correlated failures).  Everything else the dict-based sim
models (``corrupt_shards``, vote injection, divergent schedules,
observers) needs per-message state the packed representation
deliberately does not carry — those kwargs raise; use
``VectorizedHoneyBadgerSim``.

Where it runs: ``device`` (the card by default; ``device="cpu"`` runs
the kernels' plain versions).  An explicit ``mesh=`` shards the instance
axis; otherwise the instance axis is sharded over every card
(``make_mesh``) when more than one is visible and n ≥ 4096, and stays on
one device below.  Each shard's zone and commit columns live on its
device for the sim's life (the commit column advanced in place every
step); each epoch's host columns and its ``[Z, Z]`` zone reachability
are pinned tensors the sim owns, allocated once, filled every epoch and
copied to the card together (the ``to_card`` stage), so the step stage
makes no copy from pageable memory.  The reference's trace event
and its environment switches (``HBBFT_TPU_COSIM_MESH{,_MIN}``) are not
ported: the keywords are the one switch.
"""

from __future__ import annotations

import resource
import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..core.fault import FaultLog
from ..crypto.mock import _tag as _mock_tag
from ..device import DeviceLike, resolve_device
from ..parallel import mesh as PM
from ..protocols.common_coin import make_nonce
from ..protocols.honey_badger import Batch
from .epoch import EpochResult, TransactionQueueMixin
from .vectorized import packed_decrypt_attribution
from .wan import crashed_with

# the validator count from which a sim without an explicit mesh shards
# its instance axis over every visible card (the reference's default)
MESH_MIN = 4096


def _peak_rss_bytes() -> int:
    # ru_maxrss is KiB on Linux
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _rows(index: Any) -> Any:
    """A numpy index for a sequence of instance ids."""
    if isinstance(index, range):
        return slice(index.start, index.stop, index.step)
    return np.asarray(index, dtype=np.int64)


class CosimEpochStats:
    """One scale-mode epoch's aggregates (``run_epoch_packed``) — no
    per-node materialization."""

    __slots__ = (
        "epoch",
        "n",
        "accepted",
        "coin_flips",
        "wall_s",
        "epochs_per_s",
        "peak_rss_bytes",
        "bytes_per_validator",
        "mesh_devices",
    )

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw[k])


class PackedHoneyBadgerCosim:
    """HoneyBadger co-simulation with packed struct-of-arrays state.

    Byte-compatible with ``VectorizedHoneyBadgerSim(n, rng, mock=True)``:
    consumes the identical rng draw sequence (key dealing at init, one
    encryption nonce per live proposer per epoch) and produces identical
    ``EpochResult`` rows, so a packed sim and a dict-based sim driven
    from equal-seeded rngs stay in lockstep for arbitrarily many epochs.
    Mock crypto only — the real-BLS plane needs actual share exchange and
    belongs to the dict-based sim.

    After each step :attr:`last_phases` holds its walls: ``masks`` (the
    host columns), ``to_card`` (their copies to the shards), ``step``
    (the kernels), ``from_card`` (the masks' copies back), each ended by
    a synchronize of the shards' devices; ``run_epoch_packed`` adds
    ``wan_view`` (the WAN model's epoch view)."""

    def __init__(
        self,
        n: int,
        rng,
        mock: bool = True,
        wan: Optional[Any] = None,
        mesh: Optional[PM.Mesh] = None,
        device: DeviceLike = None,
    ):
        if not mock:
            raise ValueError(
                "the packed co-sim models the mock-crypto protocol "
                "plane; real BLS runs use VectorizedHoneyBadgerSim"
            )
        self.n = int(n)
        self.rng = rng
        self.mock = True
        # where the columns live: an explicit mesh's shards, else the
        # device (the card by default), sharded over every card from
        # MESH_MIN validators when more than one is visible
        self.device = mesh.devices[0] if mesh is not None else resolve_device(device)
        self._mesh = self._pick_mesh(mesh)
        # consume NetworkInfo.generate_map's exact draw sequence without
        # materializing n key objects: one group-seed draw, then one
        # per-node secret-key draw in sorted id order.  The group seed IS
        # the mock master public key bytes = the invocation id bound into
        # coin nonces.
        self._group_seed = rng.randrange(2**256).to_bytes(32, "big")
        for _ in range(self.n):
            rng.randrange(2**256)
        self.num_faulty = (self.n - 1) // 3
        self.num_correct = self.n - self.num_faulty
        self.epoch = 0
        # WAN model: a WanModel (bound here) or a pre-bound WanSchedule
        # (shared with a dict-plane twin)
        if wan is not None and hasattr(wan, "bind"):
            wan = wan.bind(self.n)
        self.wan = wan
        # -- the packed columns ----------------------------------------
        self._devices: List[torch.device] = (
            list(self._mesh.devices) if self._mesh is not None else [self.device]
        )
        S = len(self._devices)
        self._n_pad = PM.cosim_pad(self.n, S)
        self._block = self._n_pad // S
        self._Z = self.wan.Z if self.wan is not None else 1
        self._step = PM.packed_cosim_step_fn(self._mesh, self._Z)
        pin = any(d.type == "cuda" for d in self._devices)

        def host(dtype) -> torch.Tensor:
            return torch.zeros(self._n_pad, dtype=dtype, pin_memory=pin)

        # each epoch's host columns (cleared every epoch) and the masks
        # that come back, owned by the sim and allocated once
        self._h = {
            "prop_on": host(torch.int8),
            "dst_on": host(torch.int8),
            "ovr_mask": host(torch.int8),
            "ovr_c1": host(torch.int32),
            "forged_cnt": host(torch.int32),
        }
        self._back = [host(torch.int8) for _ in range(3)]
        # the epoch's zone reachability, filled each step and copied to
        # the card with the columns (to_card)
        self._reach_h = torch.zeros((self._Z, self._Z), dtype=torch.uint8, pin_memory=pin)
        zone_h = np.zeros(self._n_pad, dtype=np.int32)
        if self.wan is not None:
            zone_h[: self.n] = self.wan.zone
        self._zone = self._to_shards(torch.from_numpy(zone_h))
        # per-instance commit counters: the persistent packed sim state,
        # advanced in place by every step
        self._commit = [torch.zeros(self._block, dtype=torch.int32, device=d) for d in self._devices]
        self._state_bytes = 2 * 4 * self._n_pad  # zone and commit, int32 each
        self.last_phases: Dict[str, float] = {}

    def _pick_mesh(self, mesh: Optional[PM.Mesh]) -> Optional[PM.Mesh]:
        if mesh is not None:
            return mesh if mesh.size > 1 else None
        if self.device.type == "cuda" and torch.cuda.device_count() > 1 and self.n >= MESH_MIN:
            return PM.make_mesh(device=self.device)
        return None

    @property
    def mesh_devices(self) -> int:
        return len(self._devices)

    def _to_shards(self, col: torch.Tensor) -> List[torch.Tensor]:
        """Copy a host column's blocks to the shards' devices, each on
        its device's current stream."""
        b = self._block
        return [col[j * b : (j + 1) * b].to(d, non_blocking=True) for j, d in enumerate(self._devices)]

    def _sync(self) -> None:
        for d in set(self._devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def commit_counts(self) -> np.ndarray:
        """Per-instance committed-epoch counters (the packed state)."""
        return torch.cat([c.cpu() for c in self._commit]).numpy()[: self.n]

    # -- mock crypto, host side -------------------------------------------

    def _coin_parity(self, pid: int, agreement_epoch: int) -> int:
        """The real mock coin for (this HB epoch, instance pid, agreement
        epoch): parity of the combined group signature — subset-
        independent, so no share exchange is simulated."""
        nonce = make_nonce(self._group_seed, self.epoch, pid, agreement_epoch)
        return _mock_tag(b"SIG", self._group_seed, nonce)[0] & 1

    # -- one epoch ---------------------------------------------------------

    _UNSUPPORTED = (
        "corrupt_shards",
        "observe",
        "adv_bval",
        "adv_aux",
        "forged_coin",
        "divergent",
        "div_schedule",
    )

    def run_epoch(
        self,
        contributions: Dict[int, Any],
        dead: Optional[Set[int]] = None,
        forged_dec: Optional[Dict[int, Dict[int, Any]]] = None,
        late: Optional[Set[int]] = None,
        late_subset: Optional[Dict[int, Set[int]]] = None,
        wan: Optional[Any] = None,
        **adv,
    ) -> EpochResult:
        """Advance the whole network one epoch; equivalence mode.

        Same contract as ``VectorizedHoneyBadgerSim.run_epoch`` over the
        supported adversary surface; committed contributions are the
        proposer's original objects (mock encryption round-trips to
        identity).  ``forged_dec`` shares are bogus by definition (the
        adversary model) — each live forger is attributed once.
        """
        for k in self._UNSUPPORTED:
            if adv.get(k):
                raise ValueError(
                    f"packed co-sim does not model {k!r}; use VectorizedHoneyBadgerSim"
                )
        unknown = set(adv) - set(self._UNSUPPORTED)
        if unknown:
            raise TypeError(f"unknown adversary kwargs {sorted(unknown)}")
        t0 = time.perf_counter()
        late = set(late or set())
        forged_dec = forged_dec or {}
        late_subset = dict(late_subset or {})
        sched, dead = crashed_with(wan if wan is not None else self.wan, self.n, self.epoch, dead)
        view = sched.epoch_view(self.epoch) if sched is not None else None
        if len(dead) > self.num_faulty:
            raise ValueError(f"{len(dead)} dead nodes exceeds the f={self.num_faulty} bound")
        # 1. propose: one encryption nonce per sorted live proposer — the
        # dict-based sim's exact rng sequence (_propose_phase); the nonces
        # themselves are dead weight because mock decryption returns the
        # original plaintext
        proposers: List[int] = []
        for pid in range(self.n):
            if pid in dead or pid not in contributions:
                continue
            self.rng.randrange(2**128)
            proposers.append(pid)
        # 2. broadcast: honest RBC always delivers; `late` proposers'
        # waves are withheld past agreement (never delivered)
        delivered = [pid for pid in proposers if pid not in late]
        if len(delivered) < self.num_correct:
            raise RuntimeError(
                "fewer than N−f broadcasts delivered — common subset "
                "cannot terminate on this schedule (more than f "
                "dead/corrupt/late proposers)"
            )
        if set(late_subset) - set(delivered):
            raise ValueError(
                "late_subset proposers must have completed their "
                "broadcast (they deliver late, not never)"
            )
        # 3-5. agreement + decryption: the packed step
        n_live = self.n - len(dead)
        faults = FaultLog()
        accepted_mask, nondef_mask, fail_mask = self._run_step(
            delivered, dead, view, late_subset, forged_dec, n_live
        )
        accepted = [int(p) for p in np.flatnonzero(accepted_mask[: self.n])]
        accepted_set = set(accepted)
        # agreement bookkeeping identical to VectorizedAgreement.run on
        # this honest schedule: definite-1 decides at agreement epoch 0,
        # definite-0 at 1, coin-bound instances converge to 1 and decide
        # at 2 or 3 by the real mock coin's parity (one real flip each,
        # at agreement epoch 2)
        nondef = [int(p) for p in np.flatnonzero(nondef_mask[: self.n])]
        coin_flips = len(nondef)
        agreement_epochs: Dict[int, int] = {
            pid: 0 if pid in accepted_set else 1 for pid in range(self.n)
        }
        for pid in nondef:
            agreement_epochs[pid] = 2 if self._coin_parity(pid, 2) else 3
        # decryption fault attribution (ordering contract shared with
        # decrypt_round — see packed_decrypt_attribution)
        packed_decrypt_attribution(
            accepted, forged_dec, dead, faults, lambda pid: bool(fail_mask[pid])
        )
        shares_verified = n_live * len(accepted)
        # 6. batch assembly: mock round-trip identity — committed
        # contributions are the originals
        out_contribs: Dict[int, Any] = {
            pid: contributions[pid] for pid in accepted if not fail_mask[pid]
        }
        batch = Batch(self.epoch, out_contribs)
        wall = time.perf_counter() - t0
        phases = {"step": wall, "commit_latency": wall}
        phases.update(("step_" + k, v) for k, v in self.last_phases.items())
        self.epoch += 1
        return EpochResult(
            batch=batch,
            accepted=accepted,
            fault_log=faults,
            coin_flips=coin_flips,
            shares_verified=shares_verified,
            agreement_epochs=agreement_epochs,
            observer_batch=None,
            virtual=None,
            phases=phases,
        )

    # -- the step ------------------------------------------------------------

    def _run_step(
        self,
        delivered: Sequence[int],
        dead: Set[int],
        view,
        late_subset: Dict[int, Set[int]],
        forged_dec: Dict[int, Dict[int, Any]],
        n_live: int,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Fill the epoch's host columns, copy them to the shards, run the
        step, and return the (accepted, nondef, dec_fail) host masks —
        views of buffers the next step overwrites."""
        t0 = time.perf_counter()
        h = {k: t.numpy() for k, t in self._h.items()}
        for t in self._h.values():
            t.zero_()
        n = self.n
        live = np.ones(n, dtype=bool)
        if dead:
            live[sorted(dead)] = False
        if view is not None:
            prop = np.zeros(n, dtype=bool)
            prop[_rows(delivered)] = True
            h["prop_on"][:n] = prop & view.src_ok
            h["dst_on"][:n] = live & view.dst_ok
            reach = view.reach
        else:
            h["prop_on"][_rows(delivered)] = 1
            h["dst_on"][:n] = live
            reach = np.ones((1, 1), dtype=np.uint8)
        if reach.shape != tuple(self._reach_h.shape):
            raise ValueError(f"reach must be [{self._Z}, {self._Z}] for this sim, got {reach.shape}")
        self._reach_h.numpy()[...] = reach
        for pid, subset in late_subset.items():
            h["ovr_mask"][pid] = 1
            h["ovr_c1"][pid] = sum(1 for nid in subset if live[nid])
        for nid, targets in forged_dec.items():
            if nid in dead or not (0 <= nid < n):
                continue
            for pid in targets:
                if 0 <= pid < n:
                    h["forged_cnt"][pid] += 1
        t1 = time.perf_counter()
        cols = {k: self._to_shards(t) for k, t in self._h.items()}
        reach_t = self._reach_h.to(self._devices[0], non_blocking=True)
        self._sync()
        t2 = time.perf_counter()
        # one device's step takes tensors, a mesh's lists of shard blocks
        shards = (lambda c: c) if self._mesh is not None else (lambda c: c[0])
        out = self._step(
            shards(cols["prop_on"]), shards(cols["dst_on"]), shards(self._zone), reach_t,
            shards(cols["ovr_mask"]), shards(cols["ovr_c1"]), shards(cols["forged_cnt"]),
            shards(self._commit), (n_live, self.num_faulty),
        )
        self._sync()
        t3 = time.perf_counter()
        b = self._block
        for back, got in zip(self._back, out[:3]):
            for j, g in enumerate(got if self._mesh is not None else [got]):
                back[j * b : (j + 1) * b].copy_(g, non_blocking=True)
        self._sync()
        t4 = time.perf_counter()
        self.last_phases = {"masks": t1 - t0, "to_card": t2 - t1, "step": t3 - t2,
                            "from_card": t4 - t3}
        return tuple(t.numpy() for t in self._back)

    # -- scale mode --------------------------------------------------------

    def run_epoch_packed(self, dead: Optional[Set[int]] = None) -> CosimEpochStats:
        """Scale-mode epoch: every live validator proposes, the WAN model
        (if any) decides timeliness, and only aggregates come home — no
        batches, no rng nonces, no per-node Python objects."""
        t0 = time.perf_counter()
        sched, dead = crashed_with(self.wan, self.n, self.epoch, dead)
        view = sched.epoch_view(self.epoch) if sched is not None else None
        t_view = time.perf_counter() - t0
        n_live = self.n - len(dead)
        delivered: Sequence[int]
        if dead:
            live = np.ones(self.n, dtype=bool)
            live[sorted(dead)] = False
            delivered = np.flatnonzero(live)
        else:
            delivered = range(self.n)
        acc, nondef, _fail = self._run_step(delivered, dead, view, {}, {}, n_live)
        accepted = int(acc[: self.n].astype(np.int64).sum())
        coin_flips = int(nondef[: self.n].astype(np.int64).sum())
        wall = time.perf_counter() - t0
        self.last_phases["wan_view"] = t_view
        stats = CosimEpochStats(
            epoch=self.epoch,
            n=self.n,
            accepted=accepted,
            coin_flips=coin_flips,
            wall_s=wall,
            epochs_per_s=(1.0 / wall) if wall > 0 else float("inf"),
            peak_rss_bytes=_peak_rss_bytes(),
            bytes_per_validator=self._state_bytes / self.n,
            mesh_devices=self.mesh_devices,
        )
        self.epoch += 1
        return stats


class PackedQueueingCosim(TransactionQueueMixin):
    """QueueingHoneyBadger over the packed epoch driver — transaction
    queues, random B/N proposals, committed-transaction removal —
    rng-lockstepped with ``VectorizedQueueingSim`` (the equivalence twin)
    and arbitrarily large on the packed plane."""

    def __init__(
        self,
        n: int,
        rng,
        batch_size: int = 100,
        mock: bool = True,
        wan: Optional[Any] = None,
        mesh: Optional[PM.Mesh] = None,
        device: DeviceLike = None,
    ):
        self.sim = PackedHoneyBadgerCosim(n, rng, mock=mock, wan=wan, mesh=mesh, device=device)
        self.rng = rng
        self.batch_size = batch_size
        self._init_queues()

    def _queue_ids(self) -> List[int]:
        return list(range(self.sim.n))

    def arrival_factor(self) -> float:
        """The WAN model's flash-crowd arrival multiplier for the upcoming
        epoch (callers scale their injection by this)."""
        if self.sim.wan is None:
            return 1.0
        return self.sim.wan.arrival_factor(self.sim.epoch)

    def run_epoch(self, dead: Optional[Set[int]] = None, **adv) -> EpochResult:
        # WAN crashes must be known BEFORE queue sampling (a crashed node
        # draws no proposal) — the same merge the dict-plane twin does
        _, dead = crashed_with(self.sim.wan, self.sim.n, self.sim.epoch, dead)
        contribs = self._sample_contribs(dead)
        result = self.sim.run_epoch(contribs, dead=dead, **adv)
        self._drain(list(result.batch.tx_iter()))
        return result
