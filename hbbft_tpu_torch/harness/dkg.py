"""The fully verified dealerless DKG, with its verification MSM on the card.

The port of the real-crypto path of ``hbbft_tpu/harness/dkg.py``
(``VectorizedDkg``; semantics of ``sync_key_gen.rs``): all N
participants advance through one synchronous DKG in array form.

1. **Dealing** — each dealer's symmetric (t+1)×(t+1) coefficient matrix
   ``C_d`` is drawn from the rng exactly as ``BivarPoly.random`` draws
   it; row and value grids are native Fr matrix products
   (``ROWS_d = POW·C_d``, ``VAL_d = ROWS_d·POWᵀ``, ``POW[r][j] =
   (r+1)^j``) and commitment entries ``C_d[j][k]·P₂`` come from the
   native shared-base G2 comb.
2. **Verification** — every row check (N², ``sync_key_gen.rs:334``) and
   every ack-value check (N³, ``:449``) collapse into ONE G2 MSM over
   the N·(t+1)² commitment entries by a trilinear random linear
   combination with Fiat–Shamir coefficients:

       Σ_d Σ_{j,k} C_d[j][k] · (α_d·c_k·u_j + α'_d·u'_j·w'_k) == P₂ · T

   (see the reference module for the soundness argument).  At or above
   ``G2_DEVICE_MIN`` entries the MSM runs on ``device``
   (``ops/packed_msm.g2_msm_packed_wires``: wires to the card,
   torch unpack, the ``win_g2`` CUDA kernel, a torch complete-add tree);
   below it, native host Pippenger.  A device failure raises.  If the
   equation fails, per-dealer fused checks and then exact per-item
   checks inside failing dealers attribute INVALID_PART to dealers with
   bad rows and INVALID_ACK to senders of bad values.
3. **Generation** — ``pk_set`` (commitment = Σ_d row-0 commitments) and
   every node's share (Σ_d Lagrange₀ of the lowest t+1 valid values),
   as ``SyncKeyGen.generate()``.

``verify_honest=False`` elides the checks of honestly dealt cells and
verifies only the adversarial injections, exactly (the reference's
elided mode).

**The device dealing plane** (:meth:`VectorizedDkg._run_real_device`,
the counterpart of the reference's TPU engine over ``fr_jax``): the
clean elided run — ``verify_honest=False`` and no adversarial cell —
deals on ``device`` through ``ops/fr.py``'s ``fr_matmul``: per dealer
``ROWS_d = POW[:2t+1]·C_d``, ``VAL_d = ROWS_d[:t+1]·POWᵀ``,
``share_acc += λᵀ·VAL_d`` and ``row0_acc += C_d[0]``, every grid kept on
the device in the kernel's word layout; only the two accumulators come
back.  It is taken when ``run(engine="device")`` asks for it, or by
default when ``device`` is a CUDA device; ``engine="host"`` forces the
native path.  The reference's staging FIFO is not carried over (each
dealer's ``coeffs`` are uploaded in turn), nor its int32 grid digest,
which only kept XLA from eliminating the unread rows: eager launches
compute every grid anyway.  Without ``coeffs`` the dealing matrices are
sampled on the device.  ``mock=True`` runs the reference's mock dealing
(``_run_mock``) and needs no device.

Not ported: the obs spans (the port records stage walls in
:attr:`VectorizedDkg.last_phases`) and the reference's
``HBBFT_TPU_DKG_DEVICE`` switch (``engine=`` is the one switch).
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from .. import native as NT
from ..core.fault import FaultKind, FaultLog
from ..crypto import fields as F
from ..crypto import mock as M
from ..crypto import threshold as T
from ..crypto.curve import G1_GEN, G2_GEN
from ..crypto.hashing import sha256
from ..crypto.poly import (
    BivarPoly,
    Commitment,
    interpolate_at_zero,
    lagrange_coefficients_at_zero,
)
from ..device import DeviceLike, resolve_device, stamp
from ..ops import fr as FR
from ..ops import packed_msm

R = F.R


def _fr_bytes(vals: Sequence[int]) -> np.ndarray:
    return np.frombuffer(
        b"".join(int(v % R).to_bytes(32, "big") for v in vals), dtype=np.uint8
    ).copy()


def _fr_ints(buf: np.ndarray) -> List[int]:
    raw = buf.tobytes()
    return [int.from_bytes(raw[i : i + 32], "big") for i in range(0, len(raw), 32)]


@dataclasses.dataclass
class DkgResult:
    """Outcome of one co-simulated DKG session."""

    pk_set: Any  # T.PublicKeySet | M.MockPublicKeySet
    shares: Dict[Any, Any]  # node id → share
    fault_log: FaultLog
    complete: List[Any]  # dealers whose parts completed (≥ 2t+1 acks)
    row_checks: int  # row-check cells settled
    value_checks: int  # value-check cells settled
    msm_points: int  # size of the single fused verification MSM
    engine: str = "host"  # which engine ran the dealing plane


class Dealing(NamedTuple):
    """The wire-visible buffers of one run (corruptions applied): per
    dealer the row grid ``[n_rowed, t+1]``, the value grid
    ``[n_valued, n]`` (32-byte Fr entries) and the commitment wires
    ``[(t+1)², 192 B]``, and the number of ack senders checked."""

    rows: List[np.ndarray]
    vals: List[np.ndarray]
    commit_wires: Dict[int, np.ndarray]
    n_ackers: int


class VectorizedDkg:
    """One synchronous dealerless DKG over ``node_ids`` at threshold t,
    with the fused verification MSM and the clean dealing plane on
    ``device`` (``None`` = the card; ``"cpu"`` runs the kernels' plain
    versions).  ``mock`` runs the reference's mock dealing, on no
    device."""

    # fused MSMs of at least this many commitment entries run on the
    # device, smaller ones on the native host (the reference's rule,
    # dkg.py:770, at the size where an H100 overtakes native: it loses
    # at 256 entries and wins from 512, scripts/torch_g2_band.py)
    G2_DEVICE_MIN = 1 << 9

    def __init__(
        self,
        node_ids: Sequence[Any],
        threshold: int,
        rng,
        mock: bool = False,
        device: DeviceLike = None,
    ):
        self.node_ids = sorted(node_ids)
        self.n = len(self.node_ids)
        self.t = threshold
        if self.n < 2 * threshold + 1:
            raise ValueError("need at least 2t+1 nodes for completeness")
        self.rng = rng
        self.mock = mock
        self.device = None if mock else resolve_device(device)
        self.last_phases: Dict[str, float] = {}
        self.last_dealing: Optional[Dealing] = None

    def _stamp(self, name: str, t0: float) -> float:
        return stamp(self.last_phases, self.device, name, t0)

    def _dealer_coeffs(self, seed_rng) -> List[List[List[int]]]:
        """Symmetric (t+1)×(t+1) coefficient matrices, one per dealer,
        drawn exactly as ``BivarPoly.random`` does."""
        return [BivarPoly.random(self.t, seed_rng).coeffs for _ in self.node_ids]

    def _pow_matrix(self) -> List[List[int]]:
        """``POW[r][j] = (r+1)^j`` for r < n, j ≤ t (node r evaluates
        at x = r+1)."""
        out: List[List[int]] = []
        for r in range(self.n):
            x, acc = r + 1, 1
            row = []
            for _ in range(self.t + 1):
                row.append(acc)
                acc = acc * x % R
            out.append(row)
        return out

    # -- the run -----------------------------------------------------------

    def run(
        self,
        verify_honest: bool = True,
        wrong_row: Optional[Dict[Any, Set[Any]]] = None,
        wrong_value: Optional[Dict[Tuple[Any, Any], Set[Any]]] = None,
        coeffs: Optional[List] = None,
        engine: Optional[str] = None,
    ) -> DkgResult:
        """Run the DKG to readiness and generation.

        ``wrong_row``: dealer → receivers given a corrupted row
        (INVALID_PART on the dealer; the receiver refuses to ack).
        ``wrong_value``: (dealer, ack sender) → receivers given a
        corrupted value (INVALID_ACK on the sender; the receiver
        interpolates from other senders).  ``coeffs``: externally
        supplied dealing matrices.  ``engine``: ``"device"`` or
        ``"host"`` forces the dealing plane's engine for the clean
        elided mode; the default is :meth:`_device_auto`.  Verified or
        adversarial runs, and any run past :meth:`_device_capable`,
        take the host engine whatever the hint (the reference's
        routing).  Any other ``engine`` raises ValueError."""
        if engine not in (None, "host", "device"):
            raise ValueError(f"engine must be None, 'host' or 'device', not {engine!r}")
        self.last_phases = {}
        if self.mock:
            return self._run_mock()
        adversarial = bool(wrong_row or wrong_value)
        if (
            not verify_honest
            and not adversarial
            and engine != "host"
            and (engine == "device" or self._device_auto())
            and self._device_capable()
        ):
            return self._run_real_device(coeffs)
        if not NT.available():
            raise RuntimeError(
                "the real-BLS DKG requires the native library "
                "(hb_fr_matmul / hb_g2_mul_many)"
            )
        return self._run_real(verify_honest, wrong_row or {}, wrong_value or {}, coeffs)

    def _device_auto(self) -> bool:
        """The default route of the clean elided dealing: the device
        engine exactly when the DKG's device is a card (there the
        N = 1024 grids take seconds where the host takes hours); a CPU
        device takes the host engine, and tests opt in with
        ``engine="device"``."""
        return self.device.type == "cuda"

    def _device_capable(self) -> bool:
        """The device engine's contractions (k = t + 1) stay within the
        reference's bound ``_MAX_K``, as its routing requires; past it
        both auto and explicit routing take the host engine."""
        return self.t + 1 <= FR._MAX_K

    # -- mock ----------------------------------------------------------------

    def _run_mock(self) -> DkgResult:
        """The reference's mock dealing: one 256-bit seed a node from the
        rng, hashed into the group seed of a mock key set."""
        seeds = [self.rng.randrange(2**256).to_bytes(32, "big") for _ in self.node_ids]
        group = sha256(
            b"DKGGROUP"
            + b"".join(idx.to_bytes(4, "big") + seed for idx, seed in enumerate(seeds))
        )
        pk_set = M.MockPublicKeySet(group, self.t)
        shares = {nid: M.MockSecretKeyShare(group, i) for i, nid in enumerate(self.node_ids)}
        return DkgResult(pk_set, shares, FaultLog(), list(self.node_ids), 0, 0, 0)

    # -- the device dealing plane (clean elided mode) --------------------------

    def _words(self, vals: Sequence[int], *shape: int) -> torch.Tensor:
        """Ints as canonical Fr words on the device, shaped ``shape + (8,)``."""
        host = torch.from_numpy(FR.fr_to_words(vals)).reshape(*shape, FR.FR_WORDS)
        return host.to(self.device)

    def _run_real_device(self, coeffs) -> DkgResult:
        """The clean elided DKG with the dealing plane on ``device``:
        per dealer ``ROWS_d = POW[:2t+1]·C_d`` (all 2t + 1 rows, as the
        protocol's data plane deals them), ``VAL_d = ROWS_d[:t+1]·POWᵀ``,
        ``share_acc ← share_acc + λᵀ·VAL_d`` and
        ``row0_acc ← row0_acc + C_d[0]``, each one ``fr_matmul`` on words
        that stay on the device; the two accumulators come back once.

        Without ``coeffs``, each dealer's symmetric matrix is sampled on
        the device (48 random bytes a coefficient folded mod r,
        statistical distance < 2^-129 from uniform; the upper triangle
        mirrored, as the reference's ``step_sampled``) from a
        ``torch.Generator`` seeded by eight ``getrandbits(32)`` of the
        caller's rng — the reference's draws, so every later draw of a
        dynamic run stays aligned with its device engine.  The
        generator's state is 64 bits (a hash of the 256 drawn), as the
        reference's threefry key is: sampled dealing is for benchmarks
        and co-simulation; a deployment supplies host-drawn ``coeffs``.
        With ``coeffs``, shares and public key equal the host engine's
        (asserted in tests/test_torch_dkg.py)."""
        n, t = self.n, self.t
        tp1 = t + 1
        n_ackers = min(n, 2 * t + 1)
        n_valued = min(n, tp1)
        dev = self.device
        t0 = time.perf_counter()
        pow_rows = self._pow_matrix()
        POW = self._words([v for row in pow_rows[:n_ackers] for v in row], n_ackers, tp1)
        POWT = self._words([pow_rows[r][j] for j in range(tp1) for r in range(n)], tp1, n)
        LAM = self._words(lagrange_coefficients_at_zero(list(range(1, n_valued + 1))), 1, n_valued)
        ONE = self._words([1], 1, 1)
        share_acc = torch.zeros((1, n, FR.FR_WORDS), dtype=torch.int32, device=dev)
        row0_acc = torch.zeros((1, tp1, FR.FR_WORDS), dtype=torch.int32, device=dev)
        if coeffs is None:
            draws = b"".join(self.rng.getrandbits(32).to_bytes(4, "big") for _ in range(8))
            gen = torch.Generator(device=dev)
            gen.manual_seed(int.from_bytes(hashlib.sha256(draws).digest()[:8], "big"))
            idx = torch.arange(tp1, device=dev)
            upper = (idx[:, None] <= idx)[..., None]  # [t+1, t+1, 1]: j ≤ k

        for d in range(n):
            if coeffs is None:
                x = FR.sample_words(gen, tp1 * tp1).reshape(tp1, tp1, FR.FR_WORDS)
                c_d = torch.where(upper, x, x.transpose(0, 1)).contiguous()
            else:
                c_d = self._words([c for row in coeffs[d] for c in row], tp1, tp1)
            rows = FR.fr_matmul(POW, c_d)  # [2t+1, t+1]
            vals = FR.fr_matmul(rows[:n_valued], POWT)  # [t+1, n]
            share_acc = FR.fr_matmul(LAM, vals, share_acc)  # [1, n]
            row0_acc = FR.fr_matmul(ONE, c_d[:1], row0_acc)  # [1, t+1]
        share_vals = FR.words_to_fr(share_acc)
        pk_scalars = FR.words_to_fr(row0_acc)
        t0 = self._stamp("dealing", t0)

        pk_commit = Commitment([G2_GEN * s for s in pk_scalars])
        master_g1 = G1_GEN * pk_scalars[0]
        shares = {nid: T.SecretKeyShare(share_vals[r]) for r, nid in enumerate(self.node_ids)}
        self._stamp("generation", t0)
        return DkgResult(
            T.PublicKeySet(pk_commit, master_g1),
            shares,
            FaultLog(),
            list(self.node_ids),
            0,
            0,
            0,
            engine="device",
        )

    def _run_real(self, verify_honest, wrong_row, wrong_value, coeffs):
        n, t = self.n, self.t
        tp1 = t + 1
        faults = FaultLog()
        adversarial = bool(wrong_row or wrong_value)
        t0 = time.perf_counter()
        if coeffs is None:
            coeffs = self._dealer_coeffs(self.rng)
        pow_rows = self._pow_matrix()
        POW = _fr_bytes([v for row in pow_rows for v in row])  # [n, t+1]
        POWT = _fr_bytes([pow_rows[r][j] for j in range(tp1) for r in range(n)])
        C = [_fr_bytes([c for row in mat for c in row]) for mat in coeffs]
        # ack senders: every node when verifying or under adversaries;
        # the lowest 2t+1 under clean elision (values only for the
        # lowest t+1, the generation subset)
        if verify_honest or adversarial:
            n_ackers = n_valued = n
        else:
            n_ackers = min(n, 2 * t + 1)
            n_valued = min(n, tp1)
        ROWS: List[np.ndarray] = []
        VAL: List[np.ndarray] = []
        n_rowed = n if verify_honest else n_ackers
        for d in range(n):
            rows_d = NT.fr_matmul(POW[: n_rowed * tp1 * 32], C[d], n_rowed, tp1, tp1)
            ROWS.append(rows_d)
            VAL.append(NT.fr_matmul(rows_d[: n_valued * tp1 * 32], POWT, n_valued, tp1, n))
        t0 = self._stamp("dealing", t0)

        need_commit = (
            set(range(n))
            if verify_honest
            else {self.node_ids.index(d) for d in wrong_row}
            | {self.node_ids.index(d) for d, _ in wrong_value}
        )
        g2w = NT.g2_wire(G2_GEN)
        commit_wires = {d: NT.g2_mul_many_raw(g2w, C[d]) for d in sorted(need_commit)}
        t0 = self._stamp("commitments", t0)

        bad_rows: Set[Tuple[int, int]] = set()  # (dealer, receiver)
        for did, rs in wrong_row.items():
            d = self.node_ids.index(did)
            for rid in rs:
                bad_rows.add((d, self.node_ids.index(rid)))
        bad_vals: Set[Tuple[int, int, int]] = set()  # (dealer, sender, recv)
        for (did, sid), rs in wrong_value.items():
            d = self.node_ids.index(did)
            s = self.node_ids.index(sid)
            for rid in rs:
                if s >= n_valued:
                    raise ValueError("adversarial ack sender outside the valued set")
                bad_vals.add((d, s, self.node_ids.index(rid)))
        # a bad row perturbs what the receiver decrypted; a bad value
        # one ack cell (generation skips exactly these cells)
        for d, r in bad_rows:
            ROWS[d] = _bump(ROWS[d], r * tp1)
        for d, s, r in bad_vals:
            VAL[d] = _bump(VAL[d], s * n + r)
        self.last_dealing = Dealing(ROWS, VAL, commit_wires, n_ackers)

        row_checks = value_checks = msm_points = 0
        if verify_honest:
            ok, msm_points = self._fused_check(ROWS, VAL, commit_wires, n_ackers)
            row_checks = n * n
            value_checks = n * n_ackers * n
            if not ok:
                t0 = time.perf_counter()
                self._fallback_attribution(ROWS, VAL, commit_wires, faults)
                self._stamp("attribution", t0)
        else:
            # adversarial cells verified exactly, per item, against the
            # flagged dealer's commitment; honest cells are elided
            t0 = time.perf_counter()
            flagged_dealers: Set[int] = set()
            flagged_senders: Set[Tuple[int, int]] = set()
            for d, r in sorted(bad_rows):
                row_checks += 1
                row = _fr_ints(ROWS[d][r * tp1 * 32 : (r + 1) * tp1 * 32])
                if not self._check_row_item(commit_wires[d], row, r):
                    if d not in flagged_dealers:
                        flagged_dealers.add(d)
                        faults.add(self.node_ids[d], FaultKind.INVALID_PART)
            for d, s, r in sorted(bad_vals):
                value_checks += 1
                off = (s * n + r) * 32
                val = int.from_bytes(VAL[d][off : off + 32].tobytes(), "big")
                if not self._check_value_item(commit_wires[d], val, r, s):
                    if (d, s) not in flagged_senders:
                        flagged_senders.add((d, s))
                        faults.add(self.node_ids[s], FaultKind.INVALID_ACK)
            self._stamp("attribution", t0)

        # a receiver with a bad row refuses to ack that part
        acks: Dict[int, Set[int]] = {
            d: {s for s in range(n_ackers) if (d, s) not in bad_rows} for d in range(n)
        }
        complete = [d for d in range(n) if len(acks[d]) > 2 * t]
        if len(complete) <= t:
            raise RuntimeError("DKG not ready: too few complete parts")

        # generation (sync_key_gen.rs:396-409): pk commitment = Σ_d row-0
        # commitment; share_r = Σ_d interpolate₀(lowest t+1 valid values)
        t0 = time.perf_counter()
        pk_scalars = [sum(coeffs[d][0][k] for d in complete) % R for k in range(tp1)]
        pk_commit = Commitment([G2_GEN * s for s in pk_scalars])
        master_g1 = G1_GEN * (sum(coeffs[d][0][0] for d in complete) % R)
        lam_buf = _fr_bytes(lagrange_coefficients_at_zero(list(range(1, tp1 + 1))))
        share_acc = [0] * n
        for d in complete:
            d_bad = {(s, r) for dd, s, r in bad_vals if dd == d}
            if not d_bad:
                # senders 0..t for every receiver: one Fr matmul
                contrib = _fr_ints(NT.fr_matmul(lam_buf, VAL[d][: tp1 * n * 32], 1, tp1, n))
                for r in range(n):
                    share_acc[r] = (share_acc[r] + contrib[r]) % R
                continue
            vals_d = _fr_ints(VAL[d])  # [n_valued, n] flattened
            for r in range(n):
                pts = []
                for s in sorted(acks[d]):
                    if (s, r) in d_bad:
                        continue
                    if s >= n_valued:
                        break
                    pts.append((s + 1, vals_d[s * n + r]))
                    if len(pts) == tp1:
                        break
                if len(pts) <= t:
                    raise RuntimeError("not enough valid values to reconstruct a share")
                share_acc[r] = (share_acc[r] + interpolate_at_zero(pts)) % R
        shares = {nid: T.SecretKeyShare(share_acc[r]) for r, nid in enumerate(self.node_ids)}
        pk_set = T.PublicKeySet(pk_commit, master_g1)
        self._stamp("generation", t0)
        return DkgResult(
            pk_set,
            shares,
            faults,
            [self.node_ids[d] for d in complete],
            row_checks,
            value_checks,
            msm_points,
        )

    # -- the single fused verification MSM ---------------------------------

    def _coeff_stream(self, transcript: bytes, label: bytes, count: int) -> List[int]:
        return [
            int.from_bytes(sha256(transcript + label + i.to_bytes(4, "big"))[:12], "big") | 1
            for i in range(count)
        ]

    def _fused_terms(self, ROWS, VAL, commit_wires, n_ackers):
        """The fused equation's operands: the commitment-entry wires and
        their MSM scalars (the left side) and the Fr total T (the right
        side is T·P₂)."""
        n, tp1 = self.n, self.t + 1
        t0 = time.perf_counter()
        # the Fiat–Shamir transcript binds every commitment entry and
        # every row/value scalar the equation ranges over
        transcript = sha256(
            b"hbbft_tpu dkg fused v1"
            + b"".join(commit_wires[d].tobytes() for d in sorted(commit_wires))
            + b"".join(r.tobytes() for r in ROWS)
            + b"".join(v.tobytes() for v in VAL)
        )
        alpha = self._coeff_stream(transcript, b"a", n)
        gamma = self._coeff_stream(transcript, b"g", n)
        ck = self._coeff_stream(transcript, b"c", tp1)
        alpha2 = self._coeff_stream(transcript, b"A", n)
        beta = self._coeff_stream(transcript, b"b", n_ackers)
        gamma2 = self._coeff_stream(transcript, b"G", n)

        # u_j = Σ_r γ_r (r+1)^j, u'_j = Σ_r γ'_r (r+1)^j,
        # w'_k = Σ_s β_s (s+1)^k
        pow_cols = list(zip(*self._pow_matrix()))  # [t+1][n]
        u = [sum(g * p for g, p in zip(gamma, pow_cols[j])) % R for j in range(tp1)]
        u2 = [sum(g * p for g, p in zip(gamma2, pow_cols[j])) % R for j in range(tp1)]
        w2 = [
            sum(b * p for b, p in zip(beta, pow_cols[k][:n_ackers])) % R for k in range(tp1)
        ]
        # per entry (j, k) of dealer d: α_d·u_j·c_k + α'_d·u'_j·w'_k
        pts: List[bytes] = []
        scalars: List[int] = []
        for d in range(n):
            wires = commit_wires[d].tobytes()
            for j in range(tp1):
                for k in range(tp1):
                    e = j * tp1 + k
                    pts.append(wires[e * 192 : (e + 1) * 192])
                    scalars.append(
                        (alpha[d] * u[j] % R * ck[k] + alpha2[d] * u2[j] % R * w2[k]) % R
                    )
        t0 = self._stamp("transcript_scalars", t0)

        # T = Σ α_d γ_r c_k ROWS_d[r][k] + Σ α'_d β_s γ'_r VAL_d[s][r]
        gamma_buf, ck_buf = _fr_bytes(gamma), _fr_bytes(ck)
        beta_buf, gamma2_buf = _fr_bytes(beta), _fr_bytes(gamma2)
        total = 0
        for d in range(n):
            grc = NT.fr_matmul(NT.fr_matmul(gamma_buf, ROWS[d], 1, n, tp1), ck_buf, 1, tp1, 1)
            bv = NT.fr_matmul(beta_buf, VAL[d], 1, n_ackers, n)
            bvg = NT.fr_matmul(bv, gamma2_buf, 1, n, 1)
            total = (total + alpha[d] * _fr_ints(grc)[0] + alpha2[d] * _fr_ints(bvg)[0]) % R
        self._stamp("fr_side", t0)
        return pts, scalars, total

    def _fused_check(self, ROWS, VAL, commit_wires, n_ackers) -> Tuple[bool, int]:
        """ALL row checks + ALL value checks in one G2 MSM over the
        commitment entries; returns (verdict, MSM size)."""
        pts, scalars, total = self._fused_terms(ROWS, VAL, commit_wires, n_ackers)
        lhs_wire = self._g2_msm_wires(pts, scalars)
        t0 = time.perf_counter()
        rhs_wire = NT.g2_mul(NT.g2_wire(G2_GEN), total)
        self._stamp("rhs", t0)
        return lhs_wire == rhs_wire, len(pts)

    def _g2_msm_wires(self, pts: List[bytes], scalars: List[int]) -> bytes:
        """The fused check's G2 MSM, routed by size alone: at least
        ``G2_DEVICE_MIN`` entries on ``self.device``, fewer on the
        native host."""
        if len(pts) >= self.G2_DEVICE_MIN:
            return packed_msm.g2_msm_packed_wires(pts, scalars, self.device, self.last_phases)
        t0 = time.perf_counter()
        out = NT.g2_msm(pts, scalars)
        self._stamp("host_msm", t0)
        return out

    # -- exact per-item checks (sequential semantics) ----------------------

    def _entries(self, commit_wire: np.ndarray) -> List[bytes]:
        wires = commit_wire.tobytes()
        return [wires[e * 192 : (e + 1) * 192] for e in range((self.t + 1) ** 2)]

    def _powers(self, x: int) -> List[int]:
        out, acc = [], 1
        for _ in range(self.t + 1):
            out.append(acc)
            acc = acc * x % R
        return out

    def _check_row_item(self, commit_wire: np.ndarray, row_coeffs: List[int], r: int) -> bool:
        """Receiver r's row check (``sync_key_gen.rs:334``): for every
        column k, Σ_j C[j][k]·(r+1)^j == P₂·row_k."""
        tp1 = self.t + 1
        entries = self._entries(commit_wire)
        x_pows = self._powers(r + 1)
        g2w = NT.g2_wire(G2_GEN)
        for k in range(tp1):
            lhs = NT.g2_msm([entries[j * tp1 + k] for j in range(tp1)], x_pows)
            if lhs != NT.g2_mul(g2w, row_coeffs[k]):
                return False
        return True

    def _check_value_item(self, commit_wire: np.ndarray, val: int, r: int, s: int) -> bool:
        """The value check (``sync_key_gen.rs:449``):
        commit.evaluate(r+1, s+1) == P₂·val."""
        x_pows, y_pows = self._powers(r + 1), self._powers(s + 1)
        scal = [x * y % R for x in x_pows for y in y_pows]
        return NT.g2_msm(self._entries(commit_wire), scal) == NT.g2_mul(
            NT.g2_wire(G2_GEN), val
        )

    # -- fallback attribution ----------------------------------------------

    def _fused_check_dealer(self, d, ROWS, VAL, commit_wires) -> bool:
        """One dealer's row and value cells in one (t+1)²-point MSM with
        fresh Fiat–Shamir coefficients (the per-dealer tier)."""
        n, tp1 = self.n, self.t + 1
        rows_d, vals_d = ROWS[d], VAL[d]
        n_rowed = len(rows_d) // (tp1 * 32)
        n_valued = len(vals_d) // (n * 32)
        transcript = sha256(
            b"hbbft_tpu dkg dealer v1"
            + d.to_bytes(4, "big")
            + commit_wires[d].tobytes()
            + rows_d.tobytes()
            + vals_d.tobytes()
        )
        gamma = self._coeff_stream(transcript, b"g", n_rowed)
        ck = self._coeff_stream(transcript, b"c", tp1)
        beta = self._coeff_stream(transcript, b"b", n_valued)
        gamma2 = self._coeff_stream(transcript, b"G", n)
        pow_cols = list(zip(*self._pow_matrix()))
        u = [sum(g * p for g, p in zip(gamma, pow_cols[j][:n_rowed])) % R for j in range(tp1)]
        u2 = [sum(g * p for g, p in zip(gamma2, pow_cols[j])) % R for j in range(tp1)]
        w2 = [sum(b * p for b, p in zip(beta, pow_cols[k][:n_valued])) % R for k in range(tp1)]
        scalars = [(u[j] * ck[k] + u2[j] * w2[k]) % R for j in range(tp1) for k in range(tp1)]
        gr = NT.fr_matmul(_fr_bytes(gamma), rows_d, 1, n_rowed, tp1)
        grc = NT.fr_matmul(gr, _fr_bytes(ck), 1, tp1, 1)
        bv = NT.fr_matmul(_fr_bytes(beta), vals_d, 1, n_valued, n)
        bvg = NT.fr_matmul(bv, _fr_bytes(gamma2), 1, n, 1)
        total = (_fr_ints(grc)[0] + _fr_ints(bvg)[0]) % R
        return NT.g2_msm(self._entries(commit_wires[d]), scalars) == NT.g2_mul(
            NT.g2_wire(G2_GEN), total
        )

    def _fallback_attribution(self, ROWS, VAL, commit_wires, faults: FaultLog) -> None:
        """The fused equation failed: per-dealer fused checks first, then
        exact per-item checks only inside the failing dealers."""
        n, tp1 = self.n, self.t + 1
        for d in range(n):
            if self._fused_check_dealer(d, ROWS, VAL, commit_wires):
                continue
            rows_d = _fr_ints(ROWS[d])
            vals_d = _fr_ints(VAL[d])
            flagged_dealer = False
            for r in range(len(rows_d) // tp1):
                if not self._check_row_item(commit_wires[d], rows_d[r * tp1 : (r + 1) * tp1], r):
                    if not flagged_dealer:
                        flagged_dealer = True
                        faults.add(self.node_ids[d], FaultKind.INVALID_PART)
            flagged_senders: Set[int] = set()
            for s in range(len(vals_d) // n):
                for r in range(n):
                    if s in flagged_senders:
                        break
                    if not self._check_value_item(commit_wires[d], vals_d[s * n + r], r, s):
                        flagged_senders.add(s)
                        faults.add(self.node_ids[s], FaultKind.INVALID_ACK)


def _bump(buf: np.ndarray, cell: int) -> np.ndarray:
    """A copy of an Fr grid buffer with entry ``cell`` increased by one."""
    out = buf.copy()
    off = cell * 32
    cur = int.from_bytes(out[off : off + 32].tobytes(), "big")
    out[off : off + 32] = np.frombuffer(((cur + 1) % R).to_bytes(32, "big"), dtype=np.uint8)
    return out
