#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``hbbft_tpu_torch``) on one GPU.

Run from the repo root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvcc`` and a C++ compiler, and no network.
In order, and with no phase's failure caught:

1. **Build** — the native host library (``make -C native``) and every
   CUDA kernel of the port (``win_g1``, ``win_g2``, ``scan_g1``,
   ``ring_permute``, ``fr_matmul`` with ``fr_planes`` in one source, and
   ``cosim_step`` with ``cosim_hist`` in one source, ``sha256``,
   ``merkle_forest`` and ``gf_matmul``; one ``nvcc`` per source, all at
   once), with
   the build seconds and ``ptxas`` resource lines printed.
2. **Kernels against their plain versions** — at K = 1000 (not a
   multiple of 128) on random r-torsion points with identity rows and
   zero scalars: ``win_g1`` at 96- and 255-bit scalars, ``win_g2`` and
   ``scan_g1`` at 255 bits.  The three compute in Montgomery form and
   return canonical limbs: they must equal the plain PyTorch version on
   the card at canonical values (``canon`` of both, coordinate by
   coordinate, tolerance 0) and native ``hb_g1_mul`` / ``hb_g2_mul``
   canonically.  ``win_g1`` is then timed at the flush's shape (K =
   65,536, 96-bit scalars), and as four launches of 16,384 points on the
   four streams of a 4-shard mesh (equal to the single launch).
2b. **ring_permute against its plain version** — on a 4-shard mesh
   (shard j on card j % device_count), random int32 buffers of [64, 3,
   38] (the mesh flush's group partials) and [5, 3, 38] (not a whole
   number of 16-byte words per shard): byte equality, also with a long
   kernel queued on each shard's stream in turn.  With one card the
   cross-card leg is not run and a line says so.  One round's launch at
   the flush's message shape (the first card's senders: all four shards
   on one card) is timed against the library call that makes the same
   copies (``torch._foreach_copy_``), four ``Tensor.copy_`` calls and
   the plain version's round; the one-job ``ring_copy`` against one
   ``copy_``.  Each twice: 200 back-to-back calls paced by the host, and
   200 calls enqueued behind a ``torch.cuda._sleep`` so that they run
   back to back on the card's own timeline (the figures the ``kernels``
   line reports).  Then the whole ring step, paced by the host.
3. **The flush at full width** — N = 1024 validators × 64 fresh
   ciphertexts = 65,536 real BLS12-381 decryption shares per flush,
   settled by ``BatchingBackend(inner=CudaBackend()).prefetch`` three
   times: every share must verify, with no fallback, and ``win_g1``
   must have been launched.  Two more flushes with one corrupted share,
   at 1024 × 64 (rejected by the fused check on the card) and at
   1024 × 2 (a product below ``G1_PRODUCT_DEVICE_MIN``, on the host),
   must cache ``False`` for exactly that obligation.
3b. **The mesh flush at full width** — the same three batches through
   ``BatchingBackend(inner=CudaBackend(mesh=make_mesh(4))).prefetch``:
   4 shards of 16,384 points, the [64, 3, 38] group partials
   ring-reduced in 3 rounds.  Every flush must verify every share with
   no fallback, launch ``win_g1`` 4 times and ``ring_permute`` once per
   sending card a round (3 times on one card, 12 on four), leave the
   four shards' replicated sums the same points and give the
   single-device flush's verdicts; the corrupted 1024 × 64
   batch must be rejected on the card and attributed as the
   single-device flush attributed it.
3c. **The flat sharded MSM** — ``CudaBackend(mesh=make_mesh(4)).g1_msm``
   at K = 65,536 with 128-bit scalars (identity rows, zero scalars)
   must equal native ``hb_g1_msm``.
4. **The verified DKG** — ``VectorizedDkg(range(64), 21,
   Random(0xD6)).run(verify_honest=True)`` (``bench_dkg_verified``'s
   N = 128, t = 42 cut to half, as ``scripts/torch_dkg_walls.py`` keeps
   the whole): 30,976 commitment entries in one fused G2 MSM on the card,
   settling 4,096 row and 262,144 value checks.  It must log no
   fault, complete all 64 parts and launch ``win_g2``; t + 1 signature
   shares must combine and verify under the generated key set.  The
   same dealing with one row cell perturbed must make the fused check
   return False on the card.  ``win_g2`` is then timed once on the
   DKG's whole fused MSM, and once beside its plain version on the
   first 4,096 rows (``G2_PLAIN_ROWS``, cut from 16,384 for the time
   limit); the kernel must equal the plain version at
   canonical values on those rows and on the last 1,000 (the plain
   version takes about 0.6 ms a row).
4b. **The HoneyBadger epoch** — ``VectorizedHoneyBadgerSim`` end to end
   (threshold encryption, the batched reliable broadcast on the host,
   the array agreement, the decryption flush on the card, Lagrange
   combines, batch assembly).  (a) n = 64, real BLS, ``Random(0x64)``,
   ``verify_honest=True`` (``bench_hb_epoch64_real``'s shape with every
   one of the 4,096 shares verified): three epochs on ``CudaBackend()``
   — each batch equal to the contributions, 4,096 shares verified, no
   fault, one ``win_g1`` launch an epoch; a twin sim on the host
   ``CpuBackend()`` must give the same batch bytes, accepted set, fault
   log, coin flips, share count and agreement epochs; the same three
   epochs on ``CudaBackend(mesh=make_mesh(4))`` the same batches, with
   4 ``win_g1`` launches and one ``ring_permute`` launch a sending card
   a ring round each.  (b) N = 1024, real BLS, ``Random(0x1024)``, the
   last 50 nodes dead, ``verify_honest=True``, ``emit_minimal=False``
   (``bench_hb_1024_real``'s shape): the setup wall; a cold epoch
   carrying one forged decryption share from one live sender for one
   proposer — the fault log must name exactly that sender and the batch
   hold all 974 live contributions; then a warm honest epoch — its batch
   equal to the contributions, 974² shares verified, no fallback group —
   with its wall and phase walls, and its RBC wall split by work
   (``harness.rbc_probe.RbcProbe``: parity, decode and dead-row products,
   the backend's trees, the independent re-root), which also gives the
   parity product's shape to phase 7.  Each of the two launches ``win_g1``
   exactly once, no other EC, Fr or co-sim kernel, and each RBC kernel
   exactly as often as the backend's default size rules send the calls
   the probe saw to the card (a tree or a wave's forest of trees one
   ``merkle_forest``, a codec product one ``gf_matmul``: a warm wave
   three products and two forests; the same holds for every epoch and
   sequential run below).  ``win_g1`` is
   then timed once at that flush's shape (948,676 points, 96-bit
   scalars), its first and last 1,000 rows held against the plain
   version (the whole shape would take the plain version about a
   minute).
4c. **The era change at N = 1024** — (a) ``fr_matmul`` (the DKG's Fr
   products, ``ops/fr.py``: the ``fr_planes`` kernel lays each operand
   out as byte planes, the ``fr_matmul`` kernel multiplies them on the
   int8 tensor cores) against its plain version on the card, word for
   word (max |Δ| 0 at canonical values), and each operand's planes
   against ``fr_planes_plain`` byte for byte: random entries at one
   dealer's three shapes of the N = 1023 dealing (``[681, 341]·[341,
   341]``, ``[341, 341]·[341, 1023]`` and ``[1, 341]·[341, 1023]``, each
   with ``acc``), every entry r − 1 and every entry 2^256 − 1 at
   k = 971 (the bound ``fr_matmul`` takes), zeros, an odd
   ``[7, 5]·[5, 13]`` (the worst cases, zeros and the odd one also
   against Python), the tile's edges (m = 1, 2, 3 below a tile's 4 Fr
   rows; k = 1, 31, 32, 33, 352 around the 32-byte k-step; p = 257, not
   a multiple of a tile's 8 Fr columns) and ``sample_words``' fold
   ``[1, 2]·[2, 116281]``; then timed at the value-grid shape beside
   its plain version (the call, and the product kernel alone on the
   planes, each on the card's own timeline and with its share of the
   bound and of both counts), and ``fr_planes`` at the value grid's B
   side beside its plain version.  (b) The
   ``coeffs`` path: ``VectorizedDkg(range(64), 21, Random(0xD0))`` with
   ``_dealer_coeffs(Random(0xC0FFEE))`` on ``engine="device"`` must equal
   ``engine="host"`` (public key, commitment, every share) and launch
   ``fr_matmul``.  (c) The churn at ``bench_churn_1024``'s shape
   (``bench.py:2029``): ``VectorizedDynamicSim(1024, Random(0xC5),
   mock=False, verify_honest=False, emit_minimal=True)`` on
   ``CudaBackend()``; nodes 0..341 vote ``Remove(1023)``; the first
   epoch must return ``Complete(Remove(1023))`` with era 1 and 1023 gone,
   its DKG (t = 340) on the device engine; t + 1 signature shares of the
   new keys must combine and verify, 16 sampled nodes' commitment
   evaluations equal G2·share, and the next epoch commit all 1,023
   contributions; the path launches ``fr_matmul`` and no EC kernel.
   The setup wall, ``era_switch_s``, the DKG's wall and stage walls
   (dealing, generation, key rebuild) and ``next_epoch_s`` are printed.
4d. **scan_g1** — lies on no production path: its entry point
   ``scalar_mul_scan`` (the counterpart of ``scalar_mul_pallas``) is
   driven once at K = 65,536 × 255 bits and checked against native on a
   sample, then the kernel is timed there and, beside its plain version
   (checked against it), on its first 8,192 rows (``SCAN_TIME_K``, cut
   from 65,536 for the time limit).
5. **The sequential engines** — the protocol state machines on the
   port's ``TestNetwork``, every share check through
   ``BatchingBackend(inner=CudaBackend())``; a *forced* backend has
   ``G1_PRODUCT_DEVICE_MIN = G1_DEVICE_MIN = 1`` on its ``CudaBackend``
   instance alone, so every flush, however small, runs its G1 MSMs
   (``win_g1``) on the card, and its RBC size rules at their floor
   (``RBC_FLOOR``), so every codec product and every tree or hash batch
   of 8 or more uniform items runs on the card (``gf_matmul``,
   ``sha256``, ``merkle_forest``).  (a) QueueingHoneyBadger over
   DynamicHoneyBadger at the reference simulation's defaults (10 nodes,
   none dead, 1,000 transactions of 10 bytes, batch 100, ``Random(0)``,
   SilentAdversary with the RANDOM scheduler, real BLS) on a forced
   backend, then on an unforced one (the host): every transaction
   committed at every node, each epoch's batch byte-equal at every node
   and across the two runs, ``win_g1`` launched at least once a
   non-empty flush, no fallback; the wall, epochs, flushes, shares
   shipped and launches are printed.  (b) HoneyBadger at N = 16 with 5
   dead, real BLS, forced, every live node proposing up front: the first
   batch equals ``VectorizedHoneyBadgerSim``'s for the same
   contributions.  (c) One forged real decryption share (a random G1
   point, from a script-local adversary) checked in a flush, forced and
   on the host: both attribute the same ``INVALID_DECRYPTION_SHARE`` to
   the forger and commit the same batch; the forced flush falls back on
   the card's rejection.  (d) DynamicHoneyBadger at N = 4 with real BLS,
   forced and on the host: every validator votes ``Remove(0)``, then
   ``Add(0)`` with node 0's old key, each change running the on-chain
   DKG (DhbKeyGen over SyncKeyGen, signed votes and key-generation
   messages) and restarting the era under the new keys; every node must
   output both changes and commit every transaction, the batches must be
   byte-equal at every node and across the two runs, every node must
   hold the same new key set, every key share must sign under it and
   t + 1 of them combine and verify; ``win_g1`` launched at least once a
   non-empty flush, no fallback.  (e) The virtual-time simulator
   (``harness/simulation.simulate_queueing_honey_badger``) at the same
   defaults with 100 ms lag, 2,000 kbit/s and 100 % cpu: (i) mock crypto
   on the real clock through ``examples/torch_simulation.main`` — the
   reference's epoch table and epochs/s, every transaction committed at
   every live node; (ii) real BLS batched on a forced backend and (iii)
   real BLS unbatched on ``CudaBackend()``, both with 200 transactions
   (``SIM_REAL_TXS``, cut from 1,000 for the time limit) and under a step clock
   patched into the simulator's module (``StepClock``), so that their
   rows, table, message counts and every node's batches must be
   byte-equal; (ii) must launch ``win_g1`` at least once a non-empty
   flush with no fallback.  Their host walls (on the real clock),
   flushes, shares shipped and launches are printed.
6. **The packed co-simulation** — (a) ``cosim_step`` (the co-sim's
   whole step on one card, one cooperative launch, ``ops/cosim_step.py``)
   and ``cosim_hist`` (a mesh shard's zone histogram) against their plain
   versions on the card, byte for byte (the three int8 masks and the
   int32 commit column advanced in place):
   random columns at n = 100,003 (not a multiple of a block) with about
   1 % override rows and forged counts and a nonzero commit column, at
   Z = 1, 5 and 300 zones (300 is above the kernels' 256 shared-memory
   counters), their reach rows reaching a shuffled 1..Z zones so that
   the rows without an override come out definite-0, nondef and
   definite-1 (each class required, except definite-1 at Z = 1); the same
   through ``packed_cosim_step_fn`` on the 4-shard mesh (a ``cosim_hist``
   and a decision launch a shard, the [Z] partials ring-reduced by
   ``ring_permute``) against the one launch, with the same classes; then
   the tail shapes n = 0, 1, 15, 16, 17, 4,097 at Z = 5 and 257 (the one
   launch, ``cosim_hist`` and the mesh form called twice on one step
   function) and column views one row in (not 16-byte aligned) against
   the plain versions; then, at n = 100,000, Z = 5 on the card's
   timeline, the one-launch step, the mesh form's two kernels on one
   shard of the whole n, ``cosim_hist`` alone, ``index_add_`` and an
   empty ``<<<1, 32>>>`` kernel's launch (the floor), with the step's
   cooperative grid empty and crossing its grid barrier.  (b)
   ``bench_cosim``'s largest row: ``PackedHoneyBadgerCosim(100_000,
   Random(0xC053), wan=WanModel(seed=0xC052, DEFAULT_TOPOLOGY,
   LatencyModel("lognormal"), deadline_ms=400))``, the last 2,000 nodes
   dead, ``run_epoch_packed`` one cold and three warm epochs (init, walls,
   warm median epochs/s, accepted, coin flips, peak RSS, bytes a
   validator, the last step's phases); a ``device="cpu"`` twin and a
   ``make_mesh(4)`` twin must give the same accepted counts, coin flips
   and ``commit_counts()``; on one card the run launches one
   ``cosim_step`` an epoch and no ``cosim_hist``, on the mesh S of each
   and S − 1 ring rounds an epoch.  (c)
   ``bench_cosim``'s equivalence leg, cut from n = 1024 to 256 (its
   n = 1024 dict plane takes ~34 s; ``scripts/torch_cosim_walls.py``
   keeps it): ``VectorizedQueueingSim(256, Random(0xC051),
   batch_size=256, mock=True)`` on ``CudaBackend()`` against
   ``PackedQueueingCosim(256, Random(0xC051), batch_size=256)``, 512
   transactions, the last 30 dead, 2 epochs: batches, accepted
   sets, fault logs, coin flips and agreement epochs equal, rngs in
   lockstep; then test_cosim's WAN model (a partition window, a zone
   failure, pareto tails) at n = 64 for 4 epochs with one forger, the dict
   plane through ``wan=``.  (d) ``hw=HwQuality.from_flags(100, 2000,
   100)`` on the n = 64 real-BLS epoch (``Random(0x64)``,
   ``verify_honest=True``) on ``CudaBackend()``: it must launch
   ``win_g1``, its network terms must equal a ``CpuBackend()`` twin's,
   and ``total_s == network_s + cpu_s``; the account is printed.  (e)
   The n = 64 real-BLS epoch of 4b(a) (``Random(0x64)``,
   ``verify_honest=True``) under a ``DivergentSchedule``
   (``div_schedule``: the last f = 21 nodes equivocate with their Aux,
   class A = nodes 0..21 decides instance 32, whose broadcast reached
   only nodes 0..3 before the agreement, at agreement epoch 0 and class
   B = nodes 22..42 at epoch 1): three epochs on ``CudaBackend()`` — each
   batch equal to the contributions, no fault, ``class_epochs``
   {32: (0, 1)}, 64 × 43 = 2,752 shares verified (the equivocators are
   silent in the decryption, so the backend instance's product band is
   lowered to that count) in exactly one ``win_g1`` launch an epoch —
   and a ``CpuBackend()`` twin with the same batch bytes, accepted set,
   fault log, coin flips, share count, agreement and class epochs.
7. **The reliable-broadcast plane and the mesh's sharded programs** —
   (a) each new kernel against its plain version on the card, tolerance
   0, and against an independent host: ``sha256``'s two entries (the
   padded words, and the raw rows back to back from one byte into their
   buffer, padded by the kernel) against ``hashlib`` at messages of 0, 1,
   55, 56, 63, 64, 119, 120 and 47,672 bytes (the 1 MB broadcast's leaf
   message) at batches 1, 7 and 1,000 (the plain version once on the
   1,000, whose first rows are the smaller batches; the raw entry's
   plain padding equal to ``pad_messages``);
   ``merkle_levels_device`` (a forest of one) against
   ``MerkleTree.levels`` at 1, 2, 3, 11, 64 and 1,024 leaves (2-byte
   leaves; 47,663-byte ones up to 64), and ``merkle_forest`` against its
   plain version, every level and roots only, at those 2-byte trees, at
   the N = 1024 epoch's forests (974 and 1,948 trees of 1,024 2-byte
   leaves), at the 1 MB broadcast's 64 leaves of 47,663 bytes and at one
   tree of 4,097 leaves, above a block's shared memory;
   ``gf_matmul`` against its plain version and the native
   ``RS._matmul`` / ``_matmul16``: W = 8 at ``[42, 22] × [22, 47,663]``, a
   ``[22, 22]`` decode, 1, 3 and 4,097 columns, all-zero and all-0xFF
   data; W = 16 at the N = 1024 epoch's ``[682, 342] × [342, 974·L/2]``
   (L from phase 4b, printed), its ``[342, 342]`` decode, its wave's dead
   rows ``[50, 342] × [342, 974·L/2]`` and one proposer's ``[50, 342] ×
   [342, L/2]``.  (b) ``bench_broadcast_1mb``
   (config 3, ``bench.py:904-938``): 64 nodes, 21 silent,
   ``Random(0xB0).randbytes(1 << 20)`` broadcast by node 0 over the port's
   ``TestNetwork`` (``broadcast_1mb``), on a forced ``CudaBackend()`` and
   on ``CpuBackend()``: every good node outputs the payload, both
   deliver the same messages (count and a digest of their wire bytes),
   and the card run launches ``merkle_forest`` and ``gf_matmul`` at least
   once, each exactly as its rules sent (its trees hash their own leaves:
   no ``sha256``).  (d) The sharded programs of ``parallel/mesh.py`` on
   the 4-shard mesh at k = 64, 255-bit scalars (``mesh_programs_check``):
   G1 and G2 ``sharded_msm_fn``, ``sharded_windowed_g1_msm``,
   ``sharded_g1_msm`` and ``sharded_epoch_crypto_fn`` against native
   ``g1_multi_exp`` / ``g2_multi_exp`` and ``hashlib``, each launching
   the kernels it names once a shard.  (e) Each new kernel timed on the
   card's timeline at the shapes of (a) and (b), with its bound and its
   plain version's time; ``sha256`` also at 16,384 × 4,096 B (checked
   against ``hashlib``) and at a shard of the sharded epoch step, both
   entries, each shape with ``floor_ms`` (one warp's chain alone on a
   scheduler, :func:`sha_floor`).
8. **Report** — the ``kernels`` JSON line (launches counted per path:
   each path's counts are set to 0 just before it and read just after —
   the flush, the mesh flush, the DKG, the n = 64 epochs on the card
   (``epoch64``), on the mesh (``epoch64_mesh``) and the N = 1024
   epochs (``epoch1024``), phase 5's four forced runs (``seq_qhb``,
   ``seq_hb16``, ``seq_forged``, ``seq_churn``) and the simulator's
   forced run (``seq_sim``, with its flushes and shares in the row's
   ``seq_sim``) each on its own, and the divergent epochs
   (``epoch64_div``); ``launches`` is the N = 1024
   epochs' for ``win_g1``, the mesh epochs' for ``ring_permute``, the
   DKG's for ``win_g2``, the entry point's for ``scan_g1`` and the
   churn's (``churn1024``) for ``fr_matmul`` and ``fr_planes``, and
   ``launches_by_path`` lists every path's, ``fr_matmul``'s and
   ``fr_planes``' with ``fr_check`` and ``dkg_coeffs``; ``win_g2``'s row
   is timed
   on the DKG's first 4,096 rows and adds ``dkg_ms`` /
   ``dkg_bound_ms`` at its whole 30,976; ``win_g1``'s row is timed at
   the flush's 65,536 points and adds ``epoch_ms`` / ``epoch_bound_ms``
   at the N = 1024 epoch's 948,676; ``fr_matmul``'s is timed at the
   value-grid shape (its two ``fr_planes`` launches included; the
   product kernel alone in ``product_ms``), its bound the smaller of the
   word form's IMAD count and the limb form's int8 tensor-core count,
   and adds ``dealing_s`` / ``dealing_bound_ms`` for the churn's whole
   N = 1023 dealing; ``fr_planes``' is timed at the value grid's B side,
   bound by its bytes; ``cosim_step``'s is the one launch timed at
   n = 100,000, Z = 5, its ``launches`` the n = 100,000 scale run's on
   one card (``cosim100k``), ``launches_by_path`` with the mesh twin's
   (``cosim100k_mesh``) and the twins' (``cosim_twin``), its ``scale``
   the scale run's init, cold wall and warm epochs/s, and it adds the
   mesh form's two kernels (``mesh_pair_ms``), the launch floor
   (``floor_ms``), the step's grid empty and crossing its barrier
   (``grid_ms``, ``barrier_ms``); ``cosim_hist``'s is timed alone, its
   ``launches`` the mesh twin's, its library call one ``index_add_``;
   both bound by their bytes; ``merkle_forest`` and ``gf_matmul``'s
   ``launches`` are the forced 1 MB broadcast's, ``sha256``'s the sharded
   epoch step's on the mesh (7(d)),
   ``launches_by_path`` every path's, the epochs', the sequential runs'
   and the churn's included; ``sha256`` is timed at 1,000 × 47,672 B
   through its raw entry (every shape, the words entry's ``words_ms``
   too, in ``shapes``; the launches' 16 × 20 B shard among them),
   ``merkle_forest`` at the N = 1024 epoch's forest of 974 trees with
   every level (its bound ``forest_bound``), ``gf_matmul`` at the
   broadcast's W = 8 parity product with the N = 1024 epoch's W = 16 one
   in ``w16``, its library column ``torch._int_mm`` on the binary
   expansion's shape, which is not the same function; every other shape
   is in ``shapes``),
   the card's name and power limit, and the result line
   ``{"ok": true, "device": {...}}`` last.

Without a card, or outside a checkout of the repo, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import os
import random
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 0x5EED
N_NODES = 1024
GROUPS = 64
FLUSHES = 3
K_CHECK = 1000
K_TIME = N_NODES * GROUPS
TIME_REPS = 3
# cut from bench_dkg_verified's N = 128, t = 42 to keep the script inside
# its time limit with the sequential phase; scripts/torch_dkg_walls.py
# keeps N = 128
DKG_NODES = 64
DKG_T = 21
DKG_SEED = 0xD6
# win_g2's plain version is timed on this many of the DKG's rows (about
# 0.6 ms a row); cut from 16,384 for the script's time limit
G2_PLAIN_ROWS = 1 << 12
SCAN_BITS = 255
# scan_g1 is timed beside its plain version on this many of the entry
# point's rows (cut from 65,536 for the script's time limit; the kernel
# alone is also timed at 65,536)
SCAN_TIME_K = 1 << 13
MESH_SHARDS = 4
RING_ROWS = (GROUPS, 5)
RING_REPS = 200
# cycles the card sleeps while RING_REPS launches are enqueued behind it
# (~50 ms at the H100's 1.98 GHz boost clock)
RING_SLEEP_CYCLES = 100_000_000
FLAT_BITS = 128
EPOCH_NODES = 64
EPOCH_SEED = 0x64
EPOCH_RUNS = 3
BIG_NODES = 1024
BIG_SEED = 0x1024
BIG_DEAD = 50
CHURN_SEED = 0xC5
# the sequential engines: the reference simulation's defaults
# (examples/simulation.rs:33-52, bench.py's bench_sim_default)
SEQ_NODES = 10
SEQ_TXS = 1000
SEQ_TX_BYTES = 10
SEQ_BATCH = 100
SEQ_SEED = 0
SEQ_HB_NODES = 16
SEQ_HB_DEAD = 5
SEQ_HB_SEED = 0x16
SEQ_FORGE_NODES = 4
SEQ_FORGE_SEED = 0xF0
# the virtual-time simulator (phase 5(e)) at the same defaults, its clock
# a counter advancing this many seconds a read in the two real-BLS runs
SIM_ARGV = ("-n", str(SEQ_NODES), "-t", str(SEQ_TXS), "-b", str(SEQ_BATCH), "--lag", "100",
            "--bw", "2000", "--cpu", "100", "--tx-size", str(SEQ_TX_BYTES), "--seed", str(SEQ_SEED))
SIM_CLOCK_STEP = 0.000137
# the real-BLS pair (5(e)(ii) and (iii)) is cut from the defaults' 1,000
# transactions to this many: the unbatched run checks every share inline
# (a ~6 ms native pairing check each), 101.5 s at 1,000 on the H100's
# host, which put the whole script at 1,154 s of its 1,200 s limit
SIM_REAL_TXS = 200
# the divergent n = 64 epoch (phase 6(e)): the agreement instance whose
# broadcast reaches only nodes 0..3 before the agreement phase
DIV_INSTANCE = 32
DIV_LATE = frozenset(range(4))
# the real-BLS Remove(0) → Add(0) churn of tests/test_torch_seq_dynamic.py
SEQ_CHURN_NODES = 4
SEQ_CHURN_TXS = 4
SEQ_CHURN_SEED = 80
# fr_matmul / fr_planes launches timed on the card's timeline
FR_REPS = 10
# the packed co-simulation (phase 6): the step's check size (not a
# multiple of a block), its zone counts (300 is above the kernels' 256
# shared-memory zone counters) and its timed shape
COSIM_CHECK_N = 100_003
COSIM_ZS = (1, 5, 300)
# the tail shapes: no row, one row, 15, 16 and 17 rows (a partial 4-row
# chunk, whole chunks, one row past them) and a partial last block;
# Z = 257 takes a second 256-zone window
COSIM_TAIL_NS = (0, 1, 15, 16, 17, 4_097)
COSIM_TAIL_ZS = (5, 257)
COSIM_TIME_N = 100_000
COSIM_TIME_Z = 5
COSIM_REPS = 50
# bench_cosim's largest row (bench.py:2374-2453): 100,000 validators, the
# last 2 % dead (bench.py:2425), DEFAULT_TOPOLOGY's five zones under
# lognormal tails and a 400 ms deadline; one cold and three warm epochs
COSIM_N = 100_000
COSIM_DEAD = COSIM_N // 50
COSIM_SEED = 0xC053
COSIM_WAN_SEED = 0xC052
COSIM_WARM = 3
# bench_cosim's equivalence leg (bench.py:2455-2480), cut from n = 1024:
# there the dict plane took 16.6 + 17.2 s on the card's host, past the
# ~30 s this leg may take; scripts/torch_cosim_walls.py keeps n = 1024
COSIM_TWIN_N = 256
COSIM_TWIN_SEED = 0xC051
COSIM_TWIN_DEAD = 30
COSIM_TWIN_EPOCHS = 2
# the WAN twin at n = 64 (tests/test_cosim.py's model), one forger
COSIM_WAN_N = 64
COSIM_WAN_EPOCHS = 4
# bench_hb_1024_real's virtual-time profile (bench.py:1182): 100 ms lag,
# 2,000 kbit/s, 100 % cpu
HW_FLAGS = (100, 2000, 100)
# the step's nine columns in packed_cosim_step_fn's order (reach third
# from the front, params last)
COSIM_ROWS = ("prop_on", "dst_on", "zone", "ovr_mask", "ovr_c1", "forged_cnt", "commit")

# The reliable-broadcast plane (phase 7): SHA-256 message lengths (empty,
# one byte, the padding's edges at 55/56 and 63/64, the two-to-three-block
# edge at 119/120, and the 1 MB broadcast's leaf message 0x00 ‖ index ‖ a
# 47,663-byte shard) and batches; Merkle leaf counts
RBC_SEED = 0xBC
RBC_SHA_LENGTHS = (0, 1, 55, 56, 63, 64, 119, 120, 47_672)
RBC_SHA_BATCHES = (1, 7, 1000)
RBC_LEAVES = (1, 2, 3, 11, 64, 1024)
# Merkle forests (trees, leaves, bytes a leaf): the N = 1024 epoch's wave
# (974 proposers' commitments; twice that, a wave's two forests as one) and
# the 1 MB broadcast's tree
RBC_FORESTS = ((974, 1024, 2), (1948, 1024, 2), (1, 64, 47_663))
# one tree whose rows exceed a block's shared memory (csrc/merkle.cu keeps
# them in global memory)
RBC_BIG_LEAVES = 4097
# bench_broadcast_1mb (bench.py:904-938): 64 nodes, 21 of them silent, a
# 1 MB payload from Random(0xB0); 22 data shards of 47,663 bytes, 42 parity
BCAST_NODES = 64
BCAST_PAYLOAD = 1 << 20
BCAST_SEED = 0xB0
# the mesh's sharded programs: tests/test_parallel.py's inputs at
# full 255-bit scalars
MESH_K = 64
# the sha256 kernel's timed shapes (7(e)): 1,000 messages at every length,
# the 1 MB broadcast's 64 leaf messages, the N = 1024 epoch's 1,024 leaves
# of 11 bytes, a batch that fills the card (512 warps of 65-block
# messages, a point of scripts/torch_rbc_band.py's grid; checked against
# hashlib) and one shard of the sharded epoch step (7(d): 16 one-block
# lanes of 20 bytes)
SHA_FULL_SHAPE = (16_384, 4_096)
SHA_TIME_SHAPES = ([(max(RBC_SHA_BATCHES), n) for n in RBC_SHA_LENGTHS]
                   + [(BCAST_NODES, RBC_SHA_LENGTHS[-1]), (BIG_NODES, 11), SHA_FULL_SHAPE,
                      (MESH_K // MESH_SHARDS, 20)])
# kernel launches timed back to back on the card's timeline
RBC_REPS = 10

# The card's peak int32 multiply-add rate: the published fp32 rate of an
# H100 SXM (67 TFLOP/s = 2 flops per FMA lane-clock) halved for the
# FMA count, halved again because Hopper issues int32 on half as many
# lanes as fp32 (64 IMAD per clock per SM × 132 SMs × 1.98 GHz).
# Memory: 3.35 TB/s.
PEAK_IMAD_PER_S = 67e12 / 2 / 2
PEAK_BYTES_PER_S = 3.35e12
# NVLink between two cards of one host: 900 GB/s in all, 450 GB/s each way
NVLINK_BYTES_PER_S = 450e9
FQ_LIMBS = 38
# Multiply issue slots of one Fq product, a 12 × 32-bit Montgomery
# product, as the function needs them: the 144 products a_i·b_j and the
# 132 products m_i·p_j (j ≥ 1) need both halves of 32×32→64 bits (two
# IMAD slots, lo and hi); the 12 m_i = t_0·(−p⁻¹) mod 2^32 need the low
# half only, and the 12 m_i·p_0 the high half only (their low half
# cancels t_0): one slot each.  300 partial products, 576 slots.
FQ_MUL_SLOTS = 2 * (144 + 132) + 12 + 12
# a square a·a needs the 78 products a_i·a_j with i ≤ j (the cross terms
# doubled by a shift) in place of 144: 444 slots
FQ_SQR_SLOTS = 2 * (78 + 132) + 12 + 12
# Slots of one complete addition (RCB 2015 Alg. 7, 12 products) and of
# one doubling, the same formula with p == q, where six of the twelve
# products square (X·X, Y·Y, Z·Z, (X+Y)², (Y+Z)², (X+Z)²).  G2's products
# are over Fq2: a product is 3 Fq products (Karatsuba), a square 2
# ((a0 + a1)(a0 − a1) and a0·a1).
G1_ADD_SLOTS = 12 * FQ_MUL_SLOTS
G1_DBL_SLOTS = 6 * FQ_SQR_SLOTS + 6 * FQ_MUL_SLOTS
G2_ADD_SLOTS = 12 * 3 * FQ_MUL_SLOTS
G2_DBL_SLOTS = (6 * 2 + 6 * 3) * FQ_MUL_SLOTS
G1_POINT_BYTES = 3 * FQ_LIMBS * 4
G2_POINT_BYTES = 2 * G1_POINT_BYTES


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# main() keeps every line it logs here too, where a caller that keeps only
# the output's end finds the whole run
LOG_FILE = os.path.join("chiprun_out", "chip_smoke.log")
_log_open = False


def log(msg: str) -> None:
    print(msg, flush=True)
    if _log_open:
        with open(LOG_FILE, "a") as fh:
            fh.write(msg + "\n")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    ).stdout.strip()


def bound_ms(doublings: int, adds: int, g2: bool, nbytes: int):
    """The least time for ``doublings`` point doublings and ``adds``
    point additions on G1 (or G2), moving ``nbytes`` (each input read
    once, each output written once): the larger of the two.

    The operations are counted as the same work whatever implements
    them: each Fq product as the 32×32→64-bit partial products a 12-word
    Montgomery product needs (FQ_MUL_SLOTS, FQ_SQR_SLOTS: 300 partial
    products, some needing one half only), each doubling with its six
    squares, over the card's int32 multiply-add rate.  Additions,
    reductions and the 38-limb kernels' folds are not counted.  A kernel
    that multiplies less (Karatsuba on the integers, tensor-core
    products, a point formula with fewer products) would beat this
    count, and the bound would have to be recounted for it."""
    slots = doublings * (G2_DBL_SLOTS if g2 else G1_DBL_SLOTS)
    slots += adds * (G2_ADD_SLOTS if g2 else G1_ADD_SLOTS)
    ops_ms = slots / PEAK_IMAD_PER_S * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def windowed_bound(digits, g2: bool):
    """k·P by the 4-bit fixed window, for this run's msb-first digits
    ``[K, nwin]`` (a digit outside 0..15 selects the identity, as in the
    kernels): a row whose largest digit is m needs the table 2P..mP (one
    doubling, m − 2 adds), then from its first nonzero window on, 4
    doublings a later window and one add a later nonzero digit (the
    first loads its table entry).  A zero row needs nothing.  The
    kernels also double the identity in leading zero windows and add
    the identity for zero digits; that work is not needed and not
    counted."""
    d = digits.cpu().numpy()
    d = np.where((d < 0) | (d > 15), 0, d)
    k, nwin = d.shape
    nonzero = d != 0
    live = nonzero.any(axis=1)
    top = d.max(axis=1)
    first = nonzero.argmax(axis=1)
    doublings = np.where(live, 4 * (nwin - 1 - first) + (top >= 2), 0)
    adds = np.where(live, np.maximum(top - 2, 0) + nonzero.sum(axis=1) - 1, 0)
    pt = G2_POINT_BYTES if g2 else G1_POINT_BYTES
    return bound_ms(int(doublings.sum()), int(adds.sum()), g2, k * (2 * pt + 4 * nwin))


def ring_bound(nbytes: int, cross_card: bool):
    """One ring launch reads ``nbytes`` once and writes them once: over
    HBM on one card; across cards the write crosses NVLink one way."""
    hbm_ms = 2 * nbytes / PEAK_BYTES_PER_S * 1e3
    link_ms = nbytes / NVLINK_BYTES_PER_S * 1e3 if cross_card else 0.0
    return (max(hbm_ms, link_ms), "bytes")


def scan_bound(bits):
    """k·P by double-and-add needs, for this run's msb-first bits
    ``[K, nbits]``, bit_length − 1 doublings and popcount − 1 adds of P
    a nonzero scalar (the first set bit just loads P).  The kernel also
    computes the add on every zero bit and drops it; that work is not
    needed and not counted."""
    k, nbits = bits.shape
    set_bits = bits != 0
    popcount = set_bits.sum(axis=1)
    bit_length = np.where(popcount > 0, nbits - set_bits.argmax(axis=1), 0)
    doublings = int(np.maximum(bit_length - 1, 0).sum())
    adds = int(np.maximum(popcount - 1, 0).sum())
    return bound_ms(doublings, adds, False, k * (2 * G1_POINT_BYTES + 4 * nbits))


# The int8 tensor cores' dense rate: 1,979·10¹² operations/s, a
# multiply-add counted as two (989·10¹² multiply-adds/s).
PEAK_INT8_MAC_PER_S = 989e12
# Multiply issue slots of one Fr multiply-add in fr_matmul's form: 8 × 8
# partial products of 32 × 32 → 64 bits, both halves each.
FR_MAC_SLOTS = 2 * 8 * 8
# u8 limb products of one Fr multiply-add in a limb form on the int8
# tensor cores: the operands are < 2^256, 32 bytes, so 32 × 32 products
# (the reference's 33-limb form carries a 33rd limb that is 0 on these
# inputs).
FR_LIMB_MACS = 32 * 32


def fr_bound_macs(macs: int, nbytes: int):
    """The least time for ``macs`` Fr multiply-adds moving ``nbytes``: the
    operations counted two ways, as the IMAD slots of the 32-bit word
    form (the kernel's own arithmetic) and as the u8 products of the
    32-limb form on the int8 tensor cores; the smaller of the two is the
    card's least time for the work, the larger of that and the bytes the
    bound.  Returns (bound ms, "operations" or "bytes", IMAD ms, tensor
    ms).  Folds, carries and the final reduction are not counted."""
    imad_ms = macs * FR_MAC_SLOTS / PEAK_IMAD_PER_S * 1e3
    tc_ms = macs * FR_LIMB_MACS / PEAK_INT8_MAC_PER_S * 1e3
    ops_ms = min(imad_ms, tc_ms)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations", imad_ms, tc_ms
    return bytes_ms, "bytes", imad_ms, tc_ms


def fr_bound(m: int, k: int, p: int, acc: bool):
    """``fr_bound_macs`` for one [m, k]·[k, p] product (+ acc): m·k·p
    multiply-adds, each operand read once and the output written once,
    32 bytes an element."""
    nbytes = 32 * (m * k + k * p + m * p * (2 if acc else 1))
    return fr_bound_macs(m * k * p, nbytes)


# 32-bit integer operations of one SHA-256 compression as the function
# needs them on this card: 48 schedule words (σ0 and σ1, each two rotates
# as funnel shifts, a shift and one three-input xor: 4 ops; the four-term
# sum as 2 IADD3) and 64 rounds (Σ1 and Σ0: 4 each; ch and maj one LOP3
# each; t1's five-term sum 2 IADD3; a = t1 + Σ0 + maj one IADD3; e = d + t1
# one IADD), then 8 adds into the state: 1,384.
SHA_OPS_PER_BLOCK = 48 * (4 + 4 + 2) + 64 * (4 + 1 + 2 + 4 + 1 + 1 + 1) + 8
# The card's int32 issue rate for shifts, logical ops and adds: 64 lanes an
# SM a clock, as for IMAD (PEAK_IMAD_PER_S).
PEAK_INT32_OPS_PER_S = PEAK_IMAD_PER_S


def ops_or_bytes(ops: int, nbytes: int):
    """(bound ms, "operations" or "bytes"): the larger of ``ops`` 32-bit
    integer operations at the int32 issue rate and ``nbytes`` over HBM."""
    ops_ms = ops / PEAK_INT32_OPS_PER_S * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def sha_bound(batch: int, nblocks: int):
    """``batch`` messages of ``nblocks`` padded blocks: the compressions'
    operations, or the blocks read and the digests written."""
    return ops_or_bytes(batch * nblocks * SHA_OPS_PER_BLOCK, batch * (64 * nblocks + 32))


def sha_floor(nblocks: int) -> float:
    """The least ms of one message of ``nblocks`` blocks when its warp has a
    scheduler to itself: every compression's int32 operations, a 32-lane
    instruction two clocks, at the clock the int32 rate implies
    (``PEAK_INT32_OPS_PER_S`` over 132 SMs × 64 lanes).  A batch of at most
    528 warps cannot beat it, whatever its bound says."""
    return nblocks * SHA_OPS_PER_BLOCK * 2 / (PEAK_INT32_OPS_PER_S / (132 * 64)) * 1e3


def forest_bound(trees: int, leaves: int, length: int, roots_only: bool = False):
    """A forest of ``trees`` Merkle trees of ``leaves`` leaves of ``length``
    bytes: each leaf's compressions (0x00 ‖ index₈ ‖ value and its
    padding) and two a parent on every level, or the values read once and
    the rows written once (every level, or only the roots), the larger."""
    from hbbft_tpu_torch.ops.sha256 import level_sizes

    sizes = level_sizes(leaves)
    parents = sum(rows // 2 for rows in sizes[:-1])
    leaf_blocks = (9 + length + 72) // 64
    ops = trees * (leaves * leaf_blocks + 2 * parents) * SHA_OPS_PER_BLOCK
    out_bytes = trees * 32 * (1 if roots_only else sum(sizes))
    return ops_or_bytes(ops, trees * leaves * length + out_bytes)


def gf_bound(W: int, m: int, k: int, n: int):
    """An [m, k] GF(2^W) matrix times [k, n] symbols, the operations
    counted two ways: as the kernel's XOR-ANDs (one three-input logical op,
    y ^= mask & c, a bit of W, an (i, j) pair and a 32-bit lane of 32/W
    symbols; the masks' making is shared by the rows and not counted) at
    the int32 issue rate, and as the reference's binary-expansion product
    [W·m, W·k]·[W·k, n] on the int8 tensor cores (the parity and packing
    not counted).  The smaller is the card's least time for the work, the
    larger of that and the bytes (the matrix and the data read once, the
    output written once, W/8 bytes a symbol) the bound, as in
    :func:`fr_bound_macs`.  Returns (bound ms, "operations" or "bytes",
    XOR ms, tensor ms)."""
    lanes = -(-n * W // 32)
    xor_ms = W * m * k * lanes / PEAK_INT32_OPS_PER_S * 1e3
    tc_ms = (W * m) * (W * k) * n / PEAK_INT8_MAC_PER_S * 1e3
    ops_ms = min(xor_ms, tc_ms)
    bytes_ms = (m * k + k * n + m * n) * W // 8 / PEAK_BYTES_PER_S * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations", xor_ms, tc_ms
    return bytes_ms, "bytes", xor_ms, tc_ms


# ---------------------------------------------------------------------------
# The sequential engines (phase 5): runs over the port's TestNetwork,
# importable so that the CPU tests can run them at small sizes
# ---------------------------------------------------------------------------


def forced(backend):
    """``backend`` (a ``CudaBackend``) with its size bands opened on this
    instance alone: every G1 MSM of a flush, however small, runs on the
    card (the class values stay 2^12), and so does its reliable-broadcast
    plane, every rule at its floor (``RBC_FLOOR``: SHA-256 batches and
    trees of 8 or more uniform items, every codec product)."""
    backend.G1_PRODUCT_DEVICE_MIN = backend.G1_DEVICE_MIN = 1
    for name, value in backend.RBC_FLOOR.items():
        setattr(backend, name, value)
    return backend


def check_launches(what: str, launches: dict, sent: dict, ec: dict) -> None:
    """A path launched the EC, ring, Fr and co-sim kernels of ``ec`` (by
    name; absent names 0) exactly, and each RBC kernel exactly as often as
    the backend's size rules send the path's calls to the card (``sent``,
    an ``RbcProbe``'s)."""
    from hbbft_tpu_torch.ops.cuda_ec import RBC_KERNELS

    want = {k: sent[k] if k in RBC_KERNELS else ec.get(k, 0) for k in launches}
    if launches != want:
        fail(f"{what} launched {launches}, not {want}")


def check_rbc(what: str, launches: dict, sent: dict) -> None:
    """A run (counts reset just before it) launched each RBC kernel exactly
    as often as the size rules send its calls to the card (``sent``)."""
    from hbbft_tpu_torch.ops.cuda_ec import RBC_KERNELS

    if {k: launches[k] for k in RBC_KERNELS} != sent:
        fail(f"{what}: RBC launches {launches}, the size rules send {sent}")


def dhb_batch_bytes(batch) -> bytes:
    """A ``DhbBatch`` (not a wire type) as the ``dumps`` bytes of its
    fields: epoch, contributions, change, key set."""
    from hbbft_tpu_torch.core.serialize import dumps

    return dumps((batch.epoch, batch.contributions, batch.change, batch.pub_netinfo))


def seq_qhb_run(ops, nodes=SEQ_NODES, txs=SEQ_TXS, batch_size=SEQ_BATCH,
                tx_bytes=SEQ_TX_BYTES, seed=SEQ_SEED):
    """QueueingHoneyBadger over DynamicHoneyBadger on the port's
    ``TestNetwork`` (SilentAdversary, RANDOM scheduler, no dead node),
    the reference simulation's setup: ``txs`` random transactions of
    ``tx_bytes`` from ``Random(seed)``, every node starting with all of
    them queued, until every node has committed every one.  Real BLS,
    every share check through ``ops``; the network flushes them every
    ``nodes`` steps.  Returns the run's batches and counts."""
    from hbbft_tpu_torch.harness.network import MessageScheduler, SilentAdversary, TestNetwork
    from hbbft_tpu_torch.protocols.dynamic_honey_badger import DynamicHoneyBadger
    from hbbft_tpu_torch.protocols.queueing_honey_badger import QueueingHoneyBadger

    rng = random.Random(seed)
    all_txs = [bytes(rng.randrange(256) for _ in range(tx_bytes)) for _ in range(txs)]

    def new_algo(netinfo):
        node_rng = random.Random(f"sim-{netinfo.our_id}")
        dhb = DynamicHoneyBadger(netinfo, rng=node_rng)
        return (QueueingHoneyBadger.builder(dhb).batch_size(batch_size).rng(node_rng)
                .build_with_transactions(list(all_txs)))

    t0 = time.perf_counter()
    net = TestNetwork(
        nodes, 0, lambda adv: SilentAdversary(MessageScheduler(MessageScheduler.RANDOM, rng)),
        new_algo, rng, mock_crypto=False, ops=ops,
    )
    setup_s = time.perf_counter() - t0
    # each node's committed transactions, updated as its batches arrive
    missing = {nid: set(all_txs) for nid in net.nodes}
    seen = dict.fromkeys(net.nodes, 0)
    steps = 0
    t0 = time.perf_counter()
    while True:
        for nid, n in net.nodes.items():
            for b in n.outputs[seen[nid]:]:
                missing[nid].difference_update(b.tx_iter())
            seen[nid] = len(n.outputs)
        if not any(missing.values()):
            break
        if not net.any_busy():
            raise RuntimeError("the sequential QHB network went idle")
        net.step()
        steps += 1
    wall_s = time.perf_counter() - t0
    batches = {nid: [dhb_batch_bytes(b) for b in n.outputs] for nid, n in net.nodes.items()}
    return {"batches": batches, "steps": steps, "setup_s": setup_s, "wall_s": wall_s,
            "epochs": max(len(b) for b in batches.values())}


def seq_hb_first_batch(ops, nodes=SEQ_HB_NODES, dead=SEQ_HB_DEAD, seed=SEQ_HB_SEED):
    """Sequential HoneyBadger on the port's ``TestNetwork`` with the last
    ``dead`` nodes silent and every live node proposing up front (the
    shape of ``tests/test_epoch_vec.py``'s ``sequential_first_batch``);
    real BLS.  Returns the contributions and the first batch, which must
    be the same at every live node."""
    from hbbft_tpu_torch.harness.network import MessageScheduler, SilentAdversary, TestNetwork
    from hbbft_tpu_torch.protocols.honey_badger import HoneyBadger

    rng = random.Random(seed)
    net = TestNetwork(
        nodes - dead, dead, lambda adv: SilentAdversary(MessageScheduler(MessageScheduler.RANDOM, rng)),
        lambda ni: HoneyBadger(ni, rng=random.Random(f"{ni.our_id}-seq")), rng,
        mock_crypto=False, ops=ops,
    )
    contributions = {i: [b"seq-%d" % i] for i in range(nodes)}
    for nid in sorted(net.nodes):
        net.input(nid, contributions[nid])
    t0 = time.perf_counter()
    while not all(n.outputs for n in net.nodes.values()):
        if not net.any_busy():
            raise RuntimeError("the sequential HoneyBadger network went idle")
        net.step()
    wall_s = time.perf_counter() - t0
    first = [n.outputs[0] for n in net.nodes.values()]
    if any(b != first[0] for b in first):
        raise RuntimeError("live nodes disagree on the first batch")
    return contributions, first[0], wall_s


def seq_forged_share(ops, nodes=SEQ_FORGE_NODES, seed=SEQ_FORGE_SEED):
    """Sequential HoneyBadger, real BLS, one corrupted node: the first
    time an honest node holds epoch 0's ciphertexts, the corrupted node
    sends every validator a decryption share of a random G1 point for
    proposer 0,
    and the network flushes before any node handles it, so the forged
    share is checked in a flush.  Returns the first batch's bytes, every honest
    node's fault log and the forger's id."""
    from hbbft_tpu_torch.core.serialize import dumps
    from hbbft_tpu_torch.core.step import Target
    from hbbft_tpu_torch.crypto import fields as F
    from hbbft_tpu_torch.crypto import threshold as T
    from hbbft_tpu_torch.crypto.curve import G1_GEN
    from hbbft_tpu_torch.harness import network as N
    from hbbft_tpu_torch.protocols.honey_badger import (
        HbDecryptionShare, HoneyBadger, HoneyBadgerMessage)

    rng = random.Random(seed)

    class ForgedShareAdversary(N.Adversary):
        """A real-BLS decryption share that is a random G1 point
        (``BadShareAdversary`` forges mock shares only).  Until the
        network has flushed, no node is picked whose next message is the
        forged share, so it is checked in a flush, not inline."""

        def __init__(self):
            self.scheduler = N.MessageScheduler(N.MessageScheduler.RANDOM, rng)
            self.nodes, self.adv_ids = {}, []
            self.forged, self.flushed = None, False

        def init(self, all_nodes, adv_netinfos):
            self.nodes, self.adv_ids = all_nodes, sorted(adv_netinfos)

        def pick_node(self, nodes):
            if self.forged is not None and not self.flushed:
                later = {nid: n for nid, n in nodes.items() if n.queue and n.queue[0][1] is not self.forged}
                if later:
                    return self.scheduler.pick_node(later)
            return self.scheduler.pick_node(nodes)

        def push_message(self, sender_id, tm):
            pass

        def step(self):
            if self.forged is not None or not any(0 in n.algo.ciphertexts for n in self.nodes.values()):
                return []
            share = T.DecryptionShare(G1_GEN * rng.randrange(1, F.R))
            self.forged = HoneyBadgerMessage(0, HbDecryptionShare(0, share))
            # to the validators only: the observer handles what it is sent
            # at once, inline, and shares the validators' verdict cache
            return [N.MessageWithSender(self.adv_ids[0], Target.to(nid).message(self.forged))
                    for nid in sorted(self.nodes)]

    adversary = ForgedShareAdversary()
    net = N.TestNetwork(
        nodes - 1, 1, lambda adv: adversary,
        lambda ni: HoneyBadger(ni, rng=random.Random(f"{ni.our_id}-forge")), rng,
        mock_crypto=False, ops=ops,
    )
    for nid in sorted(net.nodes):
        net.input(nid, [b"forge-%d" % nid])
    while not all(n.outputs for n in net.nodes.values()):
        if not net.any_busy():
            raise RuntimeError("the forged-share network went idle")
        net.step()
        if adversary.forged is not None and not adversary.flushed:
            net.prefetch_crypto()
            adversary.flushed = True
    first = [dumps(n.outputs[0]) for n in net.nodes.values()]
    if any(b != first[0] for b in first):
        raise RuntimeError("honest nodes disagree on the first batch")
    faults = {nid: [f.compact() for f in n.faults] for nid, n in net.nodes.items()}
    return first[0], faults, adversary.adv_ids[0]


def seq_dhb_churn(ops, nodes=SEQ_CHURN_NODES, txs_per_node=SEQ_CHURN_TXS, seed=SEQ_CHURN_SEED):
    """DynamicHoneyBadger on the port's ``TestNetwork`` with real BLS:
    every validator votes ``Remove(0)``; once every node has output that
    change, the validators vote ``Add(0)`` with node 0's old key; the run
    ends when every node has output both changes and committed every
    transaction (the scenario of ``tests/test_torch_seq_dynamic.py``,
    whose two-sided runs use mock crypto).  Each change runs DhbKeyGen
    over SyncKeyGen with signed votes and key-generation messages, and
    the era restarts under the generated keys.  Raises if the nodes
    disagree on a batch or on the final key set, or if t + 1 shares of
    the final keys do not sign; returns every node's batches as bytes,
    the eras and the wall."""
    from hbbft_tpu_torch.core.serialize import dumps
    from hbbft_tpu_torch.harness.network import MessageScheduler, SilentAdversary, TestNetwork
    from hbbft_tpu_torch.protocols import change as C
    from hbbft_tpu_torch.protocols import dynamic_honey_badger as D

    rng = random.Random(seed)
    net = TestNetwork(
        nodes, 0, lambda adv: SilentAdversary(MessageScheduler(MessageScheduler.RANDOM, rng)),
        lambda ni: D.DynamicHoneyBadger(ni, rng=random.Random(f"dhb-{ni.our_id}")), rng,
        mock_crypto=False, ops=ops,
    )
    queues = {nid: [b"tx-%d-%d" % (nid, i) for i in range(txs_per_node)] for nid in net.nodes}
    all_txs = {tx for q in queues.values() for tx in q}
    first_pk_set = dumps(net.nodes[0].algo.netinfo.public_key_set)
    node0_pk = net.nodes[0].algo.netinfo.public_key(0)
    for nid in sorted(net.nodes):
        net.input(nid, D.ChangeInput(C.Remove(0)))

    def changed(node, cls):
        return any(isinstance(b.change, C.Complete) and isinstance(b.change.change, cls)
                   for b in node.outputs)

    def committed(node):
        return {tx for b in node.outputs for tx in b.tx_iter()}

    removed = added = False
    steps = 0
    t0 = time.perf_counter()
    while not (added and all(committed(n) >= all_txs for n in net.nodes.values())):
        steps += 1
        if steps > 200_000:
            raise RuntimeError(f"the real-BLS churn stalled (removed {removed}, added {added})")
        if not removed and all(changed(n, C.Remove) for n in net.nodes.values()):
            removed = True
            for nid in sorted(net.nodes):
                if net.nodes[nid].algo.netinfo.is_validator:
                    net.input(nid, D.ChangeInput(C.Add(0, node0_pk)))
        if not added and all(changed(n, C.Add) for n in net.nodes.values()):
            added = True
        if rng.random() < 0.2 or not net.any_busy():
            nid = rng.choice(sorted(net.nodes))
            node = net.nodes[nid]
            if node.algo.netinfo.is_validator and not node.algo.has_input():
                node.handle_input(D.UserInput([tx for tx in queues[nid] if tx not in committed(node)][:2]))
                msgs = list(node.messages)
                node.messages.clear()
                net.dispatch_messages(nid, msgs)
                continue
        if net.any_busy():
            net.step()
    wall_s = time.perf_counter() - t0
    batches = {nid: [dhb_batch_bytes(b) for b in n.outputs] for nid, n in net.nodes.items()}
    for bs in batches.values():
        for e, b in enumerate(bs):
            if any(other[e] != b for other in batches.values() if len(other) > e):
                raise RuntimeError(f"the real-BLS churn's nodes disagree on batch {e}")
    infos = [n.algo.netinfo for n in net.nodes.values()]
    pk_set = infos[0].public_key_set
    if any(dumps(ni.public_key_set) != dumps(pk_set) for ni in infos):
        raise RuntimeError("the real-BLS churn's nodes disagree on the final key set")
    if dumps(pk_set) == first_pk_set or not all(ni.is_validator for ni in infos):
        raise RuntimeError("the real-BLS churn did not end under new keys with node 0 back")
    msg = b"era %d" % net.nodes[0].algo.start_epoch
    shares = {ni.our_index: ni.secret_key_share.sign(msg) for ni in infos}
    for i, share in shares.items():
        if not pk_set.public_key_share(i).verify_signature_share(share, msg):
            raise RuntimeError(f"the real-BLS churn: node {i}'s new key share does not sign")
    signers = sorted(shares)[: pk_set.threshold + 1]
    sig = pk_set.combine_signatures({i: shares[i] for i in signers})
    if not pk_set.verify_signature(sig, msg) or pk_set.verify_signature(sig, msg + b"!"):
        raise RuntimeError("the real-BLS churn: t + 1 shares of the new keys do not combine")
    return {"batches": batches, "eras": sorted({n.algo.start_epoch for n in net.nodes.values()}),
            "epochs": max(len(b) for b in batches.values()), "steps": steps, "wall_s": wall_s}


def sequential_phase() -> dict:
    """Phase 5 (see the module docstring); fails the script on any
    mismatch.  Returns each forced run's launch counts by path."""
    from hbbft_tpu_torch.core.serialize import dumps as wire_dumps
    from hbbft_tpu_torch.harness.batching import BatchingBackend
    from hbbft_tpu_torch.harness.epoch import VectorizedHoneyBadgerSim
    from hbbft_tpu_torch.harness.rbc_probe import RbcProbe
    from hbbft_tpu_torch.ops import cuda_ec
    from hbbft_tpu_torch.ops.backend_cuda import CudaBackend

    def seq_backend(force: bool):
        inner = CudaBackend()
        return BatchingBackend(inner=forced(inner) if force else inner)

    def seq_run(run, be, what: str, ec=None):
        """``run(be)`` with the counts set to 0 just before it; its launches
        are read just after, and with ``ec`` (an unforced run) must be those
        EC kernels and the RBC kernels its size rules send to the card."""
        cuda_ec.reset_launches()
        with RbcProbe(be.inner) as probe:
            out = run(be)
        launches = dict(cuda_ec.LAUNCHES)
        if ec is None:
            check_rbc(what, launches, probe.sent)
        else:
            check_launches(what, launches, probe.sent, ec)
        return out, launches

    # (a) QHB over DHB at the reference simulation's defaults, on a forced
    # backend (every flush's G1 MSMs on the card), then on the host
    be = seq_backend(True)
    qhb, seq_qhb_launches = seq_run(seq_qhb_run, be, "sequential QHB (forced)")
    qhb_stats = be.stats
    be_host = seq_backend(False)
    qhb_host, _ = seq_run(seq_qhb_run, be_host, "the unforced sequential QHB run", {})
    for batches in qhb["batches"].values():
        for e, b in enumerate(batches):
            if any(bs[e] != b for bs in qhb["batches"].values() if len(bs) > e):
                fail(f"sequential QHB: nodes disagree on epoch {e}'s batch")
    if qhb["batches"] != qhb_host["batches"] or len(qhb["batches"]) != SEQ_NODES:
        fail("sequential QHB: the forced run's batches differ from the host run's")
    if qhb_stats.fallback_groups != 0 or be_host.stats.fallback_groups != 0:
        fail(f"sequential QHB fell back: {qhb_stats} / {be_host.stats}")
    if qhb_stats.flushes < 1 or seq_qhb_launches["win_g1"] < qhb_stats.flushes:
        fail(f"sequential QHB: {qhb_stats.flushes} non-empty flushes but launches {seq_qhb_launches}")
    log(
        f"sequential QHB N={SEQ_NODES} txs={SEQ_TXS}x{SEQ_TX_BYTES}B batch={SEQ_BATCH} real BLS: "
        f"every tx committed at every node in {qhb['epochs']} epochs, {qhb['steps']} steps; "
        f"forced backend {qhb['wall_s']} s wall (setup {qhb['setup_s']} s), host backend "
        f"{qhb_host['wall_s']} s; batches byte-equal; {qhb_stats.flushes} non-empty flushes "
        f"shipping {qhb_stats.prefetched} shares ({qhb_stats.cache_hits} cache hits, "
        f"{qhb_stats.cache_misses} inline checks); launches {seq_qhb_launches}"
    )

    # (b) HoneyBadger at N = 16 with 5 dead against the vectorized epoch
    be = seq_backend(True)
    (contributions, seq_batch, hb16_s), seq_hb16_launches = seq_run(
        seq_hb_first_batch, be, "sequential HoneyBadger N=16 (forced)")
    live = set(range(SEQ_HB_NODES - SEQ_HB_DEAD))
    sim = VectorizedHoneyBadgerSim(SEQ_HB_NODES, random.Random(SEQ_HB_SEED + 1))
    vec = sim.run_epoch({i: c for i, c in contributions.items() if i in live},
                        dead=set(range(SEQ_HB_NODES)) - live)
    if wire_dumps(seq_batch) != wire_dumps(vec.batch) or set(vec.accepted) != live:
        fail("sequential HoneyBadger N=16: the first batch differs from the vectorized epoch's")
    if (be.stats.fallback_groups != 0 or be.stats.flushes < 1
            or seq_hb16_launches["win_g1"] < be.stats.flushes):
        fail(f"sequential HoneyBadger N=16: {be.stats}, launches {seq_hb16_launches}")
    log(
        f"sequential HoneyBadger N={SEQ_HB_NODES} dead={SEQ_HB_DEAD} real BLS: first batch "
        f"({len(seq_batch.contributions)} contributions) equal to VectorizedHoneyBadgerSim's, "
        f"{hb16_s} s; {be.stats}; launches {seq_hb16_launches}"
    )

    # (c) one forged real decryption share, forced and on the host
    be = seq_backend(True)
    (forged_batch, forged_faults, forger), seq_forged_launches = seq_run(
        seq_forged_share, be, "forged share (forced)")
    be_host = seq_backend(False)
    host_batch, host_faults, _ = seq_forged_share(be_host)
    named = [f for fs in forged_faults.values() for f in fs]
    if not named or set(named) != {f"{forger!r}:INVALID_DECRYPTION_SHARE"}:
        fail(f"forged share: faults {forged_faults}")
    if forged_faults != host_faults or forged_batch != host_batch:
        fail("forged share: the forced run's faults or batch differ from the host run's")
    if be.stats.fallback_groups < 1 or seq_forged_launches["win_g1"] < 1:
        fail(f"forged share: not rejected by a flush on the card ({be.stats}, "
             f"launches {seq_forged_launches})")
    log(
        f"sequential forged share N={SEQ_FORGE_NODES}: attributed as {sorted(set(named))} on the "
        f"card and on the host alike, same batch; {be.stats}; launches {seq_forged_launches}"
    )

    # (d) the real-BLS Remove(0) → Add(0) churn, forced and on the host
    be = seq_backend(True)
    churn, seq_churn_launches = seq_run(seq_dhb_churn, be, "real-BLS churn (forced)")
    be_host = seq_backend(False)
    churn_host, _ = seq_run(seq_dhb_churn, be_host, "the unforced real-BLS churn", {})
    if churn["batches"] != churn_host["batches"] or churn["eras"] != churn_host["eras"]:
        fail("real-BLS churn: the forced run's batches differ from the host run's")
    if churn["eras"][0] < 1 or be.stats.fallback_groups != 0:
        fail(f"real-BLS churn: eras {churn['eras']}, {be.stats}")
    if be.stats.flushes < 1 or seq_churn_launches["win_g1"] < be.stats.flushes:
        fail(f"real-BLS churn: {be.stats.flushes} non-empty flushes but launches {seq_churn_launches}")
    log(
        f"sequential real-BLS DHB churn N={SEQ_CHURN_NODES} Remove(0) → Add(0): both changes "
        f"output at every node, every tx committed, {churn['epochs']} batches byte-equal at every "
        f"node and forced vs host, era {churn['eras']}, new keys sign and verify; {churn['steps']} "
        f"steps; forced backend {churn['wall_s']} s wall, host backend {churn_host['wall_s']} s; "
        f"{be.stats}; launches {seq_churn_launches}"
    )
    return {"seq_qhb": seq_qhb_launches, "seq_hb16": seq_hb16_launches,
            "seq_forged": seq_forged_launches, "seq_churn": seq_churn_launches}


# ---------------------------------------------------------------------------
# The virtual-time simulator (phase 5(e)) and the divergent epoch (phase
# 6(e)): importable so that the CPU tests can run them at small sizes
# ---------------------------------------------------------------------------


class StepClock:
    """A ``time`` stand-in for the simulator's module: ``perf_counter``
    advances ``step`` seconds a read, so a run's virtual times do not
    depend on how long its handlers took."""

    def __init__(self, step: float = SIM_CLOCK_STEP):
        self.t = 0.0
        self.step = step

    def perf_counter(self) -> float:
        self.t += self.step
        return self.t


def sim_cli():
    """``examples/torch_simulation.py`` as a module (``examples/`` is not
    a package)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent / "examples" / "torch_simulation.py"
    spec = importlib.util.spec_from_file_location("torch_simulation", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sim_real_run(ops, nodes=SEQ_NODES, txs=SEQ_TXS, batch_size=SEQ_BATCH,
                 tx_bytes=SEQ_TX_BYTES, seed=SEQ_SEED) -> dict:
    """``simulate_queueing_honey_badger`` with real BLS on ``ops``, under
    a :class:`StepClock` patched into the port's simulator module.
    Returns its rows, table, message counts, every node's outputs as
    bytes with their virtual times, the committed transactions, the
    simulated seconds and the host wall (measured on the real clock)."""
    import hbbft_tpu_torch.harness.simulation as PS

    real = PS._time
    PS._time = StepClock()
    t0 = time.perf_counter()
    try:
        stats, _, sim_s = PS.simulate_queueing_honey_badger(
            num_nodes=nodes, num_txs=txs, batch_size=batch_size, tx_size=tx_bytes,
            rng=random.Random(seed), mock_crypto=False, ops=ops)
    finally:
        PS._time = real
    host_s = time.perf_counter() - t0
    net = stats.network
    return {
        "rows": stats.rows_as_dicts(),
        "table": [stats.format_row(r) for r in stats.rows],
        "messages": (net.message_count(), net.message_size()),
        "outputs": {nid: [(t, dhb_batch_bytes(b)) for t, b in n.outputs] for nid, n in net.nodes.items()},
        "committed": len(stats.committed_txs()),
        "sim_s": sim_s,
        "host_s": host_s,
    }


def simulator_phase() -> dict:
    """Phase 5(e) (see the module docstring); fails the script on any
    mismatch.  Returns the forced run's launches, flushes and shares."""
    from hbbft_tpu_torch.harness.batching import BatchingBackend
    from hbbft_tpu_torch.harness.rbc_probe import RbcProbe
    from hbbft_tpu_torch.ops import cuda_ec
    from hbbft_tpu_torch.ops.backend_cuda import CudaBackend

    # (i) mock crypto on the real clock, through the CLI
    t0 = time.perf_counter()
    mock = sim_cli().main(list(SIM_ARGV))
    cli_s = time.perf_counter() - t0
    if mock["committed"] != SEQ_TXS:
        fail(f"simulator (mock): {mock['committed']} of {SEQ_TXS} transactions committed")
    log(f"simulator mock N={SEQ_NODES} txs={SEQ_TXS}x{SEQ_TX_BYTES}B batch={SEQ_BATCH} through "
        f"examples/torch_simulation.py: {mock['epochs']} epochs, every tx committed at every live "
        f"node; wall {mock['wall_s']} s ({mock['epochs'] / mock['wall_s']} epochs/s), simulated "
        f"{mock['sim_s']} s; the CLI call {cli_s} s")

    # (ii) real BLS, batched, every flush's G1 aggregate forced onto the card
    be = BatchingBackend(inner=forced(CudaBackend()))
    cuda_ec.reset_launches()
    with RbcProbe(be.inner) as probe:
        batched = sim_real_run(be, txs=SIM_REAL_TXS)
    launches = dict(cuda_ec.LAUNCHES)
    # (iii) real BLS, unbatched: every share checked inline
    before = dict(cuda_ec.LAUNCHES)
    unbatched = sim_real_run(CudaBackend(), txs=SIM_REAL_TXS)
    inline_launches = {k: cuda_ec.LAUNCHES[k] - before[k] for k in before}
    check_rbc("simulator (real, batched, forced)", launches, probe.sent)
    if be.stats.fallback_groups != 0:
        fail(f"simulator (real, batched) fell back: {be.stats}")
    if be.stats.flushes < 1 or launches["win_g1"] < be.stats.flushes:
        fail(f"simulator (real, batched): {be.stats.flushes} non-empty flushes but launches {launches}")
    for what, run in (("batched", batched), ("unbatched", unbatched)):
        if run["committed"] != SIM_REAL_TXS:
            fail(f"simulator (real, {what}): {run['committed']} of {SIM_REAL_TXS} transactions committed")
    for key in ("rows", "table", "messages", "outputs", "sim_s"):
        if batched[key] != unbatched[key]:
            fail(f"simulator (real): the batched run's {key} differ from the unbatched run's")
    epochs = len(batched["rows"])
    log("simulator real BLS epoch table (batched and unbatched alike):\n" + "\n".join(batched["table"]))
    log(f"simulator real BLS N={SEQ_NODES} txs={SIM_REAL_TXS}: {epochs} epochs, simulated "
        f"{batched['sim_s']} s under the step clock; rows, batches and messages "
        f"{batched['messages']} byte-equal batched vs unbatched; host wall batched on a forced "
        f"backend {batched['host_s']} s ({epochs / batched['host_s']} epochs/s), unbatched "
        f"{unbatched['host_s']} s ({epochs / unbatched['host_s']} epochs/s); {be.stats.flushes} "
        f"non-empty flushes shipping {be.stats.prefetched} shares ({be.stats.cache_hits} cache hits, "
        f"{be.stats.cache_misses} inline checks); launches batched {launches}, unbatched "
        f"{inline_launches}")
    return {"launches": launches, "flushes": be.stats.flushes, "shares": be.stats.prefetched,
            "epochs": epochs, "batched_s": batched["host_s"], "unbatched_s": unbatched["host_s"],
            "mock_epochs_per_s": mock["epochs"] / mock["wall_s"]}


def div_schedule(E, n: int, instance):
    """A ``DivergentSchedule`` of epoch module ``E`` for an n-node epoch
    whose instance ``instance`` starts with only nodes ``DIV_LATE``
    estimating true: the last f nodes equivocate (true to class A, false
    to class B, with their Aux); A = the first max(N − 2f, f + 1) correct
    nodes counts an N − f true Aux prefix and decides at agreement
    epoch 0; B, the other correct nodes, counts every false Aux it can
    see and the true ones it needs, continues, and decides at epoch 1 on
    A's f + 1 Terms.  At n = 11 this is tests/test_epoch_vec.py's
    ``TestMultiEpochDivergence`` schedule."""
    f = (n - 1) // 3
    honest = n - f
    size_a = max(honest - f, f + 1)
    a, b = frozenset(range(size_a)), frozenset(range(size_a, honest))
    if instance not in b or not DIV_LATE <= a:
        fail(f"div_schedule: instance {instance} or the late subset does not fit n = {n}")
    return E.DivergentSchedule(
        classes=(a, b),
        equiv={e: (True, False) for e in range(honest, n)},
        equiv_aux=True,
        directives={0: (
            E.ClassDirective(withhold=False, aux_counted=((True, honest),)),
            E.ClassDirective(withhold=True, aux_counted=((False, len(b) + f), (True, honest - len(b) - f))),
        )},
        instances=frozenset({instance}),
    )


def divergent_epochs(sim, n: int, runs: int, instance=DIV_INSTANCE) -> list:
    """``runs`` epochs of ``sim`` (n nodes, every node proposing) under
    :func:`div_schedule`; each must commit every contribution with the
    instance's two classes deciding at agreement epochs 0 and 1 and no
    fault.  Returns each epoch's outcome, comparable with ``==``, and
    its wall."""
    from hbbft_tpu_torch.core.serialize import dumps
    from hbbft_tpu_torch.harness import epoch as E

    contribs = {i: [b"div-%d" % i] for i in range(n)}
    sched = div_schedule(E, n, instance)
    outs = []
    for e in range(runs):
        t0 = time.perf_counter()
        res = sim.run_epoch(contribs, late_subset={instance: set(DIV_LATE)}, div_schedule=sched)
        wall = time.perf_counter() - t0
        if not res.diverged or res.class_epochs != {instance: (0, 1)}:
            fail(f"divergent epoch {e}: diverged {res.diverged}, class epochs {res.class_epochs}")
        if res.batch.contributions != contribs or not res.fault_log.is_empty():
            fail(f"divergent epoch {e}: batch of {len(res.batch.contributions)}, faults {res.fault_log}")
        outs.append(((dumps(res.batch), res.accepted, [(f.node_id, f.kind.name) for f in res.fault_log],
                      res.coin_flips, res.shares_verified, res.agreement_epochs, res.class_epochs), wall))
    return outs


def divergent_phase() -> dict:
    """Phase 6(e) (see the module docstring): the n = 64 real-BLS epoch
    of phase 4b(a) under :func:`div_schedule`, on the card and on the
    host.  Its f equivocators are silent in the decryption phase, so the
    epoch verifies 64 × 43 = 2,752 shares, below the class's 2^12
    product band: this backend instance's band is the epoch's share
    count, so that the flush takes the card.  Fails the script on any
    mismatch; returns the card path's launches."""
    from hbbft_tpu_torch.crypto.backend import CpuBackend
    from hbbft_tpu_torch.harness.epoch import VectorizedHoneyBadgerSim
    from hbbft_tpu_torch.harness.rbc_probe import RbcProbe
    from hbbft_tpu_torch.ops import cuda_ec
    from hbbft_tpu_torch.ops.backend_cuda import CudaBackend

    div_f = (EPOCH_NODES - 1) // 3
    div_shares = EPOCH_NODES * (EPOCH_NODES - div_f)
    div_ops = CudaBackend()
    div_ops.G1_PRODUCT_DEVICE_MIN = div_shares
    cuda_ec.reset_launches()
    t0 = time.perf_counter()
    sim = VectorizedHoneyBadgerSim(EPOCH_NODES, random.Random(EPOCH_SEED), verify_honest=True, ops=div_ops)
    setup_s = time.perf_counter() - t0
    card = []
    for e in range(EPOCH_RUNS):
        before = dict(cuda_ec.LAUNCHES)
        with RbcProbe(div_ops, sim) as probe:
            card += divergent_epochs(sim, EPOCH_NODES, 1)
        launches = {k: cuda_ec.LAUNCHES[k] - before[k] for k in before}
        check_launches(f"divergent epoch {e}", launches, probe.sent, {"win_g1": 1})
        if card[-1][0][4] != div_shares:
            fail(f"divergent epoch {e} verified {card[-1][0][4]} shares, not {div_shares}")
    if sim.be.stats.fallback_groups:
        fail(f"divergent epochs fell back: {sim.be.stats}")
    launches = dict(cuda_ec.LAUNCHES)
    host_sim = VectorizedHoneyBadgerSim(EPOCH_NODES, random.Random(EPOCH_SEED), verify_honest=True,
                                        ops=CpuBackend())
    host = divergent_epochs(host_sim, EPOCH_NODES, EPOCH_RUNS)
    if [o for o, _ in card] != [o for o, _ in host]:
        fail("the divergent n = 64 epochs on the card and on the host differ")
    log(f"divergent epoch n={EPOCH_NODES} real BLS ({div_f} equivocators; the classes decide instance "
        f"{DIV_INSTANCE} at agreement epochs (0, 1)): setup {setup_s} s, epoch walls on the card "
        f"{[w for _, w in card]}, on the host {[w for _, w in host]}; {div_shares} shares an epoch in "
        f"one win_g1 launch, launches {launches}; batch bytes, accepted, faults, coins, shares, "
        f"agreement and class epochs equal on the card and the host")
    return launches


# ---------------------------------------------------------------------------
# The packed co-simulation (phase 6): importable so that a scratch script
# can run it alone
# ---------------------------------------------------------------------------


def cosim_columns(gen, n: int, Z: int, n_pad: int):
    """Random step columns for n instances in Z zones, rows past n zero
    (``cosim_pad``'s padding): 1 % of proposers off, 1 % override rows
    and 1 % forged counts, a nonzero commit column; zones in contiguous
    blocks of about n/Z rows, as ``GeoTopology.assign`` gives them.

    The yes votes of a row without an override, c1 ≈ n·(share of
    receivers on)·(share of zones its zone reaches), must fall on both
    sides of the f+1 and n_live−f thresholds (n_live = 0.98n, f = n/3),
    so that a wrong histogram or reach row shows as a changed decision:
    the reach rows reach a shuffled 1, 2, …, Z zones each, at random
    columns, with 2 % of receivers off; at Z = 1, where every proposer
    sees the one count, half the receivers are off, which puts that
    count between the thresholds.  See :func:`cosim_classes`."""
    cols = {
        "prop_on": (gen.random(n) < 0.99).astype(np.int8),
        "dst_on": (gen.random(n) < (0.5 if Z == 1 else 0.98)).astype(np.int8),
        "zone": np.sort(gen.integers(0, Z, n)).astype(np.int32),
        "ovr_mask": (gen.random(n) < 0.01).astype(np.int8),
        "ovr_c1": gen.integers(0, n + 1, n).astype(np.int32),
        "forged_cnt": np.where(gen.random(n) < 0.01, gen.integers(0, n + 1, n), 0).astype(np.int32),
        "commit": gen.integers(0, 1000, n).astype(np.int32),
    }
    for k, v in cols.items():
        cols[k] = np.concatenate([v, np.zeros(n_pad - n, dtype=v.dtype)])
    reach = np.zeros((Z, Z), dtype=np.uint8)
    for z, k in enumerate(gen.permutation(Z) + 1):
        reach[z, gen.choice(Z, k, replace=False)] = 1
    return cols, reach


def cosim_classes(accepted, nondef, ovr_mask, n: int) -> tuple:
    """How many of the first n rows without an override came out
    definite-0 (not accepted), nondef (accepted, needing a coin) and
    definite-1 (accepted alone)."""
    acc, nd = np.asarray(accepted)[:n] != 0, np.asarray(nondef)[:n] != 0
    free = np.asarray(ovr_mask)[:n] == 0
    return int((free & ~acc).sum()), int((free & nd).sum()), int((free & acc & ~nd).sum())


def cosim_bound(n: int, Z: int, hist_only: bool = False):
    """(ms, "bytes"): the step's bytes over the card's memory rate —
    prop_on, dst_on, ovr_mask (1 B), zone, ovr_c1, forged_cnt, commit
    (4 B) and reach (Z² B) read once; commit (4 B) and the three masks
    (1 B each) written once: 26 B an instance.  The histogram alone
    reads dst_on and zone and writes Z counts."""
    nbytes = 5 * n + 4 * Z if hist_only else 26 * n + Z * Z
    return nbytes / PEAK_BYTES_PER_S * 1e3, "bytes"


def cosim_tail_check(mesh, record_err) -> None:
    """Phase 6(a)'s tail shapes on the card: at each n of COSIM_TAIL_NS
    and Z of COSIM_TAIL_ZS, the one-launch step (one launch, none at
    n = 0), ``cosim_hist`` and the mesh form, called twice on one step
    function (its scratch and ticket reused), byte for byte against the
    plain versions; then column views one row in (not 16-byte aligned)
    through the one launch and the mesh form's two kernels."""
    import torch

    from hbbft_tpu_torch.ops import cosim_step as CS
    from hbbft_tpu_torch.ops import cuda_ec
    from hbbft_tpu_torch.parallel.mesh import cosim_pad, packed_cosim_step_fn

    dev = torch.device("cuda")
    gen = np.random.default_rng(SEED + 1)

    def step_args(t, reach_t):
        return [t[k] for k in COSIM_ROWS[:3]] + [reach_t] + [t[k] for k in COSIM_ROWS[3:6]]

    for Z in COSIM_TAIL_ZS:
        for n in COSIM_TAIL_NS:
            n_pad = cosim_pad(n, mesh.size)
            cols, reach = cosim_columns(gen, n, Z, n_pad)
            n_live, f = n - n // 50, (n - 1) // 3
            reach_t = torch.from_numpy(reach).to(dev)
            t = {k: torch.from_numpy(v[:n].copy()).to(dev) for k, v in cols.items()}
            what = f"at n={n}, Z={Z}"
            commit_k, commit_p = t["commit"].clone(), t["commit"].clone()
            before = dict(cuda_ec.LAUNCHES)
            got = CS.cosim_step(*step_args(t, reach_t), commit_k, n_live, f)
            launched = {k: cuda_ec.LAUNCHES[k] - before[k] for k in ("cosim_hist", "cosim_step")}
            if launched != {"cosim_hist": 0, "cosim_step": 1 if n else 0}:
                fail(f"cosim_step launched {launched} {what}")
            plain = CS.cosim_step_plain(*step_args(t, reach_t), commit_p, n_live, f)
            for g, p in zip(list(got) + [commit_k], list(plain) + [commit_p]):
                record_err("cosim_step", g, p, what)
            record_err("cosim_hist", CS.cosim_hist(t["dst_on"], t["zone"], Z),
                       CS.cosim_hist_plain(t["dst_on"], t["zone"], Z), what)
            # the mesh form, twice on one step function, against the plain
            # step on the padded columns
            step = packed_cosim_step_fn(mesh, Z)
            full = {k: torch.from_numpy(v).to(dev) for k, v in cols.items()}
            b = n_pad // mesh.size
            commit_m = [full["commit"][j * b : (j + 1) * b].clone().to(d)
                        for j, d in enumerate(mesh.devices)]
            commit_p = full["commit"].clone()
            for rep in range(2):
                shards = {k: [full[k][j * b : (j + 1) * b].clone().to(d)
                              for j, d in enumerate(mesh.devices)] for k in COSIM_ROWS[:6]}
                res = step(*(shards[k] for k in COSIM_ROWS[:3]), reach_t,
                           *(shards[k] for k in COSIM_ROWS[3:6]), commit_m, (n_live, f))
                plain = CS.cosim_step_plain(*step_args(full, reach_t), commit_p, n_live, f)
                for g, p in zip(res, list(plain) + [commit_p]):
                    record_err("cosim_step", torch.cat([x.to(dev) for x in g]), p,
                               f"on {mesh}, call {rep + 1}, {what}")
        # column views one row in: not 16-byte aligned
        n = COSIM_TAIL_NS[-1]
        cols, reach = cosim_columns(gen, n + 1, Z, n + 1)
        n_live, f = n - n // 50, (n - 1) // 3
        reach_t = torch.from_numpy(reach).to(dev)
        t = {k: torch.from_numpy(v).to(dev)[1:] for k, v in cols.items()}
        commit_k, commit_m = (torch.from_numpy(cols["commit"].copy()).to(dev)[1:]
                              for _ in range(2))
        commit_p = commit_k.clone()
        got = CS.cosim_step(*step_args(t, reach_t), commit_k, n_live, f)
        plain = CS.cosim_step_plain(*step_args(t, reach_t), commit_p, n_live, f)
        a = CS.cosim_hist(t["dst_on"], t["zone"], Z)
        mesh_form = CS.cosim_decide(t["prop_on"], t["zone"], reach_t, t["ovr_mask"], t["ovr_c1"],
                                    t["forged_cnt"], commit_m, a, n_live, f)
        what = f"on views one row in at n={n}, Z={Z}"
        for g, p in zip(list(got) + [commit_k], list(plain) + [commit_p]):
            record_err("cosim_step", g, p, what)
        for g, p in zip(list(mesh_form) + [commit_m], list(plain) + [commit_p]):
            record_err("cosim_step", g, p, f"(hist + decision) {what}")
    log(f"cosim_step tail shapes n={COSIM_TAIL_NS} x Z={COSIM_TAIL_ZS}: one launch (none at "
        f"n = 0), cosim_hist and {mesh} (called twice) byte-equal to plain; views one row in "
        f"byte-equal too")


def cosim_phase(mesh, record_err, timed, device_timed) -> dict:
    """Phase 6 (see the module docstring) on the card; fails the script
    on any mismatch.  Returns the kernels' times and bounds and each
    path's launch counts."""
    import torch

    from hbbft_tpu_torch.crypto import mock as MK
    from hbbft_tpu_torch.crypto.backend import CpuBackend
    from hbbft_tpu_torch.harness import wan as W
    from hbbft_tpu_torch.harness.cosim import PackedHoneyBadgerCosim, PackedQueueingCosim
    from hbbft_tpu_torch.harness.epoch import VectorizedHoneyBadgerSim, VectorizedQueueingSim
    from hbbft_tpu_torch.harness.simulation import HwQuality
    from hbbft_tpu_torch.ops import cosim_step as CS
    from hbbft_tpu_torch.ops import cuda_ec
    from hbbft_tpu_torch.ops.backend_cuda import CudaBackend
    from hbbft_tpu_torch.parallel.mesh import cosim_pad, packed_cosim_step_fn

    dev = torch.device("cuda")
    gen = np.random.default_rng(SEED)
    out = {}

    # (a) the kernels against their plain versions, one launch and a mesh
    for Z in COSIM_ZS:
        n = COSIM_CHECK_N
        n_pad = cosim_pad(n, mesh.size)
        cols, reach = cosim_columns(gen, n, Z, n_pad)
        n_live, f = n - n // 50, (n - 1) // 3
        t = {k: torch.from_numpy(v).to(dev) for k, v in cols.items()}
        reach_t = torch.from_numpy(reach).to(dev)
        a = CS.cosim_hist(t["dst_on"], t["zone"], Z)
        record_err("cosim_hist", a, CS.cosim_hist_plain(t["dst_on"], t["zone"], Z), f"at Z={Z}")
        commit_k, commit_p = t["commit"].clone(), t["commit"].clone()
        args = [t[k] for k in COSIM_ROWS[:3]] + [reach_t] + [t[k] for k in COSIM_ROWS[3:6]]
        got = CS.cosim_step(*args, commit_k, n_live, f)
        plain = CS.cosim_step_plain(*args, commit_p, n_live, f)
        for name, g, p in zip(("accepted", "nondef", "dec_fail"), got, plain):
            record_err("cosim_step", g, p, f"{name} at n={n}, Z={Z}")
        record_err("cosim_step", commit_k, commit_p, f"commit at n={n}, Z={Z}")
        if torch.equal(commit_k, t["commit"]):
            fail(f"cosim_step advanced no commit counter at Z={Z}")
        # the mesh form: each shard's block, the [Z] partials ring-reduced
        b = n_pad // mesh.size
        shards = {k: [v[j * b : (j + 1) * b].clone().to(d) for j, d in enumerate(mesh.devices)]
                  for k, v in t.items()}
        res = packed_cosim_step_fn(mesh, Z)(
            *(shards[k] for k in COSIM_ROWS[:3]), reach_t, *(shards[k] for k in COSIM_ROWS[3:]),
            (n_live, f),
        )
        for name, g, want in zip(("accepted", "nondef", "dec_fail", "commit"), res,
                                 list(got) + [commit_k]):
            record_err("cosim_step", torch.cat([x.to(dev) for x in g]), want,
                       f"{name} on {mesh} against one launch at Z={Z}")
        # every decision class among the rows without an override, from
        # the one launch and from the mesh (at Z = 1 no such row can be
        # definite-1: they all see the one count)
        ovr = cols["ovr_mask"]
        classes = cosim_classes(*(x.cpu().numpy() for x in got[:2]), ovr, n)
        mesh_classes = cosim_classes(*(torch.cat([x.cpu() for x in g]).numpy() for g in res[:2]),
                                     ovr, n)
        if min(classes[: 2 if Z == 1 else 3]) < 1 or mesh_classes != classes:
            fail(f"cosim_step at Z={Z}: rows without an override came out (definite-0, nondef, "
                 f"definite-1) {classes}, on {mesh} {mesh_classes}")
        counts = [int(x.sum()) for x in got]
        log(f"cosim_step n={n} Z={Z}: hist and step byte-equal to plain (accepted, nondef, "
            f"dec_fail {counts}; rows without an override definite-0, nondef, definite-1 "
            f"{classes}; commit in place), {mesh} byte-equal to one launch")
    cosim_tail_check(mesh, record_err)
    # timed at the scale run's shape, on the card's timeline
    n, Z = COSIM_TIME_N, COSIM_TIME_Z
    cols, reach = cosim_columns(gen, n, Z, n)
    t = {k: torch.from_numpy(v).to(dev) for k, v in cols.items()}
    args = [t[k] for k in COSIM_ROWS[:3]] + [torch.from_numpy(reach).to(dev)] + [
        t[k] for k in COSIM_ROWS[3:]] + [n - n // 50, (n - 1) // 3]
    hist_args = (t["dst_on"], t["zone"], Z)
    for fn in (CS.cosim_step, CS.cosim_step_plain, CS.cosim_hist, CS.cosim_hist_plain):
        fn(*(hist_args if "hist" in fn.__name__ else args))  # warm-up
    # the kernels on the card's timeline; the plain versions' dozens of
    # torch calls a step take longer to enqueue than the card to run them,
    # so they are timed by events around calls paced by the host
    # (i) the one-launch step; (ii) the mesh form's two kernels back to
    # back on one shard of the whole n; (iii) cosim_hist alone
    out["step_ms"] = device_timed(lambda: CS.cosim_step(*args), COSIM_REPS)
    out["step_plain_ms"] = timed(lambda: CS.cosim_step_plain(*args), COSIM_REPS)[1]
    shard_scratch = CS.CosimScratch(Z, dev)

    def mesh_pair():
        a = CS.cosim_hist(*hist_args, scratch=shard_scratch)
        return CS.cosim_decide(args[0], args[2], args[3], *args[4:8], a, *args[8:])

    mesh_pair()  # warm-up
    out["mesh_pair_ms"] = device_timed(mesh_pair, COSIM_REPS)
    out["hist_ms"] = device_timed(lambda: CS.cosim_hist(*hist_args), COSIM_REPS)
    out["hist_plain_ms"] = timed(lambda: CS.cosim_hist_plain(*hist_args), COSIM_REPS)[1]
    # the library call that makes the same histogram: one index_add_ (its
    # index and source converted beforehand, into a kept accumulator)
    zone64, dst32 = t["zone"].to(torch.int64), t["dst_on"].to(torch.int32)
    acc = torch.zeros(Z, dtype=torch.int32, device=dev)
    acc.index_add_(0, zone64, dst32)
    out["hist_library_ms"] = device_timed(lambda: acc.index_add_(0, zone64, dst32), COSIM_REPS)
    # (v) the launch floor: an empty <<<1, 32>>> kernel enqueued the same
    # way; and the step's cooperative grid empty, then crossing its barrier
    blocks = CS.step_blocks(n, dev)
    probe_words = torch.zeros(4, dtype=torch.int32, device=dev)
    for kind in ("empty", "grid", "barrier"):
        CS.launch_probe(kind, dev, blocks, probe_words)  # warm-up
    out["floor_ms"] = device_timed(lambda: CS.launch_probe("empty", dev), COSIM_REPS)
    out["grid_ms"] = device_timed(lambda: CS.launch_probe("grid", dev, blocks), COSIM_REPS)
    out["barrier_ms"] = device_timed(
        lambda: CS.launch_probe("barrier", dev, blocks, probe_words), COSIM_REPS)
    out["step_blocks"] = blocks
    out["step_bound"] = cosim_bound(n, Z)
    out["hist_bound"] = cosim_bound(n, Z, hist_only=True)
    log(f"cosim_step n={n} Z={Z} on the card's timeline ({COSIM_REPS} enqueued behind a sleep; "
        f"the plain versions paced by the host): "
        f"step (one launch of {blocks} blocks) {out['step_ms']} ms, plain "
        f"{out['step_plain_ms']} ms, bound {out['step_bound'][0]} ms (bytes); the mesh form's "
        f"hist + decision {out['mesh_pair_ms']} ms; hist alone {out['hist_ms']} ms, plain "
        f"{out['hist_plain_ms']} ms, index_add_ {out['hist_library_ms']} ms, bound "
        f"{out['hist_bound'][0]} ms; an empty <<<1, 32>>> kernel {out['floor_ms']} ms, the "
        f"step's grid empty {out['grid_ms']} ms, crossing the grid barrier "
        f"{out['barrier_ms']} ms")
    del t, args

    # (b) bench_cosim's largest row, then a CPU twin and a mesh twin
    wan = W.WanModel(seed=COSIM_WAN_SEED, topology=W.DEFAULT_TOPOLOGY,
                     latency=W.LatencyModel("lognormal"), deadline_ms=400.0)
    dead = set(range(COSIM_N - COSIM_DEAD, COSIM_N))

    def scale_run(what: str, **kw):
        t0 = time.perf_counter()
        kw.setdefault("device", dev)
        sim = PackedHoneyBadgerCosim(COSIM_N, random.Random(COSIM_SEED), wan=wan, **kw)
        init_s = time.perf_counter() - t0
        runs = [sim.run_epoch_packed(dead=dead) for _ in range(1 + COSIM_WARM)]
        rate = statistics.median(s.epochs_per_s for s in runs[1:])
        last = runs[-1]
        log(f"cosim n={COSIM_N} {what}: init {init_s} s, cold epoch {runs[0].wall_s} s, warm "
            f"median {rate} epochs/s (walls {[s.wall_s for s in runs[1:]]}), accepted "
            f"{[s.accepted for s in runs]}, coin flips {[s.coin_flips for s in runs]}, peak RSS "
            f"{last.peak_rss_bytes / 2**20} MiB, {last.bytes_per_validator} bytes/validator, "
            f"{last.mesh_devices} shard(s); last step's phases " + json.dumps(sim.last_phases))
        return sim, runs, {"init_s": init_s, "cold_s": runs[0].wall_s, "epochs_per_s": rate}

    cuda_ec.reset_launches()
    card, card_runs, out["scale"] = scale_run("on the card")
    out["cosim100k"] = dict(cuda_ec.LAUNCHES)
    epochs = 1 + COSIM_WARM
    if card.mesh_devices == 1 and (out["cosim100k"]["cosim_hist"] != 0
                                   or out["cosim100k"]["cosim_step"] != epochs):
        fail(f"the n={COSIM_N} scale run launched {out['cosim100k']}, not one step an epoch "
             f"and no hist")
    if not 0 < card_runs[-1].accepted <= COSIM_N - COSIM_DEAD:
        fail(f"the n={COSIM_N} scale run accepted {card_runs[-1].accepted}")
    host, host_runs, _ = scale_run("on the CPU (plain versions)", device="cpu")
    cuda_ec.reset_launches()
    sharded, mesh_runs, _ = scale_run(f"on {mesh}", mesh=mesh)
    out["cosim100k_mesh"] = dict(cuda_ec.LAUNCHES)
    # a hist and a decision a shard and S − 1 ring rounds an epoch
    S = sharded.mesh_devices
    rounds = (S - 1) * len(cuda_ec.ring_plan(mesh.devices))
    if (out["cosim100k_mesh"]["cosim_hist"], out["cosim100k_mesh"]["cosim_step"],
            out["cosim100k_mesh"]["ring_permute"]) != (S * epochs, S * epochs, rounds * epochs):
        fail(f"the mesh scale run launched {out['cosim100k_mesh']}, not {S} hist, {S} step "
             f"and {rounds} ring launches an epoch")
    for what, runs, sim in (("CPU", host_runs, host), ("mesh", mesh_runs, sharded)):
        if ([(s.accepted, s.coin_flips) for s in runs] != [(s.accepted, s.coin_flips)
                                                            for s in card_runs]
                or not np.array_equal(sim.commit_counts(), card.commit_counts())):
            fail(f"the n={COSIM_N} {what} twin differs from the card's run")
    log(f"cosim n={COSIM_N}: the CPU and {mesh} twins give the card's accepted counts, coin "
        f"flips and commit_counts(); launches on the card {out['cosim100k']}, on the mesh "
        f"{out['cosim100k_mesh']}")
    del card, host, sharded

    # (c) bench_cosim's equivalence leg: the dict plane on the card's
    # backend against the packed queueing co-sim, then the WAN twin
    cuda_ec.reset_launches()
    legacy = VectorizedQueueingSim(COSIM_TWIN_N, random.Random(COSIM_TWIN_SEED),
                                   batch_size=COSIM_TWIN_N, mock=True, ops=CudaBackend(device=dev))
    packed = PackedQueueingCosim(COSIM_TWIN_N, random.Random(COSIM_TWIN_SEED),
                                 batch_size=COSIM_TWIN_N, device=dev)
    txs = [b"cosim-%06d" % i for i in range(2 * COSIM_TWIN_N)]
    legacy.input_all(txs)
    packed.input_all(txs)
    dead = set(range(COSIM_TWIN_N - COSIM_TWIN_DEAD, COSIM_TWIN_N))
    dict_s, packed_s = [], []
    for e in range(COSIM_TWIN_EPOCHS):
        t0 = time.perf_counter()
        res_l = legacy.run_epoch(dead=dead)
        t1 = time.perf_counter()
        res_p = packed.run_epoch(dead=dead)
        dict_s.append(t1 - t0)
        packed_s.append(time.perf_counter() - t1)
        if (res_l.batch != res_p.batch or res_l.accepted != res_p.accepted
                or [x.compact() for x in res_l.fault_log] != [x.compact() for x in res_p.fault_log]
                or res_l.agreement_epochs != res_p.agreement_epochs
                or res_l.coin_flips != res_p.coin_flips):
            fail(f"the packed queueing co-sim diverged from the dict plane at epoch {e}")
    if legacy.rng.random() != packed.rng.random():
        fail("the packed queueing co-sim's rng left the dict plane's")
    log(f"cosim twin n={COSIM_TWIN_N} ({COSIM_TWIN_DEAD} dead, {len(txs)} txs, "
        f"{COSIM_TWIN_EPOCHS} epochs): batches, accepted sets and fault logs equal; dict plane "
        f"walls {dict_s} s, packed {packed_s} s; {len(res_p.batch.contributions)} contributions")

    def test_model():
        topo = W.GeoTopology(zones=("a", "b", "c"),
                             delay_ms=((2, 80, 250), (80, 2, 120), (250, 120, 2)), weights=(6, 4, 3))
        return W.WanModel(seed=11, topology=topo, latency=W.LatencyModel("pareto", alpha=1.5),
                          deadline_ms=200.0, partitions=(W.PartitionWindow(1, 2, ((0, 1), (2,))),),
                          failures=(W.CorrelatedFailure(2, 3, 2),),
                          flash_crowds=(W.FlashCrowd(1, 2, 4.0),))

    n = COSIM_WAN_N
    model = test_model()
    r_d, r_p = random.Random(5), random.Random(5)
    dict_sim = VectorizedHoneyBadgerSim(n, r_d, mock=True, ops=CudaBackend(device=dev))
    packed_sim = PackedHoneyBadgerCosim(n, r_p, wan=model, device=dev)
    forged = {n - 1: {1: MK.MockDecryptionShare(b"\x00" * 32, b"\x00" * 32)}}
    for e in range(COSIM_WAN_EPOCHS):
        contribs = {i: [b"wan-%d-%d" % (e, i)] for i in range(n)}
        kw = {"forged_dec": forged} if e == 0 else {}
        a = dict_sim.run_epoch(contribs, wan=model, **kw)
        b = packed_sim.run_epoch(contribs, **kw)
        if (a.batch != b.batch or a.accepted != b.accepted or a.coin_flips != b.coin_flips
                or [x.compact() for x in a.fault_log] != [x.compact() for x in b.fault_log]
                or a.agreement_epochs != b.agreement_epochs):
            fail(f"the n={n} WAN twin diverged at epoch {e}")
        if e == 0 and [x.compact() for x in b.fault_log] != [f"{n - 1}:INVALID_DECRYPTION_SHARE"]:
            fail(f"the n={n} WAN twin's forger was not attributed: {b.fault_log}")
    if r_d.random() != r_p.random():
        fail(f"the n={n} WAN twin's rngs diverged")
    out["cosim_twin"] = dict(cuda_ec.LAUNCHES)
    if out["cosim_twin"]["cosim_step"] != COSIM_TWIN_EPOCHS + COSIM_WAN_EPOCHS:
        fail(f"the twins launched {out['cosim_twin']}")
    log(f"cosim WAN twin n={n} ({COSIM_WAN_EPOCHS} epochs, partition, zone failure, one forger): "
        f"equal to the dict plane with wan=; launches over (c) {out['cosim_twin']}")

    # (d) hw= on the n = 64 real-BLS epoch, on the card and on the host
    hw = HwQuality.from_flags(*HW_FLAGS)
    contribs = {i: [b"e64-%d" % i] for i in range(EPOCH_NODES)}
    cuda_ec.reset_launches()
    res = VectorizedHoneyBadgerSim(EPOCH_NODES, random.Random(EPOCH_SEED), verify_honest=True,
                                   hw=hw, ops=CudaBackend(device=dev)).run_epoch(contribs)
    out["epoch64_hw"] = dict(cuda_ec.LAUNCHES)
    host = VectorizedHoneyBadgerSim(EPOCH_NODES, random.Random(EPOCH_SEED), verify_honest=True,
                                    hw=hw, ops=CpuBackend()).run_epoch(contribs)

    def network(v):
        return (v.rounds, v.per_node_msgs, v.per_node_bytes, v.network_s,
                {k: x for k, x in v.breakdown.items() if not k.startswith("cpu:")})

    if out["epoch64_hw"]["win_g1"] < 1:
        fail(f"the hw= epoch launched {out['epoch64_hw']}, not win_g1")
    if res.batch.contributions != contribs or res.batch != host.batch:
        fail("the hw= epoch's batch is wrong or differs from the host twin's")
    v = res.virtual
    if network(v) != network(host.virtual) or v.total_s != v.network_s + v.cpu_s:
        fail("the hw= epoch's network terms differ from the host twin's")
    log(f"epoch n={EPOCH_NODES} hw=HwQuality.from_flags{HW_FLAGS} on the card: virtual total "
        f"{v.total_s} s = network {v.network_s} s + cpu {v.cpu_s} s, {v.rounds} rounds, "
        f"{v.per_node_msgs} msgs and {v.per_node_bytes} bytes a node (network terms equal to "
        f"the host twin's); launches {out['epoch64_hw']}; breakdown " + json.dumps(v.breakdown))
    return out


# ---------------------------------------------------------------------------
# The reliable-broadcast plane (phase 7): importable, so that the CPU tests
# run its drivers at small sizes
# ---------------------------------------------------------------------------


def broadcast_1mb(ops, nodes=BCAST_NODES, payload_bytes=BCAST_PAYLOAD, seed=BCAST_SEED) -> dict:
    """``bench_broadcast_1mb`` (config 3, ``bench.py:904-938``) on the
    port: ``Broadcast(ni, 0)`` over a ``TestNetwork`` of ``nodes`` nodes,
    ⌊(nodes − 1)/3⌋ of them silent (``SilentAdversary`` with the RANDOM
    scheduler), node 0 broadcasting ``Random(seed).randbytes(payload_bytes)``.
    Every good node must output the payload.  Returns the wall, the count
    of messages delivered and a digest of their (sender, recipient, wire
    bytes), tallied by the network's delivery filter (which delivers
    everything)."""
    import hashlib

    from hbbft_tpu_torch.core.serialize import dumps
    from hbbft_tpu_torch.harness.network import MessageScheduler, SilentAdversary, TestNetwork
    from hbbft_tpu_torch.protocols.broadcast import Broadcast

    rng = random.Random(seed)
    payload = rng.randbytes(payload_bytes)
    digest, count = hashlib.sha256(), [0]

    def tally(sender, recipient, message) -> bool:
        count[0] += 1
        digest.update(repr((sender, recipient)).encode() + dumps(message))
        return True

    faulty = (nodes - 1) // 3
    net = TestNetwork(
        nodes - faulty, faulty,
        lambda adv: SilentAdversary(MessageScheduler(MessageScheduler.RANDOM, rng)),
        lambda ni: Broadcast(ni, 0), rng, ops=ops, message_filter=tally,
    )
    t0 = time.perf_counter()
    net.input(0, payload)
    net.step_until(lambda: all(n.terminated() for n in net.nodes.values()))
    wall = time.perf_counter() - t0
    if not all(n.outputs == [payload] for n in net.nodes.values()):
        fail(f"broadcast n={nodes}: a good node did not output the payload")
    return {"wall_s": wall, "messages": count[0], "digest": digest.hexdigest(),
            "good": len(net.nodes)}


def sha256_plain_replayed(blocks):
    """``ops/sha256.sha256_plain`` of CUDA ``blocks``, its compression (the
    plain version's own torch ops, ~3,600 a block, launch-bound when
    issued one by one: ~22–39 s at 746 blocks on the H100's host) captured
    once as a CUDA graph and replayed block after block — the same
    kernels on the same inputs, without a Python dispatch an op.  CPU
    blocks run ``sha256_plain`` itself."""
    import torch

    from hbbft_tpu_torch.ops import sha256 as SH

    if blocks.device.type != "cuda":
        return SH.sha256_plain(blocks)
    x = SH._lanes(blocks)
    B = x.shape[0]
    state = torch.tensor(SH._H0.astype(np.int64), device=x.device)[:, None].repeat(1, B)
    block = torch.zeros((16, B), dtype=torch.int64, device=x.device)

    def step():
        return torch.stack(SH._compress_plain(list(state.unbind(0)), list(block.unbind(0))))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()  # warm-up, off the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    for blk in range(x.shape[1]):
        block.copy_(x[:, blk, :].T)
        graph.replay()
        state.copy_(out)
    return SH._to_int32(state.T.contiguous())


def sha_check(record_err, lengths=RBC_SHA_LENGTHS, batches=RBC_SHA_BATCHES, seed=RBC_SEED,
              device=None) -> dict:
    """Both entries of the ``sha256`` kernel against ``hashlib`` and, on the
    same messages, their plain version, at every length and batch: the
    words entry ``sha256`` on ``pad_messages``' blocks, the raw entry
    ``sha256_bytes`` on the messages' rows back to back from one byte into
    their buffer (so rows start at every alignment).  The raw entry's
    plain padding (torch ops on the rows) must equal ``pad_messages``, so
    one plain digest serves both: computed once on the largest batch,
    whose first rows are the smaller batches; on the card through
    :func:`sha256_plain_replayed`, itself held against the eager plain
    version at the 120-byte length.  Returns the plain version's ms at
    each length."""
    import hashlib

    import torch

    from hbbft_tpu_torch.ops import sha256 as SH

    dev = torch.device("cuda") if device is None else torch.device(device)
    gen = np.random.default_rng(seed)
    plain_ms = {}
    for length in lengths:
        raw = gen.integers(0, 256, size=(max(batches), length), dtype=np.uint8)
        msgs = [row.tobytes() for row in raw]
        blocks = torch.from_numpy(SH.pad_messages(msgs).view(np.int32)).to(dev)
        buf = torch.zeros(raw.size + 1, dtype=torch.uint8, device=dev)
        buf[1:] = torch.from_numpy(raw.reshape(-1)).to(dev)
        rows = buf[1:].view(raw.shape)
        if not torch.equal(SH._message_words(rows), blocks):
            fail(f"the raw entry's plain padding differs from pad_messages at {length} B")
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = sha256_plain_replayed(blocks)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        plain_ms[length] = (time.perf_counter() - t0) * 1e3
        if length == 120 and not torch.equal(plain, SH.sha256_plain(blocks)):
            fail("the replayed plain SHA-256 differs from the eager plain version")
        want = [hashlib.sha256(m).digest() for m in msgs]
        for b in batches:
            for entry, got in (("words", SH.sha256(blocks[:b])), ("raw", SH.sha256_bytes(rows[:b]))):
                record_err("sha256", got, plain[:b], f"({entry} entry) at {b} × {length} B")
                if SH.digests_to_bytes(got) != want[:b]:
                    fail(f"sha256 ({entry} entry) at {b} × {length} B differs from hashlib")
    return plain_ms


def merkle_check(record_err, leaves=RBC_LEAVES, lengths=(2, 47_663), forests=RBC_FORESTS,
                 big_leaves=RBC_BIG_LEAVES, seed=RBC_SEED, device=None) -> None:
    """``merkle_levels_device`` (a forest of one) against
    ``MerkleTree.levels`` at every leaf count (uniform 2-byte leaves, the
    N = 1024 epoch's shards, and the 1 MB broadcast's 47,663-byte ones up
    to 64 leaves); ``merkle_forest`` against its plain version, every
    level and roots only, on those 2-byte trees, on each forest of
    ``forests`` (trees, leaves, bytes) and on one tree of ``big_leaves``
    2-byte leaves (above a block's shared memory on the card), a few of
    each forest's trees against ``MerkleTree`` too."""
    import torch

    from hbbft_tpu_torch.crypto.merkle import MerkleTree
    from hbbft_tpu_torch.ops import sha256 as SH

    dev = torch.device("cuda") if device is None else torch.device(device)
    gen = np.random.default_rng(seed)

    def forest(values, what):
        plain = SH.merkle_forest_plain(values, sha=sha256_plain_replayed)
        record_err("merkle_forest", SH.merkle_forest(values), plain, f"at {what}")
        record_err("merkle_forest", SH.merkle_forest(values, roots_only=True), plain[:, -1],
                   f"at {what}, roots only")
        T, n, _ = values.shape
        host = values.cpu().numpy()
        rows = SH._words_np(plain).astype(">u4").view(np.uint8).reshape(T, -1)
        for t in sorted({0, T - 1}):
            want = MerkleTree([v.tobytes() for v in host[t]]).levels
            if SH.split_levels(rows[t].tobytes(), n) != want:
                fail(f"merkle_forest at {what}: tree {t} differs from MerkleTree")

    for length in lengths:
        for n in leaves:
            if length > 1024 and n > 64:
                continue
            vals = [gen.integers(0, 256, size=length, dtype=np.uint8).tobytes() for _ in range(n)]
            if SH.merkle_levels_device(vals, dev) != MerkleTree(vals).levels:
                fail(f"merkle_levels_device at {n} leaves of {length} B differs from MerkleTree")
            if length <= 1024:
                values = torch.from_numpy(
                    np.frombuffer(b"".join(vals), np.uint8).reshape(1, n, length).copy()).to(dev)
                forest(values, f"1 × {n} × {length} B")
    for T, n, length in list(forests) + [(1, big_leaves, 2)]:
        values = torch.from_numpy(
            gen.integers(0, 256, size=(T, n, length), dtype=np.uint8)).to(dev)
        forest(values, f"{T} × {n} × {length} B")


def gf_check(record_err, epoch_cols: int, seed=RBC_SEED, device=None, nodes8=BCAST_NODES,
             payload=BCAST_PAYLOAD, nodes16=BIG_NODES, dead16=BIG_DEAD) -> None:
    """``gf_matmul`` against its plain version and the native host
    product (``RS._matmul`` / ``RS._matmul16``), tolerance 0: W = 8 at the
    1 MB broadcast's parity ``[42, 22] × [22, 47,663]`` and a ``[22, 22]``
    decode, at 1, 3 and 4,097 columns, on all-zero and all-0xFF data;
    W = 16 at the N = 1024 epoch's parity ``[682, 342] × [342,
    epoch_cols]``, its ``[342, 342]`` decode, its wave's dead rows
    ``[50, 342] × [342, epoch_cols]`` (one product a wave) and one
    proposer's ``[50, 342] × [342, epoch_cols / 974]``, a one-column
    product at the epoch's shards (the CPU tests shrink the node
    counts)."""
    import torch

    from hbbft_tpu_torch.crypto import rs as RS
    from hbbft_tpu_torch.ops import gf256 as GF

    dev = torch.device("cuda") if device is None else torch.device(device)
    gen = np.random.default_rng(seed)

    def check(mat, data, host, what):
        t = torch.from_numpy(data if data.dtype == np.uint8 else data.view(np.int16)).to(dev)
        got = GF.gf_matmul(mat, t)
        record_err("gf_matmul", got, GF.gf_matmul_plain(mat, t), what)
        got_np = got.cpu().numpy()
        if data.dtype == np.uint16:
            got_np = got_np.view(np.uint16)
        if not np.array_equal(got_np, host(mat, data)):
            fail(f"gf_matmul {what} differs from the native host product")

    k8 = nodes8 - 2 * ((nodes8 - 1) // 3)
    codec = RS.ReedSolomon(k8, nodes8 - k8)
    shard = -(-(payload + 4) // k8)
    parity = codec.matrix[k8:]
    dec = codec.decode_matrix(sorted(gen.choice(nodes8, k8, replace=False).tolist()))
    rand8 = lambda k, n: gen.integers(0, 256, size=(k, n), dtype=np.uint8)  # noqa: E731
    check(parity, rand8(k8, shard), RS._matmul, f"W=8 parity [{len(parity)}, {k8}]·[{k8}, {shard}]")
    check(dec, rand8(k8, shard), RS._matmul, f"W=8 decode [{k8}, {k8}]·[{k8}, {shard}]")
    for n in (1, 3, 4097):
        check(parity, rand8(k8, n), RS._matmul, f"W=8 parity at {n} columns")
    for fill in (0x00, 0xFF):
        check(parity, np.full((k8, 4097), fill, np.uint8), RS._matmul,
              f"W=8 parity on all-{fill:#04x} data")
    n16 = nodes16
    k16 = n16 - 2 * ((n16 - 1) // 3)
    codec16 = RS.ReedSolomon16(k16, n16 - k16)
    rand16 = lambda k, n: gen.integers(0, 1 << 16, size=(k, n), dtype=np.uint16)  # noqa: E731
    dead = list(range(n16 - dead16, n16))
    dec16 = codec16.decode_matrix([i for i in range(n16) if i not in dead][:k16])
    per = max(epoch_cols // (n16 - dead16), 1)
    check(codec16.matrix[k16:], rand16(k16, epoch_cols), RS._matmul16,
          f"W=16 parity [{n16 - k16}, {k16}]·[{k16}, {epoch_cols}]")
    check(dec16, rand16(k16, epoch_cols), RS._matmul16,
          f"W=16 decode [{k16}, {k16}]·[{k16}, {epoch_cols}]")
    check(codec16.matrix[dead], rand16(k16, epoch_cols), RS._matmul16,
          f"W=16 the wave's dead rows [{len(dead)}, {k16}]·[{k16}, {epoch_cols}]")
    check(codec16.matrix[dead], rand16(k16, per), RS._matmul16,
          f"W=16 dead rows [{len(dead)}, {k16}]·[{k16}, {per}]")


def mesh_programs_check(mesh, k: int = MESH_K, nbits: int = 255, seed=RBC_SEED) -> dict:
    """The five sharded programs of ``parallel/mesh.py`` on ``mesh`` against
    the host (native ``g1_multi_exp`` / ``g2_multi_exp``, ``hashlib``) on
    ``tests/test_parallel.py``'s inputs, ``k`` points and ``nbits``-bit
    scalars; each builder must launch the kernels it names, one a shard
    (and ``ring_permute`` once a sending card a ring round).  Returns each
    builder's launches."""
    import hashlib

    from hbbft_tpu_torch.crypto import fields as F
    from hbbft_tpu_torch.crypto.curve import G1_GEN, G2_GEN, g1_multi_exp, g2_multi_exp
    from hbbft_tpu_torch.ops import cuda_ec
    from hbbft_tpu_torch.ops import ec as EC
    from hbbft_tpu_torch.ops import limbs as LB
    from hbbft_tpu_torch.ops import sha256 as SH
    from hbbft_tpu_torch.parallel import mesh as PM

    rng = random.Random(seed)
    on_card = mesh.devices[0].type == "cuda"
    rounds = (mesh.size - 1) * len(cuda_ec.ring_plan(mesh.devices)) if on_card else 0
    shards = mesh.size if on_card else 0
    sks = [rng.randrange(1, F.R) for _ in range(k)]
    pts = [G1_GEN * s for s in sks]
    pks = [G2_GEN * s for s in sks]
    scalars = [rng.randrange(1 << nbits) % F.R for _ in range(k)]
    bits = LB.scalars_to_bits(scalars, nbits)
    out = {}

    def run(name, fn, want, launches):
        cuda_ec.reset_launches()
        got = fn()
        out[name] = {n: v for n, v in cuda_ec.LAUNCHES.items() if v}
        want_l = {n: c for n, c in launches.items() if c}
        if out[name] != want_l:
            fail(f"{name} on {mesh} launched {out[name]}, not {want_l}")
        if got != want:
            fail(f"{name} on {mesh} differs from the host")

    g1_want, g2_want = g1_multi_exp(pts, scalars), g2_multi_exp(pks, scalars)
    run("sharded_msm_fn", lambda: EC.g1_from_limbs(PM.sharded_msm_fn(mesh)(EC.g1_to_limbs(pts), bits)),
        g1_want, {"scan_g1": shards, "ring_permute": rounds})
    run("sharded_msm_fn(g2)",
        lambda: EC.g2_from_limbs(PM.sharded_msm_fn(mesh, g2=True)(EC.g2_to_limbs(pks), bits)),
        g2_want, {"win_g2": shards, "ring_permute": rounds})
    run("sharded_windowed_g1_msm", lambda: PM.sharded_windowed_g1_msm(pts, scalars, mesh, nbits),
        g1_want, {"win_g1": shards, "ring_permute": rounds})
    run("sharded_g1_msm", lambda: PM.sharded_g1_msm(pts, scalars, mesh), g1_want,
        {"scan_g1": shards, "ring_permute": rounds})
    base = G1_GEN * 7
    shares = [base * s for s in sks]
    msgs = [bytes([i % 256]) * 20 for i in range(k)]

    def step():
        agg1, agg2, dg = PM.sharded_epoch_crypto_fn(mesh)(
            EC.g1_to_limbs(shares), bits, EC.g2_to_limbs(pks), SH.pad_messages(msgs)[:, 0, :])
        return EC.g1_from_limbs(agg1), EC.g2_from_limbs(agg2), SH.digests_to_bytes(dg)

    run("sharded_epoch_crypto_fn", step,
        (g1_multi_exp(shares, scalars), g2_want, [hashlib.sha256(m).digest() for m in msgs]),
        {"scan_g1": shards, "win_g2": shards, "sha256": shards, "ring_permute": 2 * rounds})
    return out


def rbc_phase(record_err, timed, device_timed, epoch_cols: int, mesh) -> dict:
    """Phase 7 (see the module docstring) on the card; fails the script on
    any mismatch.  ``epoch_cols``: the byte columns of the N = 1024
    epoch's parity product (phase 4b), P·L, so its symbol columns are
    P·L/2.  Returns the kernels' times, bounds and each path's launches."""
    import hashlib

    import torch

    from hbbft_tpu_torch.crypto.backend import CpuBackend
    from hbbft_tpu_torch.harness.rbc_probe import RbcProbe
    from hbbft_tpu_torch.ops import cuda_ec
    from hbbft_tpu_torch.ops import gf256 as GF
    from hbbft_tpu_torch.ops import sha256 as SH
    from hbbft_tpu_torch.ops.backend_cuda import CudaBackend
    from hbbft_tpu_torch.crypto import rs as RS

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    out = {}
    cols16 = epoch_cols // 2

    # (a) each kernel against its plain version and the host
    cuda_ec.reset_launches()
    sha_plain_ms = sha_check(record_err)
    merkle_check(record_err)
    gf_check(record_err, cols16)
    out["rbc_check"] = dict(cuda_ec.LAUNCHES)
    log(f"rbc (a): sha256 (the words and the raw entry, its rows unaligned) equal to its plain "
        f"version and hashlib at {RBC_SHA_BATCHES} × "
        f"{RBC_SHA_LENGTHS} B; merkle_levels_device equal to MerkleTree at {RBC_LEAVES} leaves; "
        f"merkle_forest equal to its plain version (levels and roots) at those trees, the forests "
        f"{RBC_FORESTS} and 1 × {RBC_BIG_LEAVES} × 2 B; gf_matmul W=8 and W=16 equal to "
        f"its plain version and the native products (the N={BIG_NODES} epoch's L = "
        f"{epoch_cols // (BIG_NODES - BIG_DEAD)} bytes a shard, {cols16} symbol columns); "
        f"launches {out['rbc_check']}")

    # (b) config 3 on a forced card backend and on the host
    card_be = forced(CudaBackend())
    cuda_ec.reset_launches()
    with RbcProbe(card_be) as probe:
        card = broadcast_1mb(card_be)
    out["broadcast1mb"] = dict(cuda_ec.LAUNCHES)
    check_launches("the forced 1 MB broadcast", out["broadcast1mb"], probe.sent, {})
    if any(out["broadcast1mb"][k] < 1 for k in ("merkle_forest", "gf_matmul")):
        fail(f"the forced 1 MB broadcast did not launch merkle_forest and gf_matmul: "
             f"{out['broadcast1mb']}")
    host = broadcast_1mb(CpuBackend())
    if (card["messages"], card["digest"]) != (host["messages"], host["digest"]):
        fail(f"the 1 MB broadcast's messages differ: card {card}, host {host}")
    out["broadcast"] = {"card_s": card["wall_s"], "host_s": host["wall_s"],
                        "messages": card["messages"]}
    log(f"rbc (b) broadcast n={BCAST_NODES} ({card['good']} good) of {BCAST_PAYLOAD} B: every good "
        f"node output the payload; forced card {card['wall_s']} s, host {host['wall_s']} s; "
        f"{card['messages']} messages, wire digest {card['digest'][:16]} equal on both; "
        f"launches {out['broadcast1mb']}")

    # (d) the mesh's sharded programs
    out["mesh_programs"] = mesh_programs_check(mesh)
    log(f"rbc (d) sharded programs on {mesh}, k={MESH_K}, 255-bit scalars: G1 and G2 "
        f"sharded_msm_fn, sharded_windowed_g1_msm, sharded_g1_msm and sharded_epoch_crypto_fn "
        f"equal to native and hashlib; launches " + json.dumps(out["mesh_programs"]))

    # (e) times on the card's timeline at the shapes of (a) and (b)
    gen = np.random.default_rng(RBC_SEED + 1)

    def kernel_ms(fn):
        fn()  # warm-up
        return device_timed(fn, RBC_REPS)

    # ms: the raw entry (sha256_many's), words_ms: the words entry on the
    # same messages padded by the host
    sha_rows = []
    for batch, length in SHA_TIME_SHAPES:
        raw = gen.integers(0, 256, size=(batch, length), dtype=np.uint8)
        msgs = [r.tobytes() for r in raw]
        rows = torch.from_numpy(raw).to(dev)
        blocks = torch.from_numpy(SH.pad_messages(msgs).view(np.int32)).to(dev)
        if (batch, length) == SHA_FULL_SHAPE:
            want = [hashlib.sha256(m).digest() for m in msgs]
            for entry, got in (("words", SH.sha256(blocks)), ("raw", SH.sha256_bytes(rows))):
                if SH.digests_to_bytes(got) != want:
                    fail(f"sha256 ({entry} entry) at {batch} × {length} B differs from hashlib")
        nblocks = blocks.shape[1]
        b = sha_bound(batch, nblocks)
        sha_rows.append({"batch": batch, "bytes": length, "blocks": nblocks,
                         "ms": kernel_ms(lambda: SH.sha256_bytes(rows)),
                         "words_ms": kernel_ms(lambda: SH.sha256(blocks)),
                         "bound_ms": b[0], "bound_by": b[1], "floor_ms": sha_floor(nblocks)})
    row = sha_rows[len(RBC_SHA_LENGTHS) - 1]
    out["sha256"] = dict(row, plain_ms=sha_plain_ms[RBC_SHA_LENGTHS[-1]], shapes=sha_rows)
    forest_rows = []
    n_live = BIG_NODES - BIG_DEAD
    for T, n, length, roots_only in ((n_live, BIG_NODES, 2, False), (n_live, BIG_NODES, 2, True),
                                     (2 * n_live, BIG_NODES, 2, False), (1, BIG_NODES, 2, False),
                                     (1, BCAST_NODES, 47_663, False),
                                     (1, RBC_BIG_LEAVES, 2, False)):
        values = torch.from_numpy(
            gen.integers(0, 256, size=(T, n, length), dtype=np.uint8)).to(dev)
        b = forest_bound(T, n, length, roots_only)
        forest_rows.append({"trees": T, "leaves": n, "bytes": length, "roots_only": roots_only,
                            "ms": kernel_ms(lambda: SH.merkle_forest(values, roots_only)),
                            "bound_ms": b[0], "bound_by": b[1]})
        if len(forest_rows) == 1:
            _, plain_ms = timed(lambda: SH.merkle_forest_plain(values))
    out["merkle_forest"] = dict(forest_rows[0], plain_ms=plain_ms, shapes=forest_rows)

    def gf_row(W, mat, cols, what, plain_lib=False):
        k = mat.shape[1]
        dtype = torch.uint8 if W == 8 else torch.int16
        # rows at a 16-byte stride, as the device codecs hand their data over
        width = -(-cols * W // 128) * 128 // W
        data = torch.randint(-128 if W == 8 else -(1 << 15), 128 if W == 8 else 1 << 15,
                             (k, width), dtype=torch.int32 if W == 16 else torch.int16,
                             device=dev).to(dtype)[:, :cols]
        b = gf_bound(W, mat.shape[0], k, cols)
        r = {"w": W, "shape": [mat.shape[0], k, cols], "what": what,
             "ms": kernel_ms(lambda: GF.gf_matmul(mat, data)), "bound_ms": b[0], "bound_by": b[1],
             "bound_xor_ms": b[2], "bound_int8_tc_ms": b[3]}
        if plain_lib:
            _, r["plain_ms"] = timed(lambda: GF.gf_matmul_plain(mat, data))
            # torch._int_mm on the binary expansion's shape (not the same
            # function: an int8 product with no parity or packing)
            pad = -(-cols // 8) * 8
            a8 = torch.randint(0, 2, (W * mat.shape[0], W * k), dtype=torch.int8, device=dev)
            b8 = torch.randint(0, 2, (pad, W * k), dtype=torch.int8, device=dev).t()
            r["library_ms"] = kernel_ms(lambda: torch._int_mm(a8, b8))
            r["library_shape"] = [W * mat.shape[0], W * k, pad]
        return r

    k8 = BCAST_NODES - 2 * ((BCAST_NODES - 1) // 3)
    c8 = RS.ReedSolomon(k8, BCAST_NODES - k8)
    shard = -(-(BCAST_PAYLOAD + 4) // k8)
    k16 = BIG_NODES - 2 * ((BIG_NODES - 1) // 3)
    c16 = RS.ReedSolomon16(k16, BIG_NODES - k16)
    dead = list(range(BIG_NODES - BIG_DEAD, BIG_NODES))
    gf_rows = [
        gf_row(16, c16.matrix[k16:], cols16, "epoch1024 parity", plain_lib=True),
        gf_row(16, c16.decode_matrix([i for i in range(BIG_NODES) if i not in dead][:k16]), cols16,
               "epoch1024 decode"),
        gf_row(16, c16.matrix[dead], cols16, "epoch1024 the wave's dead rows"),
        gf_row(16, c16.matrix[dead], cols16 // (BIG_NODES - BIG_DEAD), "epoch1024 dead rows"),
        gf_row(8, c8.matrix[k8:], shard, "broadcast1mb parity", plain_lib=True),
        gf_row(8, c8.decode_matrix(list(range(k8, 2 * k8))), shard, "broadcast1mb decode"),
    ]
    out["gf_matmul"] = dict(gf_rows[4], w16=gf_rows[0], shapes=gf_rows)
    for name in ("sha256", "merkle_forest", "gf_matmul"):
        log(f"rbc (e) {name}: " + json.dumps(out[name]))
    log(f"rbc phase: {time.perf_counter() - t_phase} s")
    return out


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA card")
    try:
        from hbbft_tpu_torch import native as NT
        from hbbft_tpu_torch.ops import cuda_ec, kernels
    except ImportError as exc:
        fail(f"run from the root of a checkout of the repo ({exc})")
    dev = torch.device("cuda")
    global _log_open
    os.makedirs(os.path.dirname(LOG_FILE), exist_ok=True)
    open(LOG_FILE, "w").close()
    _log_open = True
    log(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}"
    )

    # -- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        native_job = pool.submit(NT.build)
        nvcc_job = pool.submit(kernels.build_all)
        if not native_job.result():
            fail("make -C native produced no library")
        nvcc_s = nvcc_job.result()
    log(f"build: {time.perf_counter() - t0} s wall; nvcc per kernel {nvcc_s}")
    for name in kernels.SOURCES:
        for line in kernels.build_log(name).splitlines():
            if "registers" in line or "stack frame" in line:
                log(f"ptxas {name}: {line.strip()}")
    if not NT.available():
        fail("native library did not load")

    from hbbft_tpu_torch.crypto import fields as F
    from hbbft_tpu_torch.crypto import threshold as T
    from hbbft_tpu_torch.crypto.curve import G1, G1_GEN, G2_GEN
    from hbbft_tpu_torch.harness.batching import BatchingBackend, DecObligation
    from hbbft_tpu_torch.harness.dkg import VectorizedDkg, _bump
    from hbbft_tpu_torch.harness.rbc_probe import RbcProbe
    from hbbft_tpu_torch.harness.workload import DecryptionFlushWorkload
    from hbbft_tpu_torch.ops import limbs as LB
    from hbbft_tpu_torch.ops import packed_msm as PM
    from hbbft_tpu_torch.ops.backend_cuda import CudaBackend
    from hbbft_tpu_torch.ops.ec import g1_from_limbs, g2_from_limbs
    from hbbft_tpu_torch.parallel.mesh import make_mesh

    rng = random.Random(SEED)
    max_err = {name: 0 for name in cuda_ec.LAUNCHES}
    # the scalar-mul kernels are held at canonical values, the ring and
    # fr_matmul's byte planes byte for byte, fr_matmul's canonical words
    # word for word
    compared = {"win_g1": "canonical", "win_g2": "canonical", "scan_g1": "canonical",
                "ring_permute": "bytes", "fr_matmul": "words", "fr_planes": "bytes",
                "cosim_hist": "bytes", "cosim_step": "bytes", "sha256": "bytes",
                "merkle_forest": "bytes", "gf_matmul": "bytes"}

    def record_err(name: str, got, plain, what: str) -> None:
        torch.cuda.synchronize()
        if compared[name] == "canonical":
            f = LB.fq()
            if not torch.equal(f.canon(got), got):
                fail(f"{name} returned non-canonical limbs {what}")
            plain = f.canon(plain)
        if tuple(got.shape) != tuple(plain.shape):
            fail(f"{name} gave shape {tuple(got.shape)}, its plain version "
                 f"{tuple(plain.shape)} {what}")
        err = 0
        if got.numel():
            err = int((got.to(torch.int64) - plain.to(torch.int64)).abs().max().item())
        max_err[name] = max(max_err[name], err)
        if err != 0:
            fail(f"{name} differs from its plain version {what} (max |Δ| {err})")

    def timed(fn, reps: int = 1):
        """(result, ms per call) by CUDA events around ``reps`` calls."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end) / reps

    def g1_points(k: int, n_ident: int):
        wires = NT.g1_mul_many(NT.g1_wire(G1_GEN), [rng.randrange(1, F.R) for _ in range(k)])
        for i in rng.sample(range(k), n_ident):
            wires[i] = bytes(96)
        arr = np.frombuffer(b"".join(wires), dtype=np.uint8).reshape(k, 96).copy()
        return wires, PM._wire_points_g1(torch.from_numpy(arr).to(dev))

    def g2_points(k: int, n_ident: int):
        ks = PM.scalar_bytes_batch([rng.randrange(1, F.R) for _ in range(k)], 32)
        raw = NT.g2_mul_many_raw(NT.g2_wire(G2_GEN), ks).reshape(k, 192)
        raw[rng.sample(range(k), n_ident)] = 0
        wires = [raw[i].tobytes() for i in range(k)]
        return wires, PM._wire_points_g2(torch.from_numpy(raw.copy()).to(dev))

    def scalars_with_zeros(k: int, bits: int):
        scalars = [rng.randrange(0, 1 << bits) % F.R for _ in range(k)]
        for i in rng.sample(range(k), 10):
            scalars[i] = 0
        return scalars

    def digits_for(scalars, nbytes: int):
        sc = torch.from_numpy(PM.scalar_bytes_batch(scalars, nbytes)).to(dev)
        return PM._scalar_digits(sc)

    # -- 2. kernels against their plain versions -------------------------
    wires, pts = g1_points(K_CHECK, 10)
    for bits in (96, 255):
        scalars = scalars_with_zeros(K_CHECK, bits)
        dig = digits_for(scalars, (bits + 7) // 8)
        got = cuda_ec.win_g1(pts, dig)
        record_err("win_g1", got, cuda_ec.windowed_plain(pts, dig), f"at {bits}-bit scalars")
        host = got.cpu().numpy()
        for i in range(K_CHECK):
            if NT.g1_wire(g1_from_limbs(host[i])) != NT.g1_mul(wires[i], scalars[i]):
                fail(f"win_g1 row {i} at {bits}-bit scalars is not k·P")
        log(f"win_g1 K={K_CHECK} {bits}-bit: canonical values vs plain, canonical vs native: ok")
        if bits == 255:
            sbits = torch.from_numpy(LB.scalars_to_bits(scalars, 255)).to(dev)
            got = cuda_ec.scan_g1(pts, sbits)
            record_err("scan_g1", got, cuda_ec.scan_plain(pts, sbits), "at 255-bit scalars")
            host = got.cpu().numpy()
            for i in range(K_CHECK):
                if NT.g1_wire(g1_from_limbs(host[i])) != NT.g1_mul(wires[i], scalars[i]):
                    fail(f"scan_g1 row {i} is not k·P")
            log(f"scan_g1 K={K_CHECK} 255-bit: canonical values vs plain, canonical vs native: ok")
    g2_wires, g2_pts = g2_points(K_CHECK, 10)
    scalars = scalars_with_zeros(K_CHECK, 255)
    dig = digits_for(scalars, 32)
    got = cuda_ec.win_g2(g2_pts, dig)
    record_err("win_g2", got, cuda_ec.windowed_g2_plain(g2_pts, dig), "at 255-bit scalars")
    host = got.cpu().numpy()
    for i in range(K_CHECK):
        if NT.g2_wire(g2_from_limbs(host[i])) != NT.g2_mul(g2_wires[i], scalars[i]):
            fail(f"win_g2 row {i} is not k·P")
    log(f"win_g2 K={K_CHECK} 255-bit: canonical values vs plain, canonical vs native: ok")
    del g2_pts, got

    # win_g1 timed at the flush's shape: 65,536 points, 96-bit scalars
    _, pts = g1_points(K_TIME, 64)
    dig = digits_for([rng.randrange(1, 1 << 96) for _ in range(K_TIME)], 12)
    cuda_ec.win_g1(pts, dig)  # warm-up
    got, win_g1_ms = timed(lambda: cuda_ec.win_g1(pts, dig), TIME_REPS)
    plain, win_g1_plain_ms = timed(lambda: cuda_ec.windowed_plain(pts, dig))
    record_err("win_g1", got, plain, f"at K={K_TIME}")
    del plain
    win_g1_bound = windowed_bound(dig, g2=False)
    log(
        f"win_g1 K={K_TIME} nwin={dig.shape[1]}: kernel {win_g1_ms} ms, plain "
        f"{win_g1_plain_ms} ms, bound {win_g1_bound[0]} ms ({win_g1_bound[1]}), "
        f"equal at canonical values"
    )

    # the same points as the mesh flush runs them: four launches of
    # K/4 points, one on each shard's stream
    mesh = make_mesh(MESH_SHARDS)
    quarter = K_TIME // MESH_SHARDS
    shard_in = [
        (pts[j * quarter : (j + 1) * quarter].to(d), dig[j * quarter : (j + 1) * quarter].to(d))
        for j, d in enumerate(mesh.devices)
    ]

    def four_streams():
        mesh.fork()
        outs = []
        for j, (p, d) in enumerate(shard_in):
            with mesh.on(j):
                outs.append(cuda_ec.win_g1(p, d))
        return mesh.join(outs)

    four_streams()  # warm-up
    outs, four_ms = timed(four_streams, TIME_REPS)
    record_err("win_g1", torch.cat([o.to(dev) for o in outs]), got, "on four streams")
    log(
        f"win_g1 on {MESH_SHARDS} streams of {mesh} x {quarter} points: {four_ms} ms "
        f"span (one launch of {K_TIME}: {win_g1_ms} ms), equal to the one launch"
    )
    del outs, shard_in

    # -- 2b. ring_permute against its plain version -----------------------
    cross_card = len(set(mesh.devices)) > 1
    if not cross_card:
        log(f"ring_permute: cross-card leg not run: {torch.cuda.device_count()} card")
    gen = np.random.default_rng(SEED)
    for rows in RING_ROWS:
        bufs = [
            torch.from_numpy(
                gen.integers(-(2**31), 2**31, size=(rows, 3, FQ_LIMBS), dtype=np.int32)
            ).to(d)
            for d in mesh.devices
        ]
        plain = cuda_ec.ring_permute_plain(bufs, mesh)
        for late in [None] + list(range(MESH_SHARDS)):
            if late is not None:  # a long kernel queued on one shard's stream
                with mesh.on(late):
                    torch.cuda._sleep(5_000_000)
            got = mesh.join(cuda_ec.ring_permute(bufs, mesh))
            for j in range(MESH_SHARDS):
                record_err(
                    "ring_permute", got[j], plain[j].to(got[j].device),
                    f"at [{rows}, 3, 38], shard {j}, late stream {late}",
                )
        log(
            f"ring_permute {mesh} [{rows}, 3, 38] int32: byte-equal to plain with every "
            f"stream order tried ({'across cards' if cross_card else 'one card'})"
        )
    # one round's launch at the flush's message shape: the first card's
    # senders (every shard on one card) in one launch, against the library
    # call making the same copies, four copy_ calls and the plain round
    msg = [
        torch.from_numpy(
            gen.integers(-(2**31), 2**31, size=(GROUPS, 3, FQ_LIMBS), dtype=np.int32)
        ).to(d)
        for d in mesh.devices
    ]
    senders = cuda_ec.ring_plan(mesh.devices)[0]
    srcs = [msg[j] for j in senders]
    dsts = [torch.empty_like(msg[(j + 1) % MESH_SHARDS]) for j in senders]
    cur = torch.cuda.current_stream(srcs[0].device)

    def device_timed(fn, reps: int):
        """ms per call on the card's own timeline: the ``reps`` calls are
        enqueued behind a ``_sleep`` on the current stream, so they run
        back to back once it ends; also the host's enqueue wall and the
        sleep's length, which must exceed it."""
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        marks[0].record()
        torch.cuda._sleep(RING_SLEEP_CYCLES)
        marks[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        marks[2].record()
        torch.cuda.synchronize()
        slept_ms = marks[0].elapsed_time(marks[1])
        if enqueue_ms >= slept_ms:
            fail(f"{reps} calls took {enqueue_ms} ms to enqueue, the card slept {slept_ms} ms")
        return marks[1].elapsed_time(marks[2]) / reps

    def four_copies():
        for src, dst in zip(srcs, dsts):
            dst.copy_(src)

    ring_calls = {
        "kernel, one launch": lambda: cuda_ec.ring_copies(srcs, dsts, cur),
        "_foreach_copy_": lambda: torch._foreach_copy_(dsts, srcs),
        f"{len(srcs)} x copy_": four_copies,
        "plain round": lambda: cuda_ec.ring_permute_plain(msg, mesh),
        "ring_copy, one job": lambda: cuda_ec.ring_copy(srcs[0], dsts[0], cur),
        "one copy_": lambda: dsts[0].copy_(srcs[0]),
    }
    on_card, by_host = {}, {}
    for what, fn in ring_calls.items():
        fn()  # warm-up
        on_card[what] = device_timed(fn, RING_REPS)
        by_host[what] = timed(fn, RING_REPS)[1]
    # the library copies above wrote the same bytes: clear them so that
    # the check below sees only the kernel's (on the receivers' cards,
    # whose streams the launch does not wait on)
    for dst in dsts:
        dst.fill_(-1)
        torch.cuda.synchronize(dst.device)
    cuda_ec.ring_copies(srcs, dsts, cur)
    for j, (src, dst) in enumerate(zip(srcs, dsts)):
        record_err("ring_permute", dst, src.to(dst.device), f"timed round, job {j}")
    ring_ms = on_card["kernel, one launch"]
    ring_lib_ms = on_card["_foreach_copy_"]
    # the plain round moves every shard's message; this launch, its senders'
    ring_plain_ms = on_card["plain round"] * len(senders) / MESH_SHARDS
    log(
        f"ring_permute round of {len(srcs)} x [{GROUPS}, 3, 38] int32 from {srcs[0].device}, "
        f"ms per call on the card's timeline ({RING_REPS} enqueued behind a sleep): "
        + json.dumps(on_card)
    )
    log("ring_permute the same, ms per call paced by the host: " + json.dumps(by_host))
    log(
        f"ring_permute one launch vs _foreach_copy_ on the card's timeline: "
        f"{ring_ms} / {ring_lib_ms} ms = {ring_ms / ring_lib_ms}"
    )

    def ring_step():
        mesh.fork()
        return mesh.join(cuda_ec.ring_permute(msg, mesh))

    _, step_ms = timed(ring_step, RING_REPS)
    ring_b = ring_bound(
        sum(src.nbytes for src in srcs), any(dst.device != srcs[0].device for dst in dsts)
    )
    log(
        f"ring_permute round launch: kernel {ring_ms} ms, plain {ring_plain_ms} ms, "
        f"_foreach_copy_ {ring_lib_ms} ms, bound {ring_b[0]} ms ({ring_b[1]}); a whole ring "
        f"step over {MESH_SHARDS} shards paced by the host (events and allocation included) "
        f"{step_ms} ms"
    )
    del msg, bufs, plain, got, srcs, dsts

    # -- 3. the flush at full width --------------------------------------
    work = DecryptionFlushWorkload(N_NODES, rng)
    inner = CudaBackend()
    batches = [work.obligations(b"flush-%d" % i, GROUPS) for i in range(FLUSHES)]
    cuda_ec.reset_launches()
    walls, phases = [], []
    for obs in batches:
        be = BatchingBackend(inner=inner)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        be.prefetch(obs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        phases.append(dict(be.last_flush_phases))
        if be.stats.fallback_items or be.stats.fallback_groups:
            fail(f"honest flush fell back: {be.stats}")
        if not all(be.verify_dec_share(o.pk_share, o.share, o.ciphertext) for o in obs):
            fail("an honest share did not verify")
        if be.stats.cache_misses:
            fail(f"verdicts were not cached by the flush: {be.stats}")
    flush_launches = dict(cuda_ec.LAUNCHES)
    if flush_launches["win_g1"] < 1:
        fail("win_g1 was not launched on the flush path")
    flush_s = statistics.median(walls)
    log(
        f"flush N={N_NODES} x {GROUPS} = {K_TIME} shares: median {flush_s} s "
        f"({K_TIME / flush_s} shares/s), walls {walls}, launches {flush_launches}"
    )
    log("last_flush_phases " + json.dumps(phases[-1]))
    log("flush launch-stage walls " + json.dumps([p["launch"] for p in phases]))

    # one corrupted share, at the full width (the fused check runs on the
    # card and must reject) and at 1024 x 2 (a host-routed product): the
    # fallback must attribute it to exactly its obligation
    corrupt = {}
    for groups in (GROUPS, 2):
        obs = work.obligations(b"corrupt-%d" % groups, groups)
        bad = (groups // 2) * N_NODES + 17
        ob = obs[bad]
        obs[bad] = DecObligation(
            ob.pk_share, T.DecryptionShare(ob.share.point * 7), ob.ciphertext
        )
        be = BatchingBackend(inner=inner)
        before = cuda_ec.LAUNCHES["win_g1"]
        t0 = time.perf_counter()
        be.prefetch(obs)
        corrupt_s = time.perf_counter() - t0
        on_card = cuda_ec.LAUNCHES["win_g1"] > before
        if on_card != (len(obs) >= inner.G1_PRODUCT_DEVICE_MIN):
            fail(f"the corrupted {N_NODES} x {groups} flush ran on the wrong side")
        verdicts = [be.verify_dec_share(o.pk_share, o.share, o.ciphertext) for o in obs]
        wrong = [i for i, v in enumerate(verdicts) if v is not (i != bad)]
        if wrong:
            fail(f"corrupted flush verdicts wrong at {wrong[:10]}")
        if be.stats.fallback_groups != 1 or be.stats.fallback_items != N_NODES:
            fail(f"corrupted flush fell back beyond its one group: {be.stats}")
        corrupt[groups] = (obs, verdicts)
        log(
            f"corrupted flush N={N_NODES} x {groups} ({'card' if on_card else 'host'}): "
            f"only obligation {bad} rejected in {corrupt_s} s; stats {be.stats}"
        )

    # -- 3b. the mesh flush at full width --------------------------------
    mesh_inner = CudaBackend(mesh=mesh)

    def mesh_flush(obs):
        """One mesh flush: (verdicts, wall, phases, stats, launches)."""
        be = BatchingBackend(inner=mesh_inner)
        before = dict(cuda_ec.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        be.prefetch(obs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: cuda_ec.LAUNCHES[k] - before[k] for k in before}
        verdicts = [be.verify_dec_share(o.pk_share, o.share, o.ciphertext) for o in obs]
        return verdicts, wall, dict(be.last_flush_phases), be.stats, launches

    def same_points(sums) -> bool:
        host = [s.cpu().numpy() for s in sums]
        want = [NT.g1_wire(g1_from_limbs(host[0][g])) for g in range(host[0].shape[0])]
        return all(
            NT.g1_wire(g1_from_limbs(h[g])) == want[g] for h in host[1:] for g in range(len(want))
        )

    # a round launches the ring kernel once per sending card
    want_launches = {
        "win_g1": MESH_SHARDS,
        "ring_permute": (MESH_SHARDS - 1) * len(set(mesh.devices)),
    }
    cuda_ec.reset_launches()
    mesh_walls, mesh_phases = [], []
    for obs in batches:
        verdicts, wall, ph, stats, launches = mesh_flush(obs)
        mesh_walls.append(wall)
        mesh_phases.append(ph)
        if stats.fallback_items or stats.fallback_groups or stats.cache_misses:
            fail(f"honest mesh flush fell back or missed: {stats}")
        if not all(verdicts):
            fail("an honest share did not verify on the mesh")
        if any(launches[k] != n for k, n in want_launches.items()):
            fail(f"mesh flush launched {launches}, not {want_launches} and more")
        if len(mesh_inner.last_shard_sums) != MESH_SHARDS or not same_points(
            mesh_inner.last_shard_sums
        ):
            fail("the shards' replicated group sums differ")
    mesh_launches = dict(cuda_ec.LAUNCHES)
    # the single-device flushes verified every share of the same batches
    mesh_s = statistics.median(mesh_walls)
    log(
        f"mesh flush {mesh} N={N_NODES} x {GROUPS} = {K_TIME} shares: median {mesh_s} s "
        f"({K_TIME / mesh_s} shares/s), walls {mesh_walls}, launches {mesh_launches}; "
        f"every share verified, shards' sums equal, verdicts as the single-device flush"
    )
    log("mesh last_flush_phases " + json.dumps(mesh_phases[-1]))
    log("mesh flush launch-stage walls " + json.dumps([p["launch"] for p in mesh_phases]))
    log("mesh flush finalize-stage walls " + json.dumps([p["finalize"] for p in mesh_phases]))
    log("single-device finalize-stage walls " + json.dumps([p["finalize"] for p in phases]))

    obs, single_verdicts = corrupt[GROUPS]
    verdicts, wall, _, stats, launches = mesh_flush(obs)
    if launches["win_g1"] != MESH_SHARDS or launches["ring_permute"] != want_launches["ring_permute"]:
        fail(f"the corrupted mesh flush did not run on the mesh: {launches}")
    if verdicts != single_verdicts or verdicts.count(False) != 1:
        fail("the corrupted mesh flush's verdicts differ from the single-device flush's")
    if stats.fallback_groups != 1 or stats.fallback_items != N_NODES:
        fail(f"corrupted mesh flush fell back beyond its one group: {stats}")
    log(
        f"corrupted mesh flush N={N_NODES} x {GROUPS}: rejected on the card, only "
        f"obligation {verdicts.index(False)} attributed, as single-device, in {wall} s"
    )

    # -- 3c. the flat sharded MSM ------------------------------------------
    flat_wires = NT.g1_mul_many(NT.g1_wire(G1_GEN), [rng.randrange(1, F.R) for _ in range(K_TIME)])
    for i in rng.sample(range(K_TIME), 64):
        flat_wires[i] = bytes(96)
    flat_pts = [NT.g1_unwire(w, G1) for w in flat_wires]
    flat_scalars = scalars_with_zeros(K_TIME, FLAT_BITS)
    before = cuda_ec.LAUNCHES["win_g1"]
    t0 = time.perf_counter()
    total = mesh_inner.g1_msm(flat_pts, flat_scalars)
    flat_s = time.perf_counter() - t0
    if cuda_ec.LAUNCHES["win_g1"] - before != MESH_SHARDS:
        fail("the flat MSM did not run on the mesh")
    if NT.g1_wire(total) != NT.g1_msm(flat_wires, flat_scalars):
        fail("the flat sharded MSM differs from native")
    log(f"flat sharded MSM K={K_TIME} {FLAT_BITS}-bit on {mesh}: equal to native, {flat_s} s")
    del flat_pts, flat_wires

    # -- 4. the verified DKG at full width --------------------------------
    dkg = VectorizedDkg(list(range(DKG_NODES)), DKG_T, random.Random(DKG_SEED))
    cuda_ec.reset_launches()
    t0 = time.perf_counter()
    res = dkg.run(verify_honest=True)
    dkg_s = time.perf_counter() - t0
    dkg_launches = dict(cuda_ec.LAUNCHES)
    entries = DKG_NODES * (DKG_T + 1) ** 2
    checks = res.row_checks + res.value_checks
    if not res.fault_log.is_empty():
        fail(f"honest DKG logged faults: {res.fault_log}")
    if len(res.complete) != DKG_NODES or res.msm_points != entries:
        fail(f"DKG: {len(res.complete)} complete parts, {res.msm_points} MSM points")
    if checks != DKG_NODES**2 + DKG_NODES**3:
        fail(f"DKG settled {checks} checks")
    if dkg_launches["win_g2"] < 1:
        fail("win_g2 was not launched on the DKG path")
    signers = range(0, 2 * DKG_T + 1, 2)[: DKG_T + 1]
    sig = res.pk_set.combine_signatures({i: res.shares[i].sign(b"chip smoke") for i in signers})
    if not res.pk_set.verify_signature(sig, b"chip smoke"):
        fail("t + 1 signature shares of the generated keys did not verify")
    log(
        f"dkg N={DKG_NODES} t={DKG_T}: {entries} G2 points in one fused MSM, "
        f"{res.row_checks} row + {res.value_checks} value checks verified in {dkg_s} s "
        f"({checks / dkg_s} checks/s), launches {dkg_launches}; keys sign and verify"
    )
    log("dkg last_phases " + json.dumps(dkg.last_phases))

    deal = dkg.last_dealing
    rows = list(deal.rows)
    rows[DKG_NODES // 2] = _bump(rows[DKG_NODES // 2], 3 * (DKG_T + 1) + 5)
    before = cuda_ec.LAUNCHES["win_g2"]
    t0 = time.perf_counter()
    ok, _ = dkg._fused_check(rows, deal.vals, deal.commit_wires, deal.n_ackers)
    if ok or cuda_ec.LAUNCHES["win_g2"] == before:
        fail(f"the perturbed fused check was not rejected on the card (ok={ok})")
    log(f"dkg perturbed row cell: fused check rejected on the card in {time.perf_counter() - t0} s")

    # win_g2 timed on the DKG's own fused-MSM points and scalars, whole;
    # its plain version (about 0.6 ms a point) on the first G2_PLAIN_ROWS
    # rows, beside the kernel on the same rows, and on the last K_CHECK rows
    g2_wires, scalars, _ = dkg._fused_terms(deal.rows, deal.vals, deal.commit_wires, deal.n_ackers)
    arr = np.frombuffer(b"".join(g2_wires), dtype=np.uint8).reshape(-1, 192).copy()
    g2_pts = PM._wire_points_g2(torch.from_numpy(arr).to(dev))
    dig = digits_for(scalars, 32)
    got, dkg_g2_ms = timed(lambda: cuda_ec.win_g2(g2_pts, dig))
    head, tail = slice(0, min(G2_PLAIN_ROWS, entries)), slice(entries - K_CHECK, entries)
    record_err(
        "win_g2", got[tail], cuda_ec.windowed_g2_plain(g2_pts[tail], dig[tail]),
        f"at the DKG's K={entries}, rows {tail.start}..{tail.stop}",
    )
    got, win_g2_ms = timed(lambda: cuda_ec.win_g2(g2_pts[head], dig[head]))
    plain, win_g2_plain_ms = timed(lambda: cuda_ec.windowed_g2_plain(g2_pts[head], dig[head]))
    record_err("win_g2", got, plain, f"at the DKG's K={entries}, rows 0..{head.stop}")
    del plain, got, g2_pts
    win_g2_bound = windowed_bound(dig[head], g2=True)
    dkg_g2_bound = windowed_bound(dig, g2=True)
    log(
        f"win_g2 K={head.stop} nwin={dig.shape[1]} (the DKG's first rows): kernel {win_g2_ms} "
        f"ms, plain {win_g2_plain_ms} ms, bound {win_g2_bound[0]} ms ({win_g2_bound[1]}); "
        f"K={entries} (the DKG's fused MSM): kernel {dkg_g2_ms} ms, bound {dkg_g2_bound[0]} "
        f"ms; rows 0..{head.stop} and the last {K_CHECK} equal at canonical values"
    )

    # -- 4b. the HoneyBadger epoch ------------------------------------------
    from hbbft_tpu_torch.core.serialize import dumps
    from hbbft_tpu_torch.crypto.backend import CpuBackend
    from hbbft_tpu_torch.harness.epoch import VectorizedHoneyBadgerSim

    def outcome(res):
        """Everything the twins must agree on, comparable with ``==``."""
        return (
            dumps(res.batch),
            res.accepted,
            [(f.node_id, f.kind.name) for f in res.fault_log],
            res.coin_flips,
            res.shares_verified,
            res.agreement_epochs,
        )

    contribs64 = {i: [b"e64-%d" % i] for i in range(EPOCH_NODES)}

    def epochs64(what: str, per_epoch, **kw):
        """EPOCH_RUNS honest n = 64 epochs; each must commit every
        contribution with 4,096 shares verified, no fault and exactly
        ``per_epoch`` kernel launches (and the RBC kernels as the size
        rules sent work to them)."""
        t0 = time.perf_counter()
        sim = VectorizedHoneyBadgerSim(EPOCH_NODES, random.Random(EPOCH_SEED), **kw)
        setup = time.perf_counter() - t0
        outs, walls = [], []
        for e in range(EPOCH_RUNS):
            before = dict(cuda_ec.LAUNCHES)
            t0 = time.perf_counter()
            with RbcProbe(sim.ref.ops, sim) as probe:
                res = sim.run_epoch(contribs64)
            walls.append(time.perf_counter() - t0)
            launches = {k: cuda_ec.LAUNCHES[k] - before[k] for k in before}
            if res.batch.contributions != contribs64 or res.shares_verified != EPOCH_NODES**2:
                fail(f"{what} epoch {e}: batch or share count wrong ({res.shares_verified})")
            if not res.fault_log.is_empty():
                fail(f"{what} epoch {e}: honest epoch logged faults {res.fault_log}")
            check_launches(f"{what} epoch {e}", launches, probe.sent, per_epoch)
            outs.append(outcome(res))
        if sim.be.stats.fallback_groups:
            fail(f"{what}: an honest epoch fell back: {sim.be.stats}")
        log(f"epoch n={EPOCH_NODES} {what}: setup {setup} s, epoch walls {walls}; phases "
            + json.dumps(res.phases))
        return outs

    # each epoch path's counts are set to 0 just before it and read just after
    cuda_ec.reset_launches()
    card64 = epochs64("CudaBackend()", {"win_g1": 1})
    epoch64_launches = dict(cuda_ec.LAUNCHES)
    host64 = epochs64("CpuBackend()", {}, ops=CpuBackend())
    if card64 != host64:
        fail("the n = 64 epochs on the card and on the host differ")
    cuda_ec.reset_launches()
    mesh64 = epochs64(f"CudaBackend(mesh={mesh})", want_launches, ops=CudaBackend(mesh=mesh))
    mesh64_launches = dict(cuda_ec.LAUNCHES)
    if mesh64_launches["ring_permute"] < 1:
        fail("ring_permute was not launched on the mesh epoch path")
    if mesh64 != card64:
        fail("the n = 64 epochs on the mesh and on one card differ")
    log(f"epoch n={EPOCH_NODES}: {EPOCH_RUNS} epochs identical on the card, the host and "
        f"the mesh (batch bytes, accepted, faults, coins, shares, agreement epochs)")

    big_dead = set(range(BIG_NODES - BIG_DEAD, BIG_NODES))
    contribs = {i: [b"real-%04d" % i] for i in range(BIG_NODES) if i not in big_dead}

    def one_win_g1(what: str, before, probe) -> None:
        """An N = 1024 epoch launches win_g1 exactly once, no other EC,
        Fr or co-sim kernel, and the RBC kernels as the default size rules
        send its calls to the card."""
        launches = {k: cuda_ec.LAUNCHES[k] - before[k] for k in before}
        check_launches(f"{what} N={BIG_NODES} epoch", launches, probe.sent, {"win_g1": 1})

    cuda_ec.reset_launches()
    t0 = time.perf_counter()
    sim = VectorizedHoneyBadgerSim(
        BIG_NODES, random.Random(BIG_SEED), verify_honest=True, emit_minimal=False
    )
    log(f"epoch N={BIG_NODES} ({BIG_DEAD} dead): setup {time.perf_counter() - t0} s")
    forger, victim = 3, 5
    forged = {forger: {victim: T.DecryptionShare(G1_GEN * 0xBAD)}}
    before = dict(cuda_ec.LAUNCHES)
    t0 = time.perf_counter()
    with RbcProbe(sim.ref.ops, sim) as probe:
        res = sim.run_epoch(contribs, dead=big_dead, forged_dec=forged)
    cold_s = time.perf_counter() - t0
    one_win_g1("cold", before, probe)
    faults = [(f.node_id, f.kind.name) for f in res.fault_log]
    if faults != [(forger, "INVALID_DECRYPTION_SHARE")]:
        fail(f"cold N={BIG_NODES} epoch: fault log {faults}, not the forger {forger}")
    if res.batch.contributions != contribs:
        fail(f"cold N={BIG_NODES} epoch: batch of {len(res.batch.contributions)}")
    log(f"epoch N={BIG_NODES} cold, one forged share ({forger} for {victim}): {cold_s} s, "
        f"forger attributed, {len(contribs)} contributions committed; stats {sim.be.stats}; "
        f"phases " + json.dumps(res.phases))
    sim.be.stats = type(sim.be.stats)()
    before = dict(cuda_ec.LAUNCHES)
    t0 = time.perf_counter()
    with RbcProbe(sim.ref.ops, sim) as rbc_split:
        res = sim.run_epoch(contribs, dead=big_dead)
    warm_s = time.perf_counter() - t0
    one_win_g1("warm", before, rbc_split)
    epoch_cols = rbc_split.shapes["parity"][2]
    n_live = BIG_NODES - BIG_DEAD
    if res.batch.contributions != contribs or res.shares_verified != n_live**2:
        fail(f"warm N={BIG_NODES} epoch: batch or share count ({res.shares_verified}) wrong")
    if not res.fault_log.is_empty() or sim.be.stats.fallback_groups != 0:
        fail(f"warm N={BIG_NODES} epoch: faults {res.fault_log}, stats {sim.be.stats}")
    big_launches = dict(cuda_ec.LAUNCHES)
    log(f"epoch N={BIG_NODES} warm: {warm_s} s, {res.shares_verified} shares verified, "
        f"no fallback, launches on the N={BIG_NODES} path (cold and warm) {big_launches}; "
        f"n={EPOCH_NODES} card path {epoch64_launches}, mesh path {mesh64_launches}; phases "
        + json.dumps(res.phases))
    log(f"epoch N={BIG_NODES} warm RBC split (rbc {res.phases.get('rbc')} s): walls "
        + json.dumps(rbc_split.walls) + ", calls " + json.dumps(rbc_split.calls)
        + ", products (m, k, byte columns) " + json.dumps(rbc_split.shapes)
        + ", RBC launches " + json.dumps(rbc_split.sent))
    del sim, res

    # win_g1 timed at the N = 1024 epoch's flush shape (the flush points
    # repeated; the kernel's work does not depend on which points)
    _, pts = g1_points(K_TIME, 64)
    k_big = n_live**2
    reps = -(-k_big // K_TIME)
    big_pts = pts.repeat(reps, 1, 1)[:k_big]
    big_dig = digits_for([rng.randrange(1, 1 << 96) for _ in range(K_TIME)], 12).repeat(reps, 1)[
        :k_big
    ]
    cuda_ec.win_g1(big_pts[:K_TIME], big_dig[:K_TIME])  # warm-up
    got, big_ms = timed(lambda: cuda_ec.win_g1(big_pts, big_dig))
    for rows in (slice(0, K_CHECK), slice(k_big - K_CHECK, k_big)):
        record_err(
            "win_g1", got[rows], cuda_ec.windowed_plain(big_pts[rows], big_dig[rows]),
            f"at the epoch shape, rows {rows.start}..{rows.stop}",
        )
    big_bound = windowed_bound(big_dig, g2=False)
    log(f"win_g1 K={k_big} nwin={big_dig.shape[1]} (the N={BIG_NODES} epoch's flush): kernel "
        f"{big_ms} ms, bound {big_bound[0]} ms ({big_bound[1]}); first and last "
        f"{K_CHECK} rows equal to the plain version at canonical values")
    del big_pts, big_dig, got

    # -- 4c. the era change at N = 1024 ------------------------------------
    from hbbft_tpu_torch.harness.dynamic import VectorizedDynamicSim
    from hbbft_tpu_torch.ops import fr as FR
    from hbbft_tpu_torch.protocols.change import Complete, Remove

    def fr_tensor(vals, *shape):
        """Ints < 2^256 as int32 words on the card, shaped ``shape + (8,)``."""
        raw = b"".join(int(v).to_bytes(32, "little") for v in vals)
        host = np.frombuffer(raw, dtype="<i4").reshape(*shape, FR.FR_WORDS).copy()
        return torch.from_numpy(host).to(dev)

    def fr_random(m, k, p):
        return (fr_tensor([rng.randrange(F.R) for _ in range(m * k)], m, k),
                fr_tensor([rng.randrange(F.R) for _ in range(k * p)], k, p),
                fr_tensor([rng.randrange(F.R) for _ in range(m * p)], m, p))

    def fr_compare(what, a, b, acc, want=None):
        """The kernel against its plain version on the card, word for
        word (max |Δ| over the words as unsigned 32-bit values), and its
        operands' byte planes against theirs byte for byte; with
        ``want``, against Python's (acc + Σ a·b) mod r too."""
        got = FR.fr_matmul(a, b, acc)
        plain = FR.fr_matmul_plain(a, b, acc)
        for x, a_side in ((a, True), (b, False)):
            record_err("fr_planes", FR.fr_planes(x, a_side), FR.fr_planes_plain(x, a_side),
                       f"{what} ({'a' if a_side else 'b'} side)")
        torch.cuda.synchronize()
        diff = (got.to(torch.int64) & 0xFFFFFFFF) - (plain.to(torch.int64) & 0xFFFFFFFF)
        err = int(diff.abs().max().item()) if diff.numel() else 0
        max_err["fr_matmul"] = max(max_err["fr_matmul"], err)
        if err != 0:
            fail(f"fr_matmul differs from its plain version {what} (max |Δ| {err})")
        if want is not None and FR.words_to_fr(got) != want:
            fail(f"fr_matmul {what} is not (acc + a·b) mod r")
        log(f"fr_matmul {what}: equal to the plain version word for word")

    N_CH = BIG_NODES - 1  # the new era's validators
    T_CH = (N_CH - 1) // 3
    TP1 = T_CH + 1
    cuda_ec.reset_launches()
    # (a) one dealer's three shapes of the N = 1023 dealing, with acc
    for m, k, p, what in ((2 * T_CH + 1, TP1, TP1, "rows"), (TP1, TP1, N_CH, "values"),
                          (1, TP1, N_CH, "lambda row")):
        a, b, acc = fr_random(m, k, p)
        fr_compare(f"{what} [{m}, {k}]·[{k}, {p}] + acc", a, b, acc)
        if what == "values":
            fr_val = (a, b, acc)
    for value, name in ((F.R - 1, "r − 1"), ((1 << 256) - 1, "2^256 − 1")):
        k = FR._MAX_K
        fr_compare(f"all {name} at k = {k}", fr_tensor([value] * 3 * k, 3, k),
                   fr_tensor([value] * k * 5, k, 5), fr_tensor([value] * 15, 3, 5),
                   [(value + k * value * value) % F.R] * 15)
    fr_compare("zeros [4, 5]·[5, 6]", fr_tensor([0] * 20, 4, 5), fr_tensor([0] * 30, 5, 6),
               None, [0] * 24)
    # the tile's edges: fewer Fr rows than a tile's 4 (a warpgroup's 64
    # plane rows are 2), contractions around the 32-byte k-step, Fr columns
    # not a multiple of a tile's 8, and the sampler's fold
    for m, k, p in ((1, 33, 9), (2, 31, 9), (3, 33, 17), (5, 1, 9), (6, 31, 10),
                    (6, 32, 10), (6, 33, 10), (9, 352, 30), (9, 70, 257)):
        a, b, acc = fr_random(m, k, p)
        fr_compare(f"edge [{m}, {k}]·[{k}, {p}] + acc", a, b, acc)
    halves = torch.randint(-2**31, 2**31 - 1, (2, TP1 * TP1, FR.FR_WORDS), dtype=torch.int32,
                           device=dev)
    halves[1, :, 4:] = 0
    fr_compare(f"sampler [1, 2]·[2, {TP1 * TP1}]", fr_tensor(FR._SAMPLE_FOLD, 1, 2), halves, None)
    del halves
    odd_a = [rng.randrange(F.R) for _ in range(35)]
    odd_b = [rng.randrange(F.R) for _ in range(65)]
    odd_want = [sum(odd_a[i * 5 + t] * odd_b[t * 13 + j] for t in range(5)) % F.R
                for i in range(7) for j in range(13)]
    fr_compare("odd [7, 5]·[5, 13]", fr_tensor(odd_a, 7, 5), fr_tensor(odd_b, 5, 13), None,
               odd_want)
    # the card's own time of a call (its three launches back to back,
    # queued behind a sleep: the host's enqueue is not in it)
    a, b, acc = fr_val
    FR.fr_matmul(a, b, acc)  # warm-up
    fr_ms = device_timed(lambda: FR.fr_matmul(a, b, acc), FR_REPS)
    _, fr_plain_ms = timed(lambda: FR.fr_matmul_plain(a, b, acc))
    fr_b = fr_bound(TP1, TP1, N_CH, acc=True)
    log(f"fr_matmul [{TP1}, {TP1}]·[{TP1}, {N_CH}] + acc (one dealer's value grid, its two "
        f"fr_planes launches included): kernel {fr_ms} ms, plain {fr_plain_ms} ms, bound "
        f"{fr_b[0]} ms ({fr_b[1]}; {fr_b[0] / fr_ms:.1%}); IMAD count {fr_b[2]} ms "
        f"({fr_b[2] / fr_ms:.1%}), int8 tensor-core count {fr_b[3]} ms ({fr_b[3] / fr_ms:.1%})")
    # the product kernel alone, on the two operands' planes
    pa, pb, res = FR.fr_planes(a, True), FR.fr_planes(b, False), torch.empty_like(acc)
    stream = torch.cuda.current_stream().cuda_stream

    def product():
        if FR._lib().fr_matmul_launch(pa.data_ptr(), pb.data_ptr(), acc.data_ptr(),
                                      res.data_ptr(), TP1, TP1, N_CH, stream) != 0:
            fail("fr_matmul_launch failed")

    product()  # warm-up
    product_ms = device_timed(product, FR_REPS)
    if not torch.equal(res, FR.fr_matmul(a, b, acc)):
        fail("fr_matmul's product kernel on the planes differs from the wrapper's result")
    log(f"fr_matmul's product kernel alone at the value grid: {product_ms} ms "
        f"({fr_b[0] / product_ms:.1%} of the bound; IMAD count {fr_b[2] / product_ms:.1%}, "
        f"int8 tensor-core count {fr_b[3] / product_ms:.1%})")
    del pa, pb, res
    # fr_planes at the value grid's B side (POWᵀ, the larger operand)
    FR.fr_planes(b, False)  # warm-up
    planes_ms = device_timed(lambda: FR.fr_planes(b, False), FR_REPS)
    _, planes_plain_ms = timed(lambda: FR.fr_planes_plain(b, False))
    planes_bytes = b.numel() * 4 + FR.fr_planes_plain(b, False).numel()
    planes_b = (planes_bytes / PEAK_BYTES_PER_S * 1e3, "bytes")
    fr_check_launches = dict(cuda_ec.LAUNCHES)
    log(f"fr_planes B side [{TP1}, {N_CH}] (the value grid's POWᵀ): kernel {planes_ms} ms, "
        f"plain {planes_plain_ms} ms, bound {planes_b[0]} ms (bytes, {planes_bytes} B)")
    del a, b, acc, fr_val

    # (b) the coeffs path: the device engine equals the host engine
    coeff_nodes, coeff_t = 64, 21
    coeffs = VectorizedDkg(range(coeff_nodes), coeff_t, random.Random(0xD0))._dealer_coeffs(
        random.Random(0xC0FFEE))
    cuda_ec.reset_launches()
    t0 = time.perf_counter()
    on_card = VectorizedDkg(range(coeff_nodes), coeff_t, random.Random(0xD0)).run(
        verify_honest=False, coeffs=coeffs, engine="device")
    coeffs_s = time.perf_counter() - t0
    coeffs_launches = dict(cuda_ec.LAUNCHES)
    on_host = VectorizedDkg(range(coeff_nodes), coeff_t, random.Random(0xD0)).run(
        verify_honest=False, coeffs=coeffs, engine="host")
    if (on_card.engine, on_host.engine) != ("device", "host") or coeffs_launches["fr_matmul"] < 1:
        fail(f"coeffs DKG: engines {on_card.engine}/{on_host.engine}, launches {coeffs_launches}")
    if on_card.pk_set.public_key().to_bytes() != on_host.pk_set.public_key().to_bytes():
        fail("coeffs DKG: the device engine's public key differs from the host engine's")
    if [c.to_bytes() for c in on_card.pk_set.commitment.coeffs] != [
            c.to_bytes() for c in on_host.pk_set.commitment.coeffs]:
        fail("coeffs DKG: the device engine's commitment differs from the host engine's")
    if any(on_card.shares[i].scalar != on_host.shares[i].scalar for i in range(coeff_nodes)):
        fail("coeffs DKG: a share of the device engine differs from the host engine's")
    log(f"dkg N={coeff_nodes} t={coeff_t} coeffs path: device engine equal to the host engine "
        f"(public key, commitment, {coeff_nodes} shares) in {coeffs_s} s, launches "
        f"{coeffs_launches}")

    # (c) the churn at bench_churn_1024's shape
    cuda_ec.reset_launches()
    t0 = time.perf_counter()
    sim = VectorizedDynamicSim(BIG_NODES, random.Random(CHURN_SEED), mock=False,
                               verify_honest=False, emit_minimal=True)
    churn_setup_s = time.perf_counter() - t0
    leaving = BIG_NODES - 1
    for v in range((BIG_NODES - 1) // 3 + 1):
        sim.vote_for(v, Remove(leaving))
    first = {i: [b"c-%d" % i] for i in range(BIG_NODES)}
    t0 = time.perf_counter()
    with RbcProbe(sim.ops, sim.sim) as probe1:
        r1 = sim.run_epoch(first)
    era_switch_s = time.perf_counter() - t0
    if r1.change != Complete(Remove(leaving)) or sim.era != 1 or leaving in sim.validators:
        fail(f"churn: change {r1.change}, era {sim.era}, {len(sim.validators)} validators")
    if r1.batch.contributions != first or not r1.fault_log.is_empty():
        fail(f"churn: the era-switch epoch committed {len(r1.batch.contributions)} "
             f"contributions, faults {r1.fault_log}")
    out = sim.last_dkg
    if out.engine != "device" or out.pk_set.threshold != T_CH:
        fail(f"churn: DKG engine {out.engine}, threshold {out.pk_set.threshold}")
    pk_set = sim.sim.pk_set
    signers = range(T_CH + 1)
    sig = pk_set.combine_signatures(
        {i: sim.sim.netinfos[i].secret_key_share.sign(b"era 1") for i in signers})
    if not pk_set.verify_signature(sig, b"era 1") or pk_set.verify_signature(sig, b"era 0"):
        fail("churn: t + 1 signature shares of the new keys do not verify")
    for i in sorted(rng.sample(range(N_CH), 16)):
        if pk_set.commitment.evaluate(i + 1) != G2_GEN * out.shares[i].scalar:
            fail(f"churn: node {i}'s public key share is not G2·share")
    second = {i: [b"d-%d" % i] for i in sim.validators}
    t0 = time.perf_counter()
    with RbcProbe(sim.ops, sim.sim) as probe2:
        r2 = sim.run_epoch(second)
    next_epoch_s = time.perf_counter() - t0
    churn_launches = dict(cuda_ec.LAUNCHES)
    if r2.batch.contributions != second or r2.era != 1 or not r2.fault_log.is_empty():
        fail(f"churn: the next epoch committed {len(r2.batch.contributions)} contributions")
    if (churn_launches["fr_matmul"] < 1
            or churn_launches["fr_planes"] != 2 * churn_launches["fr_matmul"]
            or any(v for k, v in churn_launches.items()
                   if k not in ("fr_matmul", "fr_planes") + cuda_ec.RBC_KERNELS)):
        fail(f"churn: launches {churn_launches}, not fr_matmul with its two fr_planes alone")
    check_rbc("churn", churn_launches, {k: v + probe2.sent[k] for k, v in probe1.sent.items()})
    dealing_s = sim.last_switch_phases["dkg_dealing"]
    deal_macs = N_CH * ((2 * T_CH + 1) * TP1 * TP1 + TP1 * TP1 * N_CH + TP1 * N_CH + TP1
                        + 2 * TP1 * TP1)
    deal_b = fr_bound_macs(deal_macs, 0)
    log(f"churn N={BIG_NODES} → {N_CH} (Remove({leaving})): setup {churn_setup_s} s, era switch "
        f"epoch {era_switch_s} s (DKG {sim.last_switch_phases['dkg']} s on the "
        f"{out.engine} engine, t = {T_CH}), next epoch {next_epoch_s} s with {len(second)} "
        f"contributions; launches {churn_launches}; new keys sign and verify, 16 public key "
        f"shares equal G2·share")
    log("churn last_switch_phases " + json.dumps(sim.last_switch_phases))
    log("churn era-switch epoch phases " + json.dumps(r1.inner.phases))
    log("churn next epoch phases " + json.dumps(r2.inner.phases))
    log(f"churn dealing: {deal_macs} Fr multiply-adds in {dealing_s} s, bound "
        f"{deal_b[0]} ms ({deal_b[1]}; IMAD count {deal_b[2]} ms, int8 tensor-core count "
        f"{deal_b[3]} ms)")
    del sim, r1, r2, out, pk_set

    # -- 4d. scan_g1 through its entry point, then timed -------------------
    wires, pts = g1_points(K_TIME, 64)
    scalars = [rng.randrange(0, F.R) for _ in range(K_TIME)]
    host_bits = LB.scalars_to_bits(scalars, SCAN_BITS)
    cuda_ec.reset_launches()
    got = cuda_ec.scalar_mul_scan(pts, host_bits)
    torch.cuda.synchronize()
    scan_launches = dict(cuda_ec.LAUNCHES)
    if scan_launches["scan_g1"] < 1:
        fail("scalar_mul_scan did not launch scan_g1")
    host = got.cpu().numpy()
    for i in rng.sample(range(K_TIME), 200):
        if NT.g1_wire(g1_from_limbs(host[i])) != NT.g1_mul(wires[i], scalars[i]):
            fail(f"scalar_mul_scan row {i} is not k·P")
    sbits = torch.from_numpy(host_bits).to(dev)
    _, scan_full_ms = timed(lambda: cuda_ec.scan_g1(pts, sbits))
    pts, sbits = pts[:SCAN_TIME_K], sbits[:SCAN_TIME_K]
    got, scan_ms = timed(lambda: cuda_ec.scan_g1(pts, sbits))
    plain, scan_plain_ms = timed(lambda: cuda_ec.scan_plain(pts, sbits))
    record_err("scan_g1", got, plain, f"at K={SCAN_TIME_K}")
    del plain, got
    scan_b = scan_bound(host_bits[:SCAN_TIME_K])
    scan_full_b = scan_bound(host_bits)
    log(
        f"scan_g1 K={SCAN_TIME_K} nbits={SCAN_BITS}: kernel {scan_ms} ms, plain "
        f"{scan_plain_ms} ms, bound {scan_b[0]} ms ({scan_b[1]}), equal at canonical values; "
        f"K={K_TIME}: kernel {scan_full_ms} ms, bound {scan_full_b[0]} ms; entry point "
        f"checked on 200 rows against native"
    )

    # -- 5. the sequential engines ----------------------------------------
    seq_launches = sequential_phase()
    # (e) the virtual-time simulator at the reference simulation's defaults
    sim5e = simulator_phase()

    # -- 6. the packed co-simulation ----------------------------------------
    cosim = cosim_phase(mesh, record_err, timed, device_timed)

    # (e) the n = 64 real-BLS epoch under a divergent view-class schedule
    div_launches = divergent_phase()

    # -- 7. the reliable-broadcast plane and the mesh's sharded programs ----
    rbc = rbc_phase(record_err, timed, device_timed, epoch_cols, mesh)

    # -- 7. report ------------------------------------------------------
    by_path = {
        "win_g1": {"flush": flush_launches["win_g1"], "mesh_flush": mesh_launches["win_g1"],
                   "epoch64": epoch64_launches["win_g1"],
                   "epoch64_mesh": mesh64_launches["win_g1"],
                   "epoch1024": big_launches["win_g1"],
                   **{path: n["win_g1"] for path, n in seq_launches.items()},
                   "seq_sim": sim5e["launches"]["win_g1"],
                   "epoch64_div": div_launches["win_g1"]},
        "win_g2": {"dkg": dkg_launches["win_g2"]},
        "scan_g1": {"scalar_mul_scan": scan_launches["scan_g1"]},
        "ring_permute": {"mesh_flush": mesh_launches["ring_permute"],
                         "epoch64_mesh": mesh64_launches["ring_permute"]},
        "fr_matmul": {"fr_check": fr_check_launches["fr_matmul"],
                      "dkg_coeffs": coeffs_launches["fr_matmul"],
                      "churn1024": churn_launches["fr_matmul"]},
        "fr_planes": {"fr_check": fr_check_launches["fr_planes"],
                      "dkg_coeffs": coeffs_launches["fr_planes"],
                      "churn1024": churn_launches["fr_planes"]},
        **{name: {path: cosim[path][name] for path in ("cosim100k", "cosim100k_mesh", "cosim_twin")}
           for name in ("cosim_hist", "cosim_step")},
    }
    by_path["win_g1"]["epoch64_hw"] = cosim["epoch64_hw"]["win_g1"]
    by_path["ring_permute"]["cosim100k_mesh"] = cosim["cosim100k_mesh"]["ring_permute"]
    for name in cuda_ec.RBC_KERNELS:
        by_path[name] = {
            "rbc_check": rbc["rbc_check"][name], "broadcast1mb": rbc["broadcast1mb"][name],
            "epoch1024": big_launches[name], "epoch64": epoch64_launches[name],
            "epoch64_mesh": mesh64_launches[name], "churn1024": churn_launches[name],
            **{path: n[name] for path, n in seq_launches.items()},
            "seq_sim": sim5e["launches"][name], "epoch64_div": div_launches[name],
        }
    # the sharded programs on the 4-shard mesh
    for name in ("win_g1", "win_g2", "scan_g1", "ring_permute", "sha256"):
        by_path[name]["mesh_programs"] = sum(n.get(name, 0) for n in rbc["mesh_programs"].values())

    def row(name, replaces, launches, ms, plain_ms, bound, library_ms=None, source=None):
        # library_ms None: no PyTorch call computes an EC scalar multiplication
        return {
            "name": name,
            "route": "cuda",
            "source": f"hbbft_tpu_torch/csrc/{source or name}.cu",
            "replaces": replaces,
            "launches": launches,
            "launches_by_path": by_path[name],
            "max_abs_err": max_err[name],
            "compared": compared[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound[0],
            "bound_by": bound[1],
            "library_ms": library_ms,
        }

    kernels_line = {
        "kernels": [
            dict(
                row("win_g1", "hbbft_tpu/ops/pallas_ec.py:230", big_launches["win_g1"],
                    win_g1_ms, win_g1_plain_ms, win_g1_bound),
                # the N = 1024 epoch's flush shape, beside the flush's
                epoch_k=k_big, epoch_ms=big_ms, epoch_bound_ms=big_bound[0],
                # the simulator's forced real-BLS run (phase 5(e))
                seq_sim={"flushes": sim5e["flushes"], "shares": sim5e["shares"],
                         "launches": sim5e["launches"]["win_g1"]},
            ),
            dict(
                row("win_g2", "hbbft_tpu/ops/pallas_ec.py:283", dkg_launches["win_g2"],
                    win_g2_ms, win_g2_plain_ms, win_g2_bound),
                # the DKG's whole fused MSM, beside its first G2_PLAIN_ROWS rows
                dkg_k=entries, dkg_ms=dkg_g2_ms, dkg_bound_ms=dkg_g2_bound[0],
            ),
            dict(
                row("scan_g1", "hbbft_tpu/ops/pallas_ec.py:291", scan_launches["scan_g1"],
                    scan_ms, scan_plain_ms, scan_b),
                # ms and plain_ms at SCAN_TIME_K rows; the kernel alone at
                # the entry point's K_TIME
                shape=[SCAN_TIME_K, SCAN_BITS], k_time=K_TIME, k_time_ms=scan_full_ms,
                k_time_bound_ms=scan_full_b[0],
            ),
            row("ring_permute", "hbbft_tpu/ops/pallas_ec.py:882",
                mesh64_launches["ring_permute"], ring_ms, ring_plain_ms, ring_b, ring_lib_ms),
            dict(
                # library_ms None: no PyTorch call computes an Fr product mod r
                row("fr_matmul", "hbbft_tpu/ops/fr_jax.py:173", churn_launches["fr_matmul"],
                    fr_ms, fr_plain_ms, fr_b),
                replaces_kind="an XLA program (fr_jax._matmul_limbs), not a Pallas kernel",
                shape=[TP1, TP1, N_CH], bound_imad_ms=fr_b[2], bound_int8_tc_ms=fr_b[3],
                # ms is the wrapper's call (its two fr_planes launches included);
                # product_ms the product kernel alone on the planes
                product_ms=product_ms,
                # the whole N = 1023 dealing of the churn's DKG
                dealing_macs=deal_macs, dealing_s=dealing_s, dealing_bound_ms=deal_b[0],
            ),
            dict(
                # library_ms None: the plain version is torch's zero padding and
                # permuted copy, two calls; no one PyTorch call lays out the planes
                row("fr_planes", "hbbft_tpu/ops/fr_jax.py:173", churn_launches["fr_planes"],
                    planes_ms, planes_plain_ms, planes_b, source="fr_matmul"),
                replaces_kind="the limb layout of an XLA program's dot_general "
                              "(fr_jax._matmul_limbs), not a Pallas kernel",
                shape=[TP1, N_CH],
            ),
            dict(
                # library_ms None: no one PyTorch call computes the step (a
                # histogram, a reach-row dot and the agreement algebra); ms is
                # the whole step, one cooperative launch of step_blocks blocks
                row("cosim_step", "hbbft_tpu/parallel/mesh.py:473",
                    cosim["cosim100k"]["cosim_step"], cosim["step_ms"], cosim["step_plain_ms"],
                    cosim["step_bound"]),
                replaces_kind="an XLA program (packed_cosim_step_fn's _body), not a Pallas kernel",
                shape=[COSIM_TIME_N, COSIM_TIME_Z], scale=cosim["scale"],
                step_blocks=cosim["step_blocks"],
                # the mesh form on one shard of the whole n: cosim_hist, then
                # the decision kernel
                mesh_pair_ms=cosim["mesh_pair_ms"],
                # an empty <<<1, 32>>> kernel, and the step's grid empty and
                # crossing its grid barrier, enqueued the same way
                floor_ms=cosim["floor_ms"], grid_ms=cosim["grid_ms"],
                barrier_ms=cosim["barrier_ms"],
            ),
            dict(
                # library_ms: one index_add_ of the same counts (zones in
                # range); launches: the mesh path's (one card launches none)
                row("cosim_hist", "hbbft_tpu/parallel/mesh.py:473",
                    cosim["cosim100k_mesh"]["cosim_hist"], cosim["hist_ms"],
                    cosim["hist_plain_ms"], cosim["hist_bound"], cosim["hist_library_ms"],
                    source="cosim_step"),
                replaces_kind="the zone histogram of an XLA program (packed_cosim_step_fn's "
                              "_body), not a Pallas kernel",
                shape=[COSIM_TIME_N, COSIM_TIME_Z], floor_ms=cosim["floor_ms"],
            ),
            dict(
                # library_ms None: no PyTorch call hashes; ms (the raw
                # entry) and plain_ms at 1,000 messages of 47,672 B (the 1 MB
                # broadcast's leaf message); launches: the sharded epoch
                # step's on the mesh, timed at its 16 × 20 B shard in shapes
                # (the trees hash their own leaves in merkle_forest, so the
                # broadcasts and epochs launch no sha256)
                row("sha256", "hbbft_tpu/ops/sha256_jax.py:90",
                    rbc["mesh_programs"]["sharded_epoch_crypto_fn"]["sha256"],
                    rbc["sha256"]["ms"], rbc["sha256"]["plain_ms"],
                    (rbc["sha256"]["bound_ms"], rbc["sha256"]["bound_by"])),
                replaces_kind="an XLA program (_compress / sha256_device), not a Pallas kernel",
                shape=[rbc["sha256"]["batch"], rbc["sha256"]["bytes"]],
                shapes=rbc["sha256"]["shapes"],
            ),
            dict(
                # library_ms None: no PyTorch call hashes; ms at the N = 1024
                # epoch's forest of 974 trees of 1,024 2-byte leaves, every
                # level; every other forest timed in shapes
                row("merkle_forest", "hbbft_tpu/ops/sha256_jax.py:147",
                    rbc["broadcast1mb"]["merkle_forest"], rbc["merkle_forest"]["ms"],
                    rbc["merkle_forest"]["plain_ms"],
                    (rbc["merkle_forest"]["bound_ms"], rbc["merkle_forest"]["bound_by"]),
                    source="merkle"),
                replaces_kind="an XLA program's Merkle tree (merkle_levels_device), not a "
                              "Pallas kernel",
                shape=[rbc["merkle_forest"]["trees"], rbc["merkle_forest"]["leaves"],
                       rbc["merkle_forest"]["bytes"]],
                shapes=rbc["merkle_forest"]["shapes"],
            ),
            dict(
                # ms at the 1 MB broadcast's W = 8 parity product; w16 the
                # N = 1024 epoch's W = 16 parity product; library_ms is
                # torch._int_mm on the binary expansion's shape, NOT the
                # same function (an int8 product, no parity or packing)
                row("gf_matmul", "hbbft_tpu/ops/gf256_jax.py:78", rbc["broadcast1mb"]["gf_matmul"],
                    rbc["gf_matmul"]["ms"], rbc["gf_matmul"]["plain_ms"],
                    (rbc["gf_matmul"]["bound_ms"], rbc["gf_matmul"]["bound_by"]),
                    rbc["gf_matmul"]["library_ms"]),
                replaces_kind="XLA programs (_bitsliced_matmul :78, _bitsliced_matmul16 :219), "
                              "not Pallas kernels",
                library_is="torch._int_mm on the binary expansion's shape, not the same function",
                shape=rbc["gf_matmul"]["shape"], library_shape=rbc["gf_matmul"]["library_shape"],
                w16=rbc["gf_matmul"]["w16"], shapes=rbc["gf_matmul"]["shapes"],
            ),
        ]
    }
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start} s")
    log(json.dumps(kernels_line))
    log(card_line())
    log(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
