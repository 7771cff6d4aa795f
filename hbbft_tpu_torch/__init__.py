"""hbbft_tpu_torch — the PyTorch/CUDA port of ``hbbft_tpu``.

A package of its own beside the JAX reference: it imports ``torch``,
numpy and the standard library, never ``jax`` and never anything under
``hbbft_tpu``.  The host crypto it needs (fields, curve, hashing,
pairing, threshold objects, polynomials) is carried here as its own
copy.  Two paths run on the card: the device half of the
share-verification flush, with the windowed G1 scalar multiplication in
a CUDA kernel written for Hopper (``csrc/win_g1.cu``), and the fused
verification MSM of the dealerless DKG (``harness/dkg.py``), with the
windowed G2 scalar multiplication in ``csrc/win_g2.cu``.  The flush
also runs sharded over a mesh (``parallel/mesh.py``): each shard on its
own stream and card, the group partials ring-reduced by
``csrc/ring_permute.cu``.  Whole HoneyBadger epochs
(``harness/epoch.py``: ``VectorizedHoneyBadgerSim``,
``VectorizedQueueingSim``) run over that flush: encryption, the
reliable broadcast and the agreement on the host, every epoch's
decryption shares and coin shares verified on the card.  The era
change (``harness/dynamic.py``: ``VectorizedDynamicSim``,
``VectorizedDynamicQueueingSim``) runs votes on-chain, a dealerless DKG
whose clean elided dealing plane is the Fr matrix-product kernel
``csrc/fr_matmul.cu`` (``ops/fr.py``), and the era restart.  The
sequential protocol engines every validator runs (``protocols/``:
Broadcast, Agreement, CommonSubset, HoneyBadger, SyncKeyGen,
DynamicHoneyBadger, QueueingHoneyBadger) run on the adversarial test
network of ``harness/network.py``, their share checks flushed in
batches through the same backend, and on the reference's virtual-time
simulator (``harness/simulation.py``: ``SimNetwork``,
``simulate_queueing_honey_badger``; the CLI
``examples/torch_simulation.py``).  The packed co-simulation
(``harness/cosim.py``: ``PackedHoneyBadgerCosim``,
``PackedQueueingCosim``) keeps a whole network's agreement state as
``[n]`` columns on the card and resolves each epoch with one launch of
the ``cosim_step`` kernel (``csrc/cosim_step.cu``; on a mesh a
``cosim_hist`` and a ``cosim_step`` launch a shard), under the WAN model
of ``harness/wan.py``.  The bit-serial G1 ladder
(``csrc/scan_g1.cu``) lies on no production path.

Entry points run on the card unless the caller asks for the CPU:
``ops.backend_cuda.CudaBackend()``, ``harness.dkg.VectorizedDkg(...)``,
``harness.epoch.VectorizedHoneyBadgerSim(n, rng)``,
``harness.dynamic.VectorizedDynamicSim(n, rng)``,
``harness.network.TestNetwork(...)`` and
``harness.simulation.simulate_queueing_honey_badger(...)`` without
``ops``,
``harness.cosim.PackedHoneyBadgerCosim(n, rng)``,
``core.network_info.NetworkInfo.generate_map(...)`` and
``parallel.mesh.make_mesh(n)`` mean ``torch.device("cuda")`` and raise
when CUDA is absent;
``device="cpu"`` runs every kernel's plain PyTorch version instead (the
CPU tests do this; the epoch's entry points take it as
``ops=CudaBackend(device="cpu")``).
"""
