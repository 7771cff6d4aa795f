"""hbbft_tpu_torch — the PyTorch/CUDA port of ``hbbft_tpu``.

A package of its own beside the JAX reference: it imports ``torch``,
numpy and the standard library, never ``jax`` and never anything under
``hbbft_tpu``.  The host crypto it needs (fields, curve, hashing,
pairing, threshold objects) is carried here as its own copy; the device
half of the share-verification flush runs in torch on the card, with
the windowed G1 scalar multiplication in a CUDA kernel written for
Hopper (``csrc/win_g1.cu``).

Entry points run on the card unless the caller asks for the CPU:
``ops.backend_cuda.CudaBackend()`` means ``torch.device("cuda")`` and
raises when CUDA is absent; ``CudaBackend(device="cpu")`` runs every
kernel's plain PyTorch version instead (the CPU tests do this).
"""
