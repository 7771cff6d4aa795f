"""The protocol pieces the vectorized epoch takes from ``hbbft_tpu/protocols``."""
