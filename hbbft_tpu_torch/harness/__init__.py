"""Harnesses of the port: the batched share-verification flush, the
adversarial test network of the sequential engines, and the vectorized
epoch, DKG and era-change simulations."""
