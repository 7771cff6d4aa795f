"""Harnesses of the port: the batched share-verification flush, the
adversarial test network of the sequential engines, the virtual-time
simulator, the vectorized epoch, DKG and era-change simulations, the
packed co-simulation and the WAN model."""
