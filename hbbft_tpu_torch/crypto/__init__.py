"""Host crypto of the port: its own copies of the JAX package's host layer."""
