"""Device code of the port: limb field, G1 points, CUDA kernels, the CUDA backend."""
