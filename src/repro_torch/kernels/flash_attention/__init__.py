"""Flash attention: plain version, CUDA kernel, dispatching op."""
