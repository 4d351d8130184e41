"""13-point diamond dilation: plain version, CUDA kernel, dispatching op."""
