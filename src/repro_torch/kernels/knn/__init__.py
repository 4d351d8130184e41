"""Fused KNN distance + top-k: plain version, CUDA kernel, dispatching op."""
