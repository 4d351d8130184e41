"""Blocked fp32 matmul and the im2col 3×3 conv on top of it."""
