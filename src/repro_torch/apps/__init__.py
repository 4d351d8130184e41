"""The paper's benchmark applications: Stencil (Dilate), PageRank, KNN and
the systolic CNN (§5) — as (a) TaskGraphs consumed by the real partitioner,
(b) mechanistic latency models reproducing Table 3 / §5.7, and (c) runnable
PyTorch numerics on the hand-written CUDA kernels (PageRank: fixed-order
segment sums) — plus the memory-bound HBM workload set (Axpy, Dot, Gemv,
AxpyDot) whose shard tasks read operands through ``async_mmap`` memory
channels (repro_torch.mem).
"""
from . import axpy, axpydot, cnn, dot, gemv, knn, pagerank, stencil

APPS = {"stencil": stencil, "pagerank": pagerank, "knn": knn, "cnn": cnn,
        "axpy": axpy, "dot": dot, "gemv": gemv, "axpydot": axpydot}

__all__ = ["APPS", "stencil", "pagerank", "knn", "cnn",
           "axpy", "dot", "gemv", "axpydot"]
