"""The paper's benchmark applications ported so far: Stencil (Dilate), KNN
and the systolic CNN (§5) — as (a) TaskGraphs consumed by the real
partitioner, (b) mechanistic latency models reproducing Table 3 / §5.7,
and (c) runnable PyTorch numerics on the hand-written CUDA kernels.
PageRank and the HBM workload set are not yet ported.
"""
from . import cnn, knn, stencil

APPS = {"stencil": stencil, "knn": knn, "cnn": cnn}

__all__ = ["APPS", "stencil", "knn", "cnn"]
