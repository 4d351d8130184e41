"""Plain PyTorch version of the fused KNN distance + top-k.

Squared L2 by the expansion |q|² − 2 q·xᵀ + |x|² (the JAX package's
formula, so both sides round alike), then the k smallest per query in
ascending order.  A stable sort keeps ``jax.lax.top_k``'s tie order (the
lower index wins); ``torch.topk`` promises no order among ties.  On the
card the product runs in full fp32 (``torch.backends.cuda.matmul.
allow_tf32 = False``): TF32 would break the 1e-4 distance tolerance.
"""
from __future__ import annotations

from typing import Tuple

import torch


def sq_dists(queries: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """[Q, D], [N, D] → [Q, N] squared L2 by the norm expansion."""
    if queries.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False   # full fp32
    return ((queries * queries).sum(-1, keepdim=True)
            - 2.0 * queries @ data.T
            + (data * data).sum(-1)[None, :])


def knn_ref(queries: torch.Tensor, data: torch.Tensor, k: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries: [Q, D]; data: [N, D].  Returns (dists [Q,k] fp32,
    idx [Q,k] int32) — squared-L2, ascending."""
    d2 = sq_dists(queries, data)
    dists, idx = torch.sort(d2, dim=1, stable=True)
    return dists[:, :k].contiguous(), idx[:, :k].to(torch.int32)
