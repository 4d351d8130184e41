"""Fused KNN distance + top-k.

On a CUDA tensor :func:`knn_op` launches the hand-written kernel
(:func:`.kernel.knn`); a CPU tensor takes the plain version.  Any other
device raises — nothing falls back.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .kernel import knn
from .ref import knn_ref


def knn_op(queries: torch.Tensor, data: torch.Tensor, k: int = 10
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries [Q, D], data [N, D] → (dists [Q, k] fp32 ascending,
    idx [Q, k] int32); among equal distances the lower index comes first."""
    if queries.device.type == "cpu":
        return knn_ref(queries, data, k)
    if queries.device.type != "cuda":
        raise ValueError(f"knn_op: no kernel for device {queries.device}")
    return knn(queries, data, k)


__all__ = ["knn_op", "knn_ref"]
