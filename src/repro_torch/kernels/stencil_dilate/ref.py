"""Plain PyTorch version of the 13-point 2-D Dilate stencil.

Morphological dilation with a diamond structuring element of radius 2
(|di|+|dj| <= 2 → 13 points); out-of-bounds neighbours are ignored (they
read as the dtype's lowest finite value).  Only max is used, so the CUDA
kernel must agree bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

OFFSETS = tuple((di, dj)
                for di in range(-2, 3) for dj in range(-2, 3)
                if abs(di) + abs(dj) <= 2)


def dilate_ref(img: torch.Tensor) -> torch.Tensor:
    """img: [H, W] → [H, W] max over the 13-point diamond."""
    neg = torch.finfo(img.dtype).min
    padded = F.pad(img, (2, 2, 2, 2), value=neg)
    H, W = img.shape
    out = torch.full_like(img, neg)
    for di, dj in OFFSETS:
        out = torch.maximum(out,
                            padded[2 + di:2 + di + H, 2 + dj:2 + dj + W])
    return out


def dilate_iters_ref(img: torch.Tensor, iters: int) -> torch.Tensor:
    for _ in range(iters):
        img = dilate_ref(img)
    return img
