"""Plain PyTorch version of the 13-point 2-D Dilate stencil.

Morphological dilation with a diamond structuring element of radius 2
(|di|+|dj| <= 2 → 13 points); out-of-bounds neighbours are ignored (they
read as the dtype's lowest finite value, as does the running maximum's
start).  The binary maximum is JAX's (:func:`jax_maximum`): NaN when
either operand is NaN, -0.0 below +0.0, otherwise the larger.  That
operation is commutative and associative (NaN payloads aside), so any
order of the operands gives the same bits, and the CUDA kernel must agree
with this version bit for bit (NaN where both are NaN).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

OFFSETS = tuple((di, dj)
                for di in range(-2, 3) for dj in range(-2, 3)
                if abs(di) + abs(dj) <= 2)


def jax_maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(a, b)``: ``b`` where it is NaN, larger than ``a``, or
    equal to ``a`` with its sign bit clear; ``a`` elsewhere.  Written out
    so it does not rest on ``torch.maximum``'s choice between equal
    operands (-0.0 against +0.0), which differs from JAX's on the CPU."""
    take_b = (b > a) | ((b == a) & ~torch.signbit(b)) | torch.isnan(b)
    return torch.where(take_b, b, a)


def dilate_ref(img: torch.Tensor) -> torch.Tensor:
    """img: [H, W] → [H, W] max over the 13-point diamond."""
    neg = torch.finfo(img.dtype).min
    padded = F.pad(img, (2, 2, 2, 2), value=neg)
    H, W = img.shape
    out = torch.full_like(img, neg)
    for di, dj in OFFSETS:
        out = jax_maximum(out,
                          padded[2 + di:2 + di + H, 2 + dj:2 + dj + W])
    return out


def dilate_iters_ref(img: torch.Tensor, iters: int) -> torch.Tensor:
    for _ in range(iters):
        img = dilate_ref(img)
    return img


def bit_mismatches(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements of two fp32 tensors that differ: NaN in one and not the
    other, or, where neither is NaN, any bit (so -0.0 differs from +0.0).
    NaN payloads are not compared."""
    if got.shape != want.shape:
        raise ValueError(f"shapes differ: {tuple(got.shape)} against "
                         f"{tuple(want.shape)}")
    nan_got, nan_want = torch.isnan(got), torch.isnan(want)
    bits_differ = got.view(torch.int32) != want.view(torch.int32)
    return int(((nan_got != nan_want) | (bits_differ & ~nan_got)).sum())
