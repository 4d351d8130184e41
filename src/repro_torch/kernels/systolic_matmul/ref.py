"""Plain PyTorch versions of the systolic matmul and the im2col conv.

On the card the plain matmul runs in full fp32: it switches TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``), since TF32 keeps about
three decimal digits and would break the CNN's 2e-4 tolerance.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] in fp32, cast back to ``a.dtype``."""
    if a.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False   # full fp32
    return (a.float() @ b.float()).to(a.dtype)


def im2col3x3(x: torch.Tensor) -> torch.Tensor:
    """x [H, W, Cin] → [H·W, 9·Cin] columns of a 3×3 "same" window, in the
    JAX package's (row offset, column offset, channel) order."""
    H, W, Cin = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    cols = torch.stack([xp[i:i + H, j:j + W, :]
                        for i in range(3) for j in range(3)], dim=2)
    return cols.reshape(H * W, 9 * Cin)


def conv_im2col_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """VGG-style 3×3 same conv via im2col (paper CNN benchmark).
    x: [H, W, Cin]; w: [3, 3, Cin, Cout] → [H, W, Cout]."""
    H, W, Cin = x.shape
    Cout = w.shape[-1]
    out = matmul_ref(im2col3x3(x), w.reshape(9 * Cin, Cout))
    return out.reshape(H, W, Cout)
