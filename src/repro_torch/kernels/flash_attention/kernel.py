"""Wrapper around the hand-written CUDA flash attention kernel
(``csrc/flash_attention.cu``).

Replaces the TPU kernel ``repro/kernels/flash_attention/kernel.py::
flash_attention``.  The kernel reads q, k and v through their strides (the
head dim must be unit stride), so a ``[B,S,H,d]`` tensor seen as
``[B,H,S,d]`` needs no copy, and it writes an output laid out like q.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import build

#: Launches of the CUDA kernel (one per call).
LAUNCHES = build.LaunchCounter("flash_attention")
MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _aligned(t: torch.Tensor) -> bool:
    """Every row of ``t`` starts on a 16-byte boundary."""
    size = t.element_size()
    return (t.data_ptr() % 16 == 0
            and all(s * size % 16 == 0 for s in t.stride()[:3]))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,H,Sq,d]; k, v: [B,K,Sk,d] (fp32 or bf16, one dtype, one CUDA
    device, H % K == 0, d <= 128, unit stride along d).  Returns
    [B,H,Sq,d] in q's dtype and memory layout."""
    ts = (q, k, v)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError("flash_attention: q, k, v must be on one CUDA "
                         "device")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"flash_attention: fp32 or bf16, one dtype; got "
                        f"{[str(t.dtype) for t in ts]}")
    if any(t.dim() != 4 for t in ts):
        raise ValueError(f"flash_attention: 4-D operands, got "
                         f"{[tuple(t.shape) for t in ts]}")
    B, H, Sq, d = q.shape
    K, Sk = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != d
            or H % K != 0):
        raise ValueError(f"flash_attention: q [B,H,Sq,d] and k, v [B,K,Sk,d]"
                         f" with H % K == 0, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if min(B, H, Sq, Sk, d) < 1 or d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: non-empty operands and "
                         f"d <= {MAX_HEAD_DIM}, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    if any(t.stride(3) != 1 for t in ts):
        raise ValueError("flash_attention: the head dim must be unit stride")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got "
                         f"{window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got "
                         f"{softcap}")
    out = torch.empty_like(q)           # q's layout, so unit stride in d
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = build.library()
    err = lib.repro_flash_attention(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), ctypes.addressof(strides), B, H, K, Sq, Sk, d,
        scale if scale is not None else 1.0 / math.sqrt(d),
        softcap or 0.0, int(causal), window or 0,
        int(all(_aligned(t) for t in ts)), build.stream_handle(dev))
    build.check(err, "flash_attention")
    LAUNCHES.count += 1
    return out
