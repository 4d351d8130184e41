"""Wrappers around the two hand-written CUDA flash attention kernels.

Both replace the TPU kernel ``repro/kernels/flash_attention/kernel.py::
flash_attention``.  :func:`route` picks one per call by a fixed rule:

- ``"tensor_core"`` (``csrc/flash_attention_sm90.cu``): bf16 wgmma fed by
  TMA, for bf16 operands with d in {64, 128} that TMA can read in place
  (every base pointer 16-byte aligned, every stride but the head dim's a
  multiple of 16 bytes);
- ``"cuda_core"`` (``csrc/flash_attention.cu``): fp32 arithmetic on the
  CUDA cores, for every other call the wrapper accepts (fp32, other head
  dims, misaligned views).

Both read q, k and v through their strides (the head dim must be unit
stride), so a ``[B,S,H,d]`` tensor seen as ``[B,H,S,d]`` needs no copy, and
write an output laid out like q.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from .. import build

#: Launches of either kernel (one per call).
LAUNCHES = build.LaunchCounter("flash_attention")
#: Launches of the tensor-core kernel alone.
TC_LAUNCHES = build.LaunchCounter("flash_attention_tc")
MAX_HEAD_DIM = 128
TC_HEAD_DIMS = (64, 128)
#: One TMA load of the tensor-core kernel: 64 of d (128 bytes, the swizzle
#: span) by 128 rows of one head of one batch.
TC_BOX = (64, 128, 1, 1)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _aligned(t: torch.Tensor) -> bool:
    """Every row of ``t`` starts on a 16-byte boundary."""
    size = t.element_size()
    return (t.data_ptr() % 16 == 0
            and all(s * size % 16 == 0 for s in t.stride()[:3]))


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel that takes ``flash_attention(q, k, v)``: ``"tensor_core"``
    when q, k and v are bf16 with d in {64, 128}, unit stride along d, and
    TMA can read them in place (16-byte aligned base pointers, the other
    strides multiples of 16 bytes); ``"cuda_core"`` otherwise.  Reads only
    dtypes, shapes, strides and pointers, so it answers for CPU tensors
    too."""
    ts = (q, k, v)
    if (any(t.dtype != torch.bfloat16 for t in ts)
            or q.shape[-1] not in TC_HEAD_DIMS):
        return "cuda_core"
    for t in ts:
        if t.stride(-1) != 1 or t.data_ptr() % 16:
            return "cuda_core"
        if any(s * t.element_size() % 16 for s in t.stride()[:-1]):
            return "cuda_core"
    return "tensor_core"


def tma_geometry(t: torch.Tensor) -> Tuple[tuple, tuple, tuple]:
    """(dims, byte strides, box) of the tensor-core kernel's 4-D tensor map
    over a ``[batch, heads, S, d]`` view: dims innermost first,
    ``(d, S, heads, batch)``, and the byte strides of the last three."""
    B, heads, S, d = t.shape
    size = t.element_size()
    return ((d, S, heads, B),
            (t.stride(2) * size, t.stride(1) * size, t.stride(0) * size),
            TC_BOX)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,H,Sq,d]; k, v: [B,K,Sk,d] (fp32 or bf16, one dtype, one CUDA
    device, H % K == 0, d <= 128, unit stride along d).  Returns
    [B,H,Sq,d] in q's dtype and memory layout, from the kernel that
    :func:`route` picks."""
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
    launch = (_launch_tensor_core if route(q, k, v) == "tensor_core"
              else _launch_cuda_core)
    return launch(q, k, v, causal=causal, window=window, softcap=softcap,
                  scale=scale)


def _launch_tensor_core(q, k, v, *, causal=True, window=None, softcap=None,
                        scale=None) -> torch.Tensor:
    """The tensor-core kernel on operands that :func:`flash_attention` has
    checked; raises where :func:`route` says it cannot take them."""
    if route(q, k, v) != "tensor_core":
        raise ValueError("flash_attention: the tensor-core kernel takes "
                         "bf16 with d in (64, 128) and 16-byte aligned "
                         "pointers and strides only")
    B, H, Sq, d = q.shape
    K, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)           # q's layout, so unit stride in d
    geom = (ctypes.c_longlong * 33)(
        *(x for t in (q, k, v) for part in tma_geometry(t) for x in part))
    o_strides = (ctypes.c_longlong * 3)(*out.stride()[:3])
    err = build.library().repro_flash_attention_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ctypes.addressof(geom), ctypes.addressof(o_strides),
        B, H, K, Sq, Sk, d, _scale(scale, d), softcap or 0.0, int(causal),
        window or 0, build.stream_handle(q.device))
    build.check(err, "flash_attention (tensor cores)")
    TC_LAUNCHES.count += 1
    LAUNCHES.count += 1
    return out


def _launch_cuda_core(q, k, v, *, causal=True, window=None, softcap=None,
                      scale=None) -> torch.Tensor:
    """The CUDA-core kernel, which takes every call that
    :func:`flash_attention` accepts."""
    B, H, Sq, d = q.shape
    K, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)           # q's layout, so unit stride in d
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    err = build.library().repro_flash_attention(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), ctypes.addressof(strides), B, H, K, Sq, Sk, d,
        _scale(scale, d), softcap or 0.0, int(causal), window or 0,
        int(all(_aligned(t) for t in (q, k, v))),
        build.stream_handle(q.device))
    build.check(err, "flash_attention")
    LAUNCHES.count += 1
    return out


def _scale(scale: Optional[float], d: int) -> float:
    return scale if scale is not None else 1.0 / math.sqrt(d)
