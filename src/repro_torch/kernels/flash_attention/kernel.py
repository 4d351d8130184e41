"""Wrappers around the two hand-written CUDA flash attention kernels.

Both replace the TPU kernel ``repro/kernels/flash_attention/kernel.py::
flash_attention``.  :func:`route` picks one per call by a fixed rule:

- ``"tensor_core"`` (``csrc/flash_attention_sm90.cu``): bf16 wgmma fed by
  TMA, for bf16 operands whose q/k head dim d and v head dim dv are one
  of the pairs in ``TC_HEAD_DIMS`` ((64, 64), (128, 128), and MLA's
  (192, 128)) and that TMA can read in place (every base pointer 16-byte
  aligned, every stride but the head dim's a multiple of 16 bytes);
- ``"cuda_core"`` (``csrc/flash_attention.cu``): fp32 arithmetic on the
  CUDA cores, for every other call the wrapper accepts (fp32, MLA's fp32
  parity runs among them, other (d, dv) pairs up to (256, 256) --
  recurrentgemma-9b's local attention in either dtype -- and misaligned
  views).

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
#: The CUDA-core kernel's largest q/k head dim and v head dim.
MAX_HEAD_DIM = 256
MAX_V_HEAD_DIM = 256
#: The (q/k head dim, v head dim) pairs of the tensor-core kernel.
TC_HEAD_DIMS = ((64, 64), (128, 128), (192, 128))
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
    when q, k and v are bf16, (q's head dim, v's head dim) is a pair of
    ``TC_HEAD_DIMS``, each is unit stride along its head dim, and TMA can
    read them in place (16-byte aligned base pointers, the other strides
    multiples of 16 bytes); ``"cuda_core"`` otherwise.  Reads only dtypes,
    shapes, strides and pointers, so it answers for CPU tensors too."""
    ts = (q, k, v)
    if (any(t.dtype != torch.bfloat16 for t in ts)
            or (q.shape[-1], v.shape[-1]) not in TC_HEAD_DIMS):
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
    """q: [B,H,Sq,d]; k: [B,K,Sk,d]; v: [B,K,Sk,dv] (fp32 or bf16, one
    dtype, one CUDA device, H % K == 0, d <= 256, dv <= 256, unit stride
    along the head dim).  Returns [B,H,Sq,dv] in q's dtype and memory
    layout, from the kernel that :func:`route` picks."""
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be on one CUDA "
                         "device")
    check_operands(q, k, v)
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


def check_operands(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> None:
    """Raise unless one of the kernels takes q, k and v: one dtype, fp32
    or bf16; 4-D with matching batch, kv heads and lengths, H % K == 0;
    non-empty, d <= MAX_HEAD_DIM and dv <= MAX_V_HEAD_DIM; unit stride
    along the head dim.  Reads only dtypes, shapes and strides, so it
    answers for CPU tensors too."""
    ts = (q, k, v)
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"flash_attention: fp32 or bf16, one dtype; got "
                        f"{[str(t.dtype) for t in ts]}")
    if any(t.dim() != 4 for t in ts):
        raise ValueError(f"flash_attention: 4-D operands, got "
                         f"{[tuple(t.shape) for t in ts]}")
    B, H, Sq, d = q.shape
    K, Sk, dv = k.shape[1], k.shape[2], v.shape[3]
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != d
            or H % K != 0):
        raise ValueError(f"flash_attention: q [B,H,Sq,d], k [B,K,Sk,d] and "
                         f"v [B,K,Sk,dv] with H % K == 0, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if (min(B, H, Sq, Sk, d, dv) < 1 or d > MAX_HEAD_DIM
            or dv > MAX_V_HEAD_DIM):
        raise ValueError(f"flash_attention: non-empty operands, "
                         f"d <= {MAX_HEAD_DIM} and dv <= {MAX_V_HEAD_DIM}, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if any(t.stride(3) != 1 for t in ts):
        raise ValueError("flash_attention: the head dim must be unit stride")


def _launch_tensor_core(q, k, v, *, causal=True, window=None, softcap=None,
                        scale=None) -> torch.Tensor:
    """The tensor-core kernel on operands that :func:`flash_attention` has
    checked; raises where :func:`route` says it cannot take them."""
    if route(q, k, v) != "tensor_core":
        raise ValueError(f"flash_attention: the tensor-core kernel takes "
                         f"bf16 with (d, dv) in {TC_HEAD_DIMS} and 16-byte "
                         f"aligned pointers and strides only")
    B, H, Sq, d = q.shape
    K, Sk, dv = k.shape[1], k.shape[2], v.shape[3]
    out = empty_like_q(q, dv)           # q's layout, unit stride in dv
    geom = (ctypes.c_longlong * 33)(
        *(x for t in (q, k, v) for part in tma_geometry(t) for x in part))
    o_strides = (ctypes.c_longlong * 3)(*out.stride()[:3])
    err = build.library().repro_flash_attention_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ctypes.addressof(geom), ctypes.addressof(o_strides),
        B, H, K, Sq, Sk, d, dv, _scale(scale, d), softcap or 0.0,
        int(causal), window or 0, build.stream_handle(q.device))
    build.check(err, "flash_attention (tensor cores)")
    TC_LAUNCHES.count += 1
    LAUNCHES.count += 1
    return out


def _launch_cuda_core(q, k, v, *, causal=True, window=None, softcap=None,
                      scale=None) -> torch.Tensor:
    """The CUDA-core kernel, which takes every call that
    :func:`flash_attention` accepts."""
    B, H, Sq, d = q.shape
    K, Sk, dv = k.shape[1], k.shape[2], v.shape[3]
    out = empty_like_q(q, dv)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    err = build.library().repro_flash_attention(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), ctypes.addressof(strides), B, H, K, Sq, Sk, d, dv,
        _scale(scale, d), softcap or 0.0, int(causal), window or 0,
        int(all(_aligned(t) for t in (q, k, v))),
        build.stream_handle(q.device))
    build.check(err, "flash_attention")
    LAUNCHES.count += 1
    return out


def empty_like_q(q: torch.Tensor, dv: int) -> torch.Tensor:
    """An output [B,H,Sq,dv] laid out like q (its batch, head and sequence
    axes in q's stride order), unit stride in dv: ``empty_like(q)`` when
    dv is q's head dim."""
    if dv == q.shape[3]:
        return torch.empty_like(q)
    order = sorted(range(3), key=lambda i: -q.stride(i))
    out = torch.empty([q.shape[i] for i in order] + [dv], dtype=q.dtype,
                      device=q.device)
    return out.permute(*(order.index(i) for i in range(3)), 3)


def _scale(scale: Optional[float], d: int) -> float:
    return scale if scale is not None else 1.0 / math.sqrt(d)
