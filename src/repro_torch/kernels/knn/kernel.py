"""Wrapper around the hand-written CUDA KNN kernel (``csrc/knn.cu``).

Replaces the TPU kernel ``repro/kernels/knn/kernel.py::knn``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import build

#: Launches of the CUDA kernel (one per call: its two passes together).
LAUNCHES = build.LaunchCounter("knn")
#: Pass-1 thread blocks per SM that the range split aims for.
BLOCKS_PER_SM = 1
#: Queries a pass-1 block takes at D <= 16 and k <= 16 (``kWarps * kQT``
#: in ``csrc/knn.cu``).
QUERIES_PER_BLOCK = 32


def split_ranges(n: int, q: int, sm_count: int, tile: int) -> Tuple[int, int]:
    """(points per block, ranges): contiguous ranges of whole ``tile``s,
    about ``BLOCKS_PER_SM`` pass-1 blocks per SM over all query blocks."""
    tiles = -(-n // tile)
    qblocks = -(-q // QUERIES_PER_BLOCK)
    target = max(1, BLOCKS_PER_SM * sm_count // qblocks)
    per_block = -(-tiles // target) * tile
    return per_block, -(-n // per_block)


def partial_bytes(n: int, q: int, k: int, sm_count: int, tile: int) -> int:
    """Bytes of the per-range candidate lists pass 1 writes and pass 2
    reads: one (fp32, int32) list of k per (query, range)."""
    return split_ranges(n, q, sm_count, tile)[1] * q * k * 8


def knn(queries: torch.Tensor, data: torch.Tensor, k: int
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries [Q, D], data [N, D] (fp32, contiguous, one CUDA device) →
    (dists [Q, k] fp32 ascending, idx [Q, k] int32)."""
    if queries.device.type != "cuda" or data.device != queries.device:
        raise ValueError("knn: queries and data must be on one CUDA device")
    if queries.dtype != torch.float32 or data.dtype != torch.float32:
        raise TypeError(f"knn: fp32 only, got {queries.dtype}/{data.dtype}")
    if (queries.dim() != 2 or data.dim() != 2
            or queries.shape[1] != data.shape[1]):
        raise ValueError(f"knn: [Q, D] and [N, D], got "
                         f"{tuple(queries.shape)} and {tuple(data.shape)}")
    if not (queries.is_contiguous() and data.is_contiguous()):
        raise ValueError("knn: queries and data must be contiguous")
    Q, D = queries.shape
    N = data.shape[0]
    if not 1 <= k <= N or D < 1:
        raise ValueError(f"knn: need 1 <= k <= N and D >= 1, got k={k}, "
                         f"N={N}, D={D}")
    lib = build.library()
    dev = queries.device
    out_d = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return out_d, out_i
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_block, nblk = split_ranges(N, Q, sms, lib.repro_knn_tile())
    part_d = torch.empty(nblk * Q * k, dtype=torch.float32, device=dev)
    part_i = torch.empty(nblk * Q * k, dtype=torch.int32, device=dev)
    err = lib.repro_knn_f32(queries.data_ptr(), data.data_ptr(),
                            part_d.data_ptr(), part_i.data_ptr(),
                            out_d.data_ptr(), out_i.data_ptr(),
                            Q, N, D, k, per_block, nblk,
                            build.stream_handle(dev))
    build.check(err, "knn")
    LAUNCHES.count += 1
    return out_d, out_i
