"""Wrapper around the hand-written CUDA matmul kernels (``csrc/matmul.cu``).

Both replace the TPU kernel ``repro/kernels/systolic_matmul/kernel.py::
matmul``.  :func:`route` picks one per call by a fixed rule: the narrow
kernel (one warp per row of A, B in shared memory) for N <= 16 when B,
transposed and padded, fits its 48 KB of shared memory; the tiled kernel
otherwise: register-blocked tiles of 8 x 8 outputs a thread, a pipelined
K loop, and a K split summed in split order where the tiles alone leave
the card underfilled (:func:`tiled_plan`).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from .. import build

#: Launches of either kernel.
LAUNCHES = build.LaunchCounter("matmul")
#: Launches of the tiled kernel alone (also counted in :data:`LAUNCHES`).
TILED_LAUNCHES = build.LaunchCounter("matmul_tiled")
NARROW_MAX_N = 16
NARROW_SMEM_BYTES = 48 * 1024


def route(M: int, K: int, N: int) -> str:
    """``"narrow"`` or ``"tiled"``: the kernel that takes [M, K] x [K, N].
    Narrow for N <= 16 when B, transposed with N padded to a power of two
    and K to a multiple of 4, fits 48 KB of shared memory."""
    if N > NARROW_MAX_N:
        return "tiled"
    padded_n = 1 << (N - 1).bit_length()
    padded_k = -(-K // 4) * 4
    fits = padded_n * padded_k * 4 <= NARROW_SMEM_BYTES
    return "narrow" if fits else "tiled"


#: The tiled kernel's (BM, BN) output tiles, the largest first.  A block
#: has BM * BN / 64 threads of 8 x 8 outputs each: 256 or 128.  (64 x 64
#: tiles, blocks of two warps, hid too little of each slab's load latency
#: to win at any product that was timed.)
TILES = ((128, 128), (64, 128), (128, 64))
#: The depth of one K slab (``kBK`` in ``csrc/matmul.cu``).
SLAB = 16
#: The plan's design constants, for the H100 SXM whatever card runs the
#: product, so that a product's bits depend on its shape alone: its SMs;
#: the blocks' threads an SM holds at 128 registers a thread; one SM's
#: fp32 FMAs a nanosecond (67 TFLOP/s over 132 SMs and 2 operations).
SMS = 132
THREADS_HELD_PER_SM = 65536 // 128
SM_FMA_PER_NS = 67e3 / SMS / 2
#: The modelled share of that peak an SM reaches with w warps resident,
#: RATE_MAX * w / (w + RATE_HALF_WARPS); the split sum's fixed cost, its
#: cost for each batch of SUM_BATCH partials a thread loads at once
#: (``kSumBatch`` in ``csrc/matmul.cu``), and the rate at which the
#: workspace is written and read back: fitted to the times that
#: ``scripts/torch_matmul_sweep.py`` measures on an H100 SXM.
RATE_MAX = 0.8
RATE_HALF_WARPS = 3
SPLIT_SUM_NS = 3000.0
SUM_BATCH = 8
SUM_BATCH_NS = 500.0
WORKSPACE_BYTES_PER_NS = 4000.0
#: The most K splits a plan takes.
MAX_SPLITS = 128


@dataclasses.dataclass(frozen=True)
class TiledPlan:
    """How the tiled kernel takes one [M, K] x [K, N] product: (bm, bn)
    output tiles, ``splits`` ranges of ``slabs`` K slabs each (the last cut
    at K), ``blocks`` = tiles x splits (grid.x: the tiles, row tile
    fastest; grid.y: the splits), and the modelled time in ns."""

    bm: int
    bn: int
    splits: int
    slabs: int
    tiles: int
    blocks: int
    model_ns: float

    def k_ranges(self, K: int) -> list:
        """[(k0, k1)] of each split, in the order their partials are
        summed."""
        step = self.slabs * SLAB
        return [(j * step, min(K, (j + 1) * step))
                for j in range(self.splits)]


def _model_ns(M: int, K: int, N: int, bm: int, bn: int, splits: int,
              slabs: int) -> float:
    """The modelled time of one plan: the FMAs of the SM that runs the
    most blocks (the last wave's fill), at the rate that the warps it holds
    at once reach, plus, when K is split, the second launch, its batches of
    loads and the workspace [splits, M, N] written and read back."""
    threads = bm * bn // 64
    blocks = -(-M // bm) * -(-N // bn) * splits
    per_sm = -(-blocks // SMS)                    # blocks the busiest SM runs
    warps = min(per_sm, THREADS_HELD_PER_SM // threads) * threads / 32
    rate = SM_FMA_PER_NS * RATE_MAX * warps / (warps + RATE_HALF_WARPS)
    ns = per_sm * bm * bn * slabs * SLAB / rate
    if splits > 1:
        ns += (SPLIT_SUM_NS + -(-(splits - 1) // SUM_BATCH) * SUM_BATCH_NS
               + (2 * splits + 1) * M * N * 4 / WORKSPACE_BYTES_PER_NS)
    return ns


@functools.cache
def tiled_plan(M: int, K: int, N: int) -> TiledPlan:
    """The tiled kernel's plan for [M, K] x [K, N], a pure function of the
    shape: the tile and the number of K splits with the least modelled time
    (:func:`_model_ns`), ties to fewer splits and then the larger tile.  A
    split count is taken only where it gives every split whole slabs and
    none an empty range.

    At the H100's 132 SMs: CNN's default product [1024, 576] x [576, 64]
    has 16 output tiles of 64 x 64, 12% of the SMs, so the plan splits K;
    a VGG-16 conv3 layer, [3136, 2304] x [2304, 256], has 98 tiles of
    64 x 128 (74% of the SMs), split 4 ways into 392 blocks, 2.97 an SM,
    all held at once (4 an SM fit at 128 registers a thread)."""
    if min(M, K, N) <= 0:
        raise ValueError(f"tiled_plan: empty product {M} x {K} x {N}")
    total = -(-K // SLAB)
    best = None
    for bm, bn in TILES:
        tiles = -(-M // bm) * -(-N // bn)
        for splits in range(1, min(total, MAX_SPLITS) + 1):
            slabs = -(-total // splits)
            if -(-total // slabs) != splits:
                continue                           # an empty last range
            ns = _model_ns(M, K, N, bm, bn, splits, slabs)
            if best is None or ns < best.model_ns:
                best = TiledPlan(bm, bn, splits, slabs, tiles,
                                 tiles * splits, ns)
    return best


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] → [M, N], fp32 in, fp32 accumulator, fp32 out,
    on ``a``'s CUDA device, from the kernel that :func:`route` picks."""
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError("matmul: a and b must be on one CUDA device")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"matmul: fp32 only, got {a.dtype}/{b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: [M, K] x [K, N], got {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul: a and b must be contiguous")
    M, K = a.shape
    N = b.shape[1]
    if M == 0 or N == 0 or K == 0:
        return torch.zeros((M, N), dtype=torch.float32, device=a.device)
    launch = _launch_narrow if route(M, K, N) == "narrow" else _launch_tiled
    return launch(a, b)


def _launch_narrow(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The narrow kernel on operands that :func:`matmul` has checked; the
    kernel refuses a product that :func:`route` sends to the tiled one."""
    (M, K), N = a.shape, b.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    vec = int(K % 4 == 0 and a.data_ptr() % 16 == 0)
    err = build.library().repro_matmul_narrow_f32(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, vec,
        build.stream_handle(a.device))
    build.check(err, "matmul (narrow)")
    LAUNCHES.count += 1
    return out


def _launch_tiled(a: torch.Tensor, b: torch.Tensor,
                  plan: TiledPlan | None = None) -> torch.Tensor:
    """The tiled kernel, which takes every product that :func:`matmul`
    accepts, by :func:`tiled_plan`'s plan (``plan`` only to time another:
    any plan gives a result within the tolerance, its bits its own)."""
    (M, K), N = a.shape, b.shape[1]
    plan = plan or tiled_plan(M, K, N)
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    work = out
    if plan.splits > 1:
        work = torch.empty((plan.splits, M, N), dtype=torch.float32,
                           device=a.device)
    vec = (int(K % 4 == 0 and a.data_ptr() % 16 == 0)
           | 2 * int(N % 4 == 0 and b.data_ptr() % 16 == 0))
    err = build.library().repro_matmul_f32(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), work.data_ptr(), M, N, K,
        plan.bm, plan.bn, plan.splits, plan.slabs, vec,
        build.stream_handle(a.device))
    build.check(err, "matmul (tiled)")
    LAUNCHES.count += 1
    TILED_LAUNCHES.count += 1
    return out
