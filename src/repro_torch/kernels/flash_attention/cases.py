"""The cases and limits by which the flash attention kernels are held to
their plain version on the card (``chip_smoke.py`` and the ``gpu`` tests).

Each case is ``(label, (B, H, K, Sq, Sk), keyword arguments)`` and runs at
several head dims.  A bf16 output is held to the plain version of the same
inputs twice: elementwise within ``ATOL + RTOL * |ref|``, and row by row
within ``ROW_REL_LIMIT`` of the row's norm (:func:`row_rel_err`).  The row
check sees a fault confined to rows whose outputs are small, which the
elementwise one misses: a query row that averages over ~2000 keys has
outputs of ~0.02, under ATOL.
"""
from __future__ import annotations

import torch

FEATURE_CASES = (
    ("gqa", (2, 4, 2, 64, 64), {}),
    ("mqa", (1, 8, 1, 128, 128), {}),
    # chatglm3-6b's grouping: 32 query heads on 2 kv heads (G = 16).
    ("gqa_g16", (1, 32, 2, 128, 128), {}),
    ("sq_lt_sk", (1, 2, 2, 64, 256), {}),
    ("ragged_100_200", (1, 2, 2, 100, 200), {}),
    ("ragged_70_70", (2, 4, 2, 70, 70), {}),
    ("window", (1, 2, 2, 128, 128), {"window": 32}),
    ("softcap", (1, 2, 2, 128, 128), {"softcap": 50.0}),
    ("window_softcap", (1, 2, 2, 128, 128), {"window": 64, "softcap": 30.0}),
    ("noncausal", (1, 2, 2, 128, 128), {"causal": False}),
    # Window 40 with Sk - Sq = 192: the first key tiles of the last query
    # rows are fully masked (the -1e30 rule, wiped by alpha = 0).
    ("masked_lead_block", (1, 4, 2, 64, 256), {"window": 40}),
)
#: The cases of the CUDA-core kernel's (256, 256) instance, run at
#: d = dv = 256: recurrentgemma-9b's grouping (16 query heads on one kv
#: head), a window that bites (each query past the first 128 of 512 drops
#: keys), ragged lengths with Sq < Sk, softcap, and no mask.
HD256_CASES = (
    ("mqa_g16", (1, 16, 1, 128, 128), {}),
    ("mqa_g16_window_bites", (1, 16, 1, 512, 512), {"window": 128}),
    ("ragged_window", (1, 4, 1, 100, 200), {"window": 64}),
    ("window_softcap", (1, 2, 2, 128, 128), {"window": 32, "softcap": 30.0}),
    ("noncausal", (1, 2, 1, 96, 160), {"causal": False}),
)
#: bf16 elementwise limit: |got - ref| <= ATOL + RTOL * |ref|.
ATOL = RTOL = 2e-2
#: bf16 row limit on ||got - ref|| / ||ref||; both round p and the output
#: to bf16 (a step of 2^-8 to 2^-7), which leaves about 4e-3 on the worst
#: row, and one key in 2000 dropped from a row moves it by about 2e-2.
ROW_REL_LIMIT = 1e-2
#: fp32 elementwise limit.
FP32_ATOL = 2e-5


def row_rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest ``||got - ref|| / ||ref||`` over the rows (the last
    dim) of two outputs; a row whose ``ref`` is zero counts its error
    alone."""
    got, ref = got.float(), ref.float()
    norm = ref.norm(dim=-1)
    scale = torch.where(norm > 0, norm, torch.ones_like(norm))
    return float(((got - ref).norm(dim=-1) / scale).max())


def excess(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest ``|got - ref| - RTOL * |ref|``: at most ATOL when
    ``got`` passes the elementwise check."""
    got, ref = got.float(), ref.float()
    return float(((got - ref).abs() - RTOL * ref.abs()).max())
