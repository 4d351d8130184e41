"""The cases and limits by which the flash attention kernels are held to
their plain version on the card (``chip_smoke.py`` and the ``gpu`` tests),
and by which the op's gradient is (:func:`grad_errors`).

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

from .ops import flash_attention_op
from .ref import attention_ref

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
    # llava-next-34b's grouping: 7 query heads a kv head (an odd G), then
    # ragged, with Sq < Sk.
    ("gqa_g7", (1, 14, 2, 128, 128), {}),
    ("gqa_g7_ragged", (2, 14, 2, 100, 157), {}),
    # seamless's cross attention: no mask with Sq > Sk (delta < 0), the
    # keys ending 96 into a key tile.
    ("noncausal_sq_gt_sk", (1, 4, 4, 256, 96), {"causal": False}),
    # The (64, 64) instance's 192-row work tiles: Sq past a multiple of 192
    # (the last tile's second and third warpgroups hold rows past Sq, or
    # none), causal and not; a causal diagonal that crosses two 128-key
    # tiles inside the second 192-row tile; Sq > Sk without a mask, Sk
    # ending 72 into a key tile; the decode step's one query on 512 keys;
    # G = 2 with a ragged Sq.
    ("ragged_sq_200", (1, 2, 2, 200, 200), {}),
    ("ragged_sq_320_noncausal", (1, 2, 2, 320, 320), {"causal": False}),
    ("ragged_sq_577", (1, 2, 2, 577, 577), {}),
    ("diagonal_across_key_tiles", (1, 2, 2, 384, 384), {}),
    ("noncausal_sq_gt_sk_tail", (1, 2, 2, 600, 200), {"causal": False}),
    ("one_query_512_keys", (4, 4, 4, 1, 512), {"causal": False}),
    ("gqa_g2_ragged", (2, 4, 2, 250, 250), {}),
    # Past Sq = 512 (three warpgroups): a window and a softcap with
    # Sk - Sq = 300, where a warpgroup skips the key tiles its rows do not
    # see and the others mask them; G = 2, causal, ragged.
    ("window_softcap_three_wgs", (1, 2, 2, 600, 900),
     {"window": 100, "softcap": 30.0}),
    ("gqa_g2_three_wgs", (1, 4, 2, 700, 700), {}),
    # The (128, 128) kernel's persistent grid (one block on each of the
    # card's 132 SMs): more work tiles than twice the SMs, so that blocks
    # take three or more tiles of different lengths, at G = 7 with a
    # ragged Sq (294 tiles of 128 rows, each pair's last one row); the
    # same with gemma2's softcap 50, a window and Sq < Sk; fewer work
    # tiles than SMs (35); and a non-causal call past 132 tiles (140),
    # Sq > Sk, Sk ending 8 into a key tile.
    ("persistent_g7_ragged", (2, 49, 7, 257, 257), {}),
    ("persistent_g7_window_softcap", (2, 49, 7, 300, 400),
     {"window": 160, "softcap": 50.0}),
    ("persistent_fewer_tiles_than_sms", (1, 7, 1, 640, 640), {}),
    ("persistent_noncausal_140_tiles", (1, 28, 4, 600, 520),
     {"causal": False}),
)
#: The cases of the (256, 256) instances (bf16 on the tensor cores' 64-key
#: tiles, fp32 on the CUDA cores), run at d = dv = 256: recurrentgemma-9b's
#: grouping (16 query heads on one kv head), a window that bites (each
#: query past the first 128 of 512 drops keys), ragged lengths with
#: Sq < Sk, softcap, and no mask; then the 64-key tile's edges: window 40
#: with Sk - Sq = 192 (the last rows' leading 64-key tile fully masked),
#: Sq = Sk = 192 (the causal diagonal crosses the second query block's
#: middle) and Sk = 157 (the tail ends 29 keys into a 64-key tile).
HD256_CASES = (
    ("mqa_g16", (1, 16, 1, 128, 128), {}),
    ("mqa_g16_window_bites", (1, 16, 1, 512, 512), {"window": 128}),
    ("ragged_window", (1, 4, 1, 100, 200), {"window": 64}),
    ("window_softcap", (1, 2, 2, 128, 128), {"window": 32, "softcap": 30.0}),
    ("noncausal", (1, 2, 1, 96, 160), {"causal": False}),
    ("masked_lead_tile", (1, 4, 1, 64, 256), {"window": 40}),
    ("mqa_g16_diagonal_mid_block", (1, 16, 1, 192, 192), {}),
    ("ragged_tail_in_tile", (2, 4, 1, 77, 157), {}),
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


#: The bf16 op's gradient may be at most this many times as far from the
#: fp32 gradient as the plain version's is (the forward's 2x rule).
GRAD_GATE = 2.0


def _grads(fn, ts, do, **kw):
    ts = [t.detach().requires_grad_(True) for t in ts]
    return torch.autograd.grad(fn(*ts, **kw), ts, do)


def grad_errors(q, k, v, do, **kw) -> dict:
    """For each of dq, dk and dv: ``(op, plain)``, the largest absolute
    error from the fp32 gradient (autograd of :func:`attention_ref` on the
    operands widened to fp32) of the op's gradient (the kernel forward and
    ``backward.py``) and of autograd of :func:`attention_ref` run on the
    operands as they are (fp32 inside, each gradient rounded to the
    operands' dtype), for the output gradient ``do``."""
    exact = _grads(attention_ref, [t.float() for t in (q, k, v)],
                   do.float(), **kw)
    got = _grads(flash_attention_op, (q, k, v), do, **kw)
    plain = _grads(attention_ref, (q, k, v), do, **kw)
    return {name: (float((g.float() - e).abs().max()),
                   float((p.float() - e).abs().max()))
            for name, g, p, e in zip(("dq", "dk", "dv"), got, plain, exact)}
