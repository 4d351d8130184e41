"""Images that carry the values on which two binary maxima can differ:
NaN, both zeros, both infinities and both largest finite values.  Made
with numpy from a seed, so ``chip_smoke.py``, the card tests and the CPU
parity tests hand the same arrays to every version of dilate; compare the
results with :func:`.ref.bit_mismatches`."""
from __future__ import annotations

import numpy as np

FLT_MAX = np.finfo(np.float32).max
SPECIALS = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf, FLT_MAX, -FLT_MAX],
                    np.float32)
KINDS = ("specials", "zero_checkerboard", "negative_zeros",
         "zeros_and_negatives", "negative_infinity")


def dilate_image(kind: str, h: int, w: int, seed: int = 0) -> np.ndarray:
    """An fp32 [h, w] image of ``kind``:

    - ``specials``: standard normal with 5% of the cells drawn from
      ``SPECIALS``, and one of each at the corners and edge midpoints;
    - ``zero_checkerboard``: +0.0 and -0.0 alternating;
    - ``negative_zeros``: -0.0 everywhere but one +0.0;
    - ``zeros_and_negatives``: mostly -0.0, some +0.0, -1, -inf, -FLT_MAX
      and a rare NaN, so a neighbourhood's maximum is often a zero of
      either sign;
    - ``negative_infinity``: -inf everywhere but one -0.0 (the running
      maximum starts at -FLT_MAX, which -inf does not pass).
    """
    rng = np.random.default_rng(seed)
    if kind == "specials":
        img = rng.standard_normal((h, w), dtype=np.float32)
        hit = rng.random((h, w)) < 0.05
        img[hit] = rng.choice(SPECIALS, size=int(hit.sum()))
        spots = [(0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1),
                 (0, w // 2), (h // 2, 0), (h // 2, w - 1)]
        for (i, j), v in zip(spots, SPECIALS):
            img[i, j] = v
    elif kind == "zero_checkerboard":
        even = (np.add.outer(np.arange(h), np.arange(w)) % 2) == 0
        img = np.where(even, np.float32(0.0), np.float32(-0.0))
    elif kind == "negative_zeros":
        img = np.full((h, w), -0.0, np.float32)
        img[h // 2, w // 2] = 0.0
    elif kind == "zeros_and_negatives":
        values = np.array([-0.0, 0.0, -1.0, -np.inf, -FLT_MAX, np.nan],
                          np.float32)
        img = rng.choice(values, size=(h, w),
                         p=[0.6, 0.05, 0.15, 0.1, 0.095, 0.005])
    elif kind == "negative_infinity":
        img = np.full((h, w), -np.inf, np.float32)
        img[h // 2, w // 2] = -0.0
    else:
        raise ValueError(f"unknown image kind {kind!r}")
    return np.ascontiguousarray(img, dtype=np.float32)
