"""GC-bias correction-factor builder.

Functional parity target: reference smooth_GC_mrsfast.py:11-58 —
LOWESS (f=0.15) over GC bins 100..300 (25%..75%), linear tail
extrapolation from 5-point polyfits at each edge clipped to [0, 255],
correction = mean_depth / fit clipped to [1/3, 3] with zero-fit bins
forced to 3. Returns float32 factors, matching the raw-float32 pipe
protocol the reference uses between est and the Python child
(smooth_GC_mrsfast.py:56-58 ↔ QuicKmer.c:642-650) — except here there is
no subprocess and failures raise instead of silently producing garbage
(SURVEY.md Q6).
"""

from __future__ import annotations

import numpy as np

from quickmer2_tpu_torch.analytics.lowess import lowess
from quickmer2_tpu_torch.io import formats


def correction_factors(mean_curve: np.ndarray, count_curve: np.ndarray,
                       frac: float = 0.15, fit_lo: int = 100, fit_hi: int = 300,
                       clip_lo: float = 1.0 / 3.0, clip_hi: float = 3.0):
    """(mean[401], count[401]) → (factors float32[401], mean_depth).

    mean_depth = sum(mean*count)/sum(count) over all bins, the same
    average the reference's smoother computes from the .txt.
    """
    mean_curve = np.asarray(mean_curve, dtype=np.float64)
    count_curve = np.asarray(count_curve, dtype=np.float64)
    total = count_curve.sum()
    if total <= 0:
        raise ValueError("GC curve has no control k-mers")
    ave = float((mean_curve * count_curve).sum() / total)

    x = np.arange(formats.GC_BINS, dtype=np.float64) / 4.0
    xs = x[fit_lo : fit_hi + 1]
    fit = lowess(xs, mean_curve[fit_lo : fit_hi + 1], f=frac)

    coff_left = np.polyfit(xs[0:5], fit[0:5], 1)
    coff_right = np.polyfit(xs[-5:], fit[-5:], 1)
    left = np.clip(x[:fit_lo] * coff_left[0] + coff_left[1], 0, 255)
    right = np.clip(x[fit_hi + 1 :] * coff_right[0] + coff_right[1], 0, 255)
    full = np.concatenate([left, fit, right])

    with np.errstate(divide="ignore", invalid="ignore"):
        factors = np.where(full != 0, ave / full, clip_hi)
    factors = np.clip(factors, clip_lo, clip_hi)
    # zero-fit bins bypass clipping in the reference (set to exactly 3)
    factors = np.where(full == 0, clip_hi, factors)
    return factors.astype(np.float32), ave


def factors_from_txt(txt_path: str, **kw):
    mean, count, _ = formats.read_gc_curve(txt_path)
    return correction_factors(mean, count, **kw)
