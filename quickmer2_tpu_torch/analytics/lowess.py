"""Robust locally-weighted regression (LOWESS), numerically guarded.

Functional parity target: reference lowess.py:4-42 (Cleveland LOWESS,
tricube weights, 3 robustifying iterations, per-point linear WLS). The
reference solves each 2x2 system with numpy.linalg.lstsq; we use the
closed-form 2x2 solution vectorized over all points, which is identical
for nonsingular systems and falls back to the weighted mean when the
system degenerates.

Guards (SURVEY.md Q10): the reference divides by the median absolute
residual, which is 0 on degenerate inputs (e.g. uniform-GC genomes) and
poisons the weights with NaN; we clamp it away from zero.
"""

from __future__ import annotations

import numpy as np


def lowess(x: np.ndarray, y: np.ndarray, f: float = 2.0 / 3.0, iters: int = 3) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = len(x)
    r = int(np.ceil(f * n))
    # bandwidth per point: distance to the r-th nearest neighbor
    dist = np.abs(x[None, :] - x[:, None])          # [i, j] = |x_j - x_i|
    h = np.sort(dist, axis=1)[:, min(r, n - 1)]
    with np.errstate(divide="ignore", invalid="ignore"):
        w = np.clip(dist / np.where(h > 0, h, np.inf)[:, None], 0.0, 1.0)
    w = (1 - w**3) ** 3                             # tricube, w[i, j]
    yest = np.zeros(n)
    delta = np.ones(n)
    for _ in range(iters):
        # per-point weighted linear fit, closed-form 2x2 normal equations
        wt = delta[None, :] * w                     # [i, j]
        s0 = wt.sum(axis=1)
        s1 = (wt * x[None, :]).sum(axis=1)
        s2 = (wt * x[None, :] ** 2).sum(axis=1)
        t0 = (wt * y[None, :]).sum(axis=1)
        t1 = (wt * (x * y)[None, :]).sum(axis=1)
        det = s0 * s2 - s1 * s1
        ok = np.abs(det) > 1e-12 * np.maximum(s0 * s2, 1e-300)
        with np.errstate(divide="ignore", invalid="ignore"):
            beta0 = (s2 * t0 - s1 * t1) / det
            beta1 = (s0 * t1 - s1 * t0) / det
        mean = np.where(s0 > 0, t0 / np.where(s0 > 0, s0, 1.0), 0.0)
        yest = np.where(ok, beta0 + beta1 * x, mean)
        resid = y - yest
        s = np.median(np.abs(resid))
        if s <= 0:
            delta = np.ones(n)                      # Q10 guard
            continue
        delta = np.clip(resid / (6 * s), -1, 1)
        delta = (1 - delta**2) ** 2
    return yest
