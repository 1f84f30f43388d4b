"""QC plotting — the depth-vs-GC + correction-factor figure the
reference smoother saves (smooth_GC_mrsfast.py:63-83). Matplotlib is
optional; callers gate on `available()`."""

from __future__ import annotations

import math

import numpy as np

try:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    _HAVE_MPL = True
except Exception:  # pragma: no cover
    _HAVE_MPL = False


def available() -> bool:
    return _HAVE_MPL


def gc_qc_plot(txt_path: str, factors: np.ndarray, out_png: str | None = None) -> str | None:
    """Depth-vs-GC curve with the correction factors on a twin axis,
    like the reference QC png."""
    if not _HAVE_MPL:
        return None
    from quickmer2_tpu_torch.io.formats import read_gc_curve
    mean, count, _ = read_gc_curve(txt_path)
    x = np.arange(401) / 4.0
    total = count.sum()
    ave = float((mean * count).sum() / total) if total else 0.0
    max_cov = math.ceil(mean[100:301].max()) if mean[100:301].size else 1

    fig, ax1 = plt.subplots()
    ax1.plot(x, mean, "b-")
    ax1.set_xlabel("GC %")
    ax1.set_ylabel("Average Depth")
    ax1.plot([0, 100], [ave, ave], "b--")
    if max_cov != 1:
        ax1.axis([0, 100, 0, max_cov])
    for t in ax1.get_yticklabels():
        t.set_color("b")
    ax2 = ax1.twinx()
    ax2.plot(x, factors, "r-")
    ax2.set_ylabel("Correction Factor")
    ax2.axis([0, 100, 0.3, 3])
    for t in ax2.get_yticklabels():
        t.set_color("r")
    out_png = out_png or txt_path.replace("txt", "png")
    plt.savefig(out_png, format="png")
    plt.close(fig)
    return out_png
