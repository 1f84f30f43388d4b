"""A kernel's share of its roofline, counted from the window's inputs.

The peaks and `least_seconds` restate chip_smoke.py::bound_ms (commit
0be96d5): the least time is the larger of the least bytes over the HBM's
3.35 TB/s and the least operations over the int32 rate, 132 SMs x 64
lanes x 1.98 GHz (NVIDIA H100 SXM at 700 W).

The work is the window's inputs alone, never the program's layout, so a
later change of tables, buckets or slices cannot make it stale, and the
share cannot pass 100 %:
  bytes       each read base once, at 2 bits; each distinct dictionary
              k-mer the window hits, its 8-B key and its 4-B depth word
              touched once;
  operations  each valid window times the kernel's own count a window
              (OPS_PER_WINDOW).
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
INT32_OPS_S = 132 * 64 * 1.98e9

KEY_BYTES = 8 + 4
# least integer operations a valid window:
#   K2 (flat count): the rolling codec and the canonical min (~20) and a
#      hash of the 60-bit code (~16); not the probe, which is layout.
OPS_PER_WINDOW = {"k2": 36}


def least_seconds(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time for the work, and which term bounds it."""
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = n_ops / INT32_OPS_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def work(bases: int, windows: int, distinct_keys: int,
         ops_per_window: int) -> tuple[float, float]:
    """(bytes, operations) the window's inputs need."""
    return (bases * 2 / 8 + distinct_keys * KEY_BYTES,
            windows * ops_per_window)


def share_pct(kernel_s: float, run_work: dict, kernel: str):
    """100 x least time / the kernel's summed time, with the bounding
    term; None where the trace holds none of the kernel's time."""
    if not kernel_s:
        return None
    n_bytes, n_ops = work(run_work["bases"], run_work["windows"],
                          run_work["distinct_keys"], OPS_PER_WINDOW[kernel])
    least, by = least_seconds(n_bytes, n_ops)
    return 100.0 * least / kernel_s, by
