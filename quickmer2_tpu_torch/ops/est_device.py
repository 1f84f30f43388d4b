"""est's hot loop on the device: GC correction applied per k-mer and
summed per window (the port of quickmer2_tpu/ops/est_device.py).

Reference semantics (QuicKmer.c:662-682, see pipelines/est.py for the
full parity notes): per k-mer the product corr[gc & 0x1FF] * depth is
computed in float32 and accumulated per window in float64; CN =
(window_sum / n_kmers) / (mean_depth / 2).

Here the window sums are float32, as in the JAX device path, formed by
K11 (kernels.est_windows.window_sums) in a fixed order: each window
sums only its own ~w_size products, so the float32 round-off stays near
1e-6 relative whatever the genome's size (held within 1e-4 of a float64
truth at 1.01e8 k-mers). A global float32 prefix sum would lose all
precision at human scale.
"""

from __future__ import annotations

import numpy as np
import torch

from quickmer2_tpu_torch.kernels.est_windows import window_sums


def corrected_window_sums(depth_u16: np.ndarray, qgc: np.ndarray,
                          factors: np.ndarray, kstarts: np.ndarray,
                          kends: np.ndarray,
                          device: torch.device) -> np.ndarray:
    """f32[W] per-window sums of the float32 products on `device`.
    depth_u16, qgc: the u16 arrays of the .bin and the .qgc; factors
    f32[401]; kstarts / kends: the windows' k-mer ranges, within
    [0, n]."""
    n = len(depth_u16)
    ks = np.asarray(kstarts, np.int64)
    ke = np.asarray(kends, np.int64)
    if len(ks) and (ks.min() < 0 or ke.max() > n or (ke < ks).any()):
        raise ValueError("corrected_window_sums: window k-mer ranges must "
                         f"lie within [0, {n}]")

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a).view(dtype)).to(
            device)
    sums = window_sums(put(np.asarray(depth_u16, np.uint16), np.int16),
                       put(np.asarray(qgc, np.uint16), np.int16),
                       put(np.asarray(factors, np.float32), np.float32),
                       put(ks.astype(np.int32), np.int32),
                       put(ke.astype(np.int32), np.int32))
    return sums.cpu().numpy()


def cn_values(depth_u16: np.ndarray, qgc: np.ndarray, factors: np.ndarray,
              windows: np.ndarray, mean_depth: float,
              device: torch.device) -> np.ndarray:
    """CN per window (device path). windows: i64[W, 4] rows
    (start_bp, end_bp, kstart, kend)."""
    sums = corrected_window_sums(depth_u16, qgc, factors, windows[:, 2],
                                 windows[:, 3], device).astype(np.float64)
    nk = (windows[:, 3] - windows[:, 2]).astype(np.float64)
    return sums / nk / (mean_depth / 2.0)
