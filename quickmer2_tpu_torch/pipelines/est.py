"""est — GC-corrected windowed copy-number estimation.

Reference: main_estimate (QuicKmer.c:555-685) + smooth_GC_mrsfast.py via
popen. Differences by design (SURVEY.md Q5/Q6): no subprocess — the
LOWESS correction runs in-process (analytics.gc_correct) and failures
raise instead of silently emitting a zero CN bed; the .txt regeneration
path is implemented *correctly* (the reference's is multiply broken).

Parity-critical semantics reproduced exactly:
  * mean depth parsed from the .txt text as float32 (fscanf %f,
    QuicKmer.c:634-639) then mean*count accumulated in double;
  * correction factors crossed the reference's pipe as raw float32
    (QuicKmer.c:649) — we cast to float32 at the same point;
  * the per-k-mer product corr[gc & 0x1FF] * depth is computed in
    float32 (C: float * uint16 → float) and accumulated in float64
    (QuicKmer.c:676-677), in chain order;
  * a window is only emitted when the scan reaches kmer_idx >=
    kmer_end, so the final window is dropped whenever kmer_end equals
    the total k-mer count (QuicKmer.c:664-674) — windows with
    kmer_end < n_kmers are the emitted set;
  * CN = (window_sum / (kmer_end - kmer_start)) / (mean_depth / 2).
"""

from __future__ import annotations

import os

import numpy as np

from quickmer2_tpu_torch.analytics import gc_correct
from quickmer2_tpu_torch.config import EstConfig
from quickmer2_tpu_torch.device import resolve_device
from quickmer2_tpu_torch.io import formats
from quickmer2_tpu_torch.pipelines.count import gc_curve_from_depth


def mean_depth_from_txt(txt_path: str) -> float:
    """Σ(mean_f32 * count) / Σcount with the reference's float32 text
    parse (QuicKmer.c:634-639)."""
    total_depth = 0.0
    total_count = 0
    with open(txt_path) as f:
        for line in f:
            parts = line.split("\t")
            if len(parts) < 4:
                continue
            d = np.float32(parts[1])
            c = int(parts[2])
            total_depth += float(np.float32(d * np.float32(c)))
            total_count += c
    return total_depth / total_count


def run_est(ref_prefix: str, sample_prefix: str, out_bed: str,
            cfg: EstConfig | None = None, verbose: bool = True,
            device: str = "cuda", device_sums: bool = False) -> dict:
    """ref_prefix: path prefix of the dictionary companions (<p>.qgc,
    <p>.bed — the reference passes the FASTA path); sample_prefix: count
    outputs (<p>.bin, <p>.txt).

    By default the window sums are host numpy in float64 (the JAX
    package's default host path). device_sums=True takes the JAX
    package's device path (its `device=True`): float32 window sums on
    `device` by K11 (ops.est_device). `device` is resolved like every
    entry point's ("cuda" raises without a card) so a pipeline meant for
    the card never runs on the CPU unasked."""
    import time
    dev = resolve_device(device)
    t0 = time.time()
    cfg = cfg or EstConfig()
    qgc = formats.read_u16(ref_prefix + ".qgc")
    depth = formats.read_u16(sample_prefix + ".bin")
    n = min(len(qgc), len(depth))
    qgc, depth = qgc[:n], depth[:n]
    chroms, windows = formats.read_windows_bed(ref_prefix + ".bed")

    txt_path = sample_prefix + ".txt"
    if not os.path.exists(txt_path):
        # correct regeneration from .qgc + .bin (reference's path is
        # broken — SURVEY.md Q5)
        mean, count, var, _ = gc_curve_from_depth(depth, qgc)
        formats.write_gc_curve(txt_path, mean, count, var)
    mean_depth = mean_depth_from_txt(txt_path)
    if verbose:
        print("Mean sequencing depth: %.2f" % mean_depth)

    load_s = time.time() - t0
    t1 = time.time()
    factors, _ = gc_correct.factors_from_txt(
        txt_path, frac=cfg.lowess_frac, fit_lo=cfg.gc_fit_lo,
        fit_hi=cfg.gc_fit_hi, clip_lo=cfg.corr_clip_lo, clip_hi=cfg.corr_clip_hi)
    fit_s = time.time() - t1
    t2 = time.time()

    # emitted windows: kmer_end < n (final window dropped when no
    # trailing k-mers exist — QuicKmer.c:664-674)
    emit = windows[:, 3] < n
    windows_e = windows[emit]
    chroms_e = [c for c, m in zip(chroms, emit) if m]

    if device_sums:
        from quickmer2_tpu_torch.ops.est_device import cn_values
        cns = cn_values(depth, qgc, factors, windows_e, mean_depth, dev)
        rows = [(c, int(w[0]), int(w[1]), float(cn))
                for c, w, cn in zip(chroms_e, windows_e, cns)]
    else:
        # float32 products accumulated left-to-right in float64, matching
        # the C loop bit-for-bit
        gc_bin = (qgc & formats.GC_BIN_MASK).astype(np.int64)
        prod = (factors[gc_bin] * depth.astype(np.float32)).astype(np.float64)
        half_mean = mean_depth / 2.0
        rows = []
        for (chrom, (b, e, ks, ke)) in zip(chroms_e, windows_e):
            wd = (float(np.add.reduceat(prod[ks:ke], [0])[0]) if ke > ks
                  else 0.0)
            cn = wd / (ke - ks) / half_mean
            rows.append((chrom, int(b), int(e), cn))
    formats.write_cn_bed(out_bed, rows)
    return {"mean_depth": mean_depth, "n_windows": len(rows),
            "n_kmers": int(n),
            "phases": {"load_s": round(load_s, 4),
                       "fit_s": round(fit_s, 4),
                       "window_s": round(time.time() - t2, 4)},
            "factors": factors}
