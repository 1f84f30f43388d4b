"""Per-position GC-window binning for search pass 2.

Reference semantics (dump_kmer_list, QuicKmer.c:981-1002, 1023-1026):
for the k-mer ending at 0-based chromosome position p, the GC window is
[max(0, p-(gc_win+k)/2+1), min(p+(gc_win-k)/2, L-1)] — a gc_win-bp
window centered on the k-mer, truncated at chromosome edges. A base
counts as "GC" iff ASCII bit 1 is set (`fa_buf[i] & 2`, QuicKmer.c:992)
— which is true for C/G/c/g AND for 'N'/'n', so the reference's separate
N_bp half-weight term is dead code (its `else if` can never fire); we
reproduce that exactly. Bin = (N_bp + 2*GC_bp)*200 // window_bp with
N_bp = 0, giving 401 bins of 0.25%.
"""

from __future__ import annotations

import numpy as np


def gc_bins_np(chrom_bytes: np.ndarray, k: int, gc_win: int = 400) -> np.ndarray:
    """GC bin (0..400) for the k-mer ending at each position p in
    [k-1, L-1]; returned array has length L with positions < k-1 set to 0
    (they never correspond to a complete k-mer)."""
    b = np.frombuffer(chrom_bytes, dtype=np.uint8) if isinstance(chrom_bytes, (bytes, bytearray)) else chrom_bytes
    L = len(b)
    gc = ((b & 2) != 0).astype(np.int64)
    cs = np.concatenate([[0], np.cumsum(gc)])
    p = np.arange(L, dtype=np.int64)
    lead = (gc_win - k) // 2     # bases ahead of p in the window
    trail = (gc_win + k) // 2 - 1  # bases behind p
    lo = np.maximum(p - trail, 0)
    hi = np.minimum(p + lead, L - 1)
    window_bp = hi - lo + 1
    gc_bp = cs[hi + 1] - cs[lo]
    return ((2 * gc_bp) * 200 // window_bp).astype(np.uint16)
