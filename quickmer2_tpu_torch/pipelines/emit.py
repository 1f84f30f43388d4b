"""Genome-order emission shared by `search` pass 2 and `sparse`
regeneration: window bed rows, .qgc GC/control entries, and the ordered
k-mer list that defines the chain (reference: dump_kmer_list,
QuicKmer.c:925-1073)."""

from __future__ import annotations

import numpy as np

from quickmer2_tpu_torch.io import formats
from quickmer2_tpu_torch.ops import gc


class GenomeOrderEmitter:
    """Feed chromosomes in genome order; collects the dictionary chain
    order, window rows, and .qgc entries."""

    def __init__(self, k: int, window_size: int, ctrl_rows=None,
                 gc_window_bp: int = 400):
        self.k = k
        self.window_size = window_size
        self.ctrl_rows = ctrl_rows
        self.gc_window_bp = gc_window_bp
        self.ordered_kmers: list[np.ndarray] = []
        self.window_rows: list[tuple] = []
        self.qgc_parts: list[np.ndarray] = []
        self.count = 0    # global hit counter, cumulative across chroms

    def add_chrom(self, name: str, seq: bytes, canon: np.ndarray,
                  hit: np.ndarray) -> None:
        """canon: u64 canonical code per window start; hit: bool mask of
        dictionary hits (genome order)."""
        k = self.k
        p_end = np.flatnonzero(hit) + (k - 1)
        self.ordered_kmers.append(canon[hit])

        if self.ctrl_rows is not None:
            bins = gc.gc_bins_np(np.frombuffer(seq, np.uint8), k, self.gc_window_bp)
            entry = bins[p_end].astype(np.uint16)
            entry |= ctrl_flags(self.ctrl_rows, name, p_end, k)
            self.qgc_parts.append(entry)

        # window rows when the global 1-based hit count hits a multiple
        # of wsize (QuicKmer.c:1054-1059); win_start/wstart reset per
        # chromosome (QuicKmer.c:948-955) so a window straddling a
        # chromosome boundary covers fewer than wsize k-mers
        w = self.window_size
        n_hits = len(p_end)
        local_counts = self.count + 1 + np.arange(n_hits)
        emit = np.flatnonzero(local_counts % w == 0)
        win_start_bp, wstart = 0, self.count
        for i in emit:
            self.window_rows.append((name, win_start_bp, int(p_end[i]),
                                     wstart, int(local_counts[i])))
            win_start_bp, wstart = int(p_end[i]), int(local_counts[i])
        self.count += n_hits

    def ordered(self) -> np.ndarray:
        return (np.concatenate(self.ordered_kmers) if self.ordered_kmers
                else np.zeros(0, np.uint64))

    def write(self, out_prefix: str) -> None:
        formats.write_windows_bed(out_prefix + ".bed", self.window_rows)
        if self.qgc_parts:
            formats.write_u16(out_prefix + ".qgc", np.concatenate(self.qgc_parts))


def read_ctrl(path: str):
    rows = []
    with open(path) as f:
        for line in f:
            p = line.split()
            if len(p) >= 3:
                rows.append((p[0], int(p[1]), int(p[2])))
    return rows


def ctrl_flags(rows, chrom: str, p_end: np.ndarray, k: int) -> np.ndarray:
    """Control-region flags, emulating dump_kmer_list's stateful forward
    scan (QuicKmer.c:1029-1040): use the maximal run of rows for this
    chromosome starting at its first occurrence in file order; for a hit
    at end position p, the active region is the first with e >= p; flag
    iff kmer start (p+1-k) is strictly greater than its s (quirk Q7).

    Two verified stateful quirks: (a) the flag condition never rechecks
    p <= e, and (b) when the advance loop hits EOF (the chromosome's run
    is last in the file) the "absent" flag is NOT set — fscanf fails and
    leaves the last region's s/e in place — so every later k-mer of the
    chromosome with start > s_last stays flagged. "Absent" only engages
    when a different chromosome's row follows the run."""
    flags = np.zeros(len(p_end), dtype=np.uint16)
    j0 = next((i for i, r in enumerate(rows) if r[0] == chrom), None)
    if j0 is None:
        return flags
    run_e, run_s = [], []
    for r in rows[j0:]:
        if r[0] != chrom:
            break
        run_s.append(r[1])
        run_e.append(r[2])
    followed_by_other = (j0 + len(run_s)) < len(rows)
    e_arr = np.array(run_e, dtype=np.int64)
    s_arr = np.array(run_s, dtype=np.int64)
    j = np.searchsorted(e_arr, p_end, side="left")
    past_end = j >= len(e_arr)
    jc = np.minimum(j, len(e_arr) - 1)
    flag = (p_end + 1 - k) > s_arr[jc]
    if followed_by_other:
        flag &= ~past_end
    flags[flag] = formats.CTRL_FLAG
    return flags
