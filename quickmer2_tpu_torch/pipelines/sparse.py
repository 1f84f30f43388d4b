"""sparse — thin an existing dictionary to >=1 k-mer per N bp and/or
regenerate the .bed/.qgc companions (the port of
quickmer2_tpu/pipelines/sparse.py; host code).

Reference: main_sparse_kmer (QuicKmer.c:1306-1483). Parity semantics:
  * thinning scans the genome in record mode (state persists across
    lines, resets on '>' and 'N'); the per-chromosome bp counter counts
    every processed base EXCEPT 'N' (the N branch skips the increment,
    QuicKmer.c:1399-1404);
  * a dictionary hit at bp counter c is kept iff c - last_kept >= thin
    (last_kept starts 0 each chromosome, so leading hits with c < thin
    are dropped — QuicKmer.c:1419-1432);
  * the thinned table is resized to the optimal power of two for 80%
    fill: 2^ceil(log2(count/0.8)) (QuicKmer.c:1441-1449);
  * .bed and .qgc are regenerated against the thinned dictionary
    (overwriting the originals, QuicKmer.c:1450-1461) and the result is
    written as <fasta>.rqm with header byte 7 = thin & 0xFF
    (QuicKmer.c:1467-1477);
  * with thin <= 1 the table is left as-is and only the companions are
    regenerated.

Slot placement of the .rqm differs from the reference (which rehashes in
place); chain order and every chain-ordered artifact are identical.
"""

from __future__ import annotations

import math

import numpy as np

from quickmer2_tpu_torch.device import resolve_device
from quickmer2_tpu_torch.dictionary import Dictionary
from quickmer2_tpu_torch.io import fasta as fasta_io
from quickmer2_tpu_torch.pipelines import emit as emit_mod
from quickmer2_tpu_torch.pipelines.search import _chrom_kmers
from quickmer2_tpu_torch.utils import native


def thin_keep_mask_np(bp: np.ndarray, thin: int) -> np.ndarray:
    """Pure-python fallback for native.thin_hits."""
    keep = np.zeros(len(bp), dtype=bool)
    last = 0
    for i, c in enumerate(bp):
        if c - last >= thin:
            keep[i] = True
            last = c
    return keep


def run_sparse(fasta_path: str, thin: int, window_size: int = 1000,
               control_bed: str | None = None, verbose: bool = True,
               device: str = "cuda") -> Dictionary:
    """Writes <fasta>.rqm and regenerates <fasta>.bed (and .qgc with a
    control bed). The work is host code; `device` is resolved like every
    entry point's ("cuda" raises without a card)."""
    resolve_device(device)
    dic = Dictionary.from_qm(fasta_path + ".qm")
    k = dic.kmer_size

    table = np.ascontiguousarray(dic.table)
    ctrl_rows = emit_mod.read_ctrl(control_bed) if control_bed else None
    emitter = emit_mod.GenomeOrderEmitter(k, window_size, ctrl_rows)

    for name, seq in fasta_io.iter_fasta(fasta_path):
        canon, valid = _chrom_kmers(seq, k)
        if native.available():
            _, found = native.lookup_keys(table, canon)
        else:
            from quickmer2_tpu_torch.ops import hash as qhash
            _, found = qhash.probe_lookup_np(table, canon, dic.hash_size)
        hit = valid & found
        if thin > 1:
            # bp counter: index of the k-mer's last base among processed
            # non-'N' characters of the chromosome
            raw = np.frombuffer(seq, dtype=np.uint8)
            is_n = raw == ord("N")
            bp_of = np.cumsum(~is_n) - 1   # bp counter at each raw position
            p_end = np.flatnonzero(hit) + (k - 1)
            bp = bp_of[p_end].astype(np.uint32)
            keep = (native.thin_hits(bp, thin) if native.available()
                    else thin_keep_mask_np(bp, thin))
            idx = np.flatnonzero(hit)
            hit = np.zeros_like(hit)
            hit[idx[keep]] = True
        emitter.add_chrom(name, seq, canon, hit)

    ordered = emitter.ordered()
    if thin > 1:
        new_h = 1 << max(0, math.ceil(math.log2(max(1, len(ordered)) / 0.8)))
    else:
        new_h = dic.hash_size
    if verbose:
        print(f"sparse: {len(ordered)} k-mers kept, hash_size {new_h:#x}")

    out = Dictionary.from_kmers_in_order(
        ordered, new_h, k, dic.header.edit_distance,
        dic.header.edit_depth_threshold, byte7=thin & 0xFF)
    out.to_qm(fasta_path + ".rqm")
    emitter.write(fasta_path)  # regenerates .bed (+ .qgc with control)
    return out
