"""search — build the unique-k-mer dictionary from a reference genome.

Reference: main_search (QuicKmer.c:1088-1304). Three stages there:
pass-1 lock-free hash tabulation, threaded edit-distance filter,
delete/compact, then a pass-2 genome rescan emitting chain/GC/windows.

Port of quickmer2_tpu/pipelines/search.py, default filter only:
  1. tabulate   — bulk canonical k-mer extraction (native C codec) +
                  sort-based distinct counting (np.unique), saturated at
                  255 like the reference's u8 occr (QuicKmer.c:888).
  2. filter     — neighbor-occurrence sums by the blocked Hamming join
                  (ops.hamming_join, CUDA compare kernel on the card); a
                  k-mer survives iff occr == 1 and sum < d
                  (QuicKmer.c:1218-1231). The quirk-compat mode
                  (SURVEY.md Q2) is not ported yet.
  3. emit       — one genome-order pass on the host: membership lookups
                  against the pass-1 table, GC bins (ops.gc), control
                  flags, window rows; dictionary placement by insertion in genome
                  order (Dictionary.from_kmers_in_order). Slot layout
                  may differ from a reference-built .qm (whose placement
                  embeds its insert/resize/compact history) but every
                  chain-ordered artifact (.bed/.qgc, downstream .bin/CN)
                  is identical.

Hash sizing parity: the reference grows x2 whenever distinct > 0.8*H
(QuicKmer.c:891-895) and never shrinks, so H_final is the minimal
doubling of the initial size with distinct <= 0.8*H (SURVEY.md Q12).
"""

from __future__ import annotations

import numpy as np

from quickmer2_tpu_torch.config import SearchConfig
from quickmer2_tpu_torch.device import resolve_device
from quickmer2_tpu_torch.dictionary import Dictionary
from quickmer2_tpu_torch.io import fasta as fasta_io
from quickmer2_tpu_torch.ops import codec
from quickmer2_tpu_torch.ops import hash as qhash
from quickmer2_tpu_torch.ops.hamming_join import hamming_neighbor_sums
from quickmer2_tpu_torch.pipelines import emit as emit_mod
from quickmer2_tpu_torch.utils import native


def _chrom_kmers(seq: bytes, k: int):
    """Canonical codes per position (host u64) with validity; k-mer
    code 0 excluded (QuicKmer.c:864 `if (kmer && ...)`). Native C
    kmerize when available (~100x the numpy rolling loop)."""
    codes = codec.encode_bases(np.frombuffer(seq, dtype=np.uint8))
    if native.available():
        canon, valid, _ = native.sliding_canon(codes, k)
    else:
        canon, valid = codec.sliding_kmers_np(codes, k)
    return canon, valid & (canon != 0)


def _merge_sorted_counts(u1, c1, u2, c2):
    """Merge two (sorted-unique keys, counts) pairs in O(n + m): counts
    of shared keys add; new keys interleave by searchsorted position.
    No re-sort — both inputs are already sorted."""
    if len(u1) < len(u2):          # search the smaller into the larger
        u1, c1, u2, c2 = u2, c2, u1, c1
    idx = np.searchsorted(u1, u2)
    hit = np.zeros(len(u2), bool)
    inb = idx < len(u1)
    hit[inb] = u1[idx[inb]] == u2[inb]
    c1 = c1.copy()
    c1[idx[hit]] += c2[hit]        # u2 keys are unique → no index repeats
    nu, nc, nidx = u2[~hit], c2[~hit], idx[~hit]
    if len(nu) == 0:
        return u1, c1
    out_u = np.empty(len(u1) + len(nu), u1.dtype)
    out_c = np.empty(len(u1) + len(nu), c1.dtype)
    pos_new = nidx + np.arange(len(nu))
    mask = np.ones(len(out_u), bool)
    mask[pos_new] = False
    out_u[mask] = u1
    out_u[pos_new] = nu
    out_c[mask] = c1
    out_c[pos_new] = nc
    return out_u, out_c


def _tabulate_streaming(chroms, k: int):
    """Distinct canonical k-mers + saturated counts: one sort-unique
    PER CHROMOSOME, then ONE balanced pairwise-merge pass over the
    already-sorted per-chromosome arrays (each merge level is linear
    searchsorted/interleave work — no element is ever re-sorted).
    Re-uniquing the cumulative array every chromosome would cost ~25
    host sorts of an up-to-17 GB u64 array at GRCh38 scale; this does
    the equivalent of one. Saturating at the end equals the reference's per-increment
    saturation (min(n, 255), QuicKmer.c:888)."""
    stack: list[tuple[np.ndarray, np.ndarray]] = []
    total_positions = 0
    for name, seq in chroms:
        canon, valid = _chrom_kmers(seq, k)
        km = canon[valid]
        total_positions += len(km)
        # u32 counts: bounded by total genome positions (< 2^32 even at
        # GRCh38), saturated to 255 at the end — int64 here would cost
        # ~17 GB of host RAM at GRCh38 scale
        u, c = np.unique(km, return_counts=True)
        stack.append((u, c.astype(np.uint32)))
        del canon, valid, km
        # balanced merge tree: collapse equal-size neighbors eagerly so
        # the stack stays O(log chroms) deep and each element is merged
        # O(log chroms) times total
        while len(stack) >= 2 and len(stack[-2][0]) <= 2 * len(stack[-1][0]):
            (u1, c1), (u2, c2) = stack[-2], stack[-1]
            stack[-2:] = [_merge_sorted_counts(u1, c1, u2, c2)]
    while len(stack) >= 2:
        (u1, c1), (u2, c2) = stack[-2], stack[-1]
        stack[-2:] = [_merge_sorted_counts(u1, c1, u2, c2)]
    if not stack:
        return (np.zeros(0, np.uint64), np.zeros(0, np.uint8), 0)
    uniq, counts = stack[0]
    return uniq, np.minimum(counts, 255).astype(np.uint8), total_positions


def _final_hash_size(h0: int, distinct: int) -> int:
    h = h0
    while distinct > 0.8 * h:
        h <<= 1
    return h


def run_search(fasta_path: str, cfg: SearchConfig, out_prefix: str | None = None,
               verbose: bool = True, stats: dict | None = None,
               device: str = "cuda") -> Dictionary:
    """Full search phase. Writes <out>.qm, <out>.bed and, when a control
    bed is configured, <out>.qgc (out defaults to the FASTA path, like
    the reference which names outputs ref.fa.qm etc.).

    stats: optional dict the run fills with structured per-phase metrics
    (tabulate/filter/emit wall seconds, k-mer counts).
    device: "cuda" (default; raises without a card) or "cpu" — where the
    edit filter's join runs."""
    import time

    dev = resolve_device(device)
    if cfg.quirk_mod32_editdist:
        raise NotImplementedError(
            "the quirk-compat edit filter (--quirk-editdist) is not yet "
            "ported to quickmer2_tpu_torch")
    t0 = time.time()
    out_prefix = out_prefix or fasta_path
    k = cfg.kmer_size

    # -- stage 1: tabulate (streamed per chromosome; the generator is
    # re-opened for pass 2, so at most ONE chromosome's sequence is in
    # host memory at a time) ------------------------------------------
    uniq, occr_vals, n_positions = _tabulate_streaming(
        fasta_io.iter_fasta(fasta_path), k)
    hash_size = _final_hash_size(cfg.hash_size, len(uniq))
    if verbose:
        print(f"search: {n_positions} k-mer positions, {len(uniq)} distinct, "
              f"hash_size {hash_size:#x}")

    # pass-1 table (pass-2 membership tests)
    table = np.zeros(hash_size, dtype=np.uint64)
    if native.available():
        slots = native.insert_keys(table, uniq, return_slots=True)
    else:
        slots = qhash.probe_insert_np(table, uniq, hash_size)
    tabulate_s = time.time() - t0
    t1 = time.time()

    # -- stage 2: edit-distance filter (blocked Hamming join) ---------
    keep_uniq = occr_vals == 1
    n_removed = 0
    join_stats: dict = {}
    if cfg.edit_distance > 0:
        unique_kmers = uniq[keep_uniq]
        sums = hamming_neighbor_sums(unique_kmers, uniq, occr_vals, k,
                                     cfg.edit_distance, device=dev,
                                     stats=join_stats)
        survive = sums < cfg.edit_depth_threshold
        kill = np.zeros(len(uniq), dtype=bool)
        kill[np.flatnonzero(keep_uniq)[~survive]] = True
        keep_uniq = keep_uniq & ~kill
        n_removed = int((~survive).sum())
        if verbose:
            print(f"search: edit filter removed {n_removed} "
                  f"of {len(unique_kmers)} unique k-mers")
    filter_s = time.time() - t1
    t2 = time.time()

    keep_flag = np.zeros(hash_size, dtype=bool)
    keep_flag[np.asarray(slots)[keep_uniq]] = True

    # -- stage 3: genome-order emission (host) ------------------------
    ctrl_rows = emit_mod.read_ctrl(cfg.control_bed) if cfg.control_bed else None
    emitter = emit_mod.GenomeOrderEmitter(k, cfg.window_size, ctrl_rows,
                                          cfg.gc_window_bp)
    for name, seq in fasta_io.iter_fasta(fasta_path):
        canon, valid = _chrom_kmers(seq, k)
        if native.available():
            pos_slots, found = native.lookup_keys(table, canon)
        else:
            pos_slots, found = qhash.probe_lookup_np(table, canon, hash_size)
        hit = valid & found & keep_flag[pos_slots]
        # k-mer END positions are the reference's index (QuicKmer.c:987-1021)
        emitter.add_chrom(name, seq, canon, hit)

    if verbose:
        print(f"search: total output {emitter.count} k-mers")

    dictionary = Dictionary.from_kmers_in_order(
        emitter.ordered(), hash_size, k, cfg.edit_distance,
        cfg.edit_depth_threshold)
    dictionary.to_qm(out_prefix + ".qm")
    emitter.write(out_prefix)
    if stats is not None:
        stats.update({
            "n_positions": int(n_positions), "n_distinct": int(len(uniq)),
            "n_filtered": n_removed, "n_kmers": dictionary.n_kmers,
            "hash_size": hash_size, "device": str(dev),
            "filter": join_stats,
            "phases": {"tabulate_s": round(tabulate_s, 4),
                       "filter_s": round(filter_s, 4),
                       "emit_s": round(time.time() - t2, 4)}})
    return dictionary
