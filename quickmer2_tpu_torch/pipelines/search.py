"""search — build the unique-k-mer dictionary from a reference genome.

Reference: main_search (QuicKmer.c:1088-1304). Three stages there:
pass-1 lock-free hash tabulation, threaded edit-distance filter,
delete/compact, then a pass-2 genome rescan emitting chain/GC/windows.

Port of quickmer2_tpu/pipelines/search.py:
  1. tabulate   — bulk canonical k-mer extraction (native C codec) +
                  sort-based distinct counting (np.unique), saturated at
                  255 like the reference's u8 occr (QuicKmer.c:888).
  2. filter     — neighbor-occurrence sums; a k-mer survives iff
                  occr == 1 and sum < d (QuicKmer.c:1218-1231). By the
                  blocked Hamming join (default; ops.hamming_join, kernel
                  K1 on the card) with its slow queries probed one
                  neighbor at a time in a packed table of every distinct
                  k-mer behind its key filter (kernel K6) or enumerated
                  on the host; by K6 over every query ("probe"); on the
                  host against the pass-1 table ("host"); or in
                  quirk-compat mode (SURVEY.md Q2, host, k = 30).
  3. emit       — one genome-order pass: membership lookups against the
                  pass-1 table on the host (default), or with emit_devices
                  against a packed table of the survivors on the device
                  (parallel.emit_parallel, kernel K10); then on the host GC
                  bins (ops.gc), control flags, window rows; dictionary
                  placement by insertion in genome order
                  (Dictionary.from_kmers_in_order). Slot layout
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
from quickmer2_tpu_torch.device import resolve_device, to_numpy_u32, words
from quickmer2_tpu_torch.dictionary import Dictionary
from quickmer2_tpu_torch.io import fasta as fasta_io
from quickmer2_tpu_torch.kernels.neighbor_bits import (
    filter_words_for, key_filter)
from quickmer2_tpu_torch.kernels.neighbor_sum import neighbor_sum
from quickmer2_tpu_torch.ops import codec
from quickmer2_tpu_torch.ops import hash as qhash
from quickmer2_tpu_torch.ops.editdist import neighbor_occr_sum_quirk_np
from quickmer2_tpu_torch.ops.hamming_join import _rc_np, hamming_neighbor_sums
from quickmer2_tpu_torch.ops.packed_table import PackedTable
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


# device types on which the hamming filter sends its slow queries to K6,
# through a packed table of every distinct k-mer and its key filter;
# elsewhere they take the host enumeration. On an H100 80GB HBM3 at
# 700 W the table and K6 took 11.6 s against ~98 s of host enumeration
# for the smoke genome's 338,812 slow queries (PERF.md, section 5). The
# outputs are the same either way.
PACKED_SLOW_PATH_DEVICES = ("cuda",)


def _final_hash_size(h0: int, distinct: int) -> int:
    h = h0
    while distinct > 0.8 * h:
        h <<= 1
    return h


def run_search(fasta_path: str, cfg: SearchConfig, out_prefix: str | None = None,
               use_device_filter: bool = True, filter_batch: int = 1 << 20,
               filter_impl: str = "hamming", verbose: bool = True,
               stats: dict | None = None,
               device: str = "cuda",
               emit_devices: int | None = None) -> Dictionary:
    """Full search phase. Writes <out>.qm, <out>.bed and, when a control
    bed is configured, <out>.qgc (out defaults to the FASTA path, like
    the reference which names outputs ref.fa.qm etc.). Every filter
    writes the same bytes.

    use_device_filter / filter_impl: "hamming" (default) or "probe" (K6
    over every query, filter_batch queries a launch) on `device`;
    use_device_filter=False takes the host filter. cfg.
    quirk_mod32_editdist takes the quirk-compat host filter (k = 30).
    The hamming filter's slow queries go to K6 on the devices of
    PACKED_SLOW_PATH_DEVICES (a card), to the host enumeration elsewhere.
    stats: optional dict the run fills with structured per-phase metrics
    (tabulate/filter/emit wall seconds, the filter's split into join_s,
    slow_table_s (the packed table and its key filter) and slow_s, k-mer
    counts; with the device emit also emit_table_s, the survivor
    table's host build, inside emit_s).
    device: "cuda" (default; raises without a card) or "cpu" — where the
    edit filter's kernels run, and the device emit's.
    emit_devices: None or 0 (default) emits with host lookups; N >= 1
    scans the genome (K10) against a packed table of the survivors, each
    chunk split over N devices of `device`'s type (every card from
    cuda:0 up, or N copies of the CPU)."""
    import time

    dev = resolve_device(device)
    if filter_impl not in ("hamming", "probe"):
        raise ValueError(f"unknown filter_impl {filter_impl!r}: use "
                         "'hamming' or 'probe'")
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

    # pass-1 table (the host filters' lookups, pass-2 membership tests)
    table = np.zeros(hash_size, dtype=np.uint64)
    if native.available():
        slots = native.insert_keys(table, uniq, return_slots=True)
    else:
        slots = qhash.probe_insert_np(table, uniq, hash_size)
    tabulate_s = time.time() - t0
    t1 = time.time()

    # -- stage 2: edit-distance filter --------------------------------
    keep_uniq = occr_vals == 1
    n_removed = 0
    filter_stats: dict = {}
    split = {"join_s": 0.0, "slow_table_s": 0.0, "slow_s": 0.0}
    if cfg.edit_distance > 0:
        e = cfg.edit_distance
        unique_kmers = uniq[keep_uniq]
        if cfg.quirk_mod32_editdist and k != 30:
            raise ValueError(
                "quirk-compat edit filter is defined for k=30 only")
        if cfg.quirk_mod32_editdist or not use_device_filter:
            occr = np.zeros(hash_size, dtype=np.uint8)
            occr[slots] = occr_vals
            ts = time.time()
            if cfg.quirk_mod32_editdist:
                sums = neighbor_occr_sum_quirk_np(unique_kmers, table, occr,
                                                  hash_size, k, e)
            else:
                sums = _host_filter(unique_kmers, table, occr, hash_size, k, e)
            split["slow_s"] = time.time() - ts
        else:
            ptab = None
            if (filter_impl == "probe"
                    or dev.type in PACKED_SLOW_PATH_DEVICES):
                ts = time.time()
                ptab = _occ_table(uniq, occr_vals, dev)
                split["slow_table_s"] = time.time() - ts
            if filter_impl == "hamming":
                rows, n_buckets, filt = ptab or (None, 0, None)
                sums = hamming_neighbor_sums(
                    unique_kmers, uniq, occr_vals, k, e, packed_rows=rows,
                    n_buckets_packed=n_buckets, packed_filter=filt,
                    device=dev, stats=filter_stats)
                split["join_s"] = filter_stats.pop("join_s")
                split["slow_s"] = filter_stats.pop("slow_s")
            else:
                ts = time.time()
                sums = _device_filter(unique_kmers, ptab, k, e, filter_batch)
                split["slow_s"] = time.time() - ts
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
    scanner = None
    if emit_devices:
        from quickmer2_tpu_torch.parallel.emit_parallel import (
            DeviceMembershipScanner)
        ts = time.time()
        survivors = uniq[keep_uniq]
        shi, slo = codec.split_u64(survivors)
        stab = PackedTable.build(
            shi, slo, rank=np.arange(len(survivors), dtype=np.uint32))
        emit_table_s = time.time() - ts
        scanner = DeviceMembershipScanner(stab, k, data_devices=emit_devices,
                                          device=dev)
    for name, seq in fasta_io.iter_fasta(fasta_path):
        canon, valid = _chrom_kmers(seq, k)
        if scanner is not None:
            # the same hit set as (found in pass 1) & keep_flag
            hit = scanner.scan(codec.encode_bases(
                np.frombuffer(seq, dtype=np.uint8)))
        else:
            if native.available():
                pos_slots, found = native.lookup_keys(table, canon)
            else:
                pos_slots, found = qhash.probe_lookup_np(table, canon,
                                                         hash_size)
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
            "filter": filter_stats,
            "phases": {"tabulate_s": round(tabulate_s, 4),
                       "filter_s": round(filter_s, 4),
                       **{n: round(v, 4) for n, v in split.items()},
                       "emit_s": round(time.time() - t2, 4)}})
        if scanner is not None:
            stats["phases"]["emit_table_s"] = round(emit_table_s, 4)
    return dictionary


def _occ_table(uniq: np.ndarray, occr_vals: np.ndarray, dev):
    """(rows on dev, n_buckets, key filter on dev) of the packed
    two-choice table over every distinct k-mer, with its occurrence
    count in pos, and the table's key filter (one launch on a card). A
    table that cannot be built raises: the search fails rather than
    taking another path."""
    uhi, ulo = codec.split_u64(uniq)
    ptab = PackedTable.build(uhi, ulo,
                             rank=np.arange(len(uniq), dtype=np.uint32),
                             pos=occr_vals.astype(np.uint32))
    rows = words(ptab.rows, dev)
    filt = key_filter(rows, n_buckets=ptab.n_buckets,
                      n_words=filter_words_for(len(uniq)))
    return rows, ptab.n_buckets, filt


def _device_filter(unique_kmers, ptab, k, edit_distance, batch: int):
    """Neighbor-occurrence sums of every query by K6 against the packed
    table over all distinct k-mers (ptab, from _occ_table): a key-filter
    word a neighbor, two row reads for those that pass it, `batch`
    queries a launch."""
    rows, n_buckets, filt = ptab
    rc = _rc_np(unique_kmers, k)
    n = len(unique_kmers)
    sums = np.empty(n, dtype=np.uint32)
    for off in range(0, n, batch):
        sl = slice(off, min(off + batch, n))
        kh, kl = codec.split_u64(unique_kmers[sl])
        rh, rl = codec.split_u64(rc[sl])
        out = neighbor_sum(*(words(a, rows.device) for a in (kh, kl, rh, rl)),
                           rows, filt, k=k, e=edit_distance,
                           n_buckets=n_buckets)
        sums[sl] = to_numpy_u32(out)
    return sums


def _host_filter(unique_kmers, table, occr, hash_size, k, edit_distance):
    """Correct-math host filter (numpy, batched over the edit table)
    against the pass-1 linear-probe table."""
    rc = _rc_np(unique_kmers, k)
    total = np.zeros(len(unique_kmers), dtype=np.uint64)

    def add(f, r):
        canon = np.minimum(f, r)
        slots, found = qhash.probe_lookup_np(table, canon, hash_size)
        total[:] = total + np.where(found, occr[slots].astype(np.uint64),
                                    np.uint64(0))

    def mutate(f, r, pos, delta):
        base = (f >> np.uint64(2 * pos)) & np.uint64(3)
        nb = (base + np.uint64(delta)) & np.uint64(3)
        x = base ^ nb
        f = f ^ (x << np.uint64(2 * pos))
        r = r ^ (x << np.uint64(2 * (k - 1 - pos)))
        return f, r

    for p1 in range(k):
        for v1 in (1, 2, 3):
            f1, r1 = mutate(unique_kmers, rc, p1, v1)
            add(f1, r1)
            if edit_distance >= 2:
                for p2 in range(p1):
                    for v2 in (1, 2, 3):
                        f2, r2 = mutate(f1, r1, p2, v2)
                        add(f2, r2)
    return total
