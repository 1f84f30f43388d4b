"""Anchored range-add counting — the count phase's fast path
(`count --mode anchored`). Port of quickmer2_tpu/ops/anchored.py.

Reads are substrings of the genome, and the dictionary's rank order is
genome order. So a read costs a few random accesses instead of one probe
per k-mer:

  1. ANCHOR — probe a few k-mers of the read in the packed table, whose
     entries carry each k-mer's genome end position, and vote;
  2. ALIGN + VERIFY — compare the read with the genome window the anchor
     implies, on both strands;
  3. CLEAN RUNS — maximal runs of k-mers whose whole window matches the
     genome become range-adds on the rank axis (two adds into a
     difference array at ranks from the sampled prefix count `dblock`;
     depth = cumsum at finish);
  4. DIRTY k-mers are proved absent by the neighbor-hit bits (tier 1) or
     probed one by one (tier 2);
  5. reads over the caps SPILL: tier-1 spills may be rescued by tier 2,
     the rest (and unanchorable reads) are recounted exactly through the
     mono table (or, with mono_spill off and on every sharded counter,
     through the packed table).

Correctness does not depend on anchoring quality: a clean k-mer equals
the genome k-mer at its aligned position, whose rank the prefix count
encodes; everything else is probed or spilled. The result is the flat
path's depth, bit for bit.

On the card the read pass is kernel K3 (csrc/anchored.cu via
kernels.anchored), the exact recount K2r (csrc/count_mono.cu via
kernels.count_mono.count_mono_rows) or, without the mono table, K12 (same
file, kernels.count_mono.count_packed_rows), and the neighbor bitmap of the index
K4 behind the table's key filter (csrc/neighbor_bits.cu via
kernels.neighbor_bits) or, on the device types of JOIN_BITS_DEVICES, the
Hamming join K5 (ops.hamming_join.hamming_neighbor_bits). Host code here:
the index build and its .qai companion, row transport, spill routing
and finish.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import os

import numpy as np
import torch

from quickmer2_tpu_torch.device import (
    fetched, resolve_device, start_fetch, to_numpy_u32, word_dtype, words)
from quickmer2_tpu_torch.kernels.anchored import DBLK, GBLK, anchored_count
from quickmer2_tpu_torch.kernels.block_probe import block_displaced_filter
from quickmer2_tpu_torch.kernels.count_mono import (
    count_mono_rows, count_packed_rows)
from quickmer2_tpu_torch.kernels.neighbor_bits import (
    filter_words_for, key_filter, neighbor_bits)
from quickmer2_tpu_torch.ops import codec, rowpack
from quickmer2_tpu_torch.ops.monotable import MonoTable
from quickmer2_tpu_torch.ops.packed_table import PackedTable, probe_packed_np
from quickmer2_tpu_torch.utils.profiling import Phases

__all__ = ["GBLK", "DBLK", "AnchoredIndex", "AnchoredDepthCounter",
           "RowStreamer", "build_dblock", "build_neighbor_bits",
           "build_neighbor_bits_device", "genome_tiles_np",
           "rows_from_flat_codes"]


# device types on which AnchoredIndex.build takes the neighbor bitmap
# from the Hamming join (K5) instead of the K4 sweep. None so far: on
# the smoke genome of chip_smoke.py the sweep is the faster; the join is
# meant for dictionaries past the sweep's key-filter capacity, which no
# run has measured yet. Both give the same bytes.
JOIN_BITS_DEVICES: tuple = ()


@dataclasses.dataclass
class AnchoredIndex:
    """The anchored path's structures, on `device`."""
    rows: torch.Tensor | None    # packed table word tensor [B, 8] incl.
    #                              pos; None when built with place_rows
    #                              off (a dict-sharded counter places its
    #                              blocks from host_rows)
    n_buckets: int
    genome_tiles: torch.Tensor   # u8[G/GBLK, GBLK]: bits 0-2 genome code,
    #                              bits 3-6 neighbor-hit flags
    genome_len: int
    dblock: torch.Tensor         # word tensor [G/DBLK + 1, 4]:
    #                              [rank_base, mask_hi, mask_lo, 0]
    n_kmers: int
    has_neighbor_bits: bool
    host_rows: np.ndarray        # host copy of `rows` (u32[B, 8])
    device: torch.device
    mono: MonoTable | None = None       # spill-recount table, built once
    mono_rows: torch.Tensor | None = None  # by the first counter

    @classmethod
    def build(cls, genome_codes: np.ndarray, dict_end_pos: np.ndarray,
              kmers_in_order: np.ndarray, k: int,
              neighbor_bits: bool = True, device_build: bool | None = None,
              cache_path: str | None = None, place_rows: bool = True,
              device: str = "cuda") -> "AnchoredIndex":
        """genome_codes: u8[G] code stream (SEP between chromosomes);
        dict_end_pos: u32[n] genome end position of each dictionary
        k-mer in rank order; kmers_in_order: u64[n].

        neighbor_bits=True also builds the single-substitution
        neighbor-hit bitmap into the tile bytes. device_build: build it
        on `device` (default: on a card), by the K4 sweep behind the
        table's key filter or, where `device` is of a type in
        JOIN_BITS_DEVICES, by the Hamming join (K5); else by the host
        Bloom-filtered builder. All give the same bytes, and so does the
        JAX package.

        cache_path persists tiles and positions as a .qai companion
        (io.formats.write_qai), byte-identical to the JAX package's.

        place_rows=False keeps the packed rows on the host only (`rows`
        None, `host_rows` set), for a counter that shards them over the
        dict axis; the device neighbor-bit build still places the whole
        table while it runs."""
        dev = resolve_device(device)
        G = len(genome_codes)
        khi, klo = codec.split_u64(kmers_in_order)
        rank = np.arange(len(dict_end_pos), dtype=np.uint32)
        table = PackedTable.build(khi, klo, rank,
                                  pos=np.asarray(dict_end_pos, np.uint32))
        nbits = None
        if neighbor_bits:
            if device_build is None:
                device_build = dev.type == "cuda"
            if device_build and dev.type in JOIN_BITS_DEVICES:
                from quickmer2_tpu_torch.ops.hamming_join import (
                    hamming_neighbor_bits)
                nbits = hamming_neighbor_bits(genome_codes, kmers_in_order,
                                              k, device=dev)
            elif device_build:
                nbits = build_neighbor_bits_device(
                    genome_codes, words(table.rows, dev), table.n_buckets, k)
            else:
                nbits = build_neighbor_bits(genome_codes, table.rows,
                                            table.n_buckets, k)
        tiles = genome_tiles_np(genome_codes, nbits)
        if cache_path:
            from quickmer2_tpu_torch.dictionary import content_fingerprint
            from quickmer2_tpu_torch.io import formats
            formats.write_qai(cache_path, k, G, tiles, dict_end_pos,
                              neighbor_bits,
                              content_fingerprint(kmers_in_order, k))
        return cls._assemble(tiles, G, dict_end_pos, table, neighbor_bits,
                             dev, place_rows)

    @classmethod
    def _assemble(cls, tiles, G: int, dict_end_pos, table: PackedTable,
                  has_neighbor_bits: bool, dev: torch.device,
                  place_rows: bool = True) -> "AnchoredIndex":
        dblock = build_dblock(np.asarray(dict_end_pos), G)
        return cls(words(table.rows, dev) if place_rows else None,
                   table.n_buckets,
                   torch.from_numpy(np.array(tiles, np.uint8)).to(dev), G,
                   words(dblock, dev), len(dict_end_pos),
                   has_neighbor_bits=has_neighbor_bits,
                   host_rows=table.rows, device=dev)

    @staticmethod
    def estimate_hbm_bytes(n_kmers: int, genome_len: int,
                           dict_devices: int = 1) -> dict:
        """Per-device memory of the anchored structures, before building
        them:
          rows   = n_buckets * 32 B / ds (two-choice buckets at load 0.5)
          tiles  = G bytes
          dblock = G/DBLK * 16 B
          mono   = the spill-recount table and its slot counters (ds = 1)
        """
        from quickmer2_tpu_torch.ops import monotable
        from quickmer2_tpu_torch.ops.packed_table import ENTRIES_PER_BUCKET
        ds = max(int(dict_devices), 1)
        n_buckets = 1 << max(1, int(np.ceil(np.log2(
            max(n_kmers, 1) / (ENTRIES_PER_BUCKET * 0.5)))))
        rows = n_buckets * 4 * ENTRIES_PER_BUCKET * 4 // ds
        tiles = -(-genome_len // GBLK) * GBLK
        dblock = -(-genome_len // DBLK) * 16
        mono = 0
        if ds == 1:
            mb = 1 << max(1, int(np.ceil(np.log2(
                max(n_kmers, 1) / (monotable.ENTRIES * 0.5)))))
            mono = mb * 4 * monotable.ROW_WIDTH \
                + (mb * monotable.ENTRIES + 1) * 4
        return {"rows": rows, "tiles": tiles, "dblock": dblock,
                "mono_spill": mono, "dict_devices": ds,
                "total": rows + tiles + dblock + mono}

    @classmethod
    def load(cls, qai_path: str, dic, place_rows: bool = True,
             device: str = "cuda") -> "AnchoredIndex":
        """Load a .qai companion (the port's or the JAX package's); the
        cheap derivations are rebuilt from it plus the dictionary
        (place_rows as in build). Raises ValueError when the artifact
        does not match the dictionary."""
        from quickmer2_tpu_torch.io import formats
        dev = resolve_device(device)
        k, G, tiles, pos, nb, fp = formats.read_qai(qai_path)
        if k != dic.kmer_size or len(pos) != dic.n_kmers:
            raise ValueError(
                f"{qai_path}: built for k={k}, n={len(pos)} but dictionary "
                f"has k={dic.kmer_size}, n={dic.n_kmers} — stale artifact")
        if fp != dic.fingerprint:
            raise ValueError(
                f"{qai_path}: dictionary content fingerprint mismatch "
                f"({fp:#018x} != {dic.fingerprint:#018x}) — the dictionary "
                f"was rebuilt with a different k-mer set; stale artifact")
        pos = np.asarray(pos, np.uint32)
        khi, klo = codec.split_u64(dic.kmers_in_order)
        rank = np.arange(dic.n_kmers, dtype=np.uint32)
        table = PackedTable.build(khi, klo, rank, pos=pos)
        return cls._assemble(tiles, G, pos, table, nb, dev, place_rows)

    @classmethod
    def from_dictionary_and_fasta(cls, dic, fasta_path: str,
                                  neighbor_bits: bool = True,
                                  cache_path: str | None = None,
                                  device_build: bool | None = None,
                                  place_rows: bool = True,
                                  device: str = "cuda") -> "AnchoredIndex":
        """Recover the genome stream and per-rank positions by scanning
        the reference FASTA against the dictionary. With cache_path, a
        matching .qai is loaded instead (no FASTA scan) and a fresh build
        is persisted there. place_rows as in build."""
        dev = resolve_device(device)
        if cache_path and os.path.exists(cache_path):
            try:
                return cls.load(cache_path, dic, place_rows=place_rows,
                                device=dev)
            except ValueError:
                pass  # stale artifact — rebuild and overwrite below
        stream, dict_pos = _genome_stream_and_positions(dic, fasta_path)
        return cls.build(stream, dict_pos, dic.kmers_in_order, dic.kmer_size,
                         neighbor_bits=neighbor_bits, cache_path=cache_path,
                         device_build=device_build, place_rows=place_rows,
                         device=dev)


def _genome_stream_and_positions(dic, fasta_path: str):
    """Concatenated genome code stream (one SEP between chromosomes) and
    the global END position of every dictionary k-mer in rank order."""
    from quickmer2_tpu_torch.io import fasta as fasta_io
    from quickmer2_tpu_torch.utils import native

    k = dic.kmer_size
    parts = []
    pos_parts = []
    offset = 0
    table = np.ascontiguousarray(dic.table)
    rank = dic.rank
    n = dic.n_kmers
    for _, seq in fasta_io.iter_fasta(fasta_path):
        codes = codec.encode_bases(np.frombuffer(seq, dtype=np.uint8))
        if native.available():
            canon, valid, _ = native.sliding_canon(codes, k)
        else:
            canon, valid = codec.sliding_kmers_np(codes, k)
        valid = valid & (canon != 0)
        if native.available():
            slots, found = native.lookup_keys(table, canon)
        else:
            from quickmer2_tpu_torch.ops import hash as qhash
            slots, found = qhash.probe_lookup_np(table, canon, dic.hash_size)
        hit = valid & found & (rank[slots] < n)
        p_end = np.flatnonzero(hit) + (k - 1) + offset
        pos_parts.append(p_end.astype(np.uint32))
        parts.append(codes)
        parts.append(np.array([codec.SEP], np.uint8))
        offset += len(codes) + 1
    stream = np.concatenate(parts)[:-1] if parts else np.zeros(0, np.uint8)
    dict_pos = np.concatenate(pos_parts) if pos_parts else np.zeros(0, np.uint32)
    if len(dict_pos) != n:
        raise ValueError(
            f"genome scan found {len(dict_pos)} dictionary k-mers, "
            f"dictionary has {n} — wrong FASTA for this .qm?")
    return stream, dict_pos


def genome_tiles_np(genome_codes: np.ndarray,
                    neighbor_bits: np.ndarray | None = None) -> np.ndarray:
    """Pad the code stream to GBLK tiles (SEP padding). When
    neighbor_bits (u8[G], low 4 bits used) is given, each tile byte is
    code | bits << 3 — consumers mask with & 7 for the code."""
    G = len(genome_codes)
    ng = -(-G // GBLK)
    tiles = np.full(ng * GBLK, codec.SEP, np.uint8)
    tiles[:G] = genome_codes
    if neighbor_bits is not None:
        tiles[:G] |= (neighbor_bits.astype(np.uint8) & np.uint8(15)) << 3
    return tiles.reshape(ng, GBLK)


def build_neighbor_bits(genome_codes: np.ndarray, rows: np.ndarray,
                        n_buckets: int, k: int,
                        chunk: int = 1 << 22) -> np.ndarray:
    """Single-substitution neighbor-hit bitmap of the genome, on the host.

    Returns u8[G] where bit b of byte e is set iff substituting base b at
    genome position e inside ANY valid k-window gives a canonical k-mer
    that IS in the dictionary. In a unique-k-mer dictionary this is rare,
    so tier 1 takes a zero byte as proof that a lone substitution at e
    makes no dictionary k-mer. A one-byte-per-slot Bloom prefilter over
    the table keys passes ~1-2% of the variants to an exact packed-table
    probe."""
    G = len(genome_codes)
    nb = np.zeros(G, np.uint8)
    if G < k:
        return nb
    member = _bloom_member_maker(rows, n_buckets)
    step = max(chunk, 4 * k)
    for off in range(0, G - k + 1, step):
        seg = genome_codes[off: off + step + k - 1]
        fwd, rc, valid = codec.sliding_fwd_rc_np(seg, k)
        vidx = np.flatnonzero(valid)
        if len(vidx) == 0:
            continue
        fwd, rc = fwd[vidx], rc[vidx]
        for i in range(k):
            base_i = seg[vidx + i]
            sh_f = np.uint64(2 * (k - 1 - i))
            sh_r = np.uint64(2 * i)
            f_clr = fwd & ~(np.uint64(3) << sh_f)
            r_clr = rc & ~(np.uint64(3) << sh_r)
            for b in range(4):
                sel = base_i != b
                if not sel.any():
                    continue
                mf = f_clr[sel] | (np.uint64(b) << sh_f)
                mr = r_clr[sel] | (np.uint64((b - 2) & 3) << sh_r)
                canon = np.minimum(mf, mr)
                khi, klo = codec.split_u64(canon)
                found = member(khi, klo)
                if found.any():
                    e = off + vidx[sel][found] + i
                    np.bitwise_or.at(nb, e, np.uint8(1 << b))
    return nb


def _bloom_member_maker(rows: np.ndarray, n_buckets: int):
    """Exact membership tester against a packed table: Bloom byte-map
    prefilter (~64 slots/key, capped at 1 GiB) + packed probe of the
    candidates. Returns member(khi, klo) -> bool[N]."""
    from quickmer2_tpu_torch.ops.hash import djb_pair_np
    khi_t = np.ascontiguousarray(rows[:, 0::4]).ravel()
    klo_t = np.ascontiguousarray(rows[:, 1::4]).ravel()
    nz = (khi_t | klo_t) != 0
    h = djb_pair_np(khi_t[nz], klo_t[nz])
    n = int(nz.sum())
    mbits = min(max(int(np.ceil(np.log2(max(n, 1) * 64))), 16), 30)
    bloom = np.zeros(1 << mbits, np.uint8)
    bloom[h & np.uint32((1 << mbits) - 1)] = 1

    def member(khi_q: np.ndarray, klo_q: np.ndarray) -> np.ndarray:
        hq = djb_pair_np(khi_q, klo_q)
        cand = bloom[hq & np.uint32((1 << mbits) - 1)] != 0
        out = np.zeros(len(khi_q), bool)
        ci = np.flatnonzero(cand)
        if len(ci):
            out[ci] = probe_packed_np(rows, khi_q[ci], klo_q[ci], n_buckets)
        return out

    return member


def build_neighbor_bits_device(genome_codes: np.ndarray, rows: torch.Tensor,
                               n_buckets: int, k: int,
                               chunk: int = 1 << 23) -> np.ndarray:
    """build_neighbor_bits on rows' device (kernel K4 on a card), in
    chunks with a k-1 overlap; the same bytes as the host builder. The
    table's key filter is built once, before the first chunk; chunk i's
    sweep is queued before chunk i-1's bitmap is fetched."""
    genome_codes = np.asarray(genome_codes, np.uint8)
    G = len(genome_codes)
    nb = np.zeros(G, np.uint8)
    if G < k:
        return nb
    n_keys = int((rows.view(-1, 4)[:, :2] != 0).any(1).sum())
    filt = key_filter(rows, n_buckets=n_buckets,
                      n_words=filter_words_for(n_keys))
    step = max(chunk, 4 * k)
    pending = None                       # (off, fetch handle)
    for off in range(0, G - k + 1, step):
        seg = torch.from_numpy(np.ascontiguousarray(
            genome_codes[off: off + step + k - 1])).to(rows.device)
        out = start_fetch(neighbor_bits(seg, rows, filt, n_buckets=n_buckets,
                                        k=k))
        if pending is not None:
            poff, phandle = pending
            part = fetched(phandle).numpy()
            nb[poff: poff + len(part)] |= part
        pending = (off, out)
    poff, phandle = pending
    part = fetched(phandle).numpy()
    nb[poff: poff + len(part)] |= part
    return nb


def build_dblock(dict_end_pos: np.ndarray, G: int) -> np.ndarray:
    """Sampled prefix-count structure over dictionary end positions:
    per DBLK-position block, [rank_base, bitmask_hi, bitmask_lo, 0]."""
    nb = -(-G // DBLK) + 1
    dblock = np.zeros((nb, 4), np.uint32)
    blk = np.asarray(dict_end_pos) // DBLK
    bit = np.asarray(dict_end_pos) % DBLK
    hi_mask = np.zeros(nb, np.uint64)
    lo_mask = np.zeros(nb, np.uint64)
    sel_hi = bit >= 32
    np.bitwise_or.at(hi_mask, blk[sel_hi],
                     np.uint64(1) << (bit[sel_hi] - 32).astype(np.uint64))
    np.bitwise_or.at(lo_mask, blk[~sel_hi],
                     np.uint64(1) << bit[~sel_hi].astype(np.uint64))
    counts = np.bincount(blk, minlength=nb)
    rank_base = np.concatenate([[0], np.cumsum(counts[:-1])]).astype(np.uint32)
    dblock[:, 0] = rank_base
    dblock[:, 1] = hi_mask.astype(np.uint32)
    dblock[:, 2] = lo_mask.astype(np.uint32)
    return dblock


class AnchoredDepthCounter:
    """Feeds fixed-width read rows through the anchored fast path.

    Tier 1 (K3) counts most reads by range-adds; its spilled reads are
    routed on the host in FIFO order, lagged: code 1 into dense tier-2
    batches (K3, run-sliced), code 2 and every tier-2 spill into dense
    exact batches: with mono_spill (the default, as in the JAX counter)
    K2r through the mono table, plus host side-table lookups of the
    unresolved lanes; without it K12 through the packed table into the
    plain-count accumulator exact_acc. finish() returns the depth vector
    (u32[n_kmers]), bit-identical to the flat path and to the JAX
    AnchoredDepthCounter; n_spilled / n_spilled2 equal the JAX counter's.

    The transfer knobs keep the JAX names and meaning: prefetch_puts packs
    each batch (2-bit rows, pinned memory) and queues its host-to-device
    copy on a transfer thread; up to put_depth batches wait there before
    a launch is forced; spill codes and unresolved masks come back by
    event-lagged copies, drained when more than spill_lag are in flight.
    Launch order is the main thread's, so results are deterministic.
    """

    def __init__(self, index: AnchoredIndex, k: int, read_len: int,
                 batch_reads: int | None = None, max_runs: int = 4,
                 max_dirty: int = 0, tier2_max_dirty: int = 0,
                 tier2_max_runs: int = 6, tier2_dirty_runs: int = 2,
                 tier2_run_width: int = 32,
                 anchor_offsets: tuple | None = None,
                 neighbor_mode: bool | None = None,
                 spill_lag: int = 16, prefetch_puts: bool = True,
                 put_depth: int = 4, mono_spill: bool = True,
                 device: str = "cuda"):
        self.device = resolve_device(device)
        if index.device.type != self.device.type:
            raise ValueError(f"the index lives on {index.device}, the "
                             f"counter on {self.device}")
        self.index = index
        self.k = k
        self.read_len = read_len
        self._xfer = None
        if prefetch_puts:
            self._xfer = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="qm2-h2d")
        self._put_q = collections.deque()
        self._put_depth = put_depth
        # default batch sizes by lanes, not rows (2^22 lanes)
        if batch_reads is None:
            batch_reads = max(1 << 12, (1 << 22) // read_len)
        self.batch_reads = batch_reads
        self.max_runs = max_runs
        self.max_dirty = max_dirty
        self.neighbor_mode = (index.has_neighbor_bits if neighbor_mode is None
                              else neighbor_mode)
        if self.neighbor_mode and not index.has_neighbor_bits:
            raise ValueError("neighbor_mode requires an index built with "
                             "neighbor_bits=True")
        self.tier2_max_dirty = tier2_max_dirty
        self.tier2_max_runs = tier2_max_runs
        self.tier2_dirty_runs = tier2_dirty_runs
        self.tier2_run_width = tier2_run_width
        W = read_len - k + 1
        if anchor_offsets is None:
            # from the row width W, not the read length
            anchor_offsets = tuple(
                sorted({0, W // 3, (2 * W) // 3, W - 1} - {-1}))
        self.anchor_offsets = tuple(int(a) for a in anchor_offsets if 0 <= a < W)
        wd = word_dtype(self.device)
        self.mono_spill = mono_spill
        self._exact_filter = None   # K12's bitmap of keys at h2, built once
        self._init_accumulators()
        if mono_spill:
            if index.mono is None:
                flat = index.host_rows.reshape(-1, 4)
                live = (flat[:, 0] | flat[:, 1]) != 0
                mt = MonoTable.build(flat[live, 0], flat[live, 1],
                                     rank=flat[live, 2])
                assert mt.n_kmers == index.n_kmers
                index.mono, index.mono_rows = mt, words(mt.rows, self.device)
            self._mono = index.mono
            self._mono_rows = index.mono_rows
            self.exact_slot = torch.zeros(self._mono.n_slots + 1, dtype=wd,
                                          device=self.device)
            self._side_counts = np.zeros(index.n_kmers, np.uint64)
        self._pending: list[np.ndarray] = []
        self._pending_rows = 0
        self._spill: list[np.ndarray] = []
        self._spill_rows = 0
        self._spill2: list[np.ndarray] = []
        self._spill2_rows = 0
        self._inflight = collections.deque()
        self._lag = spill_lag
        self.n_reads = 0
        self.n_spilled = 0
        self.n_spilled2 = 0
        self.phases = Phases("anchored.")

    def feed_reads(self, reads_rows: np.ndarray) -> None:
        """reads_rows: u8[R, read_len] code rows (SEP-padded)."""
        if reads_rows.ndim != 2 or reads_rows.shape[1] != self.read_len:
            raise ValueError(f"rows of shape {reads_rows.shape}, expected "
                             f"(R, {self.read_len})")
        self.n_reads += len(reads_rows)
        self._pending.append(reads_rows)
        self._pending_rows += len(reads_rows)
        while self._pending_rows >= self.batch_reads:
            buf = np.concatenate(self._pending)
            self._pending = [buf[self.batch_reads:]]
            self._pending_rows = len(self._pending[0])
            self._enqueue(1, buf[: self.batch_reads])

    def _tier_kw(self, tier: int) -> dict:
        kw = dict(k=self.k, read_len=self.read_len,
                  n_buckets=self.index.n_buckets,
                  anchor_offsets=self.anchor_offsets)
        if tier == 1:
            return dict(kw, max_runs=self.max_runs, max_dirty=self.max_dirty,
                        neighbor_mode=self.neighbor_mode)
        return dict(kw, max_runs=self.tier2_max_runs,
                    max_dirty=self.tier2_max_dirty,
                    max_dirty_runs=self.tier2_dirty_runs,
                    dirty_run_width=self.tier2_run_width)

    # -- the device steps (overridden by the sharded counter) -------------

    def _init_accumulators(self) -> None:
        """diff u32[n + 2] and, without the mono table, the plain-count
        accumulator exact_acc u32[n + 2]."""
        n, wd = self.index.n_kmers, word_dtype(self.device)
        self.diff = torch.zeros(n + 2, dtype=wd, device=self.device)
        self.exact_acc = (None if self.mono_spill else
                          torch.zeros(n + 2, dtype=wd, device=self.device))

    def _kernel_step(self, put, tier) -> list:
        """One tier-1 or tier-2 batch; its spill codes, as a list of
        device tensors in read order."""
        fmt, pk, aux = put
        ix = self.index
        return [anchored_count(pk, aux, ix.rows, ix.genome_tiles, ix.dblock,
                               self.diff, fmt=fmt, **self._tier_kw(tier))]

    def _exact_step(self, put) -> list:
        """One exact batch; the unresolved-lane masks to drain (the mono
        recount's), as a list of device tensors."""
        fmt, pk, aux = put
        if self.mono_spill:
            return [count_mono_rows(pk, aux, self._mono_rows, self.exact_slot,
                                    fmt=fmt, k=self.k,
                                    n_buckets=self._mono.n_buckets,
                                    read_len=self.read_len)]
        ix = self.index
        if self._exact_filter is None:
            self._exact_filter = block_displaced_filter(ix.rows, ix.n_buckets,
                                                        0)
        count_packed_rows(pk, aux, ix.rows, self.exact_acc, fmt=fmt,
                          k=self.k, n_buckets=ix.n_buckets,
                          read_len=self.read_len,
                          displaced=self._exact_filter)
        return []

    def _merged_accumulators(self):
        """Host diff and exact_acc (None with the mono table), u32."""
        return (to_numpy_u32(self.diff), None if self.exact_acc is None
                else to_numpy_u32(self.exact_acc))

    def _snapshot_accumulators(self):
        """diff and exact_acc in the JAX snapshot's shape."""
        diff, acc = self._merged_accumulators()
        # the mono counter's exact_acc is JAX's zero accumulator: its
        # recount lives in exact_slot and the side counts
        return diff, np.zeros_like(diff) if acc is None else acc

    def _put_accumulators(self, diff: np.ndarray, acc: np.ndarray) -> None:
        """Load snapshot accumulators back onto the device."""
        if self.mono_spill:
            # depth = cumsum(diff) + exact_acc, so exact_acc folds into
            # diff as its own first differences (mod 2^32)
            self.diff = words(diff + np.diff(acc, prepend=np.uint32(0)),
                              self.device)
        else:
            self.diff = words(diff, self.device)
            self.exact_acc = words(acc, self.device)

    def _pack_put(self, batch: np.ndarray):
        """Pack a host batch and start its copy to the device (on the
        transfer thread when prefetching)."""
        with self.phases("pack_put"):
            fmt, pk, aux = rowpack.pack_batch(batch)
            pk_t, aux_t = torch.from_numpy(pk), rowpack.aux_tensor(fmt, aux)
            if self.device.type == "cuda":
                pk_t = pk_t.pin_memory().to(self.device, non_blocking=True)
                aux_t = aux_t.pin_memory().to(self.device, non_blocking=True)
        return fmt, pk_t, aux_t

    def _enqueue(self, kind, batch: np.ndarray) -> None:
        """kind: tier 1, tier 2 or "exact". Packing and the copy go to
        the transfer thread (or run inline); launches happen on this
        thread in FIFO order, put_depth batches behind."""
        if self._xfer is not None:
            payload = self._xfer.submit(self._pack_put, batch)
        else:
            payload = self._pack_put(batch)
        self._put_q.append((kind, batch, payload))
        while len(self._put_q) > self._put_depth:
            self._dispatch_oldest()

    def _dispatch_oldest(self) -> None:
        kind, batch, payload = self._put_q.popleft()
        with self.phases("put_wait"):
            put = payload.result() if hasattr(payload, "result") else payload
        with self.phases(f"dispatch_{kind}"):
            if kind == "exact":
                outs = self._exact_step(put)
                kind_out = "exactmask"
            else:
                outs = self._kernel_step(put, kind)
                kind_out = kind
        if not outs:
            return
        self._inflight.append((batch, [start_fetch(o) for o in outs],
                               kind_out))
        if len(self._inflight) > self._lag:
            self._drain_all()

    def _drain_all(self) -> None:
        """Wait for every in-flight spill code / unresolved mask copy and
        route the batches in order."""
        if not self._inflight:
            return
        with self.phases("drain"):
            items = [(batch, [fetched(h) for h in hs], kind)
                     for batch, hs, kind in self._inflight]
        self._inflight.clear()
        for batch, outs, kind in items:
            if kind == "exactmask":
                self._drain_exact_mask(batch, to_numpy_u32(outs[0]))
            else:
                self._route_spill(batch, np.concatenate(
                    [o.numpy() for o in outs]), kind)

    def _drain_exact_mask(self, batch: np.ndarray, mask_words: np.ndarray):
        """Recount this exact batch's unresolved window lanes (LSB-first
        u32 words over its R*W lanes) against the mono side table."""
        W = self.read_len - self.k + 1
        mask = np.unpackbits(mask_words.view(np.uint8), bitorder="little")
        lanes = np.flatnonzero(mask[: len(batch) * W])
        if len(lanes) == 0:
            return
        rows_i = lanes // W
        cols = lanes % W
        m = len(lanes)
        strip = np.full((m, self.k + 1), codec.SEP, np.uint8)
        idx = cols[:, None] + np.arange(self.k)[None, :]
        strip[:, : self.k] = batch[rows_i[:, None], idx]
        canon, _ = codec.sliding_kmers_np(strip.reshape(-1), self.k)
        km = canon[:: self.k + 1][:m]
        hi = (km >> np.uint64(32)).astype(np.uint32)
        lo = km.astype(np.uint32)
        found, rank = self._mono.side_lookup_np(hi, lo)
        if found.any():
            np.add.at(self._side_counts, rank[found], 1)

    def _route_spill(self, batch: np.ndarray, sp: np.ndarray, tier) -> None:
        """Route one batch's spill codes: tier-1 code 1 → the tier-2
        queue, tier-1 code 2 (unanchorable) and any tier-2 spill → the
        exact queue. A queue runs when a full batch accumulates."""
        sp = np.asarray(sp).reshape(-1)
        n_sp = int((sp != 0).sum())
        if not n_sp:
            return
        if tier == 1:
            self.n_spilled += n_sp
            t2 = sp == 1
            ex = sp == 2
            if t2.any():
                self._spill.append(batch[t2])
                self._spill_rows += int(t2.sum())
                while self._spill_rows >= self.batch_reads:
                    buf = np.concatenate(self._spill)
                    self._spill = [buf[self.batch_reads:]]
                    self._spill_rows = len(self._spill[0])
                    self._run_tier2(buf[: self.batch_reads])
            if ex.any():
                self._enqueue_exact_rows(batch[ex])
        else:
            self._enqueue_exact_rows(batch[sp != 0])

    def _run_tier2(self, batch: np.ndarray) -> None:
        if self.tier2_run_width == 0 and self.tier2_max_dirty == 0:
            self._enqueue("exact", batch)
        else:
            self._enqueue(2, batch)

    def _enqueue_exact_rows(self, rows: np.ndarray) -> None:
        # counts every row sent to the exact path, code-2 rows included
        # (as the JAX counter does)
        self.n_spilled2 += len(rows)
        self._spill2.append(rows)
        self._spill2_rows += len(rows)
        while self._spill2_rows >= self.batch_reads:
            buf = np.concatenate(self._spill2)
            self._spill2 = [buf[self.batch_reads:]]
            self._spill2_rows = len(self._spill2[0])
            self._enqueue("exact", buf[: self.batch_reads])

    def _flush(self, parts: list[np.ndarray], runner) -> None:
        """Run the rows left in a queue in batches of batch_reads, the
        last one short (the kernels take any row count; the JAX counter
        pads it with SEP rows for a fixed compiled shape, which count
        nothing)."""
        buf = np.concatenate(parts)
        for off in range(0, len(buf), self.batch_reads):
            runner(buf[off: off + self.batch_reads])

    def finish(self) -> np.ndarray:
        if self._pending_rows:
            self._flush(self._pending, lambda b: self._enqueue(1, b))
            self._pending, self._pending_rows = [], 0
        # routing tier-1 spills enqueues tier-2 work (and so on): loop
        # until settled
        while (self._put_q or self._inflight or self._spill_rows
               or self._spill2_rows):
            while self._put_q:
                self._dispatch_oldest()
            self._drain_all()
            if self._spill_rows:
                parts, self._spill, self._spill_rows = self._spill, [], 0
                self._flush(parts, self._run_tier2)
            elif self._spill2_rows:
                parts, self._spill2, self._spill2_rows = self._spill2, [], 0
                self._flush(parts, lambda b: self._enqueue("exact", b))
        if self._xfer is not None:
            self._xfer.shutdown(wait=True)
            self._xfer = None   # later feeds pack inline
        with self.phases("finish_sync"):
            diff, acc = self._merged_accumulators()
            slots = (to_numpy_u32(self.exact_slot)[:-1] if self.mono_spill
                     else None)
        n = self.index.n_kmers
        depth = np.cumsum(diff, dtype=np.uint32)[:n]
        if acc is not None:
            depth += acc[:n]
        if self.mono_spill:
            live = self._mono.slot_rank < n
            depth[self._mono.slot_rank[live]] += slots[live]   # ranks unique
            depth += self._side_counts.astype(np.uint32)      # u32 wrap (Q8)
        return depth

    # -- state carried across (the JAX counter's keys) --------------------

    def _cat_rows(self, parts: list[np.ndarray]) -> np.ndarray:
        if not parts:
            return np.zeros((0, self.read_len), np.uint8)
        return np.concatenate(parts)

    def snapshot(self) -> tuple[dict, dict]:
        """Settle all in-flight work, then capture the counter state as
        (arrays, meta), with the JAX counter's keys; the spill counters
        in meta are exact, never lagged."""
        while self._put_q:
            self._dispatch_oldest()
        self._drain_all()
        diff, acc = self._snapshot_accumulators()
        arrays = {"diff": diff, "exact_acc": acc,
                  "pending": self._cat_rows(self._pending),
                  "spill": self._cat_rows(self._spill),
                  "spill2": self._cat_rows(self._spill2)}
        meta = {"n_reads": self.n_reads, "n_spilled": self.n_spilled,
                "n_spilled2": self.n_spilled2, "read_len": self.read_len,
                "mono_spill": self.mono_spill}
        if self.mono_spill:
            arrays["exact_slot"] = to_numpy_u32(self.exact_slot)
            arrays["side_counts"] = self._side_counts.copy()
        return arrays, meta

    def restore(self, arrays: dict, meta: dict) -> None:
        """Resume from a snapshot() — this counter's or the JAX
        AnchoredDepthCounter's taken with the same mono_spill (same
        keys)."""
        if int(meta["read_len"]) != self.read_len:
            raise ValueError(
                f"checkpoint read_len {meta['read_len']} != counter "
                f"read_len {self.read_len}")
        if bool(meta.get("mono_spill", False)) != self.mono_spill:
            raise ValueError(
                f"checkpoint mono_spill={meta.get('mono_spill')} != this "
                f"counter's {self.mono_spill}; resume with the same setting")
        self._put_accumulators(np.asarray(arrays["diff"], np.uint32),
                               np.asarray(arrays["exact_acc"], np.uint32))
        if self.mono_spill:
            self.exact_slot = words(np.asarray(arrays["exact_slot"]),
                                    self.device)
            self._side_counts = np.asarray(arrays["side_counts"],
                                           np.uint64).copy()

        def rows_of(name):
            r = np.asarray(arrays[name], np.uint8).reshape(-1, self.read_len)
            return ([r] if len(r) else []), len(r)
        self._pending, self._pending_rows = rows_of("pending")
        self._spill, self._spill_rows = rows_of("spill")
        self._spill2, self._spill2_rows = rows_of("spill2")
        self._inflight.clear()
        self._put_q.clear()
        self.n_reads = int(meta["n_reads"])
        self.n_spilled = int(meta["n_spilled"])
        self.n_spilled2 = int(meta["n_spilled2"])


def rows_from_flat_codes(codes: np.ndarray, read_len: int,
                         with_overflow: bool = False,
                         segment_k: int | None = None,
                         stats_out: dict | None = None):
    """Split a separator-delimited code stream into fixed-length
    SEP-padded rows.

    Reads longer than read_len:
      - segment_k=k (the anchored default): sliced into read_len-wide
        segments with stride read_len-k+1, so consecutive segments share
        k-1 bases and every k-mer window of the read lands in exactly one
        segment; each segment rides the anchored path as a row;
      - with_overflow (and no segment_k): returned as a second value, a
        separator-delimited code stream for the flat path;
      - otherwise: raise."""
    codes = np.asarray(codes, np.uint8)
    empty_over = np.zeros(0, np.uint8)
    if len(codes) == 0:
        rows = np.zeros((0, read_len), np.uint8)
        return (rows, empty_over) if with_overflow else rows
    # uniform-length reads, an exactly (read_len+1)-periodic stream (the
    # common FASTQ shape): a reshape, no gather
    L1 = read_len + 1
    if len(codes) % L1 == 0 and codes[read_len] == codec.SEP:
        n = len(codes) // L1
        mat = codes.reshape(n, L1)
        if (mat[:, read_len] == codec.SEP).all() and not \
                (mat[:, :read_len] == codec.SEP).any():
            rows = np.ascontiguousarray(mat[:, :read_len])
            return (rows, empty_over) if with_overflow else rows
    sep_idx = np.flatnonzero(codes == codec.SEP)
    bounds = np.concatenate([[-1], sep_idx, [len(codes)]])
    starts = bounds[:-1] + 1
    lens = bounds[1:] - starts
    keep = lens > 0
    starts, lens = starts[keep], lens[keep]
    overflow = empty_over
    if len(starts) and lens.max() > read_len:
        over = lens > read_len
        if segment_k is not None:
            stride = read_len - segment_k + 1
            o_starts = starts[over].astype(np.int64)
            o_lens = lens[over].astype(np.int64)
            n_seg = -(-(o_lens - segment_k + 1) // stride)   # >= 2
            rep = np.repeat(np.arange(len(o_starts)), n_seg)
            csum = np.concatenate([[0], np.cumsum(n_seg)])
            j = np.arange(int(n_seg.sum())) - csum[rep]
            seg_starts = o_starts[rep] + j * stride
            seg_lens = np.minimum(read_len,
                                  o_starts[rep] + o_lens[rep] - seg_starts)
            starts = np.concatenate([starts[~over], seg_starts])
            lens = np.concatenate([lens[~over], seg_lens])
            if stats_out is not None:
                stats_out["n_long_reads"] = \
                    stats_out.get("n_long_reads", 0) + len(o_starts)
                stats_out["n_segments"] = \
                    stats_out.get("n_segments", 0) + int(n_seg.sum())
        elif not with_overflow:
            raise ValueError(
                f"read of {lens.max()} bases exceeds row width {read_len}")
        else:
            over_parts = []
            for s, ln in zip(starts[over], lens[over]):
                over_parts.append(codes[s: s + ln])
                over_parts.append(np.array([codec.SEP], np.uint8))
            overflow = np.concatenate(over_parts)
            starts, lens = starts[~over], lens[~over]
    if len(starts) == 0:
        rows = np.zeros((0, read_len), np.uint8)
        return (rows, overflow) if with_overflow else rows
    codes_pad = np.concatenate([codes, np.full(read_len, codec.SEP, np.uint8)])
    idx = starts.astype(np.int64)[:, None] + np.arange(read_len)[None, :]
    rows = codes_pad[idx]
    short = lens < read_len
    if short.any():
        rows[short] = np.where(
            np.arange(read_len)[None, :] >= lens[short][:, None],
            codec.SEP, rows[short])
    return (rows, overflow) if with_overflow else rows


class RowStreamer:
    """Accumulates a separator-delimited code stream and emits
    fixed-length read rows, carrying partial reads across chunks.

    With segment_k=k (how pipelines.count builds it), reads longer than
    read_len are sliced into k-1-overlap segments (rows_from_flat_codes);
    .stats counts them. Without segment_k, overlong reads accumulate in
    .overflow (a separator-delimited code stream) for the flat path."""

    def __init__(self, read_len: int, segment_k: int | None = None):
        self.read_len = read_len
        self.segment_k = segment_k
        self._tail = np.zeros(0, np.uint8)
        self.overflow: list[np.ndarray] = []
        self.stats: dict = {}

    def take_overflow(self) -> np.ndarray:
        if not self.overflow:
            return np.zeros(0, np.uint8)
        out = np.concatenate(self.overflow)
        self.overflow = []
        return out

    def _rows(self, codes: np.ndarray) -> np.ndarray:
        rows, over = rows_from_flat_codes(codes, self.read_len,
                                          with_overflow=True,
                                          segment_k=self.segment_k,
                                          stats_out=self.stats)
        if len(over):
            self.overflow.append(over)
        return rows

    def feed(self, codes: np.ndarray) -> np.ndarray:
        buf = np.concatenate([self._tail, codes]) if len(self._tail) else codes
        seps = np.flatnonzero(buf == codec.SEP)
        if len(seps) == 0:
            self._tail = buf
            return np.zeros((0, self.read_len), np.uint8)
        cut = seps[-1] + 1
        self._tail = buf[cut:]
        return self._rows(buf[:cut])

    def finish(self) -> np.ndarray:
        rows = self._rows(self._tail)
        self._tail = np.zeros(0, np.uint8)
        return rows

    # -- state carried across ------------------------------------------

    def snapshot(self) -> dict:
        over = (np.concatenate(self.overflow) if self.overflow
                else np.zeros(0, np.uint8))
        return {"tail": self._tail.copy(), "overflow": over}

    def restore(self, snap: dict) -> None:
        self._tail = np.asarray(snap["tail"], np.uint8)
        over = np.asarray(snap["overflow"], np.uint8)
        self.overflow = [over] if len(over) else []
