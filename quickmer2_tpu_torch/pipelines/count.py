"""count — stream sample reads, probe the dictionary, accumulate depth.

Reference: QuicKmer.c:304-545 (single-threaded parser feeding a pthread
FIFO worker pool doing atomic u16 increments). Port of
quickmer2_tpu/pipelines/count.py, single device, in two modes with the
same output bytes. Flat mode, the mono engine:

  host:   chunked file reads → native streaming parser (2-bit codes with
          separators; per-line reset semantics = SURVEY.md Q4) → batches
          of batch_bases codes with a (k-1)-code carry so no window is
          lost at a batch boundary → 2-bit packing (ops.rowpack) → H2D
  device: the fused count kernel (csrc/count_mono.cu via
          kernels.count_mono.count_mono_step): per window codec → DJB →
          one 64-B mono-table row → depth atomicAdd in SLOT order, plus
          a bitmask of unresolved lanes (misses in full buckets)
  host, one batch behind: the unresolved lanes recount against the
          mono table's side table
  finish: slot → rank permutation + side counts (u32 wrap); the .bin
          wraps to u16 (SURVEY.md Q8)

Anchored mode (ops.anchored): the code stream becomes fixed-width read
rows (RowStreamer; long reads in k-1-overlap segments), each batch runs
the anchored read pass (kernel K3), and spilled reads are recounted
through tier 2 (K3 again) and the mono table (K2r); the row width is
autodetected from the first chunk unless given.

With device="cpu" the same stream runs through the kernels' plain
PyTorch versions.
"""

from __future__ import annotations

import collections
import os
import sys
import time

import numpy as np
import torch

from quickmer2_tpu_torch.device import (
    fetched, resolve_device, start_fetch, to_numpy_u32, word_dtype, words)
from quickmer2_tpu_torch.dictionary import Dictionary
from quickmer2_tpu_torch.io import formats
from quickmer2_tpu_torch.kernels.count_mono import count_mono_step
from quickmer2_tpu_torch.ops import codec, rowpack
from quickmer2_tpu_torch.ops.codec import SEP
from quickmer2_tpu_torch.ops.monotable import MonoTable
from quickmer2_tpu_torch.utils import native


_SEP_ARR = np.array([SEP], np.uint8)


class PyPacker:
    """Pure-python fallback for utils.native.StreamPacker.

    Chunk-size-invariant byte state machine with the exact emission
    semantics of native/qm2core.c:qm2_parse_chunk — the output stream is
    identical for ANY feed chunking (including 1-byte feeds), and
    identical to the native packer's. FASTQ quality lines are skipped by
    byte count (seq_len), so a '@' at a quality-line start never
    misclassifies the record. State round-trips through
    get_state/set_state with the same keys as the native packer, so
    checkpoints are interchangeable.
    """

    _LINE_START, _HEADER, _SEQ, _PLUS, _QUAL = range(5)

    def __init__(self, mode: str):
        self.mode = mode
        self._fastq = mode == "fastq"
        self._per_line_sep = mode != "fasta-record"
        self._state = self._LINE_START
        self._seq_len = 0
        self._qual_left = 0
        self._emitted_sep = True

    def feed(self, data: bytes) -> np.ndarray:
        out: list[np.ndarray] = []
        i, n = 0, len(data)
        st = self._state
        while i < n:
            if st == self._LINE_START:
                c = data[i]
                if c == 0x0A:                       # blank line
                    i += 1
                elif c == 0x3E or (self._fastq and c == 0x40):  # '>' / '@'
                    st = self._HEADER
                    self._seq_len = 0
                    if not self._emitted_sep:
                        out.append(_SEP_ARR)
                        self._emitted_sep = True
                    i += 1
                elif self._fastq and c == 0x2B:     # '+'
                    st = self._PLUS
                    self._qual_left = self._seq_len
                    i += 1
                else:
                    st = self._SEQ                  # reprocess byte as seq
            elif st == self._HEADER:
                nl = data.find(b"\n", i)
                if nl < 0:
                    i = n
                else:
                    i = nl + 1
                    st = self._SEQ if self._fastq else self._LINE_START
            elif st == self._SEQ:
                if data[i] == 0x0A:
                    st = self._LINE_START
                    if self._per_line_sep and not self._emitted_sep:
                        out.append(_SEP_ARR)
                        self._emitted_sep = True
                    i += 1
                else:
                    nl = data.find(b"\n", i)
                    end = n if nl < 0 else nl
                    codes = codec.encode_bases(data[i:end])
                    out.append(codes)
                    self._emitted_sep = bool(codes[-1] == SEP)
                    if self._fastq:
                        self._seq_len += end - i
                    i = end
            elif st == self._PLUS:
                nl = data.find(b"\n", i)
                if nl < 0:
                    i = n
                else:
                    i = nl + 1
                    st = self._QUAL
                    if not self._emitted_sep:
                        out.append(_SEP_ARR)
                        self._emitted_sep = True
            else:                                   # _QUAL: skip by count
                while self._qual_left > 0 and i < n:
                    if data[i] == 0x0A:
                        i += 1
                        continue
                    nl = data.find(b"\n", i)
                    end = n if nl < 0 else nl
                    take = min(end - i, self._qual_left)
                    self._qual_left -= take
                    i += take
                if self._qual_left == 0:
                    st = self._LINE_START
                    self._seq_len = 0
        self._state = st
        if not out:
            return np.zeros(0, np.uint8)
        return np.concatenate(out)

    # state keys match utils.native.StreamPacker for checkpoint parity
    def get_state(self) -> dict:
        return {"mode": native.StreamPacker.MODES[self.mode], "state": self._state,
                "seq_len": self._seq_len, "qual_left": self._qual_left,
                "emitted_sep": int(self._emitted_sep)}

    def set_state(self, d: dict) -> None:
        self._state = int(d["state"])
        self._seq_len = int(d["seq_len"])
        self._qual_left = int(d["qual_left"])
        self._emitted_sep = bool(d["emitted_sep"])


def make_packer(mode: str):
    if native.available():
        return native.StreamPacker(mode)
    return PyPacker(mode)


class DepthCounter:
    """Accumulates k-mer depth over streamed code batches on the device.

    The mono layout (ops.monotable) with 2-bit-packed H2D is the only
    one ported so far: depth lives in SLOT space (bucket*8 + entry) as a
    u32 word tensor until finish, unresolved lanes (possible side-table
    members) recount on the host one batch behind.
    """

    layout = "mono"     # recorded in snapshots; restore checks it

    def __init__(self, dictionary: Dictionary, batch_bases: int = 1 << 24,
                 packed_table=None, device: str = "cuda"):
        self.device = resolve_device(device)
        self.dict = dictionary
        self.k = dictionary.kmer_size
        self.batch_bases = batch_bases
        # packed_table: pass a prebuilt MonoTable to amortize the build
        self._mono = (packed_table if isinstance(packed_table, MonoTable)
                      else MonoTable.from_dictionary(dictionary))
        self.rows = words(self._mono.rows, self.device)
        self.depth = torch.zeros(self._mono.n_slots + 1,
                                 dtype=word_dtype(self.device),
                                 device=self.device)
        self._side_counts = np.zeros(dictionary.n_kmers, np.uint64)
        self._pending_masks: list[tuple[np.ndarray, tuple]] = []
        self._carry = np.zeros(0, np.uint8)
        self._pending: list[np.ndarray] = []
        self._pending_len = 0
        self.total_kmer_windows = 0
        self.phase_s: dict = collections.defaultdict(float)

    def feed_codes(self, chunk: np.ndarray) -> None:
        self._pending.append(chunk)
        self._pending_len += len(chunk)
        while self._pending_len + len(self._carry) >= self.batch_bases:
            buf = np.concatenate([self._carry] + self._pending)
            self._pending = [buf[self.batch_bases :]]
            self._pending_len = len(self._pending[0])
            self._run(buf[: self.batch_bases])

    def _run(self, batch: np.ndarray) -> None:
        assert len(batch) == self.batch_bases
        t0 = time.time()
        pk, bits = rowpack.pack_rows(batch[None, :])
        pk_d = torch.from_numpy(pk[0]).to(self.device)
        bits_d = torch.from_numpy(bits[0]).to(self.device)
        t1 = time.time()
        self.phase_s["pack_put"] += t1 - t0
        ub = count_mono_step(pk_d, bits_d, self.rows, self.depth, k=self.k,
                             n_buckets=self._mono.n_buckets,
                             n_bases=self.batch_bases)
        self._pending_masks.append((batch, start_fetch(ub)))
        self.phase_s["dispatch"] += time.time() - t1
        # drain masks one batch behind so the D2H never stalls the next
        # launch; ~0.1% of lanes at load 0.5 end up unresolved
        if len(self._pending_masks) > 1:
            self._drain_mask(*self._pending_masks.pop(0))
        self.total_kmer_windows += len(batch) - self.k + 1
        self._carry = batch[-(self.k - 1):].copy()

    def finish(self) -> np.ndarray:
        """Flush the tail (padded to full batch shape with separators) and
        return host depth u32[n_kmers]."""
        if self._pending_len:
            buf = np.concatenate([self._carry] + self._pending)
            pad = np.full(self.batch_bases - len(buf) % self.batch_bases, SEP, np.uint8)
            buf = np.concatenate([buf, pad])
            for off in range(0, len(buf), self.batch_bases):
                self._run(buf[off : off + self.batch_bases])
            self._pending, self._pending_len = [], 0
        for pend in self._pending_masks:
            self._drain_mask(*pend)
        self._pending_masks = []
        slots = to_numpy_u32(self.depth)[:-1]
        out = np.zeros(self.dict.n_kmers, np.uint64)
        live = self._mono.slot_rank < self.dict.n_kmers
        out[self._mono.slot_rank[live]] = slots[live]
        out += self._side_counts
        return out.astype(np.uint32)          # u32 wrap (Q8 parity)

    def _drain_mask(self, batch: np.ndarray, handle: tuple) -> None:
        """Recount this batch's unresolved lanes against the side
        table. Host cost is O(lanes), not O(batch): only the k-mer
        windows AT the unresolved positions are re-encoded (gathered
        into a SEP-separated strip and run through the exact host
        codec). The mask is LSB-first u32 words (lane i = bit i&31 of
        word i>>5)."""
        t0 = time.time()
        mask = np.unpackbits(to_numpy_u32(fetched(handle)).view(np.uint8),
                             bitorder="little")
        self.phase_s["drain"] += time.time() - t0
        lanes = np.flatnonzero(mask)
        lanes = lanes[lanes < len(batch) - self.k + 1]
        if len(lanes) == 0:
            return
        m = len(lanes)
        strip = np.full((m, self.k + 1), SEP, np.uint8)
        strip[:, :self.k] = batch[lanes[:, None] + np.arange(self.k)]
        canon, _ = codec.sliding_kmers_np(strip.reshape(-1), self.k)
        km = canon[:: self.k + 1][:m]
        hi = (km >> np.uint64(32)).astype(np.uint32)
        lo = km.astype(np.uint32)
        found, rank = self._mono.side_lookup_np(hi, lo)
        if found.any():
            np.add.at(self._side_counts, rank[found], 1)

    # -- state carried across (same dict keys as the JAX DepthCounter) --

    def snapshot(self) -> dict:
        """Slot-space depth + residual host codes + side counts; with the
        stream offset and parser state this fully determines the
        remaining computation."""
        residual = np.concatenate([self._carry] + self._pending) \
            if (self._pending_len or len(self._carry)) else np.zeros(0, np.uint8)
        for pend in self._pending_masks:
            self._drain_mask(*pend)
        self._pending_masks = []
        return {"depth": to_numpy_u32(self.depth), "residual": residual,
                "windows": self.total_kmer_windows, "layout": self.layout,
                "side_counts": self._side_counts.copy()}

    def restore(self, snap: dict) -> None:
        """Resume from a snapshot() dict — this counter's or the JAX
        package's mono DepthCounter's (numpy arrays, same keys)."""
        snap_layout = str(snap.get("layout", ""))
        if snap_layout and snap_layout != self.layout:
            raise ValueError(
                f"checkpoint was taken with table layout {snap_layout!r}, "
                f"this counter uses {self.layout!r}; resume with the same "
                f"layout (depth orders differ between layouts)")
        want = self._mono.n_slots + 1
        if len(snap["depth"]) != want:
            raise ValueError(
                f"checkpoint depth length {len(snap['depth'])} != {want}; "
                f"the checkpoint was taken with a different table layout "
                f"than this counter's ({self.layout!r})")
        self.depth = words(np.asarray(snap["depth"]), self.device)
        self._side_counts = np.asarray(snap["side_counts"], np.uint64).copy()
        self._pending_masks = []
        residual = snap["residual"]
        # the first k-1 of the residual are the carry; re-split exactly
        self._carry = np.zeros(0, np.uint8)
        self._pending = [residual] if len(residual) else []
        self._pending_len = len(residual)
        self.total_kmer_windows = int(snap["windows"])


def gc_curve_from_depth(depth_u16: np.ndarray, qgc: np.ndarray):
    """Control-k-mer depth-vs-GC curve (QuicKmer.c:498-542 semantics).

    Returns (mean[401], count[401], var[401], mean_depth). Accumulation in
    float64 over the u16-wrapped depths, matching the reference's doubles.
    """
    ctrl = (qgc & formats.CTRL_FLAG) != 0
    bins = (qgc[ctrl] & formats.GC_BIN_MASK).astype(np.int64)
    d = depth_u16[ctrl].astype(np.float64)
    n = formats.GC_BINS
    count = np.bincount(bins, minlength=n)[:n]
    sum_d = np.bincount(bins, weights=d, minlength=n)[:n]
    sum_d2 = np.bincount(bins, weights=d * d, minlength=n)[:n]
    with np.errstate(invalid="ignore", divide="ignore"):
        mean = np.where(count > 0, sum_d / np.maximum(count, 1), 0.0)
        var = np.where(count > 0, sum_d2 / np.maximum(count, 1) - mean * mean, 0.0)
    total = count.sum()
    mean_depth = float(sum_d.sum() / total) if total else 0.0
    return mean, count, var, mean_depth


class StreamCounter:
    """Drives one sample's depth accumulation on one device, in flat or
    anchored mode: the object run_count feeds.

    Anchored mode builds its AnchoredDepthCounter at the first chunk, so
    the row width can be autodetected from real reads; reads wider than
    the row width are cut into k-1-overlap segments, so every read rides
    the anchored path (the JAX package's flat overflow counter is never
    fed under segmentation)."""

    def __init__(self, dictionary: Dictionary, *, mode: str = "flat",
                 index=None, batch_bases: int = 1 << 24,
                 read_len: int | None = None, packed_table=None,
                 device: str = "cuda"):
        self.dict = dictionary
        self.mode = mode
        self.batch_bases = batch_bases
        self.read_len = read_len
        self.device = resolve_device(device)
        self.counter = None
        self.row_streamer = None
        if mode == "anchored":
            if index is None:
                raise ValueError("anchored mode needs an AnchoredIndex")
            self.index = index
            if read_len is not None:
                self._make_anchored(read_len)
        elif mode == "flat":
            self.counter = DepthCounter(dictionary, batch_bases=batch_bases,
                                        packed_table=packed_table,
                                        device=self.device)
        else:
            raise ValueError(f"unknown count mode {mode!r}")

    def _make_anchored(self, read_len: int) -> None:
        from quickmer2_tpu_torch.ops.anchored import (
            AnchoredDepthCounter, RowStreamer)
        self.read_len = read_len
        self.row_streamer = RowStreamer(read_len,
                                        segment_k=self.dict.kmer_size)
        self.counter = AnchoredDepthCounter(
            self.index, self.dict.kmer_size, read_len, device=self.device)

    def feed_codes(self, codes: np.ndarray) -> None:
        if self.mode != "anchored":
            self.counter.feed_codes(codes)
            return
        if self.counter is None:
            self._make_anchored(_autodetect_read_len(codes))
        rows = self.row_streamer.feed(codes)
        if len(rows):
            self.counter.feed_reads(rows)

    def finish(self) -> np.ndarray:
        """Flush tails and return the merged host depth u32[n_kmers]."""
        if self.mode == "anchored":
            if self.counter is None:     # empty sample
                return np.zeros(self.dict.n_kmers, np.uint32)
            tail = self.row_streamer.finish()
            if len(tail):
                self.counter.feed_reads(tail)
        return self.counter.finish()

    @property
    def stats(self) -> dict:
        s = {"mode": self.mode,
             "total_windows": getattr(self.counter, "total_kmer_windows", 0)}
        if self.mode == "anchored" and self.counter is not None:
            # n_reads counts rows through the anchored pass; long reads
            # appear as segments, tallied separately
            s["n_reads"] = self.counter.n_reads
            s["n_spilled"] = self.counter.n_spilled
            s["n_spilled2"] = self.counter.n_spilled2
            s["read_len"] = self.read_len
            s.update(self.row_streamer.stats)      # n_long_reads, n_segments
        for key, val in getattr(self.counter, "phase_s", {}).items():
            s["phase_" + key + "_s"] = round(val, 4)
        return s


def run_count(qm_path: str, sample_path: str, out_prefix: str,
              batch_bases: int = 1 << 24, fmt: str | None = None,
              chunk_bytes: int = 1 << 24, verbose: bool = True,
              mode: str = "flat", ref_fasta: str | None = None,
              read_len: int | None = None, device: str = "cuda") -> dict:
    """Full count phase: .qm + reads → <out_prefix>.bin (+ .txt if the
    dictionary's .qgc companion exists). Returns summary stats.

    mode="flat"     — separator-delimited code stream, one mono-table
                      probe per k-mer.
    mode="anchored" — the fast path (ops.anchored): fixed-width read rows
                      anchored against the genome; needs ref_fasta (the
                      genome the dictionary was built from; default: the
                      .qm path without its suffix). The first anchored
                      count builds <ref_fasta>.qai, later ones load it.
                      Output identical to flat mode.
    read_len        — anchored row width (default: autodetected).
    device: "cuda" (default; raises without a card) or "cpu".
    """
    dev = resolve_device(device)
    t0 = time.time()
    dictionary = Dictionary.from_qm(qm_path)
    index = None
    index_s = 0.0
    if mode == "anchored":
        from quickmer2_tpu_torch.ops.anchored import AnchoredIndex
        if ref_fasta is None:
            ref_fasta = _companion(qm_path, "")
        ti = time.time()
        index = AnchoredIndex.from_dictionary_and_fasta(
            dictionary, ref_fasta, cache_path=ref_fasta + ".qai", device=dev)
        index_s = time.time() - ti
    sc = StreamCounter(dictionary, mode=mode, index=index,
                       batch_bases=batch_bases, read_len=read_len,
                       device=dev)
    setup_s = time.time() - t0
    stream = sys.stdin.buffer if sample_path == "-" else open(sample_path, "rb")
    bytes_consumed = 0
    try:
        data = stream.read(chunk_bytes)
        # FASTQ autodetected by a leading '@' (QuicKmer.c:393); works
        # for pipes too since we already hold the first chunk
        fmt = fmt or ("fastq" if data[:1] == b"@" else "fasta-lines")
        packer = make_packer(fmt)
        t_stream = time.time()
        while data:
            sc.feed_codes(packer.feed(data))
            bytes_consumed += len(data)
            data = stream.read(chunk_bytes)
    finally:
        if sample_path != "-":
            stream.close()
    stream_s = time.time() - t_stream
    tf = time.time()
    depth = sc.finish()
    finish_s = time.time() - tf
    depth_u16 = (depth & 0xFFFF).astype(np.uint16)   # Q8 wrap parity
    formats.write_u16(out_prefix + ".bin", depth_u16)

    stats = {"n_kmers": dictionary.n_kmers,
             "elapsed_s": time.time() - t0,
             "device": str(dev),
             "phases": {"setup_s": round(setup_s, 4),
                        "index_s": round(index_s, 4),
                        "stream_s": round(stream_s, 4),
                        "finish_s": round(finish_s, 4)},
             "bytes_consumed": bytes_consumed,
             **sc.stats}
    qgc_path = _companion(qm_path, ".qgc")
    if not os.path.exists(qgc_path):
        qgc_path = qm_path + ".qgc"
    if os.path.exists(qgc_path):
        qgc = formats.read_u16(qgc_path)[: dictionary.n_kmers]
        mean, count, var, mean_depth = gc_curve_from_depth(depth_u16, qgc)
        formats.write_gc_curve(out_prefix + ".txt", mean, count, var)
        stats["mean_depth"] = mean_depth
        if verbose:
            print("Mean sequencing depth: %.2f" % mean_depth)
    return stats


def _autodetect_read_len(codes: np.ndarray, cap: int = 1024) -> int:
    """Row width for the anchored path: the longest read in the first
    packed chunk, rounded up to a multiple of 32 and capped (longer reads
    are cut into segments)."""
    seps = np.flatnonzero(codes == SEP)
    if len(seps) == 0:
        longest = len(codes)
    else:
        bounds = np.concatenate([[-1], seps, [len(codes)]])
        longest = int(np.max(bounds[1:] - bounds[:-1]) - 1)
    longest = max(longest, 32)
    return min(-(-longest // 32) * 32, cap)


def _companion(qm_path: str, ext: str) -> str:
    """The reference derives companions from the FASTA path (ref.fa.qgc);
    our .qm paths are ref.fa.qm (sparse writes ref.fa.rqm,
    QuicKmer.c:1467-1477, with companions regenerated at ref.fa.*), so
    strip the dictionary suffix first."""
    if qm_path.endswith(".rqm"):
        base = qm_path[:-4]
    elif qm_path.endswith(".qm"):
        base = qm_path[:-3]
    else:
        base = qm_path
    return base + ext
