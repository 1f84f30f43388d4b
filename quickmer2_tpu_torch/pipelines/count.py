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

The flat count's other engines (DepthCounter layouts, `count --engine`)
replace the mono table: the two-choice packed table (K8), the
reference's linear probe over the .qm table (K7), or no table at all
(sortjoin: the codec K9, then a join against the sorted keys,
ops.sortjoin). They give the same depth.

Anchored mode (ops.anchored): the code stream becomes fixed-width read
rows (RowStreamer; long reads in k-1-overlap segments), each batch runs
the anchored read pass (kernel K3), and spilled reads are recounted
through tier 2 (K3 again) and the mono table (K2r); the row width is
autodetected from the first chunk unless given.

run_count writes a resume checkpoint (utils.checkpoint, the JAX
package's format) every checkpoint_every_bytes of input when asked, in
either mode. With device="cpu" the same stream runs through the
kernels' plain PyTorch versions.
"""

from __future__ import annotations

import contextlib
import os
import struct
import sys
import time

import numpy as np
import torch

from quickmer2_tpu_torch.device import (
    fetched, resolve_device, start_fetch, to_numpy_u32, word_dtype, words)
from quickmer2_tpu_torch.dictionary import Dictionary
from quickmer2_tpu_torch.io import formats
from quickmer2_tpu_torch.kernels.count_flat import (
    count_linear_step, count_packed_step, kmerize_step, linear_rank_slots,
    linear_table, packed_rank_slots, rank_depth_to_slot, slot_depth_to_rank)
from quickmer2_tpu_torch.kernels.count_mono import count_mono_step
from quickmer2_tpu_torch.ops import codec, rowpack
from quickmer2_tpu_torch.ops.codec import SEP
from quickmer2_tpu_torch.ops.monotable import MonoTable
from quickmer2_tpu_torch.ops.packed_table import PackedTable
from quickmer2_tpu_torch.ops.sortjoin import SortJoinEngine
from quickmer2_tpu_torch.utils import checkpoint, native
from quickmer2_tpu_torch.utils.profiling import Phases, annotate


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


# layout="auto" takes sortjoin for a dictionary of at most this many
# k-mers, else mono. Set from the H100 (chip_smoke.py times one 2^24-base
# batch through both at n = 2^14 .. 2^20 keys; PERF.md): sort-join took
# 14.3-14.6 ms a batch at every n against K2's 0.20-0.24 ms, so it never
# wins and auto is mono.
AUTO_SORTJOIN_MAX_N = 0

LAYOUTS = ("mono", "packed", "sortjoin", "linear", "auto")


class DepthCounter:
    """Accumulates k-mer depth over streamed code batches on the device.

    Each batch crosses as 2-bit codes (ops.rowpack) and runs one of the
    JAX package's table layouts, all with the same depth at finish:
      mono     — the single-row mono table (K2, kernels.count_mono):
                 depth in SLOT space (bucket*8 + entry) until finish,
                 unresolved lanes (possible side-table members) recount
                 on the host one batch behind;
      packed   — the two-choice packed table (K8), depth in SLOT space
                 (bucket*2 + entry) on the device;
      linear   — the reference's linear probe over the .qm table (K7),
                 depth in SLOT space (the .qm slot) on the device;
      sortjoin — no table: the codec (K9) and a join against the sorted
                 keys (ops.sortjoin), depth in key-sorted order;
      auto     — sortjoin for dictionaries of at most AUTO_SORTJOIN_MAX_N
                 k-mers, else mono.
    Rank-order depth is u32[n_kmers + 1], its last lane the trash lane of
    invalid windows and misses. The packed and linear layouts keep a
    trash counter as their slot depth's last lane and translate to rank
    order on the device at snapshot and finish (and back at restore), so
    their snapshots are the JAX counter's.
    """

    def __init__(self, dictionary: Dictionary, batch_bases: int = 1 << 24,
                 layout: str = "mono", packed_table=None,
                 device: str = "cuda"):
        if layout not in LAYOUTS:
            raise ValueError(f"unknown table layout {layout!r}; one of "
                             f"{LAYOUTS}")
        self.device = resolve_device(device)
        self.dict = dictionary
        self.k = dictionary.kmer_size
        self.batch_bases = batch_bases
        if layout == "auto":
            layout = ("sortjoin" if dictionary.n_kmers <= AUTO_SORTJOIN_MAX_N
                      else "mono")
        self.layout = layout     # recorded in snapshots; restore checks it
        wd = word_dtype(self.device)
        # packed_table: a prebuilt MonoTable (mono) or PackedTable (packed)
        # amortizes the build across counters (cohorts)
        if layout == "mono":
            self._mono = (packed_table if isinstance(packed_table, MonoTable)
                          else MonoTable.from_dictionary(dictionary))
            self.rows = words(self._mono.rows, self.device)
            self.depth = torch.zeros(self._mono.n_slots + 1, dtype=wd,
                                     device=self.device)
            self._side_counts = np.zeros(dictionary.n_kmers, np.uint64)
            self._pending_masks: list[tuple[np.ndarray, tuple]] = []
        elif layout == "packed":
            self._packed = (packed_table
                            if isinstance(packed_table, PackedTable)
                            else PackedTable.from_dictionary(dictionary))
            self.rows = self._packed.device_rows(self.device)
            self.rank_slots = packed_rank_slots(self.rows,
                                                dictionary.n_kmers)
            n_lanes = 2 * self._packed.n_buckets + 1
        elif layout == "linear":
            self.table = linear_table(dictionary, self.device)
            self.rank_slots = linear_rank_slots(dictionary, self.device)
            n_lanes = dictionary.hash_size + 1
        else:
            self._engine = SortJoinEngine(dictionary.kmers_in_order,
                                          self.device)
        if layout in ("packed", "linear"):
            self.depth = torch.zeros(n_lanes, dtype=wd, device=self.device)
        self._carry = np.zeros(0, np.uint8)
        self._pending: list[np.ndarray] = []
        self._pending_len = 0
        self.total_kmer_windows = 0
        # the host side's phases per batch (PERF.md §3 has their tree)
        self.phases = Phases("counter.")

    def feed_codes(self, chunk: np.ndarray) -> None:
        self._pending.append(chunk)
        self._pending_len += len(chunk)
        while self._pending_len + len(self._carry) >= self.batch_bases:
            with self.phases("concat"):
                buf = np.concatenate([self._carry] + self._pending)
            self._pending = [buf[self.batch_bases :]]
            self._pending_len = len(self._pending[0])
            self._run(buf[: self.batch_bases])

    def _run(self, batch: np.ndarray) -> None:
        assert len(batch) == self.batch_bases
        self.phases.add("batches", 1)
        with self.phases("pack_put"):
            with self.phases("pack"):
                pk, bits = rowpack.pack_rows(batch[None, :])
            with self.phases("put"):
                pk_d = torch.from_numpy(pk[0]).to(self.device)
                bits_d = torch.from_numpy(bits[0]).to(self.device)
        kw = dict(k=self.k, n_bases=self.batch_bases)
        with self.phases("dispatch"):
            if self.layout == "mono":
                ub = count_mono_step(pk_d, bits_d, self.rows, self.depth,
                                     n_buckets=self._mono.n_buckets, **kw)
                self._pending_masks.append((batch, start_fetch(ub)))
            elif self.layout == "packed":
                count_packed_step(pk_d, bits_d, self.rows, self.depth,
                                  n_buckets=self._packed.n_buckets, **kw)
            elif self.layout == "linear":
                count_linear_step(pk_d, bits_d, self.table, self.depth,
                                  hash_size=self.dict.hash_size, **kw)
            else:
                self._engine.count_codes(*kmerize_step(pk_d, bits_d, **kw))
        # drain masks one batch behind so the D2H never stalls the next
        # launch; ~0.1% of lanes at load 0.5 end up unresolved
        if self.layout == "mono" and len(self._pending_masks) > 1:
            self._drain_mask(*self._pending_masks.pop(0))
        self.total_kmer_windows += len(batch) - self.k + 1
        self._carry = batch[-(self.k - 1):].copy()

    def finish(self) -> np.ndarray:
        """Flush the tail (padded to full batch shape with separators) and
        return host depth u32[n_kmers] in rank order."""
        if self._pending_len:
            with self.phases("finish_tail"):
                with self.phases("concat"):
                    buf = np.concatenate([self._carry] + self._pending)
                    pad = np.full(self.batch_bases - len(buf) % self.batch_bases, SEP, np.uint8)
                    buf = np.concatenate([buf, pad])
                for off in range(0, len(buf), self.batch_bases):
                    self._run(buf[off : off + self.batch_bases])
                self._pending, self._pending_len = [], 0
        return self._final_depth()

    def _final_depth(self) -> np.ndarray:
        """The whole stream's depth, host u32[n_kmers] in rank order."""
        if self.layout == "sortjoin":
            return self._engine.finish()
        if self.layout != "mono":
            with self.phases("depth_fetch"):
                return to_numpy_u32(self._rank_depth())[:-1]
        for pend in self._pending_masks:
            self._drain_mask(*pend)
        self._pending_masks = []
        with self.phases("depth_fetch"):
            slots = to_numpy_u32(self.depth)[:-1]
        with self.phases("depth_rank"):
            out = np.zeros(self.dict.n_kmers, np.uint64)
            live = self._mono.slot_rank < self.dict.n_kmers
            out[self._mono.slot_rank[live]] = slots[live]
            out += self._side_counts
            return out.astype(np.uint32)      # u32 wrap (Q8 parity)

    def _rank_depth(self) -> torch.Tensor:
        """The packed or linear layout's depth in rank order, u32[n_kmers
        + 1] with the trash lane last (one translation on the device)."""
        return slot_depth_to_rank(self.depth, self.rank_slots,
                                  self.dict.n_kmers)

    def _drain_mask(self, batch: np.ndarray, handle: tuple) -> None:
        """Recount this batch's unresolved lanes against the side
        table. Host cost is O(lanes), not O(batch): only the k-mer
        windows AT the unresolved positions are re-encoded (gathered
        into a SEP-separated strip and run through the exact host
        codec). The mask is LSB-first u32 words (lane i = bit i&31 of
        word i>>5)."""
        with self.phases("drain"):
            with self.phases("mask_wait"):
                host = fetched(handle)
            with self.phases("mask_scan"):
                mask = np.unpackbits(to_numpy_u32(host).view(np.uint8),
                                     bitorder="little")
                lanes = np.flatnonzero(mask)
                lanes = lanes[lanes < len(batch) - self.k + 1]
            m = len(lanes)
            self.phases.add("recount_lanes", m)
            if m == 0:
                return
            with self.phases("recount"):
                strip = np.full((m, self.k + 1), SEP, np.uint8)
                strip[:, :self.k] = batch[lanes[:, None] + np.arange(self.k)]
                canon, _ = codec.sliding_kmers_np(strip.reshape(-1), self.k)
                km = canon[:: self.k + 1][:m]
                hi = (km >> np.uint64(32)).astype(np.uint32)
                lo = km.astype(np.uint32)
                found, rank = self._mono.side_lookup_np(hi, lo)
                hits = np.count_nonzero(found)
                self.phases.add("side_hits", hits)
                if hits:
                    np.add.at(self._side_counts, rank[found], 1)

    # -- state carried across (same dict keys as the JAX DepthCounter) --

    def snapshot(self) -> dict:
        """Depth (in the layout's order) + residual host codes (+ side
        counts for mono); with the stream offset and parser state this
        fully determines the remaining computation. The layout is
        recorded, since the depth orders differ between layouts."""
        residual = np.concatenate([self._carry] + self._pending) \
            if (self._pending_len or len(self._carry)) else np.zeros(0, np.uint8)
        return {**self._depth_state(), "residual": residual,
                "windows": self.total_kmer_windows}

    def _depth_state(self) -> dict:
        """The snapshot's depth in the layout's order, the layout, and
        the mono layout's side counts."""
        if self.layout == "sortjoin":
            depth = self._engine.snapshot_depth()
        elif self.layout == "mono":
            depth = to_numpy_u32(self.depth)
        else:
            depth = to_numpy_u32(self._rank_depth())
        snap = {"depth": depth, "layout": self.layout}
        if self.layout == "mono":
            for pend in self._pending_masks:
                self._drain_mask(*pend)
            self._pending_masks = []
            snap["side_counts"] = self._side_counts.copy()
        return snap

    def restore(self, snap: dict) -> None:
        """Resume from a snapshot() dict — this counter's or the JAX
        package's DepthCounter's of the same layout (numpy arrays, same
        keys)."""
        self._put_depth_state(snap)
        residual = snap["residual"]
        # the first k-1 of the residual are the carry; re-split exactly
        self._carry = np.zeros(0, np.uint8)
        self._pending = [residual] if len(residual) else []
        self._pending_len = len(residual)
        self.total_kmer_windows = int(snap["windows"])

    def _put_depth_state(self, snap: dict) -> None:
        """restore's depth: checked against the layout, put in place."""
        snap_layout = str(snap.get("layout", ""))
        if snap_layout and snap_layout != self.layout:
            raise ValueError(
                f"checkpoint was taken with table layout {snap_layout!r}, "
                f"this counter uses {self.layout!r}; resume with the same "
                f"layout (depth orders differ between layouts)")
        want = (self._mono.n_slots + 1 if self.layout == "mono"
                else self.dict.n_kmers + 1)
        if len(snap["depth"]) != want:
            raise ValueError(
                f"checkpoint depth length {len(snap['depth'])} != {want}; "
                f"the checkpoint was taken with a different table layout "
                f"than this counter's ({self.layout!r})")
        if self.layout == "sortjoin":
            self._engine.restore_depth(snap["depth"])
        elif self.layout == "mono":
            self.depth = words(np.asarray(snap["depth"]), self.device)
        else:
            self.depth = rank_depth_to_slot(
                words(np.asarray(snap["depth"]), self.device),
                self.rank_slots, len(self.depth))
        if self.layout == "mono":
            self._side_counts = np.asarray(snap["side_counts"],
                                           np.uint64).copy()
            self._pending_masks = []


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
    """Drives one sample's depth accumulation, in flat or anchored mode,
    on one device or sharded: the object run_count and run_cohort feed, so
    all share one set of semantics.

    Flat mode runs a DepthCounter of table layout `engine`, or with
    data_devices / dict_devices above 1 a ShardedDepthCounter (packed
    bucket blocks; `engine` is then unused, as in the JAX package) over a
    data x dict mesh of `device`'s type. Anchored mode
    builds its AnchoredDepthCounter at the first chunk, so the row width
    can be autodetected from real reads; reads wider than the row width
    are cut into k-1-overlap segments, so every read rides the anchored
    path and nothing feeds a flat overflow counter. A JAX checkpoint
    whose overflow counter is live (ovf_* arrays) restores it as a mono
    DepthCounter, which adds its depth at finish and is snapshot again,
    as the JAX StreamCounter does."""

    def __init__(self, dictionary: Dictionary, *, mode: str = "flat",
                 index=None, batch_bases: int = 1 << 24,
                 read_len: int | None = None, packed_table=None,
                 engine: str = "mono", data_devices: int | None = None,
                 dict_devices: int | None = None, devices=None,
                 device: str = "cuda"):
        """devices: an explicit device list for the mesh (default: the
        cards of the box, or copies of the CPU)."""
        self.dict = dictionary
        self.mode = mode
        self.batch_bases = batch_bases
        self.read_len = read_len
        self.engine = engine          # flat-path DepthCounter layout
        self.device = resolve_device(device)
        self.data_devices = data_devices
        self.dict_devices = dict_devices
        self._devices = devices
        self._packed_table = packed_table
        self.counter = None
        self.row_streamer = None
        self.overflow_counter = None
        if mode == "anchored":
            if index is None:
                raise ValueError("anchored mode needs an AnchoredIndex")
            self.index = index
            if read_len is not None:
                self._make_anchored(read_len)
        elif mode == "flat" and self._sharded():
            from quickmer2_tpu_torch.parallel.count_parallel import (
                ShardedDepthCounter)
            self.counter = ShardedDepthCounter(dictionary, self._mesh(),
                                               batch_bases=batch_bases)
        elif mode == "flat":
            self.counter = DepthCounter(dictionary, batch_bases=batch_bases,
                                        layout=engine,
                                        packed_table=packed_table,
                                        device=self.device)
        else:
            raise ValueError(f"unknown count mode {mode!r}")

    def _sharded(self) -> bool:
        return (self.data_devices or 1) > 1 or (self.dict_devices or 1) > 1

    def _mesh(self):
        from quickmer2_tpu_torch.parallel.mesh import make_mesh
        return make_mesh(self.data_devices or 1, self.dict_devices or 1,
                         devices=self._devices, device=self.device)

    def _make_anchored(self, read_len: int) -> None:
        from quickmer2_tpu_torch.ops.anchored import (
            AnchoredDepthCounter, RowStreamer)
        self.read_len = read_len
        self.row_streamer = RowStreamer(read_len,
                                        segment_k=self.dict.kmer_size)
        if self._sharded():
            from quickmer2_tpu_torch.parallel.anchored_parallel import (
                ShardedAnchoredCounter)
            self.counter = ShardedAnchoredCounter(
                self.index, self.dict.kmer_size, read_len, self._mesh())
        else:
            self.counter = AnchoredDepthCounter(
                self.index, self.dict.kmer_size, read_len,
                device=self.device)

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
        depth = self.counter.finish()
        if self.overflow_counter is not None:
            depth = depth + self.overflow_counter.finish()
        return depth

    @property
    def stats(self) -> dict:
        s = {"mode": self.mode,
             "total_windows": getattr(self.counter, "total_kmer_windows", 0)}
        if self.mode == "flat":
            s["layout"] = self.counter.layout
        if self.mode == "anchored" and self.counter is not None:
            # n_reads counts rows through the anchored pass; long reads
            # appear as segments, tallied separately
            s["n_reads"] = self.counter.n_reads
            s["n_spilled"] = self.counter.n_spilled
            s["n_spilled2"] = self.counter.n_spilled2
            s["read_len"] = self.read_len
            s.update(self.row_streamer.stats)      # n_long_reads, n_segments
        phases = getattr(self.counter, "phases", None)
        if phases is not None:
            s.update(phases.stats())
        return s

    # -- checkpoint/resume (the JAX StreamCounter's arrays and meta) -----

    def snapshot(self) -> tuple[dict, dict]:
        """(arrays, meta) capturing the counter, the row streamer and a
        restored overflow counter. Restore on an identically configured
        StreamCounter (same mode and engine), of this package or the JAX
        one, resumes bit for bit."""
        arrays: dict = {}
        meta: dict = {"mode": self.mode}
        if self.mode == "anchored":
            meta["read_len"] = self.read_len
            if self.counter is not None:
                a, m = self.counter.snapshot()
                arrays.update({"anch_" + k: v for k, v in a.items()})
                meta["anch"] = m
                rs = self.row_streamer.snapshot()
                arrays["rs_tail"] = rs["tail"]
                arrays["rs_overflow"] = rs["overflow"]
        else:
            snap = self.counter.snapshot()
            arrays["depth"] = snap["depth"]
            arrays["residual"] = snap["residual"]
            meta["windows"] = snap["windows"]
            meta["layout"] = snap.get("layout", "")
            if "side_counts" in snap:           # mono layout
                arrays["side_counts"] = snap["side_counts"]
        if self.overflow_counter is not None:
            osnap = self.overflow_counter.snapshot()
            arrays["ovf_depth"] = osnap["depth"]
            arrays["ovf_residual"] = osnap["residual"]
            meta["ovf_windows"] = osnap["windows"]
            arrays["ovf_side_counts"] = osnap["side_counts"]
        return arrays, meta

    def restore(self, arrays: dict, meta: dict) -> None:
        if meta["mode"] != self.mode:
            raise ValueError(f"checkpoint mode {meta['mode']!r} != {self.mode!r}")
        if self.mode == "anchored":
            if "anch" in meta:
                if self.counter is None:
                    self._make_anchored(int(meta["read_len"]))
                self.counter.restore(
                    {k[5:]: v for k, v in arrays.items()
                     if k.startswith("anch_")}, meta["anch"])
                self.row_streamer.restore({"tail": arrays["rs_tail"],
                                           "overflow": arrays["rs_overflow"]})
        else:
            snap = {"depth": arrays["depth"],
                    "residual": arrays["residual"],
                    "windows": meta["windows"],
                    "layout": meta.get("layout", "")}
            if "side_counts" in arrays:
                snap["side_counts"] = arrays["side_counts"]
            self.counter.restore(snap)
        if "ovf_depth" in arrays:
            self.overflow_counter = DepthCounter(
                self.dict, batch_bases=self.batch_bases,
                packed_table=self._packed_table, device=self.device)
            self.overflow_counter.restore(
                {"depth": arrays["ovf_depth"],
                 "residual": arrays["ovf_residual"],
                 "windows": meta["ovf_windows"],
                 "side_counts": arrays["ovf_side_counts"]})


def run_count(qm_path: str, sample_path: str, out_prefix: str,
              batch_bases: int = 1 << 24, fmt: str | None = None,
              chunk_bytes: int = 1 << 24, verbose: bool = True,
              mode: str = "flat", ref_fasta: str | None = None,
              read_len: int | None = None,
              checkpoint_path: str | None = None,
              checkpoint_every_bytes: int = 1 << 30,
              hbm_limit_bytes: int | None = None,
              engine: str = "mono", data_devices: int | None = None,
              dict_devices: int | None = None,
              device: str = "cuda") -> dict:
    """Full count phase: .qm + reads → <out_prefix>.bin (+ .txt if the
    dictionary's .qgc companion exists). Returns summary stats.

    mode="flat"     — separator-delimited code stream, one table probe
                      per k-mer through the DepthCounter layout `engine`
                      (mono, packed, sortjoin, linear or auto).
    mode="anchored" — the fast path (ops.anchored): fixed-width read rows
                      anchored against the genome; needs ref_fasta (the
                      genome the dictionary was built from; default: the
                      .qm path without its suffix). The first anchored
                      count builds <ref_fasta>.qai, later ones load it.
                      Output identical to flat mode.
    read_len        — anchored row width (default: autodetected).
    checkpoint_path — write a resume checkpoint (utils.checkpoint) every
                      checkpoint_every_bytes of consumed input; a rerun
                      with the same arguments resumes from it, also from
                      stdin ("-"), whose replayed prefix is read and
                      dropped; the file is removed on success.
    hbm_limit_bytes — when the anchored structures would not fit this
                      many bytes of one device's memory (the rows split
                      over dict_devices), count in flat mode.
    data_devices    — shard the read stream over this many devices.
    dict_devices    — shard the dictionary's packed rows into this many
                      bucket blocks, one a device (tables larger than one
                      card). Both: a data x dict mesh of `device`'s type
                      (every card from cuda:0 up, or copies of the CPU);
                      output identical to one device.
    device: "cuda" (default; raises without a card) or "cpu".
    """
    dev = resolve_device(device)
    t0 = time.time()
    dictionary = Dictionary.from_qm(qm_path)
    index = None
    index_s = 0.0
    fallback = None
    if mode == "anchored":
        from quickmer2_tpu_torch.ops.anchored import AnchoredIndex
        if ref_fasta is None:
            ref_fasta = _companion(qm_path, "")
        if hbm_limit_bytes is not None:
            # budget check before building: the genome length from the
            # .qai header when present, else bounded by the FASTA size
            qai = ref_fasta + ".qai"
            if os.path.exists(qai):
                with open(qai, "rb") as f:
                    g_est = struct.unpack("<Q", f.read(16)[8:16])[0]
            else:
                g_est = os.path.getsize(ref_fasta)
            # per device: the rows term splits over the dict axis (the
            # index then keeps its rows on the host, each card one
            # block), so a dict-sharded anchored count can fit where an
            # unsharded one cannot
            est = AnchoredIndex.estimate_hbm_bytes(
                dictionary.n_kmers, g_est, dict_devices=dict_devices or 1)
            if est["total"] > hbm_limit_bytes:
                fallback = {"reason": "anchored-structures-exceed-hbm",
                            "estimate_bytes": est,
                            "hbm_limit_bytes": hbm_limit_bytes}
                mode = "flat"
                if verbose:
                    print(f"count: anchored structures need "
                          f"~{est['total'] / 1e9:.1f} GB per device "
                          f"(ds={est['dict_devices']}, > limit "
                          f"{hbm_limit_bytes / 1e9:.1f} GB) — falling back "
                          f"to the flat "
                          f"{'sharded ' if data_devices else ''}path")
        if mode == "anchored":
            ti = time.time()
            index = AnchoredIndex.from_dictionary_and_fasta(
                dictionary, ref_fasta, cache_path=ref_fasta + ".qai",
                place_rows=(dict_devices or 1) == 1, device=dev)
            index_s = time.time() - ti
    sc = StreamCounter(dictionary, mode=mode, index=index,
                       batch_bases=batch_bases, read_len=read_len,
                       engine=engine, data_devices=data_devices,
                       dict_devices=dict_devices, device=dev)
    setup_s = time.time() - t0
    stream = sys.stdin.buffer if sample_path == "-" else open(sample_path, "rb")
    bytes_consumed = 0
    next_ckpt = checkpoint_every_bytes
    resumed = checkpoint.load(checkpoint_path) if checkpoint_path else None
    regions = contextlib.ExitStack()      # count.stream, on every path
    try:
        if resumed is not None:
            bytes_consumed, arrays, meta = resumed
            if sample_path == "-":
                _discard_exactly(stream, bytes_consumed, chunk_bytes)
            else:
                stream.seek(bytes_consumed)
            fmt = meta["fmt"]
            packer = make_packer(fmt)
            packer.set_state(meta["packer"])
            sc.restore(arrays, meta["state"])
            next_ckpt = bytes_consumed + checkpoint_every_bytes
            if verbose:
                print(f"count: resumed at byte {bytes_consumed}")
            data = stream.read(chunk_bytes)
        else:
            data = stream.read(chunk_bytes)
            # FASTQ autodetected by a leading '@' (QuicKmer.c:393); works
            # for pipes too since we already hold the first chunk
            fmt = fmt or ("fastq" if data[:1] == b"@" else "fasta-lines")
            packer = make_packer(fmt)
        t_stream = time.time()
        regions.enter_context(annotate("count.stream"))
        while data:
            sc.feed_codes(packer.feed(data))
            bytes_consumed += len(data)
            if checkpoint_path and bytes_consumed >= next_ckpt:
                arrays, state_meta = sc.snapshot()
                checkpoint.save(checkpoint_path, bytes_consumed, arrays,
                                meta={"fmt": fmt, "packer": packer.get_state(),
                                      "state": state_meta})
                next_ckpt += checkpoint_every_bytes
            data = stream.read(chunk_bytes)
    finally:
        if sample_path != "-":
            stream.close()
        regions.close()
    stream_s = time.time() - t_stream
    tf = time.time()
    with annotate("count.finish"):
        depth = sc.finish()
    finish_s = time.time() - tf
    if checkpoint_path and os.path.exists(checkpoint_path):
        os.remove(checkpoint_path)
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
    if fallback is not None:
        stats["fallback"] = fallback
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


def _discard_exactly(stream, n: int, chunk_bytes: int) -> None:
    """Fast-forward a non-seekable stream past its consumed prefix
    (checkpoint resume from stdin: the upstream pipe replays from the
    start and the count drops what was already counted)."""
    left = n
    while left > 0:
        got = stream.read(min(chunk_bytes, left))
        if not got:
            raise EOFError(
                f"stream ended {left} bytes before the checkpoint offset "
                f"{n}; the replayed input is shorter than the original")
        left -= len(got)


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
