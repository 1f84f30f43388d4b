"""Edit-distance filter as a blocked Hamming join — the search phase's
flagship kernel (port of quickmer2_tpu/ops/hamming_join.py).

Reference semantics (Recurse_edit, QuicKmer.c:687-736): for each unique
k-mer u, sum the occurrence counts of every substitution neighbor at
Hamming distance 1..e (e ≤ 2), probing neighbors in canonical form. This
module inverts the enumeration into a weighted JOIN of dense compares:

  sum(u) = Σ_{w ∈ W, 1 ≤ H(w,u) ≤ e} occ(w)

where W = all distinct genome k-mers ∪ their reverse complements
(palindrome duplicates dropped) — every neighbor WORD of u that can
probe successfully is such a w, exactly once.

Pigeonhole: split the k bases into 3 contiguous parts; any pair with
H ≤ 2 agrees exactly on ≥ 1 part. For each part, group W and the
queries by the part's value into padded bucket layouts (i',
kernels.hamming_join.bucket_layouts: a stable counting sort and an
expand on the card; its plain version ranks each entry by a stable torch
sort and scatters with `_bucket_layouts`) and compare every query
against its
bucket's members (the CUDA kernel csrc/hamming_join.cu through
kernels.hamming_join.join_compare). A pair with m exact parts is found
by exactly the m part-joins whose bucket is intact, so each join
contributes occ·(6/m) and the total is divided by 6.

Exactness under bucket overflow: buckets larger than `cpad` are
truncated, so any query whose OWN part value lands in an overflowed
bucket (for any part) is routed to the slow path: per-neighbor probes of
the caller's packed table behind its key filter (kernel K6,
kernels.neighbor_sum) or, without one, the host `_slow_sums_sorted_np`
(enumeration + searchsorted); for
the remaining fast queries every exact-part join of every relevant pair
is intact, because the pair's bucket in an exact part IS the query's
bucket.

`hamming_neighbor_bits` is the same join at Hamming distance exactly 1
over genome windows, emitting the anchored index's neighbor bitmap
(kernel K5, kernels.hamming_join.join_bits). Its inputs are bucket
runs (each side sorted by one part's key, CSR) built on the device by a
counting sort (kernels.hamming_join.bucket_runs), the word side once
per (pad, part, word chunk) and the query side once per tile and
part.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from quickmer2_tpu_torch.device import (
    U32, resolve_device, store, to_numpy_u32, u32, word_dtype, words)
from quickmer2_tpu_torch.kernels.hamming_join import (
    bucket_layouts, bucket_runs, join_bits, join_compare, part_keys)
from quickmer2_tpu_torch.kernels.neighbor_sum import neighbor_sum
from quickmer2_tpu_torch.ops import codec
from quickmer2_tpu_torch.ops.editdist import edit_table
from quickmer2_tpu_torch.utils import native

CHUNK_W = 12_000_000    # words per word chunk
CHUNK_Q = 4_000_000     # queries per query chunk
CHUNK_Q_BITS = 2_000_000    # genome windows per tile of the bits join
ESCALATE_PAD = 240      # word and query pads of the escalation re-join
# lanes of one escalation layout array (4 GiB of u32): at k = 32 the
# widest part has 16 M buckets, whose 240-wide layouts (seven arrays of
# 16 GiB) do not fit an 80 GB card, so the bits join escalates only where
# B * 240 stays within this (k <= 31)
ESCALATE_MAX_LANES = 1 << 30


def part_ranges(k: int) -> list[tuple[int, int]]:
    """Three contiguous base ranges covering [0, k) (bit offsets are
    2x). First part takes the remainder."""
    p = k // 3
    first = k - 2 * p
    return [(0, first), (first, first + p), (first + p, k)]


def _extract_part_np(hi: np.ndarray, lo: np.ndarray, lo_base: int,
                     hi_base: int) -> np.ndarray:
    """Bits [2*lo_base, 2*hi_base) of the 2k-bit (hi,lo) code as u32
    (part width ≤ 16 bases = 32 bits; base 16 is the lo/hi word seam)."""
    a, b = 2 * lo_base, 2 * hi_base
    width = b - a
    assert width <= 32
    full = (np.asarray(lo, np.uint64)
            | (np.asarray(hi, np.uint64) << np.uint64(32)))
    v = (full >> np.uint64(a)) & np.uint64((1 << width) - 1)
    return v.astype(np.uint32)


def _part_masks(k: int):
    """(hi_mask, lo_mask) u32 pairs for each of the 3 parts."""
    masks = []
    for (s, e) in part_ranges(k):
        a, b = 2 * s, 2 * e
        m = ((1 << b) - 1) ^ ((1 << a) - 1)
        masks.append((np.uint32((m >> 32) & 0xFFFFFFFF),
                      np.uint32(m & 0xFFFFFFFF)))
    return masks


def _bucket_layouts(whi, wlo, wocc, wslot, qhi, qlo, qslot, *, lo_bit: int,
                    width: int, n_buckets: int, cpad: int, cpad_q: int):
    """Scatter one word chunk and the query chunk into padded bucket
    layouts (the first half of quickmer2_tpu _part_chunk_join,
    hamming_join.py:126-149): word lane key*cpad + slot, query lane
    key*cpad_q + slot; entries whose slot reaches the pad stay out. The
    scatter of i''s plain version (kernels.hamming_join.
    bucket_layouts_plain).
    Returns (dh, dl, docc, qh, ql, qidx) — word tensors of B*cpad + 1 /
    B*cpad_q + 1 lanes (the last lane is the hole) and int32 qidx, nq on
    holes."""
    dtype = whi.dtype
    nq = qhi.shape[0]
    hole_d = n_buckets * cpad
    hole_q = n_buckets * cpad_q
    dev = whi.device
    wsel = wslot.to(torch.int64) < cpad
    keyw = part_keys(whi[wsel], wlo[wsel], lo_bit, width)
    wf = keyw * cpad + wslot[wsel].to(torch.int64)
    dh = torch.zeros(hole_d + 1, dtype=dtype, device=dev)
    dl = torch.zeros_like(dh)
    docc = torch.zeros_like(dh)
    dh[wf] = whi[wsel]
    dl[wf] = wlo[wsel]
    docc[wf] = wocc[wsel].to(dtype)
    qsel = qslot.to(torch.int64) < cpad_q
    keyq = part_keys(qhi[qsel], qlo[qsel], lo_bit, width)
    qf = keyq * cpad_q + qslot[qsel].to(torch.int64)
    qh = torch.zeros(hole_q + 1, dtype=dtype, device=dev)
    ql = torch.zeros_like(qh)
    qidx = torch.full((hole_q + 1,), nq, dtype=torch.int32, device=dev)
    qh[qf] = qhi[qsel]
    ql[qf] = qlo[qsel]
    qidx[qf] = torch.nonzero(qsel).flatten().to(torch.int32)
    return dh, dl, docc, qh, ql, qidx


def _slots_u8(keys: np.ndarray) -> np.ndarray:
    """Per-entry in-bucket slot (rank among equal keys), in ORIGINAL
    entry order, saturated to u8: the bits join's slots (_BitsWords); the
    sums join takes none (i' ranks on the card)."""
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    first = np.ones(len(ks), bool)
    first[1:] = ks[1:] != ks[:-1]
    start = np.maximum.accumulate(np.where(first, np.arange(len(ks)), 0))
    slot_sorted = np.arange(len(ks)) - start
    slot = np.empty(len(ks), np.int64)
    slot[order] = slot_sorted
    return np.minimum(slot, 255).astype(np.uint8)


class _JoinPlan:
    """Chunking and slow-path routing of one hamming_neighbor_sums call,
    and the bucket layouts of each (part, word chunk, query chunk) it
    joins.

    The word side W = [uniq, rc(uniq)] goes to the device once, on first
    use, with its live flags (a palindrome's rc word is dead), and the
    rc half is computed there (_build_w_device); no slot is computed for
    it: i' ranks each entry within its bucket on the device. W is cut into
    chunks of at most `chunk_w` words and the queries into chunks of at
    most `chunk_q`, so bucket loads stay under the pads at any genome
    size (a pair is found in exactly the (query chunk, word chunk) cell
    holding both ends).

    Chunks are INTERLEAVED (chunk c = every n-th element from c), where
    the JAX package cuts contiguous slices. Both arrays are sorted by
    code, so a contiguous slice covers a narrow range of the top part's
    keys and piles its bucket loads past the pads; on a 12 Mb realistic
    genome that sent so many queries to the host slow path that search
    ran past 20 minutes on an H100 host without finishing. The sums are
    the same either way.

    Routing: a query is slow when any part's word bucket, in any word
    chunk, holds more than `cpad` live words (stage 1, on construction),
    or when its bucket within its query chunk holds more than
    min(cpad_q, cpad) queries (stage 2, query_chunk). The query layout
    holds min(cpad_q, cpad) lanes per bucket, so that is the bound
    stage 2 checks; the JAX package checks cpad_q, which drops queries
    from the join when cpad < cpad_q.
    """

    def __init__(self, unique_kmers: np.ndarray, uniq: np.ndarray,
                 occ: np.ndarray, k: int, *, cpad: int, cpad_q: int,
                 device: torch.device, chunk_w: int = CHUNK_W,
                 chunk_q: int = CHUNK_Q):
        if not (1 <= cpad <= 255 and 1 <= cpad_q <= 255):
            raise ValueError("pads must lie in 1..255 (in-bucket slots are u8)")
        self.k, self.cpad, self.cpad_q = k, cpad, min(cpad_q, cpad)
        self.device = device
        self.uniq, self.occ = uniq, occ
        # database W = [uniq, rc(uniq)] (static 2n shape), palindromic rc
        # lanes DEAD by their live flag
        rc_db = _rc_np(uniq, k)
        self.w_live = np.concatenate([np.ones(len(uniq), bool),
                                      rc_db != uniq])
        whi, wlo = codec.split_u64(np.concatenate([uniq, rc_db]))
        self.qhi, self.qlo = codec.split_u64(
            np.asarray(unique_kmers, np.uint64))
        self.ranges = part_ranges(k)
        self.part_keys_w = [_extract_part_np(whi, wlo, s, t)
                            for (s, t) in self.ranges]
        self.part_keys_q = [_extract_part_np(self.qhi, self.qlo, s, t)
                            for (s, t) in self.ranges]
        self.n_bkts = [1 << (2 * (t - s)) for (s, t) in self.ranges]
        n_w = len(whi)
        n_wchunks = max(1, -(-n_w // chunk_w))
        self.chunks = [slice(c, n_w, n_wchunks) for c in range(n_wchunks)]

        # stage 1 (word side): the overflowed-bucket set unions over
        # chunks first, then all queries route with one gather per part
        self.slow = np.zeros(len(self.qhi), bool)
        for i in range(3):
            over_w = np.zeros(self.n_bkts[i], bool)
            for c in self.chunks:
                hw = np.bincount(self.part_keys_w[i][c][self.w_live[c]],
                                 minlength=self.n_bkts[i])
                over_w |= hw > cpad
            self.slow |= over_w[self.part_keys_q[i]]
        self.fast = np.flatnonzero(~self.slow)
        self.n_qchunks = -(-len(self.fast) // chunk_q)
        self._w_d = None

    def query_chunk(self, qc: int) -> np.ndarray:
        """Indices of query chunk `qc` (every n_qchunks-th stage-1 fast
        query from qc) that the join takes; the chunk's queries whose
        bucket overflows the query pad are marked slow (stage 2)."""
        qsel = self.fast[qc::self.n_qchunks]
        chunk_slow = np.zeros(len(qsel), bool)
        for i in range(3):
            hq = np.bincount(self.part_keys_q[i][qsel],
                             minlength=self.n_bkts[i])
            chunk_slow |= hq[self.part_keys_q[i][qsel]] > self.cpad_q
        self.slow[qsel[chunk_slow]] = True
        return qsel[~chunk_slow]

    def _words(self):
        if self._w_d is None:
            uhi, ulo = codec.split_u64(self.uniq)
            whi_d, wlo_d = _build_w_device(words(uhi, self.device),
                                           words(ulo, self.device), k=self.k)
            occ_d = torch.from_numpy(np.asarray(self.occ, np.uint8)).to(
                self.device)
            self._w_d = (whi_d, wlo_d, torch.cat([occ_d, occ_d]),
                         torch.from_numpy(self.w_live).to(self.device))
        return self._w_d

    def queries(self, qsel: np.ndarray) -> dict:
        """The device side of one query chunk: its codes."""
        return {"hi": words(self.qhi[qsel], self.device),
                "lo": words(self.qlo[qsel], self.device)}

    def layouts(self, i: int, ci: int, q: dict):
        """Bucket layouts of part i, word chunk ci and query chunk q
        (from queries()): (dh, dl, docc, qh, ql, qidx), see
        kernels.hamming_join.bucket_layouts (i')."""
        whi_d, wlo_d, wocc_d, wlive_d = self._words()
        c = self.chunks[ci]
        s, t = self.ranges[i]
        return bucket_layouts(
            whi_d[c], wlo_d[c], wocc_d[c], wlive_d[c], q["hi"], q["lo"],
            lo_bit=2 * s, width=2 * (t - s), n_buckets=self.n_bkts[i],
            cpad=self.cpad, cpad_q=self.cpad_q)

    def release(self) -> None:
        """Free the device word side."""
        self._w_d = None


def hamming_neighbor_sums(unique_kmers: np.ndarray, uniq: np.ndarray,
                          occ: np.ndarray, k: int, e: int,
                          cpad: int = 64, cpad_q: int = 32,
                          chunk_w: int = CHUNK_W,
                          chunk_q: int = CHUNK_Q,
                          packed_rows: torch.Tensor | None = None,
                          n_buckets_packed: int = 0,
                          packed_filter: torch.Tensor | None = None,
                          escalate: int = 0,
                          escalate_min: int = 1024,
                          device: str | torch.device = "cuda",
                          stats: dict | None = None) -> np.ndarray:
    """Neighbor-occurrence sums for `unique_kmers` (queries) against the
    distinct-genome-k-mer multiset (`uniq` canonical u64, `occ` u8/u32
    saturated counts). Exact: identical to brute-force enumeration and to
    the JAX package's hamming_neighbor_sums. Chunking and routing are
    _JoinPlan's.

    packed_rows / n_buckets_packed / packed_filter: the packed table over
    `uniq` with occ in the pos field and its key filter
    (kernels.neighbor_bits.key_filter; word tensors on `device`); with
    them the slow queries go through K6 in one launch (K6 holds no
    per-neighbor intermediate, so the JAX package's batch_slow has no
    counterpart), without them through the host `_slow_sums_sorted_np`.
    escalate > 0: a slow set larger than escalate_min is joined again
    at pads of 240 (escalate - 1 more times) before what is left takes
    the slow path.

    stats: optional dict filled with the routing counts (queries in
    total, joined on the device, sent to the slow path; join calls), the
    seconds of the join (`join_s`, re-joins included; `plan_s` of it the
    join plan's host routing) and of the slow path (`slow_s`) and, after
    an escalation, the re-join's own stats (`escalation`).
    """
    device = resolve_device(device)
    if not 1 <= e <= 2:
        raise ValueError("edit distance must be 1 or 2")
    n = len(unique_kmers)
    if n == 0:
        return np.zeros(0, np.uint32)
    if cpad == 64 and len(uniq) > 20_000_000:
        # repeat-family bucket loads scale with W: past ~20 M distinct
        # k-mers wider pads shrink the slow set (exactness is
        # pad-independent)
        cpad, cpad_q = 128, 64
    t0 = time.time()
    plan = _JoinPlan(unique_kmers, uniq, occ, k, cpad=cpad, cpad_q=cpad_q,
                     chunk_w=chunk_w, chunk_q=chunk_q, device=device)
    plan_s = time.time() - t0
    masks = _part_masks(k)
    sums = np.zeros(n, np.uint64)
    join_compare_calls = 0
    for qc in range(plan.n_qchunks):
        qsel = plan.query_chunk(qc)
        if len(qsel) == 0:
            continue
        q = plan.queries(qsel)
        scaled_d = torch.zeros(len(qsel) + 1, dtype=word_dtype(device),
                               device=device)
        for i in range(3):
            for ci in range(len(plan.chunks)):
                layouts = plan.layouts(i, ci, q)
                join_compare(*layouts, scaled_d, e=e, masks=masks,
                             n_buckets=plan.n_bkts[i], cpad=plan.cpad,
                             cpad_q=plan.cpad_q)
                join_compare_calls += 1
                del layouts
        scaled = to_numpy_u32(scaled_d).astype(np.uint64)
        part_sums, rem = divmod(scaled[:len(qsel)], 6)
        if rem.any():
            raise RuntimeError("hamming join scale invariant violated")
        sums[qsel] = part_sums
        del q, scaled_d
    plan.release()

    slow_idx = np.flatnonzero(plan.slow)
    if stats is not None:
        stats.update({"n_queries": n, "n_slow": len(slow_idx),
                      "n_joined": n - len(slow_idx),
                      "join_calls": join_compare_calls,
                      "join_s": time.time() - t0, "plan_s": plan_s,
                      "slow_s": 0.0})
    uk = np.asarray(unique_kmers, np.uint64)
    if (len(slow_idx) > escalate_min and escalate > 0
            and cpad < ESCALATE_PAD):
        sub = {} if stats is not None else None
        sums[slow_idx] = hamming_neighbor_sums(
            uk[slow_idx], uniq, occ, k, e, cpad=ESCALATE_PAD,
            cpad_q=ESCALATE_PAD, chunk_w=chunk_w, chunk_q=chunk_q,
            packed_rows=packed_rows, n_buckets_packed=n_buckets_packed,
            packed_filter=packed_filter, escalate=escalate - 1,
            escalate_min=escalate_min, device=device, stats=sub)
        if stats is not None:
            stats["escalation"] = sub
            stats["join_s"] += sub["join_s"]
            stats["slow_s"] = sub["slow_s"]
        return np.minimum(sums, np.iinfo(np.uint32).max).astype(np.uint32)
    t1 = time.time()
    if len(slow_idx) and packed_rows is not None:
        # per-neighbor probes of the caller's packed table (K6)
        sq = uk[slow_idx]
        halves = codec.split_u64(sq) + codec.split_u64(_rc_np(sq, k))
        out = neighbor_sum(*(words(a, device) for a in halves), packed_rows,
                           packed_filter, k=k, e=e,
                           n_buckets=n_buckets_packed)
        sums[slow_idx] = to_numpy_u32(out)
    elif len(slow_idx):
        # host path: enumerate neighbors vectorized and binary-search the
        # SORTED distinct array (np.unique output)
        sums[slow_idx] = _slow_sums_sorted_np(uk[slow_idx], uniq, occ, k, e)
    if stats is not None:
        stats["slow_s"] = time.time() - t1
    return np.minimum(sums, np.iinfo(np.uint32).max).astype(np.uint32)


class _BitsWords:
    """The word side of hamming_neighbor_bits: W = [dict, rc(dict)] on
    the device (palindromic rc lanes dead, slot 255), cut into
    contiguous chunks of at most `chunk_w` words in dictionary order —
    genome order, so a chunk's part keys spread like the whole's (the
    sums join interleaves its chunks because its arrays are sorted by
    code). Caches, per pad, the overflowed buckets (unioned over chunks)
    and, per (pad, part, chunk), the word runs on the device (K5's
    counting sort, kernels.hamming_join.bucket_runs); joins a query set
    into per-query bit planes with K5, building the query runs once a
    part."""

    def __init__(self, dict_kmers: np.ndarray, k: int, chunk_w: int,
                 device: torch.device):
        self.k, self.device = k, device
        rc_db = _rc_np(dict_kmers, k)
        self.live = np.concatenate([np.ones(len(dict_kmers), bool),
                                    rc_db != dict_kmers])
        whi, wlo = codec.split_u64(np.concatenate([dict_kmers, rc_db]))
        self.ranges = part_ranges(k)
        self.n_bkts = [1 << (2 * (t - s)) for (s, t) in self.ranges]
        self.part_keys = [_extract_part_np(whi, wlo, s, t)
                          for (s, t) in self.ranges]
        n_w = len(whi)
        self.chunks = [slice(c0, min(c0 + chunk_w, n_w))
                       for c0 in range(0, n_w, chunk_w)]
        dhi, dlo = codec.split_u64(dict_kmers)
        self.whi_d, self.wlo_d = _build_w_device(
            words(dhi, device), words(dlo, device), k=k)
        self._over: dict = {}
        self._slots: dict = {}
        self._runs: dict = {}
        self.calls = 0

    def over(self, cp: int, i: int) -> np.ndarray:
        """bool[B]: part i's buckets holding more than cp live words in
        some chunk."""
        if (cp, i) not in self._over:
            ov = np.zeros(self.n_bkts[i], bool)
            for c in self.chunks:
                hw = np.bincount(self.part_keys[i][c][self.live[c]],
                                 minlength=self.n_bkts[i])
                ov |= hw > cp
            self._over[(cp, i)] = ov
        return self._over[(cp, i)]

    def _w_slots(self, i: int, ci: int) -> torch.Tensor:
        if (i, ci) not in self._slots:
            c = self.chunks[ci]
            live = self.live[c]
            s8 = np.full(len(live), 255, np.uint8)
            s8[live] = _slots_u8(self.part_keys[i][c][live])
            self._slots[(i, ci)] = torch.from_numpy(s8).to(self.device)
        return self._slots[(i, ci)]

    def _part_bits(self, i: int) -> dict:
        s, t = self.ranges[i]
        return {"lo_bit": 2 * s, "width": 2 * (t - s)}

    def word_runs(self, i: int, ci: int, cp: int):
        """Part i's word runs of chunk ci at pad cp: (codes, offsets),
        the live words whose slot is below cp (bucket_runs), built on
        the device on first use and cached."""
        key = (cp, i, ci)
        if key not in self._runs:
            c = self.chunks[ci]
            self._runs[key] = bucket_runs(
                self.whi_d[c], self.wlo_d[c], self._w_slots(i, ci), cap=cp,
                **self._part_bits(i))
        return self._runs[key]

    def query_runs(self, i: int, qhi, qlo, qfwd, qslot, cpq: int):
        """Part i's query runs: (codes, tags, offsets) of the queries
        (word tensors qhi/qlo, strand flags qfwd) whose slot qslot is
        below cpq."""
        return bucket_runs(qhi, qlo, qslot, cap=cpq, fwd=qfwd,
                           **self._part_bits(i))

    def join_runs(self, i: int, runs_w, runs_q, planes) -> None:
        """OR part i's bits of query runs against word runs into planes
        (K5)."""
        join_bits(*runs_w, *runs_q, planes, k=self.k, **self._part_bits(i))
        self.calls += 1

    def query_slots(self, i: int, keys_q, active) -> torch.Tensor:
        """In-bucket slots of part i for the `active` queries (bool np
        array), 255 for the others, on the device."""
        qslot = np.full(len(active), 255, np.uint8)
        qslot[active] = _slots_u8(keys_q[i][active])
        return torch.from_numpy(qslot).to(self.device)

    def join(self, qhi, qlo, qfwd, keys_q, active, planes, cp: int,
             cpq: int) -> None:
        """OR the bits of the `active` queries (bool np array) into
        planes [n + 1, 4]; qhi/qlo word tensors of the canonical codes,
        qfwd their strand flags on the device, keys_q their part keys
        (host)."""
        for i in range(3):
            runs_q = self.query_runs(i, qhi, qlo, qfwd,
                                     self.query_slots(i, keys_q, active), cpq)
            for ci in range(len(self.chunks)):
                self.join_runs(i, self.word_runs(i, ci, cp), runs_q, planes)

    def route_tile(self, seg: np.ndarray, cp: int, cpq: int):
        """A tile of codes (len chunk_q + k - 1): its windows' canonical
        codes, validity and strand on the host, their part keys, and the
        windows the join takes (`active`) and leaves to the slow path
        (`slow`): those in a word bucket over cp, or in a bucket of the
        tile's active windows over cpq."""
        k = self.k
        if native.available():
            canon, valid, is_fwd = native.sliding_canon(seg, k)
        else:
            fwd, rc, valid = codec.sliding_fwd_rc_np(seg, k)
            canon, is_fwd = np.minimum(fwd, rc), fwd <= rc
        keys_q = self.part_keys_of(canon)
        slow = np.zeros(len(canon), bool)
        for i in range(3):
            slow |= self.over(cp, i)[keys_q[i]]
        active = valid & ~slow
        for i in range(3):
            hq = np.bincount(keys_q[i][active], minlength=self.n_bkts[i])
            over_q = hq[keys_q[i]] > cpq
            slow |= over_q & active
            active &= ~over_q
        return canon, valid, is_fwd, keys_q, active, slow

    def part_keys_of(self, canon: np.ndarray) -> list:
        hi, lo = codec.split_u64(canon)
        return [_extract_part_np(hi, lo, s, t) for (s, t) in self.ranges]


def hamming_neighbor_bits(genome_codes: np.ndarray, dict_kmers: np.ndarray,
                          k: int, cpad: int = 64, cpad_q: int = 32,
                          chunk_w: int = CHUNK_W,
                          chunk_q: int = CHUNK_Q_BITS,
                          escalate: bool = True,
                          escalate_min: int = 50_000,
                          device: str | torch.device = "cuda",
                          stats: dict | None = None) -> np.ndarray:
    """Neighbor-hit bitmap of the genome against the dictionary as a
    Hamming join — the same bytes as ops.anchored.build_neighbor_bits
    and the JAX package's hamming_neighbor_bits: u8[G], bit b of byte e
    set iff substituting base b at position e inside any valid window
    yields a canonical k-mer in the dictionary.

    Genome windows (queries) go in fixed contiguous tiles of chunk_q;
    each H = 1 pair of a window and a word of W = [dict, rc(dict)]
    names its substitution (offset, base), ORed into per-window bit
    planes (K5) and smeared onto genome positions. Windows in
    overflowed buckets (repeat tracts) are joined again at pads of 240
    when there are more than escalate_min of them and the wider layouts
    fit (ESCALATE_MAX_LANES), and what is left enumerates its 3k
    variants on the host against the sorted dictionary.

    stats: optional dict filled with the valid windows, the windows left
    to the slow path by the main pass (`n_slow`), how many of them the
    escalation took and the host enumerated, and the K5 calls."""
    device = resolve_device(device)
    G = len(genome_codes)
    nb = np.zeros(G, np.uint8)
    if G < k or len(dict_kmers) == 0:
        return nb
    genome_codes = np.asarray(genome_codes, np.uint8)
    dict_kmers = np.asarray(dict_kmers, np.uint64)
    w = _BitsWords(dict_kmers, k, chunk_w, device)
    wd = word_dtype(device)

    # main pass: contiguous window tiles; codes cross at 1 B a base and
    # the canonical pairs and strand flags are derived on the device
    n_valid = 0
    slow_parts = []
    for t0 in range(0, G - k + 1, chunk_q):
        seg = genome_codes[t0: t0 + chunk_q + k - 1]
        pad = chunk_q + k - 1 - len(seg)
        if pad:
            seg = np.concatenate([seg, np.full(pad, codec.SEP, np.uint8)])
        canon, valid, is_fwd, keys_q, active, slow = w.route_tile(
            seg, cpad, cpad_q)
        n_valid += int(valid.sum())
        chi, clo, fwd = _device_kmerize(
            torch.from_numpy(seg).to(device), k)
        planes = torch.zeros((chunk_q + 1, 4), dtype=wd, device=device)
        w.join(chi, clo, fwd, keys_q, active, planes, cpad, cpad_q)
        hot, rows = _fetch_hot_planes(planes, chunk_q)
        _smear_planes(nb, t0 + hot, rows, k)
        left = np.flatnonzero(valid & slow)
        if len(left):
            slow_parts.append((t0 + left.astype(np.int64), canon[left],
                               is_fwd[left]))
        del chi, clo, fwd, planes

    n_slow = sum(len(p[0]) for p in slow_parts)
    n_escalated = n_host = 0
    if slow_parts:
        gsel = np.concatenate([p[0] for p in slow_parts])
        canon = np.concatenate([p[1] for p in slow_parts])
        is_fwd = np.concatenate([p[2] for p in slow_parts])
        still = np.ones(len(gsel), bool)
        fits = max(w.n_bkts) * ESCALATE_PAD <= ESCALATE_MAX_LANES
        if (escalate and fits and cpad < ESCALATE_PAD
                and len(gsel) > escalate_min):
            # gathered windows: their canonical pairs upload directly
            n_escalated = len(gsel)
            still = _join_gathered(w, nb, gsel, canon, is_fwd, ESCALATE_PAD,
                                   ESCALATE_PAD, chunk_q)
        n_host = int(still.sum())
        if n_host:
            other = _rc_np(canon[still], k)
            fwd_q = np.where(is_fwd[still], canon[still], other)
            rc_q = np.where(is_fwd[still], other, canon[still])
            _slow_bits_np(nb, gsel[still], fwd_q, rc_q, np.sort(dict_kmers),
                          k)
    if stats is not None:
        stats.update({"n_windows": n_valid, "n_slow": n_slow,
                      "n_escalated": n_escalated, "n_host": n_host,
                      "join_calls": w.calls})
    return nb


def _join_gathered(w: _BitsWords, nb: np.ndarray, gsel, canon, is_fwd,
                   cp: int, cpq: int, chunk_q: int) -> np.ndarray:
    """Escalation pass over a gathered window set at pads cp/cpq: the
    resolved windows' bits are ORed into nb; returns the mask of the
    windows still unresolved."""
    keys_q = w.part_keys_of(canon)
    slow = np.zeros(len(gsel), bool)
    for i in range(3):
        slow |= w.over(cp, i)[keys_q[i]]
    fast_pos = np.flatnonzero(~slow)
    s_qhi, s_qlo = codec.split_u64(canon)
    for qc0 in range(0, len(fast_pos), chunk_q):
        qpos = fast_pos[qc0: qc0 + chunk_q]
        chunk_slow = np.zeros(len(qpos), bool)
        for i in range(3):
            hq = np.bincount(keys_q[i][qpos], minlength=w.n_bkts[i])
            chunk_slow |= hq[keys_q[i][qpos]] > cpq
        slow[qpos[chunk_slow]] = True
        qpos = qpos[~chunk_slow]
        if len(qpos) == 0:
            continue
        n_q = len(qpos)
        planes = torch.zeros((n_q + 1, 4), dtype=word_dtype(w.device),
                             device=w.device)
        w.join(words(s_qhi[qpos], w.device), words(s_qlo[qpos], w.device),
               torch.from_numpy(is_fwd[qpos]).to(w.device),
               [kq[qpos] for kq in keys_q], np.ones(n_q, bool), planes, cp,
               cpq)
        hot, rows = _fetch_hot_planes(planes, n_q)
        _smear_planes(nb, gsel[qpos[hot]], rows, k=w.k)
        del planes
    return slow


def _device_kmerize(codes: torch.Tensor, k: int):
    """Canonical (hi, lo) word tensors and the forward-strand flag of
    every window of a code tile, on its device."""
    fhi, flo, rhi, rlo, _ = codec.sliding_fwd_rc(codes, k)
    fwd_less = (fhi < rhi) | ((fhi == rhi) & (flo <= rlo))
    wd = word_dtype(codes.device)
    return (store(torch.where(fwd_less, fhi, rhi), wd),
            store(torch.where(fwd_less, flo, rlo), wd), fwd_less)


def _fetch_hot_planes(planes: torch.Tensor, n_rows: int):
    """(indices of the rows among the first n_rows with a bit set, those
    rows as u32[n, 4]) on the host: neighbor hits are rare, so only the
    hot rows cross to the host."""
    acc = planes[:n_rows]
    hot = torch.nonzero((acc != 0).any(1)).flatten()
    return (hot.cpu().numpy().astype(np.int64),
            to_numpy_u32(acc[hot]).reshape(-1, 4))


def _smear_planes(nb: np.ndarray, qsel: np.ndarray, planes: np.ndarray,
                  k: int) -> None:
    """OR per-window bit planes (u32[n,4], bit j of plane b = hit at
    window offset j, base b) onto genome positions: nb[o+j] |= 1<<b."""
    hot = np.flatnonzero(planes.any(axis=1))    # neighbor hits are rare
    if len(hot) == 0:
        return
    pl = planes[hot]
    osel = qsel[hot]
    for j in range(k):
        bits = ((pl >> np.uint32(j)) & 1).astype(np.uint8)
        byte = (bits[:, 0] | (bits[:, 1] << 1) | (bits[:, 2] << 2)
                | (bits[:, 3] << 3))
        nz = np.flatnonzero(byte)
        if len(nz):
            np.bitwise_or.at(nb, osel[nz] + j, byte[nz])


def _slow_bits_np(nb: np.ndarray, o_idx: np.ndarray, fwd: np.ndarray,
                  rc: np.ndarray, sorted_dict: np.ndarray, k: int,
                  batch: int = 4096) -> None:
    """Host path for overflow windows: enumerate all 3k single
    substitutions, canonicalize, membership by searchsorted into the
    sorted dictionary, OR hits into nb. Same enumeration semantics as
    the probe builders (ops.anchored.build_neighbor_bits)."""
    for off in range(0, len(o_idx), batch):
        sl = slice(off, off + batch)
        f = fwd[sl]
        r = rc[sl]
        o = o_idx[sl]
        for j in range(k):
            sh_f = np.uint64(2 * (k - 1 - j))
            sh_r = np.uint64(2 * j)
            orig = (f >> sh_f) & np.uint64(3)
            for d in (1, 2, 3):
                b = (orig + np.uint64(d)) & np.uint64(3)
                x = orig ^ b
                mf = f ^ (x << sh_f)
                mr = r ^ (x << sh_r)
                canon = np.minimum(mf, mr)
                idx = np.searchsorted(sorted_dict, canon)
                inb = idx < len(sorted_dict)
                idc = np.minimum(idx, len(sorted_dict) - 1)
                hit = inb & (sorted_dict[idc] == canon)
                if hit.any():
                    np.bitwise_or.at(
                        nb, o[hit] + j,
                        (np.uint8(1) << b[hit].astype(np.uint8)))


def _build_w_device(dhi: torch.Tensor, dlo: torch.Tensor, *, k: int):
    """Word-side device arrays [dict, rc(dict)] as word tensors — only the
    dict codes cross the link; the rc half is computed on the device."""
    rh, rl = _rc_device(u32(dhi), u32(dlo), k=k)
    return (torch.cat([dhi, store(rh, dhi.dtype)]),
            torch.cat([dlo, store(rl, dlo.dtype)]))


def _rev2bit32(x: torch.Tensor) -> torch.Tensor:
    """Reverse the 16 2-bit symbols of u32 values (log-step swaps)."""
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) | (x >> 16)) & U32


def _rc_device(hi: torch.Tensor, lo: torch.Tensor, *, k: int):
    """Exact reverse complement of 2k-bit codes given as int64 u32 pairs:
    complement = per-symbol XOR 0b10, then reverse the 32 symbols of the
    u64 and realign to the low 2k bits (matches _rc_np bit for bit)."""
    two_k = 2 * k
    hi_bits = max(two_k - 32, 0)
    ch = hi ^ (0xAAAAAAAA & ((1 << hi_bits) - 1))
    cl = lo ^ (0xAAAAAAAA & ((1 << min(two_k, 32)) - 1))
    rhi = _rev2bit32(cl)
    rlo = _rev2bit32(ch)
    sh = 64 - two_k
    if sh == 0:
        return rhi, rlo
    if sh < 32:
        return rhi >> sh, ((rlo >> sh) | (rhi << (32 - sh))) & U32
    return torch.zeros_like(rhi), rhi >> (sh - 32)


def _slow_sums_sorted_np(queries: np.ndarray, uniq_sorted: np.ndarray,
                         occ: np.ndarray, k: int, e: int,
                         batch: int = 512) -> np.ndarray:
    """Neighbor-occurrence sums by vectorized enumeration + searchsorted
    into the sorted distinct array. Exact-math semantics identical to
    the join (edit_table enumeration, canonical min)."""
    p1, d1, p2, d2 = edit_table(k, e)
    p1 = p1.astype(np.uint64)[None, :]
    d1 = d1.astype(np.uint64)[None, :]
    p2m = np.maximum(p2, 0).astype(np.uint64)[None, :]
    d2m = (d2 * (p2 >= 0)).astype(np.uint64)[None, :]   # delta 0 = no-op
    occ64 = np.asarray(occ, np.uint64)
    out = np.zeros(len(queries), np.uint64)
    rc_all = _rc_np(queries, k)

    def mutate(f, r, pos, delta):
        base = (f >> (np.uint64(2) * pos)) & np.uint64(3)
        nb = (base + delta) & np.uint64(3)
        x = base ^ nb
        f = f ^ (x << (np.uint64(2) * pos))
        r = r ^ (x << (np.uint64(2) * (np.uint64(k - 1) - pos)))
        return f, r

    for off in range(0, len(queries), batch):
        f = queries[off: off + batch, None]
        r = rc_all[off: off + batch, None]
        f1, r1 = mutate(f, r, p1, d1)
        f2, r2 = mutate(f1, r1, p2m, d2m)
        canon = np.minimum(f2, r2)
        idx = np.searchsorted(uniq_sorted, canon)
        inb = idx < len(uniq_sorted)
        idc = np.minimum(idx, len(uniq_sorted) - 1)
        hit = inb & (uniq_sorted[idc] == canon)
        out[off: off + batch] = np.sum(
            np.where(hit, occ64[idc], np.uint64(0)), axis=1)
    return out


def _rc_np(kmers: np.ndarray, k: int) -> np.ndarray:
    rc = np.zeros_like(kmers)
    tmp = np.asarray(kmers, np.uint64).copy()
    for _ in range(k):
        rc = (rc << np.uint64(2)) | ((tmp - np.uint64(2)) & np.uint64(3))
        tmp >>= np.uint64(2)
    return rc & np.uint64((1 << (2 * k)) - 1)
