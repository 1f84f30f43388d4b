"""Hamming-join compare chains: the CUDA kernels of csrc/hamming_join.cu
(K1 with i', which builds its layouts, and K5 with its counting sort)
and their plain PyTorch versions.

`join_compare` (K1) replaces the slab loop of quickmer2_tpu/ops/
hamming_join.py::_part_chunk_join (and the Pallas prototype
tools/proto_join2d.py::kernel). Given one (part, word chunk)'s bucket
layouts it adds, for every live query lane, Σ occ(w)·(6/m) over the
bucket's word lanes w with 1 ≤ H(q, w) ≤ e into scaled[qidx] (u32,
wrapping). `bucket_layouts` (i') builds those layouts from one word chunk
and one query chunk, each entry at its rank among the live entries of
its key in entry order: on the card a stable counting sort of each side
into bucket runs and an expand of the runs into the padded lanes, so no
caller computes slots; its plain version `bucket_layouts_plain` ranks by
a stable torch sort (`rank_slots`) and scatters with ops/
hamming_join.py::_bucket_layouts.

`join_bits` (K5) replaces _part_chunk_join_bits: it ORs into
planes[q, b] the bit j of every substitution (window offset j, base b)
that turns query window q into a word of its bucket at Hamming distance
exactly 1. Its inputs are bucket runs, not padded layouts: each side's
entries sorted by one part's key, with offsets u32[B + 1] (CSR), built
on the card by `bucket_runs`, a counting sort that keeps each entry at
its in-bucket slot, so the runs hold the lanes the padded layout held.
It places in two levels over coarse bins of the part key (`runs_plan`):
each block sorts its tile by bin into the bins' ranges, then a block a
bin puts its range in order through shared memory. Every entry's place
is offsets[key] + slot whatever the passes' order, so its plain version
`bucket_runs_plain` is a sort. Terms and layouts are described in the
CUDA source.

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel, or raises.
"""

from __future__ import annotations

import ctypes

import torch

from quickmer2_tpu_torch.device import popcount32, store, u32
from quickmer2_tpu_torch.kernels import build

_ARGTYPES = ([ctypes.c_void_p] * 7
             + [ctypes.c_longlong] + [ctypes.c_int] * 4
             + [ctypes.c_uint] * 6 + [ctypes.c_void_p])
_RUNS_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                  + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 8)
_LAYOUT_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
                    + [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                    + [ctypes.c_int] * 4
                    + [ctypes.c_void_p, ctypes.c_longlong]
                    + [ctypes.c_void_p] * 7)
_BITS_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong,
                                           ctypes.c_void_p]
                  + [ctypes.c_int] * 3 + [ctypes.c_void_p])
MAX_BINS = 2048     # coarse bins, at most
MAX_BIN_KEYS = 8192    # keys a bin, at most
STAGE_BYTES = 192 * 1024   # the place pass's stage in shared memory


def _lib():
    lib = build.load("hamming_join",
                     {"qm2t_hamming_join": _ARGTYPES,
                      "qm2t_bucket_layouts": _LAYOUT_ARGTYPES,
                      "qm2t_layout_scratch_bytes": [ctypes.c_longlong,
                                                    ctypes.c_longlong,
                                                    ctypes.c_int],
                      "qm2t_bucket_runs": _RUNS_ARGTYPES,
                      "qm2t_hamming_join_bits": _BITS_ARGTYPES})
    lib.qm2t_layout_scratch_bytes.restype = ctypes.c_longlong
    return lib


def join_compare_plain(dh, dl, docc, qh, ql, qidx, scaled, *, e: int, masks,
                       n_buckets: int, cpad: int, cpad_q: int,
                       slab_pairs: int = 1 << 22) -> None:
    """Plain PyTorch version: the JAX slab loop over the buckets that hold
    at least one live query lane, in slabs of ≤ slab_pairs lane pairs."""
    nq = scaled.shape[0] - 1
    qix_all = qidx[:n_buckets * cpad_q].view(n_buckets, cpad_q)
    buckets = torch.nonzero((qix_all != nq).any(1)).flatten()
    slab = max(1, slab_pairs // (cpad * cpad_q))
    words = [u32(a[:n_buckets * cpad]).view(n_buckets, cpad)
             for a in (dh, dl, docc)]
    queries = [u32(a[:n_buckets * cpad_q]).view(n_buckets, cpad_q)
               for a in (qh, ql)]
    for s in range(0, buckets.shape[0], slab):
        b = buckets[s:s + slab]
        dhs, dls, dos = (w[b] for w in words)
        qhs, qls = (q[b] for q in queries)
        xh = qhs[:, :, None] ^ dhs[:, None, :]
        xl = qls[:, :, None] ^ dls[:, None, :]
        # per-base differ bits: fold each 2-bit symbol to its low lane
        ham = (popcount32((xh | (xh >> 1)) & 0x55555555)
               + popcount32((xl | (xl >> 1)) & 0x55555555))
        m = torch.zeros_like(xh)
        for mh, ml in masks:
            m += (((xh & int(mh)) | (xl & int(ml))) == 0).to(torch.int64)
        ok = (ham >= 1) & (ham <= e)
        scale = torch.where(m > 0, 6 // torch.clamp(m, min=1), 0)
        contrib = torch.where(ok, dos[:, None, :] * scale, 0)
        out = contrib.sum(2).flatten()
        qix = qix_all[b].flatten().to(torch.int64)
        live = qix != nq
        qix, out = qix[live], out[live]
        scaled[qix] = store(u32(scaled[qix]) + out, scaled.dtype)


def join_compare(dh: torch.Tensor, dl: torch.Tensor, docc: torch.Tensor,
                 qh: torch.Tensor, ql: torch.Tensor, qidx: torch.Tensor,
                 scaled: torch.Tensor, *, e: int, masks, n_buckets: int,
                 cpad: int, cpad_q: int) -> None:
    """Add one (part, word chunk)'s neighbor terms into `scaled`
    (u32[nq+1] word tensor, in place). masks: the three (hi, lo) part
    masks of ops.hamming_join._part_masks."""
    if dh.device.type == "cpu":
        join_compare_plain(dh, dl, docc, qh, ql, qidx, scaled, e=e,
                           masks=masks, n_buckets=n_buckets, cpad=cpad,
                           cpad_q=cpad_q)
        return
    nd = (n_buckets * cpad + 1,)
    nql = (n_buckets * cpad_q + 1,)
    build.check_tensors("join_compare", dh.device, [
        ("dh", dh, torch.int32, nd), ("dl", dl, torch.int32, nd),
        ("docc", docc, torch.int32, nd), ("qh", qh, torch.int32, nql),
        ("ql", ql, torch.int32, nql), ("qidx", qidx, torch.int32, nql),
        ("scaled", scaled, torch.int32, (scaled.shape[0],))])
    if not (1 <= cpad <= 255 and 1 <= cpad_q <= 255 and e >= 1):
        raise ValueError(f"join_compare: bad cpad={cpad} cpad_q={cpad_q} "
                         f"e={e}")
    lib = _lib()
    flat_masks = [int(v) for pair in masks for v in pair]
    with torch.cuda.device(dh.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qm2t_hamming_join(
            dh.data_ptr(), dl.data_ptr(), docc.data_ptr(), qh.data_ptr(),
            ql.data_ptr(), qidx.data_ptr(), scaled.data_ptr(), n_buckets,
            cpad, cpad_q, scaled.shape[0] - 1, e, *flat_masks, stream)
    build.check(lib, rc, "join_compare")
    join_compare.launches += 1


join_compare.launches = 0


def rank_slots(keys: torch.Tensor, live=None) -> torch.Tensor:
    """u8 in-bucket slots: each entry's rank among the live entries of
    its key (int64 keys), in entry order, saturated to 255; 255 for an
    entry whose live flag is False. A stable sort by key, as the host's
    ops/hamming_join.py::_slots_u8 does with np.argsort."""
    n = keys.shape[0]
    slot = torch.full((n,), 255, dtype=torch.int64, device=keys.device)
    sel = (torch.arange(n, device=keys.device) if live is None
           else torch.nonzero(live).flatten())
    order = torch.sort(keys[sel], stable=True).indices
    ks = keys[sel][order]
    pos = torch.arange(ks.shape[0], device=keys.device)
    head = torch.ones_like(ks, dtype=torch.bool)
    head[1:] = ks[1:] != ks[:-1]
    start = torch.cummax(torch.where(head, pos, 0), 0).values
    slot[sel[order]] = torch.clamp(pos - start, max=255)
    return slot.to(torch.uint8)


def bucket_layouts_plain(whi, wlo, wocc, wlive, qhi, qlo, *, lo_bit: int,
                         width: int, n_buckets: int, cpad: int,
                         cpad_q: int):
    """Plain PyTorch version of i': each side's in-bucket slots by a
    stable sort (rank_slots), then the scatter of ops/hamming_join.py::
    _bucket_layouts."""
    from quickmer2_tpu_torch.ops.hamming_join import _bucket_layouts
    wslot = rank_slots(part_keys(whi, wlo, lo_bit, width), wlive)
    qslot = rank_slots(part_keys(qhi, qlo, lo_bit, width))
    return _bucket_layouts(whi, wlo, wocc, wslot, qhi, qlo, qslot,
                           lo_bit=lo_bit, width=width, n_buckets=n_buckets,
                           cpad=cpad, cpad_q=cpad_q)


def bucket_layouts(whi: torch.Tensor, wlo: torch.Tensor, wocc: torch.Tensor,
                   wlive: torch.Tensor, qhi: torch.Tensor, qlo: torch.Tensor,
                   *, lo_bit: int, width: int, n_buckets: int, cpad: int,
                   cpad_q: int):
    """K1's padded layouts of one part (i'): the word chunk (codes whi,
    wlo, u8 occ wocc and bool live flags wlive, False for a word that
    stays out; 1-D views of the word side that share a stride, as the
    join plan's interleaved chunks are) and the query chunk (qhi, qlo),
    each live entry at lane key * pad + its rank among the live entries
    of its key in entry order, where that rank is below the pad. Returns
    (dh, dl, docc, qh, ql, qidx), as bucket_layouts_plain does. The
    kernel's scratch needs no clearing: it comes from torch's caching
    allocator each call, and nothing is held between calls."""
    if whi.device.type == "cpu":
        return bucket_layouts_plain(whi, wlo, wocc, wlive, qhi, qlo,
                                    lo_bit=lo_bit, width=width,
                                    n_buckets=n_buckets, cpad=cpad,
                                    cpad_q=cpad_q)
    dev = whi.device
    n_w, nq = whi.shape[0], qhi.shape[0]
    stride = whi.stride(0) if n_w > 1 else 1
    for name, t, dtype in (("whi", whi, torch.int32),
                           ("wlo", wlo, torch.int32),
                           ("wocc", wocc, torch.uint8),
                           ("wlive", wlive, torch.bool)):
        if (t.dtype != dtype or t.dim() != 1 or t.shape[0] != n_w
                or t.device != dev or (n_w > 1 and t.stride(0) != stride)):
            raise ValueError(
                f"bucket_layouts: {name} must be a 1-D {dtype} tensor of "
                f"{n_w} entries with stride {stride} on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} with strides {t.stride()} on {t.device}")
    build.check_tensors("bucket_layouts", dev, [
        ("qhi", qhi, torch.int32, (nq,)), ("qlo", qlo, torch.int32, (nq,))])
    if not (1 <= width <= 24 and 0 <= lo_bit <= 64 - width
            and n_buckets == 1 << width and 1 <= cpad <= 255
            and 1 <= cpad_q <= 255):
        raise ValueError(f"bucket_layouts: bad part bits [{lo_bit}, "
                         f"{lo_bit} + {width}), {n_buckets} buckets or pads "
                         f"{cpad}/{cpad_q}")
    nd, nql = n_buckets * cpad + 1, n_buckets * cpad_q + 1
    out = [torch.empty(n, dtype=torch.int32, device=dev)
           for n in (nd, nd, nd, nql, nql, nql)]
    lib = _lib()
    n_scratch = lib.qm2t_layout_scratch_bytes(n_w, nq, width)
    scratch = torch.empty(n_scratch, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qm2t_bucket_layouts(
            whi.data_ptr(), wlo.data_ptr(), wocc.data_ptr(),
            wlive.data_ptr(), stride, n_w, qhi.data_ptr(), qlo.data_ptr(),
            nq, lo_bit, width, cpad, cpad_q, scratch.data_ptr(), n_scratch,
            *(t.data_ptr() for t in out), stream)
    build.check(lib, rc, "bucket_layouts")
    bucket_layouts.launches += 1
    return tuple(out)


bucket_layouts.launches = 0


def part_keys(hi: torch.Tensor, lo: torch.Tensor, lo_bit: int,
              width: int) -> torch.Tensor:
    """Bits [lo_bit, lo_bit + width) of the (hi, lo) codes (word
    tensors) as int64: one pigeonhole part's bucket."""
    return (((u32(hi) << 32) | u32(lo)) >> lo_bit) & ((1 << width) - 1)


def bucket_runs_plain(hi, lo, slot, *, lo_bit: int, width: int, cap: int,
                      fwd=None):
    """Plain PyTorch version of bucket_runs: a stable sort by (part key,
    slot) of the entries whose slot is below cap."""
    n = hi.shape[0]
    key = part_keys(hi, lo, lo_bit, width)
    s = slot.to(torch.int64)
    sel = torch.nonzero(s < cap).flatten()
    order = sel[torch.argsort(key[sel] * 256 + s[sel])]
    off = torch.zeros((1 << width) + 1, dtype=torch.int64, device=hi.device)
    off[1:] = torch.cumsum(torch.bincount(key[sel], minlength=1 << width), 0)
    codes = torch.zeros((n, 2), dtype=hi.dtype, device=hi.device)
    codes[:len(order), 0] = hi[order]
    codes[:len(order), 1] = lo[order]
    off = store(off, hi.dtype)
    if fwd is None:
        return codes, off
    tags = torch.zeros(n, dtype=torch.int64, device=hi.device)
    tags[:len(order)] = order | (fwd[order].to(torch.int64) << 31)
    return codes, store(tags, hi.dtype), off


def runs_plan(n: int, width: int, tags: bool) -> tuple[int, int]:
    """The counting sort's coarse bins for n entries and 2^width keys:
    (bin_shift, stage), a bin being key >> bin_shift and stage the
    entries the place pass stages (12 B each with tags, else 8). The
    least power of two of bins whose mean bin is at most half the stage
    (the part keys are raw code bits, so bins are skewed: a bin over the
    stage is stored straight) and whose bins hold at most MAX_BIN_KEYS
    keys; at most MAX_BINS bins and at most a key a bin."""
    stage = STAGE_BYTES // (12 if tags else 8)
    bits = max(0, width - (MAX_BIN_KEYS.bit_length() - 1))
    while (bits < min(width, MAX_BINS.bit_length() - 1)
           and n >> bits > stage // 2):
        bits += 1
    return width - bits, stage


def bucket_runs(hi: torch.Tensor, lo: torch.Tensor, slot: torch.Tensor, *,
                lo_bit: int, width: int, cap: int, fwd=None):
    """One side's bucket runs for one part (K5's counting sort): the
    entries (codes hi[i], lo[i], word tensors) whose in-bucket slot (u8,
    the rank among equal keys in entry order; 255 for an entry left out)
    is below cap, sorted by part key and slot. Returns (codes [n, 2],
    offsets [2^width + 1]) and, with the query side's strand flags fwd
    (bool), (codes, tags, offsets), a tag being the entry's index with
    its flag in bit 31. Of the n rows the first offsets[-1] are the
    runs."""
    if hi.device.type == "cpu":
        return bucket_runs_plain(hi, lo, slot, lo_bit=lo_bit, width=width,
                                 cap=cap, fwd=fwd)
    n = hi.shape[0]
    specs = [("hi", hi, torch.int32, (n,)), ("lo", lo, torch.int32, (n,)),
             ("slot", slot, torch.uint8, (n,))]
    if fwd is not None:
        specs.append(("fwd", fwd, torch.bool, (n,)))
    build.check_tensors("bucket_runs", hi.device, specs)
    if not (1 <= width <= 24 and 0 <= lo_bit <= 64 - width
            and 1 <= cap <= 255):
        raise ValueError(f"bucket_runs: bad part bits [{lo_bit}, "
                         f"{lo_bit} + {width}) or cap {cap}")
    shift, _ = runs_plan(n, width, fwd is not None)
    dev = hi.device
    sc = _run_scratch(dev)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)
    off, codes, mid = empty((1 << width) + 1), empty(n, 2), empty(n, 4)
    tags = None if fwd is None else empty(n)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qm2t_bucket_runs(
            hi.data_ptr(), lo.data_ptr(), slot.data_ptr(),
            None if fwd is None else fwd.data_ptr(), n, lo_bit, width, cap,
            shift, sc["total"].data_ptr(), sc["fill"].data_ptr(),
            sc["bin_start"].data_ptr(), mid.data_ptr(), off.data_ptr(),
            codes.data_ptr(), None if tags is None else tags.data_ptr(),
            stream)
    if rc:
        # a failed call may leave the bins' totals nonzero: drop them, so
        # that the next call starts from zeroed scratch
        del _scratch[dev]
    build.check(lib, rc, "bucket_runs")
    bucket_runs.launches += 1
    return (codes, off) if tags is None else (codes, tags, off)


bucket_runs.launches = 0


def _run_scratch(device: torch.device) -> dict:
    """The counting sort's cached scratch on a device: the bins' totals
    and fill counters (zero between calls: the kernels leave them so)
    and the bins' starts. Calls that share it run on one stream."""
    if device not in _scratch:
        def zeros(n):
            return torch.zeros(n, dtype=torch.int32, device=device)
        _scratch[device] = {"total": zeros(MAX_BINS), "fill": zeros(MAX_BINS),
                            "bin_start": zeros(MAX_BINS + 1)}
    return _scratch[device]


_scratch: dict = {}


def _ctz_onehot(y: torch.Tensor) -> torch.Tensor:
    """Bit position of a one-hot u32 (int64 tensors): popcount(y - 1)."""
    return popcount32((y - 1) & 0xFFFFFFFF)


def pair_bits(qh, ql, fwd, wh, wl, k: int) -> torch.Tensor:
    """K5's term of each (query, word) pair (int64 u32 values, fwd bool):
    [n, 4] planes with bit j of plane b set where the pair is at Hamming
    distance exactly 1 and substituting base b at window offset j turns
    the query window into the word; 0 elsewhere."""
    yh = ((qh ^ wh) | ((qh ^ wh) >> 1)) & 0x55555555
    yl = ((ql ^ wl) | ((ql ^ wl) >> 1)) & 0x55555555
    ok = popcount32(yh) + popcount32(yl) == 1
    in_lo = yl != 0
    sym = torch.where(in_lo, _ctz_onehot(yl) >> 1, (_ctz_onehot(yh) >> 1) + 16)
    t = (torch.where(in_lo, wl, wh) >> ((sym & 15) << 1)) & 3
    j = torch.where(fwd, k - 1 - sym, sym) & 31
    base = torch.where(fwd, t, (t - 2) & 3)
    bit = torch.where(ok, torch.ones_like(j) << j, 0)
    return torch.stack([torch.where(base == c, bit, 0) for c in range(4)], -1)


def join_bits_plain(wcodes, woff, qcodes, qtags, qoff, planes, *, k: int,
                    lo_bit: int, width: int,
                    slab_pairs: int = 1 << 22) -> None:
    """Plain PyTorch version: every query of the runs against its
    bucket's word run, in slabs of queries of at most slab_pairs pairs
    (one query's pairs may exceed it). A query holds one entry of the
    runs, and distinct words give distinct (offset, base) bits, so a sum
    over its pairs is their OR."""
    n = int(u32(qoff[-1]))
    qh, ql = u32(qcodes[:n, 0]), u32(qcodes[:n, 1])
    tag = u32(qtags[:n])
    fwd, qix = (tag >> 31) != 0, tag & 0x7FFFFFFF
    key = part_keys(qh, ql, lo_bit, width)
    wo = u32(woff)
    first, cnt = wo[key], wo[key + 1] - wo[key]
    ends = torch.cumsum(cnt, 0)
    q0 = 0
    while q0 < n:
        lim = (0 if q0 == 0 else int(ends[q0 - 1])) + slab_pairs
        q1 = max(q0 + 1, int(torch.searchsorted(ends, lim, right=True)))
        q1 = min(q1, n)
        c = cnt[q0:q1]
        qi = torch.repeat_interleave(torch.arange(q1 - q0, device=c.device),
                                     c)
        starts = torch.cumsum(c, 0) - c
        wj = first[q0:q1][qi] + torch.arange(qi.shape[0],
                                             device=c.device) - starts[qi]
        bits = pair_bits(qh[q0:q1][qi], ql[q0:q1][qi], fwd[q0:q1][qi],
                         u32(wcodes[wj, 0]), u32(wcodes[wj, 1]), k)
        acc = torch.zeros((q1 - q0, 4), dtype=torch.int64, device=c.device)
        acc.index_add_(0, qi, bits)
        rows = qix[q0:q1]
        planes[rows] = store(u32(planes[rows]) | acc, planes.dtype)
        q0 = q1


def join_bits(wcodes: torch.Tensor, woff: torch.Tensor, qcodes: torch.Tensor,
              qtags: torch.Tensor, qoff: torch.Tensor, planes: torch.Tensor,
              *, k: int, lo_bit: int, width: int) -> None:
    """OR one part's neighbor bits of the query runs (qcodes, qtags,
    qoff) against the word runs (wcodes, woff), both from bucket_runs
    with this part's bits, into `planes` (u32 word tensor [nq + 1, 4], in
    place; a query's row is its tag's index)."""
    if wcodes.device.type == "cpu":
        join_bits_plain(wcodes, woff, qcodes, qtags, qoff, planes, k=k,
                        lo_bit=lo_bit, width=width)
        return
    n_keys = (1 << width) + 1
    n_max = qcodes.shape[0]
    build.check_tensors("join_bits", wcodes.device, [
        ("wcodes", wcodes, torch.int32, (wcodes.shape[0], 2)),
        ("woff", woff, torch.int32, (n_keys,)),
        ("qcodes", qcodes, torch.int32, (n_max, 2)),
        ("qtags", qtags, torch.int32, (n_max,)),
        ("qoff", qoff, torch.int32, (n_keys,)),
        ("planes", planes, torch.int32, (planes.shape[0], 4))])
    if not (1 <= width <= 24 and 0 <= lo_bit <= 64 - width and 1 <= k <= 32):
        raise ValueError(f"join_bits: bad part bits [{lo_bit}, {lo_bit} + "
                         f"{width}) or k={k}")
    if planes.data_ptr() % 16 or planes.shape[0] < n_max:
        raise ValueError("join_bits: planes must be 16-B aligned with a row "
                         "for every query")
    lib = _lib()
    with torch.cuda.device(wcodes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qm2t_hamming_join_bits(
            wcodes.data_ptr(), woff.data_ptr(), qcodes.data_ptr(),
            qtags.data_ptr(), qoff[-1:].data_ptr(), n_max, planes.data_ptr(),
            lo_bit, width, k, stream)
    build.check(lib, rc, "join_bits")
    join_bits.launches += 1


join_bits.launches = 0
