"""The anchored read pass: the CUDA kernel csrc/anchored.cu (K3) and its
plain PyTorch version.

`anchored_count` replaces quickmer2_tpu/ops/anchored.py::
anchored_count_kernel as `_anchored_count_kernel_packed` runs it: one
batch of 2-bit packed read rows (ops.rowpack.pack_batch, "lens" or
"mask") against the anchored index (packed table rows, genome tiles,
dblock). Clean runs of every read that is not spilled become range-adds
into `diff` (u32 words, updated in place; depth = cumsum at finish);
returns the spill code per read as int8: 0 counted, 1 spilled (tier 2
may rescue it), 2 spilled and unanchorable. The branch follows the
JAX function's keywords:
  dirty_run_width > 0             tier 2, run-sliced dirty probes;
  neighbor_mode and max_dirty 0   tier 1, neighbor-bit discard;
  otherwise                       tier 1, up to max_dirty point probes.

Under a dict-sharded table (the JAX function's dict_axis) `rows` is one
bucket block [blk_lo, blk_lo + block_buckets) and the read pass is two
launches around a sum: `anchor_probes` (K3a) probes each read's anchor
windows in the block, the caller sums found and pos over the blocks in
block order (the JAX psum), and `anchored_count(..., anchors=(found,
pos))` votes on the sums, probes its dirty windows in the block only,
and adds the clean runs only where `ranges` is set (the first block).

`anchored_count_plain` repeats the JAX function op for op (including
fetch_genome_window's clamped tile gathers and roll), on word tensors of
either storage (device.py). A tensor on the CPU takes the plain version;
a CUDA tensor launches the kernel, or raises.
"""

from __future__ import annotations

import ctypes

import torch

from quickmer2_tpu_torch.device import U32, popcount32, store, u32
from quickmer2_tpu_torch.kernels import build
from quickmer2_tpu_torch.ops import codec, rowpack
from quickmer2_tpu_torch.ops.packed_table import (
    ROW_WIDTH, bucket_hashes_t, probe_packed_block)

GBLK = 64          # genome tile width (bases)
DBLK = 64          # prefix-count block size (positions per dblock row)
BRANCHES = {"neighbor": 0, "point": 1, "runs": 2}

_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_longlong, ctypes.c_void_p,
                                      ctypes.c_longlong, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_longlong,
                                      ctypes.c_void_p]
             + [ctypes.c_int] * 13 + [ctypes.c_void_p])
# qm2t_anchored_block: qm2t_anchored's, with the block, the summed anchors
# and `ranges` after n_buckets
_BLOCK_ARGTYPES = (_ARGTYPES[:5] + [ctypes.c_longlong] * 2
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] + _ARGTYPES[5:])
_PROBE_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])


def branch_of(max_dirty: int, dirty_run_width: int,
              neighbor_mode: bool) -> str:
    if dirty_run_width > 0:
        return "runs"
    if neighbor_mode and max_dirty == 0:
        return "neighbor"
    return "point"


def rank_at(dblock: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """R(q) = number of dictionary end positions <= q, as int64 (q:
    int64 positions, clamped to [0, G-1] by the caller). One dblock row
    [rank_base, mask_hi, mask_lo, 0] per DBLK positions."""
    row = u32(dblock[q // DBLK])
    b = q % DBLK
    ones = torch.full_like(b, U32)
    in_hi = b >= 32
    lo_keep = torch.where(in_hi, ones, ones >> (31 - torch.clamp(b, max=31)))
    hi_keep = torch.where(in_hi, ones >> (63 - torch.clamp(b, min=32)), 0)
    return (row[..., 0] + popcount32(row[..., 2] & lo_keep)
            + popcount32(row[..., 1] & hi_keep)) & U32


def fetch_genome_window(tiles: torch.Tensor, start: torch.Tensor,
                        width: int) -> torch.Tensor:
    """Genome bytes [start, start + width) per lane from u8[T, GBLK]
    tiles, as the JAX function gathers them: rows from the clamped tile
    start, then a circular shift by the clamped offset. Lanes whose
    window leaves the genome get the same garbage the JAX version
    returns (callers mask them). Returns u8[N, width]."""
    ntiles = tiles.shape[0]
    n_rows = width // GBLK + 2
    t0 = torch.clamp(torch.div(start, GBLK, rounding_mode="floor"),
                     0, ntiles - 1)
    r = torch.arange(n_rows, device=start.device)
    idx = torch.clamp(t0[:, None] + r[None, :], 0, ntiles - 1)
    buf = tiles[idx].reshape(start.shape[0], n_rows * GBLK)
    off = torch.clamp(start - t0 * GBLK, 0, GBLK)
    cols = (torch.arange(width, device=start.device)[None, :]
            + off[:, None]) % (n_rows * GBLK)
    return buf.gather(1, cols)


def _first_runs(start_m, end_m, n: int, width: int):
    """Up to n (start, end) pairs of the runs marked by start/end masks
    over a row of `width` lanes, -1 where absent (the JAX min-scan)."""
    jidx = torch.arange(width, device=start_m.device)[None, :]
    starts, ends = [], []
    for _ in range(n):
        s = torch.where(start_m, jidx, width).min(1).values
        e = torch.where(end_m & (jidx >= s[:, None]), jidx, width).min(1).values
        got = s < width
        starts.append(torch.where(got, s, -1))
        ends.append(torch.where(got, e, -1))
        start_m = start_m & (jidx > s[:, None])
        end_m = end_m & (jidx > e[:, None])
    shape = (start_m.shape[0], 0)
    if not starts:
        empty = torch.zeros(shape, dtype=torch.int64, device=start_m.device)
        return empty, empty
    return torch.stack(starts, 1), torch.stack(ends, 1)


def _pad_left(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x.new_zeros(x.shape[0], 1), x], 1)


def _read_windows(pk, aux, fmt: str, k: int, read_len: int):
    """The rows unpacked, and (chi, clo, valid) of their windows [R, W]."""
    reads = rowpack.unpack_batch(fmt, pk, aux, read_len=read_len)
    R, L = reads.shape
    W = L - k + 1
    chi_f, clo_f, valid_f = codec.sliding_kmers(reads.reshape(-1), k)

    def rowwise(a):
        out = a.new_zeros(R * L)
        out[:a.shape[0]] = a
        return out.view(R, L)[:, :W]
    return reads, rowwise(chi_f), rowwise(clo_f), rowwise(valid_f)


def _anchor_probes(rows, chi, clo, valid, offs, n_buckets, blk_lo,
                   block_buckets):
    """found bool[A, R] and pos int64[A, R] of the anchor windows in the
    block: found only where the window is valid, pos 0 where not found."""
    fs, ps = [], []
    for j in offs:
        f, _, p = probe_packed_block(rows, chi[:, j], clo[:, j], n_buckets,
                                     block_buckets, blk_lo, 0)
        f = f & valid[:, j]
        fs.append(f)
        ps.append(torch.where(f, p, 0))
    return torch.stack(fs), torch.stack(ps)


def anchor_probes_plain(pk, aux, rows, *, fmt: str, k: int, read_len: int,
                        n_buckets: int, anchor_offsets, blk_lo: int,
                        block_buckets: int):
    """Plain PyTorch version of K3a: (found u8[A, R], pos u32 words [A,
    R])."""
    _, chi, clo, valid = _read_windows(pk, aux, fmt, k, read_len)
    found, pos = _anchor_probes(rows, chi, clo, valid,
                                [int(a) for a in anchor_offsets], n_buckets,
                                blk_lo, block_buckets)
    return found.to(torch.uint8), store(pos, rows.dtype)


def anchored_count_plain(pk, aux, rows, tiles, dblock, diff, *, fmt: str,
                         k: int, read_len: int, n_buckets: int,
                         anchor_offsets, max_runs: int = 4,
                         max_dirty: int = 8, max_dirty_runs: int = 0,
                         dirty_run_width: int = 0,
                         neighbor_mode: bool = False, anchors=None,
                         blk_lo: int = 0, block_buckets: int = 0,
                         ranges: bool = True,
                         trace: dict | None = None) -> torch.Tensor:
    """Plain PyTorch version of the anchored read pass. With `anchors`
    (found, pos) summed over the blocks, rows is the block [blk_lo,
    blk_lo + block_buckets) and `ranges` says whether it adds the clean
    runs. With a `trace` dict it also records the indices of the table
    rows, genome tiles, dblock rows and diff words that the batch needs
    (for bounds)."""
    reads, chi, clo, valid = _read_windows(pk, aux, fmt, k, read_len)
    dev = reads.device
    R, L = reads.shape
    W = L - k + 1
    n_diff = diff.shape[0]
    trash = n_diff - 1
    branch = branch_of(max_dirty, dirty_run_width, neighbor_mode)
    block_buckets = block_buckets or n_buckets

    def probe(qhi, qlo, miss_rank):
        return probe_packed_block(rows, qhi, qlo, n_buckets, block_buckets,
                                  blk_lo, miss_rank)

    # -- anchoring and the majority vote ---------------------------------
    offs = [int(j) for j in anchor_offsets]
    offs_t = torch.tensor(offs, dtype=torch.int64, device=dev)
    if anchors is None:
        fstk, pstk = _anchor_probes(rows, chi, clo, valid, offs, n_buckets,
                                    blk_lo, block_buckets)
    else:
        fstk = anchors[0].to(torch.bool)
        pstk = torch.where(fstk, u32(anchors[1]), 0)
    av = torch.stack([fstk[i] & valid[:, j] for i, j in enumerate(offs)])
    p_i32 = pstk - ((pstk >> 31) << 32)          # the JAX int32 cast
    s_cand = p_i32 - (k - 1) - offs_t[:, None]
    g_cand = p_i32 + offs_t[:, None]
    okj = av[None, :, :]
    agree_f = (okj & (s_cand[None, :, :] == s_cand[:, None, :])).sum(1)
    agree_r = (okj & (g_cand[None, :, :] == g_cand[:, None, :])).sum(1)
    score = torch.where(av, torch.maximum(agree_f, agree_r), 0)
    best = torch.argmax(score, 0)                 # first maximum
    a_found = av.any(0)
    a_pos = p_i32.gather(0, best[None, :])[0]
    a_off = offs_t[best]

    # -- genome windows, both strands --------------------------------------
    G = tiles.shape[0] * GBLK
    s_f = a_pos - (k - 1) - a_off
    fwd_in_range = (s_f >= 0) & (s_f + L <= G)
    gwraw_f = fetch_genome_window(tiles, s_f, L)
    gwin_f = gwraw_f & 7
    match_f = ((reads == gwin_f) & (reads < 4) & (gwin_f < 4)
               & fwd_in_range[:, None])
    ge = a_pos + a_off
    rc_in_range = (ge - (L - 1) >= 0) & (ge < G)
    gflip = fetch_genome_window(tiles, ge - (L - 1), L).flip(1)
    gflip_c = gflip & 7
    gwin_rc = torch.where(gflip_c < 4, (gflip_c + 2) & 3, 4).to(torch.uint8)
    match_r = ((reads == gwin_rc) & (reads < 4) & (gwin_rc < 4)
               & rc_in_range[:, None])
    use_fwd = match_f.sum(1) >= match_r.sum(1)
    match = torch.where(use_fwd[:, None], match_f, match_r)

    # -- clean windows, clean runs, dirty windows --------------------------
    csz = _pad_left(torch.cumsum((~match).to(torch.int64), 1))
    clean = (csz[:, k:] - csz[:, :-k]) == 0
    clean = clean & valid & a_found[:, None]
    false_col = torch.zeros(R, 1, dtype=torch.bool, device=dev)
    prev = torch.cat([false_col, clean[:, :-1]], 1)
    nxt = torch.cat([clean[:, 1:], false_col], 1)
    run_start, run_end = clean & ~prev, clean & ~nxt
    n_runs = run_start.sum(1)
    dirty = valid & ~clean
    n_dirty = dirty.sum(1)
    anyvalid = valid.any(1)

    # -- the spill decision ----------------------------------------------------
    if branch == "runs":
        dprev = torch.cat([false_col, dirty[:, :-1]], 1)
        dnxt = torch.cat([dirty[:, 1:], false_col], 1)
        n_dirty_runs = (dirty & ~dprev).sum(1)
        d_starts, d_ends = _first_runs(dirty & ~dprev, dirty & ~dnxt,
                                       max_dirty_runs, W)
        widths_ok = torch.where(d_starts >= 0,
                                d_ends - d_starts < dirty_run_width,
                                True).all(1)
        covered = (n_dirty_runs <= max_dirty_runs) & widths_ok
        unanch = ~a_found & anyvalid
        spilled = unanch | (n_runs > max_runs) | ~covered
    elif branch == "neighbor":
        in_range = torch.where(use_fwd, fwd_in_range, rc_in_range)
        g_raw = torch.where(use_fwd[:, None], gwraw_f, gflip)
        g_code = g_raw & 7
        g_nb = (g_raw >> 3) & 15
        b_gen = torch.where(use_fwd[:, None], reads & 3, (reads + 2) & 3)
        t = torch.arange(L, device=dev)
        hi_c = torch.clamp(t + 1, max=W)
        lo_c = torch.clamp(t - k + 1, 0, W)
        csv = _pad_left(torch.cumsum(valid.to(torch.int64), 1))
        cov = (csv[:, hi_c] - csv[:, lo_c]) > 0
        mm_any = ~match & cov
        base_ok = (reads < 4) & (g_code < 4)
        mm_sub = mm_any & base_ok
        mm_bad = (mm_any & ~base_ok).any(1)
        csm = _pad_left(torch.cumsum(mm_sub.to(torch.int64), 1))
        mm_close = ((csm[:, hi_c] - csm[:, lo_c]) >= 2).any(1)
        nb_hit = (mm_sub & (((g_nb >> b_gen) & 1) != 0)).any(1)
        unanch = anyvalid & (~a_found | ~in_range)
        spilled = unanch | (n_runs > max_runs) | mm_bad | mm_close | nb_hit
    else:
        unanch = ~a_found & anyvalid
        spilled = unanch | (n_runs > max_runs) | (n_dirty > max_dirty)
    active = ~spilled

    # -- clean runs → range-adds -------------------------------------------
    starts, ends = _first_runs(run_start & active[:, None],
                               run_end & active[:, None], max_runs, W)
    q_start = torch.where(use_fwd[:, None], s_f[:, None] + starts + (k - 1),
                          ge[:, None] - ends)
    q_end = torch.where(use_fwd[:, None], s_f[:, None] + ends + (k - 1),
                        ge[:, None] - starts)
    run_ok = (starts >= 0) & ranges
    q_lo = torch.clamp(q_start - 1, 0, G - 1)
    q_hi = torch.clamp(q_end, 0, G - 1)
    lo_r = torch.where(q_start <= 0, 0, rank_at(dblock, q_lo))
    hi_r = rank_at(dblock, q_hi)
    lo_i = torch.where(run_ok, lo_r, trash).reshape(-1)
    hi_i = torch.where(run_ok, hi_r, trash).reshape(-1)
    acc = torch.zeros(n_diff, dtype=torch.int64, device=dev)

    def add(idx, val):
        acc.index_add_(0, idx, torch.full(idx.shape, val, dtype=torch.int64,
                                          device=dev))
    add(lo_i, 1)
    add(hi_i, -1)

    # -- dirty k-mers → exact probes ---------------------------------------
    probed_hi, probed_lo, points = [], [], []
    if branch == "runs":
        P = 1
        while P < W:
            P <<= 1
        chi_p = torch.cat([chi, chi.new_zeros(R, P - W)], 1)
        clo_p = torch.cat([clo, clo.new_zeros(R, P - W)], 1)
        off_l = torch.arange(dirty_run_width, device=dev)[None, :]
        for m in range(max_dirty_runs):
            s = d_starts[:, m]
            exists = (s >= 0) & active
            sc = torch.clamp(s, min=0)
            cols = (sc[:, None] + off_l) % P
            ahi, alo = chi_p.gather(1, cols), clo_p.gather(1, cols)
            lane_ok = exists[:, None] & (off_l <= (d_ends[:, m] - sc)[:, None])
            f, r, _ = probe(ahi.reshape(-1), alo.reshape(-1), trash)
            point = torch.where(lane_ok.reshape(-1) & f, r, trash)
            add(point, 1)
            add(torch.clamp(point + 1, max=trash), -1)
            probed_hi.append(ahi[lane_ok])
            probed_lo.append(alo[lane_ok])
            points.append(point)
    else:
        dm = dirty & active[:, None]
        jidx = torch.arange(W, device=dev)[None, :]
        for _ in range(max_dirty):
            j = torch.where(dm, jidx, W).min(1).values
            got = j < W
            jc = torch.clamp(j, max=W - 1)[:, None]
            dhi, dlo = chi.gather(1, jc)[:, 0], clo.gather(1, jc)[:, 0]
            f, r, _ = probe(dhi, dlo, trash)
            point = torch.where(got & f, r, trash)
            add(point, 1)
            add(torch.clamp(point + 1, max=trash), -1)
            dm = dm & (jidx > j[:, None])
            probed_hi.append(dhi[got])
            probed_lo.append(dlo[got])
            points.append(point)
    diff.copy_(store(u32(diff) + acc, diff.dtype))

    if trace is not None:
        # what the batch must touch: the rows of every real probe, the
        # tiles under every in-range window of an anchored read, the
        # dblock rows of every range-add and every diff word it changes
        hs, ls = [chi[:, j][av[i]] for i, j in enumerate(offs)], \
            [clo[:, j][av[i]] for i, j in enumerate(offs)]
        qh = torch.cat(hs + probed_hi)
        ql = torch.cat(ls + probed_lo)
        from quickmer2_tpu_torch.ops.hash import djb_pair
        h1, h2 = bucket_hashes_t(djb_pair(qh, ql), n_buckets)
        trace["probe_rows"] = torch.cat([h1, h2])
        tiles_of = []
        for lo, ok in ((s_f, fwd_in_range), (ge - (L - 1), rc_in_range)):
            sel = lo[ok & a_found]
            span = torch.arange(-(-L // GBLK) + 1, device=dev)
            ti = sel[:, None] // GBLK + span[None, :]
            tiles_of.append(ti[ti <= (sel[:, None] + L - 1) // GBLK])
        trace["tiles"] = torch.cat(tiles_of)
        trace["dblock_rows"] = torch.cat([q_lo[run_ok & (q_start > 0)],
                                          q_hi[run_ok]]) // DBLK
        trace["diff_words"] = torch.nonzero(acc != 0).flatten()
        trace["probes"] = int(qh.shape[0])
    code = torch.where(spilled, torch.where(unanch, 2, 1), 0)
    return code.to(torch.int8)


def anchored_count(pk: torch.Tensor, aux: torch.Tensor, rows: torch.Tensor,
                   tiles: torch.Tensor, dblock: torch.Tensor,
                   diff: torch.Tensor, *, fmt: str, k: int, read_len: int,
                   n_buckets: int, anchor_offsets, max_runs: int = 4,
                   max_dirty: int = 8, max_dirty_runs: int = 0,
                   dirty_run_width: int = 0, neighbor_mode: bool = False,
                   anchors=None, blk_lo: int = 0, block_buckets: int = 0,
                   ranges: bool = True) -> torch.Tensor:
    """One batch of packed read rows into `diff` (in place); returns the
    spill codes int8[R]. With `anchors` (found u8[A, R], pos words [A,
    R], summed over the blocks) rows is the block [blk_lo, blk_lo +
    block_buckets) of a dict-sharded table, and the clean runs are added
    only where `ranges` is set. `.launches` counts the kernel's launches,
    `.branch_launches` the same launches by branch and `.block_launches`
    those with given anchors."""
    kw = dict(fmt=fmt, k=k, read_len=read_len, n_buckets=n_buckets,
              anchor_offsets=anchor_offsets, max_runs=max_runs,
              max_dirty=max_dirty, max_dirty_runs=max_dirty_runs,
              dirty_run_width=dirty_run_width, neighbor_mode=neighbor_mode)
    block_buckets = block_buckets or n_buckets
    if pk.device.type == "cpu":
        return anchored_count_plain(pk, aux, rows, tiles, dblock, diff,
                                    anchors=anchors, blk_lo=blk_lo,
                                    block_buckets=block_buckets,
                                    ranges=ranges, **kw)
    R, L = pk.shape[0], read_len
    W = L - k + 1
    offs = [int(a) for a in anchor_offsets]
    aux_shape, aux_dtype = rowpack.aux_layout(fmt, R, L)
    n_tiles = tiles.shape[0]
    specs = [("pk", pk, torch.uint8, (R, -(-L // 4))),
             ("aux", aux, aux_dtype, aux_shape),
             ("rows", rows, torch.int32, (block_buckets, ROW_WIDTH)),
             ("tiles", tiles, torch.uint8, (n_tiles, GBLK)),
             ("dblock", dblock, torch.int32, (dblock.shape[0], 4)),
             ("diff", diff, torch.int32, (diff.shape[0],))]
    if anchors is not None:
        specs += [("found", anchors[0], torch.uint8, (len(offs), R)),
                  ("pos", anchors[1], torch.int32, (len(offs), R))]
    build.check_tensors("anchored_count", pk.device, specs)
    if (fmt not in ("lens", "mask") or not 1 <= k <= 32 or not 1 <= W
            or L > 1024 or R < 1 or not 1 <= len(offs) <= 4
            or not all(0 <= a < W for a in offs)
            or dblock.shape[0] < n_tiles or diff.shape[0] < 2
            or not 0 <= blk_lo <= n_buckets - block_buckets):
        raise ValueError(
            f"anchored_count: bad shapes or options (fmt={fmt!r}, k={k}, "
            f"read_len={read_len}, rows={R}, anchors={offs}, block "
            f"[{blk_lo}, {blk_lo} + {block_buckets}) of {n_buckets})")
    code = torch.empty(R, dtype=torch.int8, device=pk.device)
    padded = offs + [0] * (4 - len(offs))
    branch = branch_of(max_dirty, dirty_run_width, neighbor_mode)
    lib = build.load("anchored", {"qm2t_anchored": _ARGTYPES,
                                  "qm2t_anchored_block": _BLOCK_ARGTYPES,
                                  "qm2t_anchor_probes": _PROBE_ARGTYPES})
    rest = (tiles.data_ptr(), n_tiles * GBLK, dblock.data_ptr(),
            diff.data_ptr(), diff.shape[0], code.data_ptr(), R, L, k,
            len(offs), *padded, max_runs, max_dirty, max_dirty_runs,
            dirty_run_width, BRANCHES[branch])
    with torch.cuda.device(pk.device):
        stream = torch.cuda.current_stream().cuda_stream
        if anchors is None:
            rc = lib.qm2t_anchored(pk.data_ptr(), aux.data_ptr(),
                                   int(fmt == "lens"), rows.data_ptr(),
                                   n_buckets, *rest, stream)
        else:
            rc = lib.qm2t_anchored_block(
                pk.data_ptr(), aux.data_ptr(), int(fmt == "lens"),
                rows.data_ptr(), n_buckets, blk_lo, block_buckets,
                anchors[0].data_ptr(), anchors[1].data_ptr(), int(ranges),
                *rest, stream)
    build.check(lib, rc, "anchored_count")
    anchored_count.launches += 1
    anchored_count.branch_launches[branch] += 1
    if anchors is not None:
        anchored_count.block_launches += 1
    return code


anchored_count.launches = 0
anchored_count.branch_launches = dict.fromkeys(BRANCHES, 0)
anchored_count.block_launches = 0


def anchor_probes(pk: torch.Tensor, aux: torch.Tensor, rows: torch.Tensor, *,
                  fmt: str, k: int, read_len: int, n_buckets: int,
                  anchor_offsets, blk_lo: int, block_buckets: int):
    """K3a: the anchor windows of one batch of packed read rows probed in
    the bucket block `rows` ([blk_lo, blk_lo + block_buckets) of
    n_buckets): (found u8[A, R], pos words [A, R]), found only where the
    window is valid, pos 0 where not found."""
    if pk.device.type == "cpu":
        return anchor_probes_plain(pk, aux, rows, fmt=fmt, k=k,
                                   read_len=read_len, n_buckets=n_buckets,
                                   anchor_offsets=anchor_offsets,
                                   blk_lo=blk_lo,
                                   block_buckets=block_buckets)
    R, L = pk.shape[0], read_len
    W = L - k + 1
    offs = [int(a) for a in anchor_offsets]
    aux_shape, aux_dtype = rowpack.aux_layout(fmt, R, L)
    build.check_tensors("anchor_probes", pk.device, [
        ("pk", pk, torch.uint8, (R, -(-L // 4))),
        ("aux", aux, aux_dtype, aux_shape),
        ("rows", rows, torch.int32, (block_buckets, ROW_WIDTH))])
    if (fmt not in ("lens", "mask") or not 1 <= k <= 32 or not 1 <= W
            or L > 1024 or R < 1 or not 1 <= len(offs) <= 4
            or not all(0 <= a < W for a in offs)
            or not 0 <= blk_lo <= n_buckets - block_buckets):
        raise ValueError(
            f"anchor_probes: bad shapes or options (fmt={fmt!r}, k={k}, "
            f"read_len={read_len}, rows={R}, anchors={offs})")
    found = torch.empty(len(offs), R, dtype=torch.uint8, device=pk.device)
    pos = torch.empty(len(offs), R, dtype=torch.int32, device=pk.device)
    padded = offs + [0] * (4 - len(offs))
    lib = build.load("anchored", {"qm2t_anchored": _ARGTYPES,
                                  "qm2t_anchored_block": _BLOCK_ARGTYPES,
                                  "qm2t_anchor_probes": _PROBE_ARGTYPES})
    with torch.cuda.device(pk.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qm2t_anchor_probes(
            pk.data_ptr(), aux.data_ptr(), int(fmt == "lens"),
            rows.data_ptr(), n_buckets, blk_lo, block_buckets,
            found.data_ptr(), pos.data_ptr(), R, L, k, len(offs), *padded,
            stream)
    build.check(lib, rc, "anchor_probes")
    anchor_probes.launches += 1
    return found, pos


anchor_probes.launches = 0
