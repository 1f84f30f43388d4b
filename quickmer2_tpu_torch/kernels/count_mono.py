"""Fused mono-table count steps: the CUDA kernels of csrc/count_mono.cu
(K2 over a flat batch, K2r over read rows) and their plain PyTorch
versions.

`count_mono_step` replaces quickmer2_tpu/pipelines/count.py::
count_step_mono_pk. It takes one batch of `n_bases` 2-bit codes (the
ops.rowpack layout, one row = the batch), adds 1 to depth[slot] for
every valid window whose canonical k-mer sits in the mono table, and
returns the unresolved-lane mask (valid & nonzero & miss & bucket full)
as LSB-first u32 words: lane i is bit i & 31 of word i >> 5. On the card
a table larger than L2 is probed slice by slice (`partitions_for`),
through a scratch buffer cached per device and batch size.

`count_mono_rows` replaces quickmer2_tpu/ops/anchored.py::
exact_count_rows_mono_packed, the anchored path's exact recount: the same
step over R read rows of width read_len (ops.rowpack.pack_batch layout,
"lens" or "mask"), windows that cross a row end masked, the unresolved
mask over the R*W window lanes (W = read_len - k + 1), LSB-first u32
words. On the card it probes in one pass, 512 lanes a block.

`count_packed_rows` (K12) replaces quickmer2_tpu/ops/anchored.py::
exact_count_rows (as exact_count_rows_packed runs it, and under a dict
axis): the exact recount of read rows through the PACKED table, or one
bucket block of it, adding 1 to a plain-count accumulator at the rank of
every valid window found there. K2r's row-window map with the block probe.

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel, or raises.
"""

from __future__ import annotations

import ctypes

import torch

from quickmer2_tpu_torch.device import store
from quickmer2_tpu_torch.kernels import build
from quickmer2_tpu_torch.ops import codec, monotable, rowpack
from quickmer2_tpu_torch.ops.packed_table import ROW_WIDTH

_ARGTYPES = {
    "qm2t_count_mono": [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p],
    "qm2t_count_mono_rows": [ctypes.c_void_p] * 2 + [ctypes.c_int] + [
        ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p],
    "qm2t_exact_rows_packed": [ctypes.c_void_p] * 2 + [ctypes.c_int,
        ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]}
SLICE_BYTES = 24 << 20     # table + depth bytes of one probed slice
MAX_PARTS = 256
_work: dict = {}


def slice_count(n_units: int, unit_bytes: int) -> int:
    """The least power of two P for which a slice of n_units / P table
    units of unit_bytes each (table and depth bytes) fits SLICE_BYTES,
    at most 256 and at most n_units."""
    p = 1
    while (p < min(MAX_PARTS, n_units)
           and n_units * unit_bytes // p > SLICE_BYTES):
        p <<= 1
    return p


def partitions_for(n_buckets: int) -> int:
    """K2's slice count P: rows and depth words are 96 B a bucket."""
    return slice_count(n_buckets,
                       4 * (monotable.ROW_WIDTH + monotable.ENTRIES))


def workspace(device: torch.device, n: int) -> torch.Tensor:
    """The sliced kernels' scratch for n windows, u32[2 * 256 + 64 +
    n]: slice totals, fills, the sliced K7 and K8 calls' 64 hit counters,
    and bins; one per device and window count, reused by every batch of
    that size (K2, K7 and K8 alike: calls on one stream run in turn)."""
    key = (device, n)
    if key not in _work:
        _work[key] = torch.empty(2 * MAX_PARTS + 64 + n, dtype=torch.int32,
                                 device=device)
    return _work[key]


def pack_lanes(flags: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """bool[n] → LSB-first u32 words [ceil(n/32)] in word storage dtype."""
    n = flags.shape[0]
    padded = torch.zeros(-(-n // 32) * 32, dtype=torch.int64,
                         device=flags.device)
    padded[:n] = flags.to(torch.int64)
    shifts = torch.arange(32, device=flags.device)
    return store((padded.view(-1, 32) << shifts).sum(1), dtype)


def count_mono_step_plain(pk, bits, rows, depth, *, k: int, n_buckets: int,
                          n_bases: int) -> torch.Tensor:
    """Plain PyTorch version: unpack, kmerize, probe, add, pack."""
    codes = rowpack.unpack_rows(pk[None], bits[None], read_len=n_bases)[0]
    chi, clo, valid = codec.sliding_kmers(codes, k)
    found, slot, unresolved = monotable.probe_mono(rows, chi, clo, n_buckets)
    hit = slot[valid & found]
    depth.index_add_(0, hit, torch.ones(hit.shape, dtype=depth.dtype,
                                        device=depth.device))
    return pack_lanes(valid & unresolved, depth.dtype)


def count_mono_step(pk: torch.Tensor, bits: torch.Tensor, rows: torch.Tensor,
                    depth: torch.Tensor, *, k: int, n_buckets: int,
                    n_bases: int) -> torch.Tensor:
    """One batch into `depth` (slot order, updated in place); returns the
    unresolved-lane mask words."""
    if pk.device.type == "cpu":
        return count_mono_step_plain(pk, bits, rows, depth, k=k,
                                     n_buckets=n_buckets, n_bases=n_bases)
    mask = count_mono_launch(pk, bits, rows, depth, k=k, n_buckets=n_buckets,
                             n_bases=n_bases,
                             n_parts=partitions_for(n_buckets))
    count_mono_step.launches += 1
    return mask


def count_mono_launch(pk, bits, rows, depth, *, k: int, n_buckets: int,
                      n_bases: int, n_parts: int) -> torch.Tensor:
    """K2 on CUDA tensors at P = n_parts slices (1: the one-pass kernel);
    count_mono_step's launch, which it alone counts."""
    n = n_bases - k + 1
    build.check_tensors("count_mono_step", pk.device, [
        ("pk", pk, torch.uint8, (-(-n_bases // 4),)),
        ("bits", bits, torch.uint8, (-(-n_bases // 8),)),
        ("rows", rows, torch.int32, (n_buckets, 2 * monotable.ENTRIES)),
        ("depth", depth, torch.int32, (n_buckets * monotable.ENTRIES + 1,))])
    if not 1 <= k <= 32 or n <= 0:
        raise ValueError(f"count_mono_step: bad k={k} for {n_bases} bases")
    if (pk.data_ptr() | bits.data_ptr()) & 7:
        raise ValueError("count_mono_step: pk and bits must be 8-byte aligned")
    work = workspace(pk.device, n) if n_parts > 1 else None
    mask = torch.empty(-(-n // 32), dtype=torch.int32, device=pk.device)
    lib = build.load("count_mono", _ARGTYPES)
    with torch.cuda.device(pk.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qm2t_count_mono(pk.data_ptr(), bits.data_ptr(),
                                 rows.data_ptr(), depth.data_ptr(),
                                 mask.data_ptr(), n_bases, k, n_buckets,
                                 n_parts, None if work is None
                                 else work.data_ptr(), stream)
    build.check(lib, rc, "count_mono")
    return mask


count_mono_step.launches = 0


def row_windows(pk, aux, *, fmt: str, k: int, read_len: int):
    """(chi, clo, valid) of every window j < W = read_len - k + 1 of every
    row, flat in row order (lane r * W + j), by the plain codec."""
    reads = rowpack.unpack_batch(fmt, pk, aux, read_len=read_len)
    R, L = reads.shape
    W = L - k + 1
    chi, clo, valid = codec.sliding_kmers(reads.reshape(-1), k)

    def rowwise(a):
        out = a.new_zeros(R * L)
        out[:a.shape[0]] = a
        return out.view(R, L)[:, :W].reshape(-1)
    return rowwise(chi), rowwise(clo), rowwise(valid)


def count_mono_rows_plain(pk, aux, rows, depth, *, fmt: str, k: int,
                          n_buckets: int, read_len: int) -> torch.Tensor:
    """Plain PyTorch version: unpack the rows, kmerize the flat stream,
    keep the windows inside a row, probe, add, pack."""
    chi, clo, valid = row_windows(pk, aux, fmt=fmt, k=k, read_len=read_len)
    found, slot, unresolved = monotable.probe_mono(rows, chi, clo, n_buckets)
    hit = slot[valid & found]
    depth.index_add_(0, hit, torch.ones(hit.shape, dtype=depth.dtype,
                                        device=depth.device))
    return pack_lanes(valid & unresolved, depth.dtype)


def count_mono_rows(pk: torch.Tensor, aux: torch.Tensor, rows: torch.Tensor,
                    depth: torch.Tensor, *, fmt: str, k: int, n_buckets: int,
                    read_len: int) -> torch.Tensor:
    """One batch of read rows into `depth` (slot order, updated in
    place); returns the unresolved-lane mask words over the R*W lanes."""
    if pk.device.type == "cpu":
        return count_mono_rows_plain(pk, aux, rows, depth, fmt=fmt, k=k,
                                     n_buckets=n_buckets, read_len=read_len)
    R, L = pk.shape[0], read_len
    W = L - k + 1
    aux_shape, aux_dtype = rowpack.aux_layout(fmt, R, L)
    build.check_tensors("count_mono_rows", pk.device, [
        ("pk", pk, torch.uint8, (R, -(-L // 4))),
        ("aux", aux, aux_dtype, aux_shape),
        ("rows", rows, torch.int32, (n_buckets, 2 * monotable.ENTRIES)),
        ("depth", depth, torch.int32, (n_buckets * monotable.ENTRIES + 1,))])
    if fmt not in ("lens", "mask") or not 1 <= k <= 32 or W < 1 or R < 1:
        raise ValueError(f"count_mono_rows: bad fmt={fmt!r} k={k} "
                         f"read_len={read_len} rows={R}")
    if (pk.data_ptr() | aux.data_ptr()) & 7:
        raise ValueError("count_mono_rows: pk and aux must be 8-byte aligned")
    mask = torch.empty(-(-(R * W) // 32), dtype=torch.int32, device=pk.device)
    lib = build.load("count_mono", _ARGTYPES)
    with torch.cuda.device(pk.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qm2t_count_mono_rows(
            pk.data_ptr(), aux.data_ptr(), int(fmt == "lens"),
            rows.data_ptr(), depth.data_ptr(), mask.data_ptr(), R, L, k,
            n_buckets, stream)
    build.check(lib, rc, "count_mono_rows")
    count_mono_rows.launches += 1
    return mask


count_mono_rows.launches = 0


def count_packed_rows_plain(pk, aux, rows, acc, *, fmt: str, k: int,
                            n_buckets: int, read_len: int, blk_lo: int = 0,
                            block_buckets: int | None = None) -> None:
    """Plain PyTorch version: the windows of the rows, probed in the
    block, and 1 added at the rank of each valid one found."""
    from quickmer2_tpu_torch.ops.packed_table import probe_packed_block
    chi, clo, valid = row_windows(pk, aux, fmt=fmt, k=k, read_len=read_len)
    found, rank, _ = probe_packed_block(
        rows, chi, clo, n_buckets, block_buckets or n_buckets, blk_lo, 0)
    hit = rank[valid & found]
    acc.index_add_(0, hit, torch.ones(hit.shape, dtype=acc.dtype,
                                      device=acc.device))


def count_packed_rows(pk: torch.Tensor, aux: torch.Tensor, rows: torch.Tensor,
                      acc: torch.Tensor, *, fmt: str, k: int, n_buckets: int,
                      read_len: int, blk_lo: int = 0,
                      block_buckets: int | None = None) -> None:
    """One batch of read rows into the plain-count accumulator `acc` u32
    (rank order, updated in place), probed against `rows`: the packed
    table's buckets [blk_lo, blk_lo + block_buckets) (default: the whole
    table of n_buckets)."""
    block_buckets = block_buckets or n_buckets
    if pk.device.type == "cpu":
        count_packed_rows_plain(pk, aux, rows, acc, fmt=fmt, k=k,
                                n_buckets=n_buckets, read_len=read_len,
                                blk_lo=blk_lo, block_buckets=block_buckets)
        return
    R, L = pk.shape[0], read_len
    W = L - k + 1
    aux_shape, aux_dtype = rowpack.aux_layout(fmt, R, L)
    build.check_tensors("count_packed_rows", pk.device, [
        ("pk", pk, torch.uint8, (R, -(-L // 4))),
        ("aux", aux, aux_dtype, aux_shape),
        ("rows", rows, torch.int32, (block_buckets, ROW_WIDTH)),
        ("acc", acc, torch.int32, (acc.shape[0],))])
    if (fmt not in ("lens", "mask") or not 1 <= k <= 32 or W < 1 or R < 1
            or not 0 <= blk_lo <= n_buckets - block_buckets):
        raise ValueError(f"count_packed_rows: bad fmt={fmt!r} k={k} "
                         f"read_len={read_len} rows={R} block [{blk_lo}, "
                         f"{blk_lo} + {block_buckets}) of {n_buckets}")
    if (pk.data_ptr() | aux.data_ptr()) & 7:
        raise ValueError("count_packed_rows: pk and aux must be 8-byte "
                         "aligned")
    lib = build.load("count_mono", _ARGTYPES)
    with torch.cuda.device(pk.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qm2t_exact_rows_packed(
            pk.data_ptr(), aux.data_ptr(), int(fmt == "lens"),
            rows.data_ptr(), n_buckets, blk_lo, block_buckets,
            acc.data_ptr(), R, L, k, stream)
    build.check(lib, rc, "count_packed_rows")
    count_packed_rows.launches += 1


count_packed_rows.launches = 0
