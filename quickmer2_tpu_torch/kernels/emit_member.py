"""The search's pass-2 membership scan: the CUDA kernel
csrc/emit_member.cu (K10) and its plain PyTorch version.

`member_scan` replaces quickmer2_tpu/parallel/emit_parallel.py::
_member_chunk: for each window of one genome chunk (`n_bases` codes
packed by ops.rowpack.pack_rows as one row, the flat batch layout K2,
K7, K8 and K9 read), whether its canonical k-mer is a valid, nonzero
member of a packed table (ops.packed_table). The result is the hit mask
bit-packed: bit i & 31 of word i >> 5 for window i, a word tensor of
ceil((n_bases - k + 1) / 32) words (`unpack_mask` gives the bools).

The probe is the block probe of K8b and K12 (kernels.block_probe) with
the whole table as one block: h2's row is read only where h1's is full
and lacks the code and the code's bit is set in `displaced`, the
table's block_displaced_filter, which the caller builds once. On the
card the windows are binned by the slice of their h1 bucket and probed
slice by slice (`member_partitions_for`), through one scratch buffer a
device, grown to the largest chunk seen.

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel, or raises. The wrapper counts its own launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from quickmer2_tpu_torch.device import store, to_numpy_u32, word_dtype
from quickmer2_tpu_torch.kernels import build
from quickmer2_tpu_torch.kernels.block_probe import block_probe_plain
from quickmer2_tpu_torch.kernels.count_flat import batch_windows, check_batch
from quickmer2_tpu_torch.ops.packed_table import ROW_WIDTH

_ARGTYPES = {"qm2t_member_scan": [ctypes.c_void_p] * 4 + [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]}

# rows of one probed slice: at 2^25 buckets 8 MB slices (P = 128) ran
# faster than 4, 16 and 32 MB on the H100 (PERF.md section 6)
MEMBER_SLICE_BYTES = 8 << 20
MAX_PARTS = 256                 # csrc/block_bins.cuh's kMaxParts


def mask_words(n_windows: int) -> int:
    return -(-n_windows // 32)


def pack_mask(hit: torch.Tensor) -> torch.Tensor:
    """bool[n] → bit-packed word tensor (bit i & 31 of word i >> 5)."""
    n = hit.numel()
    pad = torch.zeros(mask_words(n) * 32, dtype=torch.int64,
                      device=hit.device)
    pad[:n] = hit.to(torch.int64)
    weights = torch.arange(32, device=hit.device)
    words = (pad.view(-1, 32) << weights).sum(1)
    return store(words, word_dtype(hit.device))


def unpack_mask(words: torch.Tensor, n: int) -> np.ndarray:
    """Bit-packed word tensor → host bool[n]."""
    raw = to_numpy_u32(words).astype("<u4").view(np.uint8)
    return np.unpackbits(raw, bitorder="little")[:n].astype(bool)


def member_partitions_for(n_buckets: int) -> int:
    """The scan's slice count P: the least power of two that cuts the
    table's 32-B rows into slices of at most MEMBER_SLICE_BYTES, at most
    MAX_PARTS and at most n_buckets."""
    p = 1
    while (p < min(MAX_PARTS, n_buckets)
           and n_buckets * 4 * ROW_WIDTH // p > MEMBER_SLICE_BYTES):
        p <<= 1
    return p


def member_scan_plain(pk, bits, rows, *, k: int, n_buckets: int,
                      n_bases: int, displaced=None) -> torch.Tensor:
    """Plain PyTorch version: unpack, codec.sliding_kmers, the block
    probe over the whole table (block_probe_plain with `displaced`;
    None: every h2 behind a full h1 that lacks the code), found & valid
    & nonzero, then pack the mask."""
    chi, clo, valid = batch_windows(pk, bits, k, n_bases)
    slot, _, _ = block_probe_plain(rows, chi, clo, displaced,
                                   n_buckets=n_buckets, blk_lo=0,
                                   block_buckets=n_buckets)
    return pack_mask((slot >= 0) & valid)


def member_scan(pk: torch.Tensor, bits: torch.Tensor, rows: torch.Tensor, *,
                k: int, n_buckets: int, n_bases: int,
                displaced: torch.Tensor | None = None) -> torch.Tensor:
    """The bit-packed hit mask of the chunk's n_bases - k + 1 windows.
    displaced: the table's block_probe.block_displaced_filter(rows,
    n_buckets, 0), built once by the caller (required on the card)."""
    if pk.device.type == "cpu":
        return member_scan_plain(pk, bits, rows, k=k, n_buckets=n_buckets,
                                 n_bases=n_bases, displaced=displaced)
    mask = _member_scan_launch(pk, bits, rows, displaced, k=k,
                               n_buckets=n_buckets, n_bases=n_bases,
                               n_parts=member_partitions_for(n_buckets))
    member_scan.launches += 1
    return mask


def _member_scan_launch(pk, bits, rows, displaced, *, k: int,
                        n_buckets: int, n_bases: int,
                        n_parts: int) -> torch.Tensor:
    """K10 on CUDA tensors at P = n_parts slices of the table (a slice
    count other than member_partitions_for's is for timing it);
    member_scan's launch, which it alone counts."""
    if displaced is None:
        raise ValueError("member_scan: the table's displaced-key bitmap is "
                         "required on the card")
    n_words = displaced.shape[0]
    check_batch("member_scan", pk, bits, k, n_bases, [
        ("rows", rows, torch.int32, (n_buckets, ROW_WIDTH)),
        ("displaced", displaced, torch.int32, (n_words,))])
    if n_buckets < 1 or n_buckets > 1 << 31 or n_buckets & (n_buckets - 1):
        raise ValueError(f"member_scan: bad n_buckets {n_buckets}")
    if n_words < 1 or n_words & (n_words - 1) or n_words > 1 << 27:
        raise ValueError(f"member_scan: bad bitmap of {n_words} words")
    if (n_parts < 1 or n_parts > min(MAX_PARTS, n_buckets)
            or n_parts & (n_parts - 1)):
        raise ValueError(f"member_scan: bad slice count {n_parts}")
    n = n_bases - k + 1
    mask = torch.empty(mask_words(n), dtype=torch.int32, device=pk.device)
    work = _workspace(pk.device, n)
    lib = build.load("emit_member", _ARGTYPES)
    with torch.cuda.device(pk.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qm2t_member_scan(
            pk.data_ptr(), bits.data_ptr(), rows.data_ptr(),
            displaced.data_ptr(), (32 * n_words).bit_length() - 1,
            mask.data_ptr(), n_bases, k, n_buckets, n_parts,
            work.data_ptr(), stream)
    build.check(lib, rc, "member_scan")
    return mask


def _workspace(device: torch.device, n: int) -> torch.Tensor:
    """The scan's scratch for n windows at up to MAX_PARTS slices: the
    runs (2 B a window of each 4096-window tile) and the tiles' P + 1
    run offsets; one a device, grown to the largest chunk seen (a
    genome's chromosome tails are chunks of many sizes)."""
    tiles = -(-n // 4096)
    size = 2 * tiles * 4096 + 4 * tiles * (MAX_PARTS + 1)
    if device not in _work or _work[device].numel() < size:
        _work[device] = torch.empty(size, dtype=torch.uint8, device=device)
    return _work[device]


_work: dict = {}

member_scan.launches = 0
