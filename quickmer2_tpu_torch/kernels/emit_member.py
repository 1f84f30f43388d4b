"""The search's pass-2 membership scan: the CUDA kernel
csrc/emit_member.cu (K10) and its plain PyTorch version.

`member_scan` replaces quickmer2_tpu/parallel/emit_parallel.py::
_member_chunk: for each window of one genome chunk (`n_bases` codes
packed by ops.rowpack.pack_rows as one row, the flat batch layout K2,
K7, K8 and K9 read), whether its canonical k-mer is a valid, nonzero
member of a packed table (ops.packed_table). The result is the hit mask
bit-packed: bit i & 31 of word i >> 5 for window i, a word tensor of
ceil((n_bases - k + 1) / 32) words (`unpack_mask` gives the bools).

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel, or raises. The wrapper counts its own launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from quickmer2_tpu_torch.device import store, to_numpy_u32, word_dtype
from quickmer2_tpu_torch.kernels import build
from quickmer2_tpu_torch.kernels.count_flat import batch_windows, check_batch
from quickmer2_tpu_torch.ops.packed_table import ROW_WIDTH, probe_packed

_ARGTYPES = {"qm2t_member_scan": [ctypes.c_void_p] * 4 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]}


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


def member_scan_plain(pk, bits, rows, *, k: int, n_buckets: int,
                      n_bases: int) -> torch.Tensor:
    """Plain PyTorch version: unpack, codec.sliding_kmers, probe_packed,
    found & valid & nonzero, then pack the mask."""
    chi, clo, valid = batch_windows(pk, bits, k, n_bases)
    found, _, _ = probe_packed(rows, chi, clo, n_buckets, 0)
    return pack_mask(found & valid & ((chi | clo) != 0))


def member_scan(pk: torch.Tensor, bits: torch.Tensor, rows: torch.Tensor, *,
                k: int, n_buckets: int, n_bases: int) -> torch.Tensor:
    """The bit-packed hit mask of the chunk's n_bases - k + 1 windows."""
    if pk.device.type == "cpu":
        return member_scan_plain(pk, bits, rows, k=k, n_buckets=n_buckets,
                                 n_bases=n_bases)
    check_batch("member_scan", pk, bits, k, n_bases, [
        ("rows", rows, torch.int32, (n_buckets, ROW_WIDTH))])
    if n_buckets < 1 or n_buckets > 1 << 32 or n_buckets & (n_buckets - 1):
        raise ValueError(f"member_scan: bad n_buckets {n_buckets}")
    mask = torch.empty(mask_words(n_bases - k + 1), dtype=torch.int32,
                       device=pk.device)
    lib = build.load("emit_member", _ARGTYPES)
    with torch.cuda.device(pk.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qm2t_member_scan(pk.data_ptr(), bits.data_ptr(),
                                  rows.data_ptr(), mask.data_ptr(), n_bases,
                                  k, n_buckets, stream)
    build.check(lib, rc, "member_scan")
    member_scan.launches += 1
    return mask


member_scan.launches = 0
