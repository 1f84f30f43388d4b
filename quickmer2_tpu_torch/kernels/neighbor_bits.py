"""Single-substitution neighbor sweep: the CUDA kernels of
csrc/neighbor_bits.cu (K4 and its key filter) and their plain PyTorch
versions.

`neighbor_bits` replaces quickmer2_tpu/ops/anchored.py::
_neighbor_bits_kernel: over one genome chunk u8[n] (bases 0-3,
separators >= 4) it returns u8[n] where bit b of byte e is set iff
substituting base b at position e inside a valid k-window gives a
canonical k-mer in the packed table. It reads the table only for the
probes that pass `key_filter`'s words, a blocked Bloom filter over the
table's keys (three bits of one u32 word per key, chosen from the DJB
hash the probe computes anyway; no false negatives, so the result is
the unfiltered sweep's). ops.anchored.build_neighbor_bits_device builds
the filter once and runs the sweep chunk by chunk; the host builder
ops.anchored.build_neighbor_bits gives the same bytes.

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel, or raises.
"""

from __future__ import annotations

import ctypes

import torch

from quickmer2_tpu_torch.device import store, u32, word_dtype
from quickmer2_tpu_torch.kernels import build
from quickmer2_tpu_torch.ops import codec
from quickmer2_tpu_torch.ops.hash import djb_pair, mul32
from quickmer2_tpu_torch.ops.packed_table import (
    H2_MULT, ROW_WIDTH, bucket_hashes_t, probe_packed)

FILTER_MULT = 0x85EBCA77          # csrc/packed_probe.cuh kFilterMult
FILTER_BITS_PER_KEY = 8
MIN_FILTER_WORDS = 1 << 5         # 1 Kib
MAX_FILTER_WORDS = 1 << 23        # 32 MB: stays in the H100's 50 MB L2

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_longlong, ctypes.c_void_p])
_FILTER_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_void_p]


def filter_words_for(n_keys: int) -> int:
    """Words of the key filter for n_keys keys: the least power of two
    that gives FILTER_BITS_PER_KEY bits a key, within [MIN_FILTER_WORDS,
    MAX_FILTER_WORDS]."""
    n = MIN_FILTER_WORDS
    while n < MAX_FILTER_WORDS and 32 * n < FILTER_BITS_PER_KEY * n_keys:
        n <<= 1
    return n


def filter_slots(h: torch.Tensor, n_words: int):
    """(word index, the three bit positions) of DJB hashes h (int64 u32
    values) in a filter of n_words words (a power of two)."""
    word = mul32(h, int(H2_MULT)) >> (32 - (n_words.bit_length() - 1))
    p = mul32(h, FILTER_MULT)
    return word, [(p >> s) & 31 for s in (27, 22, 17)]


def key_filter_plain(rows: torch.Tensor, *, n_words: int) -> torch.Tensor:
    """Plain PyTorch version: set each non-empty entry's three bits,
    then pack the bit map into u32 words (word storage dtype of rows'
    device)."""
    r = u32(rows).view(-1, 4)
    live = (r[:, 0] | r[:, 1]) != 0
    word, positions = filter_slots(djb_pair(r[live, 0], r[live, 1]), n_words)
    flags = torch.zeros(n_words, 32, dtype=torch.bool, device=rows.device)
    for pos in positions:
        flags[word, pos] = True
    out = torch.zeros(n_words, dtype=torch.int64, device=rows.device)
    for b in range(32):
        out |= flags[:, b].to(torch.int64) << b
    return store(out, word_dtype(rows.device))


def key_filter(rows: torch.Tensor, *, n_buckets: int,
               n_words: int) -> torch.Tensor:
    """The key filter of a packed table, u32 words [n_words]."""
    if rows.device.type == "cpu":
        return key_filter_plain(rows, n_words=n_words)
    build.check_tensors("key_filter", rows.device, [
        ("rows", rows, torch.int32, (n_buckets, ROW_WIDTH))])
    if n_words not in [1 << b for b in range(5, 24)]:
        raise ValueError(f"key_filter: bad filter size {n_words} words")
    filt = torch.zeros(n_words, dtype=torch.int32, device=rows.device)
    lib = build.load("neighbor_bits")
    lib.qm2t_key_filter.argtypes = _FILTER_ARGTYPES
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qm2t_key_filter(rows.data_ptr(), n_buckets, filt.data_ptr(),
                                 n_words.bit_length() - 1, stream)
    build.check(lib, rc, "key_filter")
    key_filter.launches += 1
    return filt


key_filter.launches = 0


def filter_pass(filt: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """bool: the filter holds every bit of hashes h (int64 u32 values)."""
    word, positions = filter_slots(h, filt.shape[0])
    got = u32(filt)[word]
    return ((got >> positions[0]) & (got >> positions[1])
            & (got >> positions[2]) & 1) != 0


def _set2(hi, lo, sh: int, val):
    """Set the 2-bit field at bit offset sh (even, so it never straddles
    the words) of a u64 held as (hi, lo) int64 u32 values."""
    if sh < 32:
        return hi, (lo & ~(3 << sh)) | (val << sh)
    return (hi & ~(3 << (sh - 32))) | (val << (sh - 32)), lo


def neighbor_bits_plain(codes: torch.Tensor, rows: torch.Tensor,
                        filt: torch.Tensor, *, n_buckets: int, k: int,
                        trace: dict | None = None) -> torch.Tensor:
    """Plain PyTorch version: for each offset i and substitution delta
    d = 1..3, mutate every window to base (b + d) & 3, canonicalize,
    probe, and OR the hits into the byte of position window + i. It
    probes every mutation; `filt` is read only with a `trace` dict,
    which records the probes of valid windows, how many pass the filter,
    the table rows those name (for bounds and pass rates) and the hits
    the filter would drop (`missed`, 0 for a filter without false
    negatives)."""
    n = codes.shape[0]
    out = torch.zeros(n, dtype=torch.int64, device=codes.device)
    if n < k:
        return out.to(torch.uint8)
    N = n - k + 1
    fhi, flo, rhi, rlo, valid = codec.sliding_fwd_rc(codes, k)
    c64 = codes.to(torch.int64)
    if trace is not None:
        touched = torch.zeros(n_buckets, dtype=torch.bool,
                              device=codes.device)
        trace.update(probes=3 * k * int(valid.sum()), passed=0, missed=0)
    for i in range(k):
        base_i = c64[i:i + N]
        hits = torch.zeros(N, dtype=torch.int64, device=codes.device)
        for d in range(1, 4):
            nb = (base_i + d) & 3
            mfh, mfl = _set2(fhi, flo, 2 * (k - 1 - i), nb)
            mrh, mrl = _set2(rhi, rlo, 2 * i, (nb + 2) & 3)
            fwd_less = (mfh < mrh) | ((mfh == mrh) & (mfl <= mrl))
            chi = torch.where(fwd_less, mfh, mrh)
            clo = torch.where(fwd_less, mfl, mrl)
            found, _, _ = probe_packed(rows, chi, clo, n_buckets, 0)
            if trace is not None:
                h = djb_pair(chi, clo)
                passed = filter_pass(filt, h) & valid
                for b in bucket_hashes_t(h[passed], n_buckets):
                    touched[b] = True
                trace["passed"] += int(passed.sum())
                trace["missed"] += int((found & valid & ~passed).sum())
            hits |= torch.where(found & valid,
                                torch.ones_like(nb) << nb, 0)
        out[i:i + N] |= hits
    if trace is not None:
        trace["rows_touched"] = int(touched.sum())
    return out.to(torch.uint8)


def neighbor_bits(codes: torch.Tensor, rows: torch.Tensor,
                  filt: torch.Tensor, *, n_buckets: int,
                  k: int) -> torch.Tensor:
    """Neighbor-hit byte per position of one chunk, u8[n]; filt is
    key_filter(rows)."""
    if codes.device.type == "cpu":
        return neighbor_bits_plain(codes, rows, filt, n_buckets=n_buckets,
                                   k=k)
    n, n_words = codes.shape[0], filt.shape[0]
    build.check_tensors("neighbor_bits", codes.device, [
        ("codes", codes, torch.uint8, (n,)),
        ("rows", rows, torch.int32, (n_buckets, ROW_WIDTH)),
        ("filt", filt, torch.int32, (n_words,))])
    if not 1 <= k <= 32 or n < k:
        raise ValueError(f"neighbor_bits: bad k={k} for {n} bases")
    if n_words not in [1 << b for b in range(5, 24)]:
        raise ValueError(f"neighbor_bits: bad filter size {n_words} words")
    out = torch.zeros(-(-n // 4), dtype=torch.int32, device=codes.device)
    lib = build.load("neighbor_bits")
    lib.qm2t_neighbor_bits.argtypes = _ARGTYPES
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qm2t_neighbor_bits(codes.data_ptr(), rows.data_ptr(),
                                    filt.data_ptr(), n_words.bit_length() - 1,
                                    out.data_ptr(), n, k, n_buckets, stream)
    build.check(lib, rc, "neighbor_bits")
    neighbor_bits.launches += 1
    return out.view(torch.uint8)[:n]


neighbor_bits.launches = 0
