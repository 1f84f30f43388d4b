"""Single-substitution neighbor sweep: the CUDA kernel
csrc/neighbor_bits.cu (K4) and its plain PyTorch version.

`neighbor_bits` replaces quickmer2_tpu/ops/anchored.py::
_neighbor_bits_kernel: over one genome chunk u8[n] (bases 0-3,
separators >= 4) it returns u8[n] where bit b of byte e is set iff
substituting base b at position e inside a valid k-window gives a
canonical k-mer in the packed table. ops.anchored.build_neighbor_bits_
device runs it chunk by chunk; the host builder
ops.anchored.build_neighbor_bits gives the same bytes.

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel, or raises.
"""

from __future__ import annotations

import ctypes

import torch

from quickmer2_tpu_torch.kernels import build
from quickmer2_tpu_torch.ops import codec
from quickmer2_tpu_torch.ops.hash import djb_pair
from quickmer2_tpu_torch.ops.packed_table import (
    ROW_WIDTH, bucket_hashes_t, probe_packed)

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_longlong, ctypes.c_void_p]


def _set2(hi, lo, sh: int, val):
    """Set the 2-bit field at bit offset sh (even, so it never straddles
    the words) of a u64 held as (hi, lo) int64 u32 values."""
    if sh < 32:
        return hi, (lo & ~(3 << sh)) | (val << sh)
    return (hi & ~(3 << (sh - 32))) | (val << (sh - 32)), lo


def neighbor_bits_plain(codes: torch.Tensor, rows: torch.Tensor, *,
                        n_buckets: int, k: int,
                        trace: dict | None = None) -> torch.Tensor:
    """Plain PyTorch version: for each offset i and substitution delta
    d = 1..3, mutate every window to base (b + d) & 3, canonicalize,
    probe, and OR the hits into the byte of position window + i. With a
    `trace` dict it also records the probes of valid windows and the
    table rows they touch (for bounds)."""
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
        trace["probes"] = 3 * k * int(valid.sum())
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
                for b in bucket_hashes_t(djb_pair(chi[valid], clo[valid]),
                                         n_buckets):
                    touched[b] = True
            hits |= torch.where(found & valid, torch.ones_like(nb) << nb, 0)
        out[i:i + N] |= hits
    if trace is not None:
        trace["rows_touched"] = int(touched.sum())
    return out.to(torch.uint8)


def neighbor_bits(codes: torch.Tensor, rows: torch.Tensor, *,
                  n_buckets: int, k: int) -> torch.Tensor:
    """Neighbor-hit byte per position of one chunk, u8[n]."""
    if codes.device.type == "cpu":
        return neighbor_bits_plain(codes, rows, n_buckets=n_buckets, k=k)
    n = codes.shape[0]
    build.check_tensors("neighbor_bits", codes.device, [
        ("codes", codes, torch.uint8, (n,)),
        ("rows", rows, torch.int32, (n_buckets, ROW_WIDTH))])
    if not 1 <= k <= 32 or n < k:
        raise ValueError(f"neighbor_bits: bad k={k} for {n} bases")
    out = torch.zeros(-(-n // 4), dtype=torch.int32, device=codes.device)
    lib = build.load("neighbor_bits")
    lib.qm2t_neighbor_bits.argtypes = _ARGTYPES
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qm2t_neighbor_bits(codes.data_ptr(), rows.data_ptr(),
                                    out.data_ptr(), n, k, n_buckets, stream)
    build.check(lib, rc, "neighbor_bits")
    neighbor_bits.launches += 1
    return out.view(torch.uint8)[:n]


neighbor_bits.launches = 0
