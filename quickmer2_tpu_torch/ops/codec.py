"""K-mer codec: 2-bit base encoding, reverse complement, canonicalization,
and bulk sliding-window k-mer extraction.

Encoding parity with the reference (QuicKmer.c:43-64):
  base code = (ascii >> 1) & 3  →  A=0, C=1, T=2, G=3
  complement(code) = (code - 2) & 3  (A↔T, C↔G)
  k-mer code = bases packed MSB-first into the low 2k bits of a u64
  canonical  = min(forward, reverse-complement)   [exact for all k here;
               the reference is exact only at k=30 — SURVEY.md Q1]

Two implementations:
  * host path  — numpy uint64, used by file IO, dictionary build, tests
  * device path — plain PyTorch over (hi, lo) u32 word pairs carried in
    int64 tensors (device.py); the CUDA count kernel
    (csrc/count_mono.cu) inlines the same arithmetic per window.

A "sequence stream" is a uint8 code array where values 0..3 are bases and
SEP (>=4) marks invalid positions: N bases, record separators, padding.
A window of k codes yields a k-mer iff it contains no SEP — this single
rule reproduces the reference's per-line rolling-state reset in count
(QuicKmer.c:399-402, SURVEY.md Q4) and the '>'/N resets in search
(QuicKmer.c:826-852) once the host packer inserts separators at the
right places.
"""

from __future__ import annotations

import numpy as np
import torch

# Code for any non-ACGT byte in a packed sequence stream.
SEP = np.uint8(4)

# 256-entry byte → 2-bit-code lookup; non-ACGT(acgt) maps to SEP.
_BASE_LUT = np.full(256, SEP, dtype=np.uint8)
for _b in b"ACGTacgt":
    _BASE_LUT[_b] = (_b >> 1) & 3

_CODE_TO_BASE = np.frombuffer(b"ACTG", dtype=np.uint8)  # code 0,1,2,3


def encode_bases(seq: bytes | np.ndarray) -> np.ndarray:
    """ASCII sequence → uint8 code array (0..3, SEP for non-ACGT)."""
    buf = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, (bytes, bytearray)) else seq
    return _BASE_LUT[buf]


def decode_kmer(code: int, k: int) -> str:
    """u64 k-mer code → ACGT string (MSB-first)."""
    out = bytearray(k)
    for i in range(k - 1, -1, -1):
        out[i] = _CODE_TO_BASE[code & 3]
        code >>= 2
    return out.decode()


def encode_kmer_string(s: str) -> int:
    """ACGT string → canonical u64 code (reference Kmer_encode semantics,
    exact reverse complement)."""
    codes = encode_bases(s.encode())
    if (codes >= 4).any():
        raise ValueError(f"non-ACGT base in k-mer {s!r}")
    k = len(codes)
    fwd = 0
    rc = 0
    for j, c in enumerate(codes):
        fwd = (fwd << 2) | int(c)
        rc |= ((int(c) - 2) & 3) << (2 * j)
    return min(fwd, rc) & ((1 << (2 * k)) - 1)


def revcomp_code(code: int, k: int) -> int:
    """Exact reverse complement of a 2k-bit k-mer code
    (reference Reverse_strand_encoded, QuicKmer.c:101-111)."""
    rc = 0
    for _ in range(k):
        rc = (rc << 2) | ((code - 2) & 3)
        code >>= 2
    return rc & ((1 << (2 * k)) - 1)


# ---------------------------------------------------------------------------
# Host bulk extraction (numpy, u64)
# ---------------------------------------------------------------------------

def sliding_fwd_rc_np(codes: np.ndarray, k: int):
    """Forward and reverse-complement codes of every sliding window
    (NOT canonicalized — callers needing per-strand bit surgery, e.g.
    the neighbor-hit index build, take min themselves).

    Returns (fwd u64[N], rc u64[N], valid bool[N]), N = len(codes)-k+1.
    Window i's base at offset j sits in fwd bits [2(k-1-j), 2(k-j)) and,
    complemented, in rc bits [2j, 2j+2).
    """
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64), np.zeros(0, bool)
    mask = np.uint64((1 << (2 * k)) - 1)
    fwd = np.zeros(n, np.uint64)
    rc = np.zeros(n, np.uint64)
    top = np.uint64(2 * (k - 1))
    for j in range(k):
        c = codes[j : j + n].astype(np.uint64) & np.uint64(3)
        fwd = ((fwd << np.uint64(2)) | c) & mask
        rcb = (c - np.uint64(2)) & np.uint64(3)
        rc = (rc >> np.uint64(2)) | (rcb << top)
    bad = (codes >= 4).astype(np.int32)
    cs = np.concatenate([[0], np.cumsum(bad)])
    valid = (cs[k:] - cs[:-k]) == 0
    return fwd, rc, valid


def sliding_kmers_np(codes: np.ndarray, k: int):
    """All sliding-window canonical k-mers of a code stream.

    Returns (canon u64[N], valid bool[N]) with N = len(codes) - k + 1.
    valid[i] is False if any of codes[i:i+k] is SEP.
    """
    fwd, rc, valid = sliding_fwd_rc_np(codes, k)
    return np.minimum(fwd, rc), valid


def split_u64(x: np.ndarray):
    """u64 array → (hi u32, lo u32)."""
    x = np.asarray(x, dtype=np.uint64)
    return (x >> np.uint64(32)).astype(np.uint32), (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def join_u64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)


# ---------------------------------------------------------------------------
# Device bulk extraction (plain PyTorch, u32 words in int64 tensors)
# ---------------------------------------------------------------------------

def sliding_fwd_rc(codes: torch.Tensor, k: int):
    """Sliding-window strand codes as (hi, lo) u32 word pairs (int64
    tensors), NOT canonicalized.

    codes: uint8[L] sequence stream (0..3 bases, >=4 separators).
    Returns (fhi, flo, rhi, rlo (int64[N] each), valid bool[N]),
    N = L - k + 1. Window i's base at offset j sits in fwd bits
    [2(k-1-j), 2(k-j)) and, complemented, in rc bits [2j, 2j+2).
    k <= 16 keeps every bit in lo (hi mask 0); k = 32 fills lo
    (lo mask 0xFFFFFFFF).
    """
    L = codes.shape[0]
    n = L - k + 1
    if n <= 0:
        raise ValueError("stream shorter than k")
    two_k = 2 * k
    lo_bits = min(32, two_k)
    hi_bits = max(0, two_k - 32)
    lo_mask = 0xFFFFFFFF if lo_bits == 32 else (1 << lo_bits) - 1
    hi_mask = (1 << hi_bits) - 1
    top = two_k - 2  # bit offset of the most significant base

    c64 = codes.to(torch.int64)
    fhi = torch.zeros(n, dtype=torch.int64, device=codes.device)
    flo = torch.zeros_like(fhi)
    rhi = torch.zeros_like(fhi)
    rlo = torch.zeros_like(fhi)
    for j in range(k):
        c = c64[j:j + n] & 3
        # forward: shift left 2, push c at LSB
        fhi = ((fhi << 2) | (flo >> 30)) & hi_mask
        flo = ((flo << 2) | c) & lo_mask
        # reverse: shift right 2, push complement at bit `top`
        rcb = (c - 2) & 3
        rlo = (rlo >> 2) | ((rhi & 3) << 30)
        rhi = rhi >> 2
        if top >= 32:
            rhi = rhi | (rcb << (top - 32))
        else:
            rlo = rlo | (rcb << top)

    bad = (codes >= 4).to(torch.int64)
    cs = torch.cat([torch.zeros(1, dtype=torch.int64, device=codes.device),
                    torch.cumsum(bad, 0)])
    valid = (cs[k:k + n] - cs[:n]) == 0
    return fhi, flo, rhi, rlo, valid


def sliding_kmers(codes: torch.Tensor, k: int):
    """Plain PyTorch version of sliding_kmers_np on (hi, lo) words.

    Returns (canon_hi, canon_lo (int64[N] u32 values), valid bool[N]),
    N = L - k + 1.
    """
    fhi, flo, rhi, rlo, valid = sliding_fwd_rc(codes, k)
    # canonical = lexicographic min over (hi, lo)
    fwd_less = (fhi < rhi) | ((fhi == rhi) & (flo <= rlo))
    chi = torch.where(fwd_less, fhi, rhi)
    clo = torch.where(fwd_less, flo, rlo)
    return chi, clo, valid
