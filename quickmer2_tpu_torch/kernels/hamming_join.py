"""Hamming-join compare chains: the CUDA kernels of csrc/hamming_join.cu
(K1 and K5) and their plain PyTorch versions.

`join_compare` (K1) replaces the slab loop of quickmer2_tpu/ops/
hamming_join.py::_part_chunk_join (and the Pallas prototype
tools/proto_join2d.py::kernel). Given one (part, word chunk)'s bucket
layouts it adds, for every live query lane, Σ occ(w)·(6/m) over the
bucket's word lanes w with 1 ≤ H(q, w) ≤ e into scaled[qidx] (u32,
wrapping).

`join_bits` (K5) replaces the slab loop of _part_chunk_join_bits: on the
same layouts, with a live flag in place of occ and a strand flag per
query lane, it ORs into planes[qidx, b] the bit j of every substitution
(window offset j, base b) that turns the query window into a word at
Hamming distance exactly 1. Layouts and terms are described in the CUDA
source.

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
_BITS_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong]
                  + [ctypes.c_int] * 4 + [ctypes.c_void_p])


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
    lib = build.load("hamming_join",
                     {"qm2t_hamming_join": _ARGTYPES,
                      "qm2t_hamming_join_bits": _BITS_ARGTYPES})
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


def _ctz_onehot(y: torch.Tensor) -> torch.Tensor:
    """Bit position of a one-hot u32 (int64 tensors): popcount(y - 1)."""
    return popcount32((y - 1) & 0xFFFFFFFF)


def join_bits_plain(dh, dl, dlive, qh, ql, qfw, qidx, planes, *, k: int,
                    n_buckets: int, cpad: int, cpad_q: int,
                    slab_pairs: int = 1 << 22) -> None:
    """Plain PyTorch version: the JAX slab loop over the buckets that
    hold at least one live query lane, in slabs of ≤ slab_pairs lane
    pairs. Within one call a query holds one lane, and distinct words
    give distinct (offset, base) bits, so a sum over the bucket's words
    is their OR."""
    nq = planes.shape[0] - 1
    qix_all = qidx[:n_buckets * cpad_q].view(n_buckets, cpad_q)
    buckets = torch.nonzero((qix_all != nq).any(1)).flatten()
    slab = max(1, slab_pairs // (cpad * cpad_q))
    words = [u32(a[:n_buckets * cpad]).view(n_buckets, cpad)
             for a in (dh, dl, dlive)]
    queries = [u32(a[:n_buckets * cpad_q]).view(n_buckets, cpad_q)
               for a in (qh, ql, qfw)]
    for s in range(0, buckets.shape[0], slab):
        b = buckets[s:s + slab]
        dhs, dls, dvs = (w[b][:, None, :] for w in words)
        qhs, qls, qfs = (q[b][:, :, None] for q in queries)
        yh = ((qhs ^ dhs) | ((qhs ^ dhs) >> 1)) & 0x55555555
        yl = ((qls ^ dls) | ((qls ^ dls) >> 1)) & 0x55555555
        ok = (popcount32(yh) + popcount32(yl) == 1) & (dvs != 0)
        in_lo = yl != 0
        sym = torch.where(in_lo, _ctz_onehot(yl) >> 1,
                          (_ctz_onehot(yh) >> 1) + 16)
        t = (torch.where(in_lo, dls, dhs) >> ((sym & 15) << 1)) & 3
        fwd = qfs != 0
        j = torch.where(fwd, k - 1 - sym, sym) & 31
        base = torch.where(fwd, t, (t - 2) & 3)
        bit = torch.where(ok, torch.ones_like(j) << j, 0)
        vals = torch.stack([torch.where(base == c, bit, 0).sum(2)
                            for c in range(4)], -1).view(-1, 4)
        qix = qix_all[b].flatten().to(torch.int64)
        live = qix != nq
        qix, vals = qix[live], vals[live]
        planes[qix] = store(u32(planes[qix]) | vals, planes.dtype)


def join_bits(dh: torch.Tensor, dl: torch.Tensor, dlive: torch.Tensor,
              qh: torch.Tensor, ql: torch.Tensor, qfw: torch.Tensor,
              qidx: torch.Tensor, planes: torch.Tensor, *, k: int,
              n_buckets: int, cpad: int, cpad_q: int) -> None:
    """OR one (part, word chunk)'s neighbor bits into `planes` (u32 word
    tensor [nq + 1, 4], in place)."""
    if dh.device.type == "cpu":
        join_bits_plain(dh, dl, dlive, qh, ql, qfw, qidx, planes, k=k,
                        n_buckets=n_buckets, cpad=cpad, cpad_q=cpad_q)
        return
    nd = (n_buckets * cpad + 1,)
    nql = (n_buckets * cpad_q + 1,)
    build.check_tensors("join_bits", dh.device, [
        ("dh", dh, torch.int32, nd), ("dl", dl, torch.int32, nd),
        ("dlive", dlive, torch.int32, nd), ("qh", qh, torch.int32, nql),
        ("ql", ql, torch.int32, nql), ("qfw", qfw, torch.int32, nql),
        ("qidx", qidx, torch.int32, nql),
        ("planes", planes, torch.int32, (planes.shape[0], 4))])
    if not (1 <= cpad <= 255 and 1 <= cpad_q <= 255 and 1 <= k <= 32):
        raise ValueError(f"join_bits: bad cpad={cpad} cpad_q={cpad_q} k={k}")
    lib = build.load("hamming_join",
                     {"qm2t_hamming_join": _ARGTYPES,
                      "qm2t_hamming_join_bits": _BITS_ARGTYPES})
    with torch.cuda.device(dh.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qm2t_hamming_join_bits(
            dh.data_ptr(), dl.data_ptr(), dlive.data_ptr(), qh.data_ptr(),
            ql.data_ptr(), qfw.data_ptr(), qidx.data_ptr(), planes.data_ptr(),
            n_buckets, cpad, cpad_q, planes.shape[0] - 1, k, stream)
    build.check(lib, rc, "join_bits")
    join_bits.launches += 1


join_bits.launches = 0
