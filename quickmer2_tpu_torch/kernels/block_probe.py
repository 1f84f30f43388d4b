"""The block probe that K8b (kernels/count_flat.py::count_packed_block_step),
K12 (kernels/count_mono.py::count_packed_rows), K10 (kernels/
emit_member.py::member_scan, the whole table as one block) and K3a
(kernels/anchored.py::anchor_probes, with the entry's position) share:
the plain PyTorch side of csrc/block_probe.cuh::BlockProbe, and the
bitmap of a bucket block's displaced keys that gates its h2 read.

A key of the packed table sits in its h2 bucket only where its h1
bucket was full when it was placed, and a bucket never empties
(ops/packed_table.py::PackedTable.build). So the probe reads h2's row
only where h1's is not local, or is full and lacks the key, and the
key's bit is set in the bitmap of the block's displaced keys.
"""

from __future__ import annotations

import torch

from quickmer2_tpu_torch.device import U32, u32
from quickmer2_tpu_torch.kernels.neighbor_bits import FILTER_MULT
from quickmer2_tpu_torch.ops import packed_table
from quickmer2_tpu_torch.ops.hash import djb_pair, mul32


def block_displaced_filter(rows: torch.Tensor, n_buckets: int,
                           blk_lo: int) -> torch.Tensor:
    """The bitmap of a block's displaced keys, those that sit in their
    h2 bucket because h1's was full at build: u32 words [2^b / 32], at
    least 32 bits a displaced key and 1024 words, with bit (DJB *
    FILTER_MULT mod 2^32) >> (32 - b) set for each. It has no false
    negatives, so the probe reads h2's row only where a code's bit is
    set. Plain torch, once a block (rows: the block's [Bb, 8])."""
    from quickmer2_tpu_torch.kernels.count_mono import pack_lanes
    e = u32(rows.reshape(-1, 4))
    bucket = torch.arange(e.shape[0], device=rows.device) // 2 + blk_lo
    h = djb_pair(e[:, 0], e[:, 1])
    moved = ((e[:, 0] | e[:, 1]) != 0) & ((h & (n_buckets - 1)) != bucket)
    n_bits = max(15, (32 * int(moved.sum()) - 1).bit_length())
    flags = torch.zeros(1 << n_bits, dtype=torch.bool, device=rows.device)
    flags[mul32(h[moved], FILTER_MULT) >> (32 - n_bits)] = True
    return pack_lanes(flags, rows.dtype)


def maybe_displaced(h: torch.Tensor, displaced: torch.Tensor | None):
    """Whether each hash's bit is set in the bitmap (all set for None)."""
    if displaced is None:
        return torch.ones(h.shape, dtype=torch.bool, device=h.device)
    n_bits = (32 * displaced.shape[0]).bit_length() - 1
    i = mul32(h, FILTER_MULT) >> (32 - n_bits)
    return ((u32(displaced)[i >> 5] >> (i & 31)) & 1) != 0


def block_probe_plain(rows, chi, clo, displaced, *, n_buckets: int,
                      blk_lo: int, block_buckets: int):
    """BlockProbe in plain torch, for codes (chi, clo) (int64 u32
    values): h1's bucket where it is local, then h2's where it is local,
    the code's bit in `displaced` (block_displaced_filter; None: every
    local h2) is set and h1's row, where it is local, is full; code 0
    matches nothing. Returns (slot, rank, pos), int64: the local slot 2 *
    bucket + entry of the matching entry, its rank and its genome
    position (its fourth word; BlockProbe::probe_pos), slot -1 where
    none matches."""
    chi, clo = u32(chi), u32(clo)
    h = djb_pair(chi, clo)
    o1, o2 = ((b - blk_lo) & U32
              for b in packed_table.bucket_hashes_t(h, n_buckets))
    nz = (chi | clo) != 0
    c1 = nz & (o1 < block_buckets)
    r1 = rows[torch.where(c1, o1, 0)]
    full1 = (r1[:, :4] != 0).any(1) & (r1[:, 4:] != 0).any(1)
    slot = torch.full(chi.shape, -1, dtype=torch.int64, device=chi.device)
    rank = torch.zeros_like(slot)
    pos = torch.zeros_like(slot)
    # h2 first, so that h1's match is the one kept
    for o, cand in ((o2, nz & (o2 < block_buckets) & (full1 | ~c1)
                     & maybe_displaced(h, displaced)), (o1, c1)):
        r = u32(rows[torch.where(cand, o, 0)])
        for e in range(packed_table.ENTRIES_PER_BUCKET):
            m = cand & (r[:, 4 * e] == chi) & (r[:, 4 * e + 1] == clo)
            slot = torch.where(m, 2 * o + e, slot)
            rank = torch.where(m, r[:, 4 * e + 2], rank)
            pos = torch.where(m, r[:, 4 * e + 3], pos)
    return slot, rank, pos
