"""Single-gather bucket dictionary table — the 1-random-op probe layout.

The count path's table: a probe is ONE 64-B row read (on the card, four
16-B loads in csrc/count_mono.cu):

  * ONE hash (DJB low bits) selects a 64 B bucket row of C=8 entries x
    (hi, lo) u32 pairs — 8 B/entry, no rank field;
  * depth accumulates in SLOT order (bucket*8 + entry), so the scatter
    index falls out of the compare — the slot -> genome-rank permutation
    is applied ONCE at finish, not per k-mer;
  * keys that overflow their bucket at build time (load 0.5 at C=8 =
    Poisson(4) occupancy: ~0.9% of keys) go to a SIDE two-choice packed
    table. A query can only belong to the side table if its bucket is
    FULL (the key overflowed from a full bucket), so the kernel flags
    `unresolved = miss & bucket_full` lanes (~a few % of lanes at
    realistic hit rates) and the caller recounts just those against the
    side table — host numpy at streaming time (the lanes are rare).

Memory: n/4 buckets x 64 B = 16 B/k-mer + side table for ~1% of keys.
The build is the JAX package's, so the arrays are identical
(tests/test_torch_count.py), including the k-mer-0 / empty-slot quirk
Q3 masking.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quickmer2_tpu_torch.device import u32

ENTRIES = 8
ROW_WIDTH = 2 * ENTRIES          # 16 u32 = 64 B


@dataclasses.dataclass
class MonoTable:
    rows: np.ndarray             # u32[B, 16]
    n_buckets: int
    n_kmers: int
    slot_rank: np.ndarray        # u32[B*8]: slot -> rank (n_kmers = hole)
    side: "object | None"        # PackedTable over overflow keys, or None
    side_rank: np.ndarray | None  # u32[n_side]: side local rank -> rank

    @classmethod
    def build(cls, khi: np.ndarray, klo: np.ndarray,
              rank: np.ndarray | None = None, load: float = 0.5,
              ) -> "MonoTable":
        """khi/klo (+optional rank payload) per dictionary k-mer. load
        is entries used / entries available (λ = 8*load per bucket)."""
        from quickmer2_tpu_torch.ops.hash import djb_pair_np
        from quickmer2_tpu_torch.ops.packed_table import PackedTable
        n = len(khi)
        if rank is None:
            rank = np.arange(n, dtype=np.uint32)
        rank = np.asarray(rank, np.uint32)
        n_buckets = 1 << max(1, int(np.ceil(np.log2(
            max(n, 1) / (ENTRIES * load)))))
        h = djb_pair_np(khi, klo)
        b = (h & np.uint32(n_buckets - 1)).astype(np.int64)
        order = np.argsort(b, kind="stable")
        bs = b[order]
        first = np.ones(n, bool)
        first[1:] = bs[1:] != bs[:-1]
        start = np.maximum.accumulate(np.where(first, np.arange(n), 0))
        entry = np.arange(n) - start          # in-bucket arrival index
        fits = entry < ENTRIES
        slot = bs[fits] * ENTRIES + entry[fits]
        keep = order[fits]
        rows = np.zeros((n_buckets, ROW_WIDTH), np.uint32)
        flat = rows.reshape(-1, 2)
        flat[slot, 0] = khi[keep]
        flat[slot, 1] = klo[keep]
        slot_rank = np.full(n_buckets * ENTRIES, n, np.uint32)
        slot_rank[slot] = rank[keep]

        spill = order[~fits]
        side = side_rank = None
        if len(spill):
            side = PackedTable.build(
                khi[spill], klo[spill],
                rank=np.arange(len(spill), dtype=np.uint32))
            side_rank = rank[spill]
        return cls(rows, n_buckets, n, slot_rank, side, side_rank)

    @classmethod
    def from_dictionary(cls, dic, load: float = 0.5) -> "MonoTable":
        from quickmer2_tpu_torch.ops import codec
        khi, klo = codec.split_u64(dic.kmers_in_order)
        return cls.build(khi, klo)

    @property
    def n_slots(self) -> int:
        return self.n_buckets * ENTRIES

    def side_lookup_np(self, khi: np.ndarray, klo: np.ndarray):
        """Host probe of the side table: (found bool[N], rank u32[N]).
        Misses get rank n_kmers (the trash lane)."""
        out = np.full(len(khi), self.n_kmers, np.uint32)
        if self.side is None or len(khi) == 0:
            return np.zeros(len(khi), bool), out
        from quickmer2_tpu_torch.ops.hash import djb_pair_np
        from quickmer2_tpu_torch.ops.packed_table import (
            ENTRIES_PER_BUCKET, bucket_hashes)
        h = djb_pair_np(khi, klo)
        h1, h2 = bucket_hashes(h, self.side.n_buckets)
        found = np.zeros(len(khi), bool)
        local = np.zeros(len(khi), np.int64)
        for idx in (h1, h2):
            r = self.side.rows[idx.astype(np.int64)]
            for e in range(ENTRIES_PER_BUCKET):
                m = (r[:, 4 * e] == khi) & (r[:, 4 * e + 1] == klo)
                found |= m
                local[m] = r[m, 4 * e + 2]
        found &= (khi | klo) != 0
        out[found] = self.side_rank[local[found]]
        return found, out


def probe_mono(rows: torch.Tensor, khi: torch.Tensor, klo: torch.Tensor,
               n_buckets: int):
    """Plain PyTorch probe: ONE row gather per query. rows: word tensor
    [B, 16]; khi/klo: int64 u32 values. Returns (found bool[N],
    slot int64[N] — garbage on miss, unresolved bool[N] — miss in a full
    bucket, so the key may live in the side table)."""
    from quickmer2_tpu_torch.ops.hash import djb_pair
    h = djb_pair(khi, klo)
    i1 = h & (n_buckets - 1)
    r = u32(rows[i1])
    nonzero_q = (khi | klo) != 0
    found = torch.zeros(khi.shape, dtype=torch.bool, device=khi.device)
    ent = torch.zeros(khi.shape, dtype=torch.int64, device=khi.device)
    full = torch.ones(khi.shape, dtype=torch.bool, device=khi.device)
    for e in range(ENTRIES):
        m = nonzero_q & (r[:, 2 * e] == khi) & (r[:, 2 * e + 1] == klo)
        found = found | m
        ent = torch.where(m, e, ent)
        full = full & ((r[:, 2 * e] | r[:, 2 * e + 1]) != 0)
    slot = i1 * ENTRIES + ent
    unresolved = nonzero_q & ~found & full
    return found, slot, unresolved
