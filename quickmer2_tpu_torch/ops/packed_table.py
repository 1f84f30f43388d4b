"""Packed bucketized two-choice dictionary table.

Two uses in the port: the mono table's SIDE table (ops.monotable), probed
on the host for the rare unresolved lanes, and the anchored path's
dictionary (ops.anchored), whose entries carry each k-mer's genome end
position. Layout, placement and probe semantics are the JAX package's
(quickmer2_tpu/ops/packed_table.py):

  * B buckets of C=2 entries; each bucket is one contiguous 32-B row of
    8 u32: [hi, lo, rank, pos] x 2;
  * every key lives in bucket h1(key) or h2(key) (two-choice placement,
    first-fit h1 at build time, deterministic cuckoo eviction for the
    rest, bucket count doubling on failure);
  * empty entries are (0,0) — k-mer code 0 is reserved (quirk Q3), so a
    query of 0 is masked and can never false-match an empty entry.

`probe_packed` is the plain PyTorch probe, and `probe_packed_block` the
same against one bucket block of a dict-sharded table; the CUDA kernels
inline both from csrc/packed_probe.cuh.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quickmer2_tpu_torch.device import u32

# 2 entries x (hi, lo, rank, pos) = 8 u32 = 32 B per bucket row;
# two-choice placement at load 0.5 with C=2 succeeds w.h.p. (doubling
# on the rare failure).
ENTRIES_PER_BUCKET = 2
ROW_WIDTH = 4 * ENTRIES_PER_BUCKET  # 8 u32 = 32 B

H2_MULT = np.uint32(2654435761)  # Knuth multiplicative hash
# Both candidate buckets derive from one DJB value, so at most
# 2 x ENTRIES_PER_BUCKET keys may share it; the doubling stops after
# MAX_DOUBLINGS.
MAX_SHARED_HASH = 2 * ENTRIES_PER_BUCKET
MAX_DOUBLINGS = 8


def bucket_hashes(h: np.ndarray, n_buckets: int):
    """Two bucket candidates from the DJB low-32 hash (h1 = same home
    bucket family as the reference's probe start; h2 decorrelated)."""
    h1 = h & np.uint32(n_buckets - 1)
    h2 = ((h * H2_MULT) >> np.uint32(7)) & np.uint32(n_buckets - 1)
    return h1, h2


def bucket_hashes_t(h: torch.Tensor, n_buckets: int):
    """bucket_hashes on int64 tensors of u32 values."""
    from quickmer2_tpu_torch.ops.hash import mul32
    prod = mul32(h, int(H2_MULT))
    return h & (n_buckets - 1), (prod >> 7) & (n_buckets - 1)


@dataclasses.dataclass
class PackedTable:
    rows: np.ndarray        # u32[B, 16]
    n_buckets: int
    n_kmers: int

    @classmethod
    def build(cls, khi: np.ndarray, klo: np.ndarray, rank: np.ndarray,
              pos: np.ndarray | None = None, load: float = 0.5) -> "PackedTable":
        """khi/klo/rank (+optional pos) per dictionary k-mer (any order).
        Raises ValueError when more than MAX_SHARED_HASH keys share one
        DJB value (no bucket count can place them: both candidates come
        from that value) or when MAX_DOUBLINGS doublings do not place
        every key.

        The table keeps an invariant that the block probe (kernels/
        block_probe.py, csrc/block_probe.cuh) relies on: a key sits in
        its h2 bucket only where its h1 bucket is full. A key goes to h2
        only when h1 has no room (_try_place), a cuckoo move puts its
        evicter in the place it leaves (_cuckoo_evict), and no entry is
        ever emptied. A change to the placement must keep it, or the
        probe would miss keys at h2 behind an h1 row with an empty
        entry."""
        from quickmer2_tpu_torch.ops.hash import djb_pair_np
        n = len(khi)
        if pos is None:
            pos = np.zeros(n, np.uint32)
        n_buckets = 1 << max(
            1, int(np.ceil(np.log2(max(n, 1) / (ENTRIES_PER_BUCKET * load)))))
        h = djb_pair_np(khi, klo)
        if n:
            shared = int(np.unique(h, return_counts=True)[1].max())
            if shared > MAX_SHARED_HASH:
                raise ValueError(
                    f"PackedTable.build: {shared} keys share one DJB hash; "
                    f"two-choice buckets of {ENTRIES_PER_BUCKET} entries "
                    f"hold at most {MAX_SHARED_HASH}")
        for _ in range(MAX_DOUBLINGS + 1):
            rows = _try_place(khi, klo, rank, pos, h, n_buckets)
            if rows is not None:
                return cls(rows, n_buckets, n)
            n_buckets <<= 1
        raise ValueError(
            f"PackedTable.build: {n} keys not placed after {MAX_DOUBLINGS} "
            f"doublings ({n_buckets >> 1} buckets)")

    @classmethod
    def from_dictionary(cls, dic, pos: np.ndarray | None = None,
                        load: float = 0.5) -> "PackedTable":
        """The table of a dictionary's k-mers, rank = genome order (the
        packed flat count's table, kernels.count_flat)."""
        from quickmer2_tpu_torch.ops import codec
        khi, klo = codec.split_u64(dic.kmers_in_order)
        rank = np.arange(dic.n_kmers, dtype=np.uint32)
        return cls.build(khi, klo, rank, pos, load)

    def device_rows(self, device: torch.device) -> torch.Tensor:
        """The rows as a word tensor [B, 8] on `device`."""
        from quickmer2_tpu_torch.device import words
        return words(self.rows, device)


def _try_place(khi, klo, rank, pos, h, n_buckets):
    """Vectorized two-choice first-fit: several rounds of 'everyone not
    yet placed tries its next candidate slot; ties broken by scatter
    order'. Deterministic (stable order by key index). A key takes h2
    only where h1 is full, and a bucket's fill only grows (the block
    probe's invariant, PackedTable.build)."""
    n = len(khi)
    fill = np.zeros(n_buckets, np.int64)
    slot_of = np.full(n, -1, np.int64)       # bucket*C + entry
    h1, h2 = bucket_hashes(h, n_buckets)
    pending = np.arange(n)
    for _ in range(2 * ENTRIES_PER_BUCKET + 4):
        if len(pending) == 0:
            break
        # choose candidate bucket: h1 if it has room else h2
        b1 = h1[pending].astype(np.int64)
        b2 = h2[pending].astype(np.int64)
        cand = np.where(fill[b1] < ENTRIES_PER_BUCKET, b1,
                        np.where(fill[b2] < ENTRIES_PER_BUCKET, b2, -1))
        stuck = cand < 0
        if stuck.all():
            break  # remaining keys all need eviction — go to cuckoo
        # first-come order within this round: stable sequential claim via
        # cumulative count per bucket
        order = np.argsort(cand, kind="stable")
        cs = cand[order]
        first_in_group = np.ones(len(cs), bool)
        first_in_group[1:] = cs[1:] != cs[:-1]
        grp_start = np.maximum.accumulate(
            np.where(first_in_group, np.arange(len(cs)), 0))
        offset_in_group = np.arange(len(cs)) - grp_start
        entry = fill[cs] + offset_in_group
        ok = (~stuck[order]) & (entry < ENTRIES_PER_BUCKET)
        placed_idx = pending[order[ok]]
        slot_of[placed_idx] = cs[ok] * ENTRIES_PER_BUCKET + entry[ok]
        np.add.at(fill, cs[ok], 1)
        pending = pending[np.isin(pending, placed_idx, invert=True)]
    if len(pending) and not _cuckoo_evict(pending, slot_of, h1, h2, n_buckets):
        return None
    if (slot_of < 0).any():
        return None
    rows = np.zeros((n_buckets, ROW_WIDTH), np.uint32)
    flat = rows.reshape(-1, 4)
    flat[slot_of, 0] = khi
    flat[slot_of, 1] = klo
    flat[slot_of, 2] = np.asarray(rank, np.uint32)
    flat[slot_of, 3] = np.asarray(pos, np.uint32)
    return rows


def _cuckoo_evict(pending, slot_of, h1, h2, n_buckets) -> bool:
    """Place the (rare, ~0.1%) keys whose both buckets filled during the
    greedy rounds, by deterministic cuckoo random-walk eviction. Mutates
    slot_of in place; returns False if a walk exceeds the kick budget
    (caller doubles the table). A walk starts at the key's h1 and a
    victim moves out only where its evicter takes its entry, so a key
    moved to h2 leaves its h1 full (the block probe's invariant,
    PackedTable.build)."""
    C = ENTRIES_PER_BUCKET
    occupant = np.full(n_buckets * C, -1, np.int64)
    placed = slot_of >= 0
    occupant[slot_of[placed]] = np.flatnonzero(placed)
    for key in pending:
        cur = int(key)
        bucket = int(h1[cur])
        for kick in range(512):
            base = bucket * C
            empty = -1
            for e in range(C):
                if occupant[base + e] < 0:
                    empty = e
                    break
            if empty >= 0:
                occupant[base + empty] = cur
                slot_of[cur] = base + empty
                break
            victim_e = kick % C
            victim = int(occupant[base + victim_e])
            occupant[base + victim_e] = cur
            slot_of[cur] = base + victim_e
            slot_of[victim] = -1
            # victim moves to its alternate bucket
            bucket = int(h2[victim]) if int(h1[victim]) == bucket else int(h1[victim])
            cur = victim
        else:
            return False
    return True


def probe_packed_np(rows: np.ndarray, khi: np.ndarray, klo: np.ndarray,
                    n_buckets: int) -> np.ndarray:
    """Host (numpy) membership probe over both candidate rows, found
    flags only."""
    from quickmer2_tpu_torch.ops.hash import djb_pair_np
    h = djb_pair_np(khi, klo)
    h1, h2 = bucket_hashes(h, n_buckets)
    found = np.zeros(len(khi), bool)
    for idx in (h1, h2):
        r = rows[idx.astype(np.int64)]
        for e in range(ENTRIES_PER_BUCKET):
            found |= (r[:, 4 * e] == khi) & (r[:, 4 * e + 1] == klo)
    found &= (khi | klo) != 0
    return found


def probe_packed(rows: torch.Tensor, khi: torch.Tensor, klo: torch.Tensor,
                 n_buckets: int, miss_rank: int):
    """Plain PyTorch probe: two row gathers. rows: word tensor [B, 8];
    khi/klo: int64 u32 values. Returns (found bool[N], rank int64[N],
    pos int64[N]); misses get miss_rank and pos 0. A query of 0 never
    matches (quirk Q3: empty entries are (0, 0)). The whole table is the
    one block of probe_packed_block."""
    return probe_packed_block(rows, khi, klo, n_buckets, n_buckets, 0,
                              miss_rank)


def probe_packed_block(local_rows: torch.Tensor, khi: torch.Tensor,
                       klo: torch.Tensor, n_buckets: int, block_buckets: int,
                       blk_lo: int, miss_rank: int):
    """probe_packed against one contiguous bucket block of a dict-sharded
    table: local_rows holds buckets [blk_lo, blk_lo + block_buckets). A
    candidate outside the block (the u32 wrap of cand - blk_lo) matches
    nothing, so a key is found on the one block that holds it and the
    blocks' (found, rank, pos) combine by a sum. The kernels inline it as
    csrc/packed_probe.cuh::packed_probe_block_h."""
    from quickmer2_tpu_torch.ops.hash import djb_pair
    i1, i2 = bucket_hashes_t(djb_pair(khi, klo), n_buckets)
    nonzero_q = (khi | klo) != 0
    found = torch.zeros(khi.shape, dtype=torch.bool, device=khi.device)
    rank = torch.full(khi.shape, miss_rank, dtype=torch.int64,
                      device=khi.device)
    pos = torch.zeros(khi.shape, dtype=torch.int64, device=khi.device)
    for cand in (i1, i2):
        off = (cand - blk_lo) & 0xFFFFFFFF
        local = off < block_buckets
        r = u32(local_rows[torch.where(local, off, 0)])
        for e in range(ENTRIES_PER_BUCKET):
            m = (local & nonzero_q & (r[:, 4 * e] == khi)
                 & (r[:, 4 * e + 1] == klo))
            found = found | m
            rank = torch.where(m, r[:, 4 * e + 2], rank)
            pos = torch.where(m, r[:, 4 * e + 3], pos)
    return found, rank, pos
