"""DJB2 hashing and open-addressing probe, host and device paths.

Reference semantics (QuicKmer.c:66-99):
  * hash = DJB2 over the 8 little-endian bytes of the u64 k-mer code,
    masked to Hash_size-1 (Hash_size a power of two).
  * probe: linear scan; start slots in the upper half of the table scan
    downward, lower half scan upward ("bidirectional" probing). The scan
    stops at an empty slot (code 0) or a match. No bounds check — safety
    comes from low fill plus the toward-the-middle scan direction.
  * k-mer code 0 (poly-A/T) therefore "matches" the first empty slot
    (SURVEY.md Q3); callers must treat slot hits on empty slots as
    out-of-dictionary.

Because Hash_size <= 2^32, the probe index only needs the LOW 32 bits of
the 64-bit DJB value, and DJB2 mod 2^32 is computable entirely in uint32
arithmetic. The plain PyTorch `djb_pair` carries those u32 values in
int64 tensors and masks every step (device.py); the CUDA count kernel
inlines the same loop on unsigned ints.
"""

from __future__ import annotations

import numpy as np
import torch

from quickmer2_tpu_torch.device import U32

DJB_SEED = 5381


def djb_u64_np(kmer: np.ndarray) -> np.ndarray:
    """Low 32 bits of DJB2 over the 8 LE bytes of u64 codes (numpy)."""
    kmer = np.asarray(kmer, dtype=np.uint64)
    h = np.full(kmer.shape, DJB_SEED, dtype=np.uint32)
    for i in range(8):
        byte = ((kmer >> np.uint64(8 * i)) & np.uint64(0xFF)).astype(np.uint32)
        h = h * np.uint32(33) + byte
    return h


def djb_pair_np(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    h = np.full(np.shape(lo), DJB_SEED, dtype=np.uint32)
    for word in (np.asarray(lo, np.uint32), np.asarray(hi, np.uint32)):
        for i in range(4):
            h = h * np.uint32(33) + ((word >> np.uint32(8 * i)) & np.uint32(0xFF))
    return h


def djb_pair(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """DJB2 (low 32 bits) over a (hi, lo) u32 pair given as int64
    tensors of u32 values; h*33 + byte wraps mod 2^32."""
    h = torch.full(lo.shape, DJB_SEED, dtype=torch.int64, device=lo.device)
    for word in (lo, hi):
        for i in range(4):
            h = (h * 33 + ((word >> (8 * i)) & 0xFF)) & U32
    return h


def mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2^32 for int64 tensors of u32 values and a u32
    constant m. The full product would pass 2^63, so it is formed from
    the 16-bit halves of m."""
    return (h * (m & 0xFFFF) + (((h * (m >> 16)) & 0xFFFF) << 16)) & U32


# ---------------------------------------------------------------------------
# Host table: build / probe (numpy + tight python where order-dependent)
# ---------------------------------------------------------------------------

def scan_direction_np(idx0: np.ndarray, hash_size: int) -> np.ndarray:
    """+1 for lower-half start slots, -1 for upper-half (QuicKmer.c:92-94)."""
    return np.where(idx0 & np.uint32(hash_size >> 1), -1, 1).astype(np.int64)


def probe_insert_np(table: np.ndarray, keys: np.ndarray, hash_size: int) -> np.ndarray:
    """Insert keys into an existing table in order; returns slot per key."""
    idx0 = djb_u64_np(keys) & np.uint32(hash_size - 1)
    step = scan_direction_np(idx0, hash_size)
    out = np.empty(len(keys), dtype=np.int64)
    for i in range(len(keys)):
        j = int(idx0[i])
        s = int(step[i])
        k = keys[i]
        while table[j] and table[j] != k:
            j += s
        table[j] = k
        out[i] = j
    return out


def probe_lookup_np(table: np.ndarray, keys: np.ndarray, hash_size: int):
    """Vectorized host lookup. Returns (slot i64[N], found bool[N]).

    found is True when the scan terminated on a matching nonzero slot;
    a key of 0 "finds" the first empty slot with found=True, mirroring
    the reference quirk Q3 — callers mask with the dictionary chain.
    """
    keys = np.asarray(keys, dtype=np.uint64)
    idx = (djb_u64_np(keys) & np.uint32(hash_size - 1)).astype(np.int64)
    step = scan_direction_np(idx, hash_size)
    active = np.ones(len(keys), dtype=bool)
    while active.any():
        entry = table[idx[active]]
        k = keys[active]
        done = (entry == k) | (entry == 0)
        idx[active] += np.where(done, 0, step[active])
        nxt = active.copy()
        nxt[active] = ~done
        active = nxt
    return idx, table[idx] == keys


# ---------------------------------------------------------------------------
# Device probe (plain PyTorch; kernel K7 inlines it, csrc/count_flat.cu)
# ---------------------------------------------------------------------------

MAX_STEPS = 4096


def slot_at(idx: torch.Tensor, hash_size: int) -> torch.Tensor:
    """The slot that the JAX package's gather reads at index idx: an
    index in [-hash_size, 0) wraps once by +hash_size, then the index
    clamps to [0, hash_size - 1]."""
    idx = torch.where(idx < 0, idx + hash_size, idx)
    return idx.clamp(0, hash_size - 1)


def probe_lookup(table_hi: torch.Tensor, table_lo: torch.Tensor,
                 khi: torch.Tensor, klo: torch.Tensor, hash_size: int,
                 max_steps: int = MAX_STEPS):
    """Plain PyTorch version of quickmer2_tpu/ops/hash.py::probe_lookup.

    table_hi/table_lo: the table's u32 halves, (0, 0) = empty slot;
    khi/klo: query canonical codes (int64 tensors of u32 values).
    Returns (idx int64[N], found bool[N]): idx is where the scan
    stopped, before slot_at (it may pass either end of a small table);
    found is True when it stopped on a match. The scan starts at DJB &
    (hash_size - 1), steps -1 from the upper half and +1 from the lower
    half, stops at a match or an empty slot, and takes at most max_steps
    steps. Only the lanes still scanning are gathered at each step.
    """
    idx = djb_pair(khi, klo) & (hash_size - 1)
    step = torch.where((idx & (hash_size >> 1)) != 0, -1, 1)

    def probe(at, qhi, qlo):
        s = slot_at(at, hash_size)
        ehi, elo = table_hi[s], table_lo[s]
        return (ehi == qhi) & (elo == qlo), (ehi == 0) & (elo == 0)

    found, empty = probe(idx, khi, klo)
    active = torch.nonzero(~(found | empty)).flatten()
    for _ in range(max_steps):
        if not active.numel():
            break
        idx[active] += step[active]
        match, empty = probe(idx[active], khi[active], klo[active])
        found[active] = match
        active = active[~(match | empty)]
    return idx, found
