"""Edit-distance-1/2 neighbor enumeration and occurrence sums (port of
quickmer2_tpu/ops/editdist.py).

Reference: Recurse_edit/Permute_kmer/Kmer_filter_TSK (QuicKmer.c:78-88,
687-736). For every k-mer with occurrence count 1, the reference sums the
occurrence counts of all substitution neighbors at edit distance <= e
(distance-2 pairs restricted to pos2 < pos1, each pair enumerated once),
early-exiting once the partial sum exceeds the threshold d. The early
exit is order-independent, so the full neighbor sum followed by a
compare is exactly equivalent: a k-mer is deleted iff occr > 1 or
sum >= d (QuicKmer.c:1218-1231).

The edits are a static table of (pos1, delta1, pos2, delta2) tuples:
M = 3k single edits plus 9*k*(k-1)/2 double edits (4005 at k=30).
Applying an edit is one XOR at a variable bit offset on both the forward
code and its exact reverse complement (complement differences
XOR-commute), then canonical = min of the pair.

Here: the table, the plain PyTorch neighbor generator (`_neighbor_canon`),
the sum through the reference's linear-probe table (`neighbor_occr_sum`,
plain PyTorch; nothing in the search calls it), and the host quirk-compat
sum. The sum through the packed two-choice table is kernel K6
(kernels.neighbor_sum).

Quirk-compat mode (SURVEY.md Q2): the reference computes its clear masks
with `3 << (2*pos)` in 32-bit int arithmetic — undefined behavior whose
x86 semantics (shift count mod 32, sign-extended subtraction) corrupt
the generated neighbors for fwd pos >= 16 / rc pos <= k-17. The shipped
GRCh38 dictionaries embed this. `quirk_permute_np` reproduces the mod-32
semantics bit for bit (host path, k=30 only) for dictionary parity.
"""

from __future__ import annotations

import numpy as np
import torch

from quickmer2_tpu_torch.ops import hash as qhash


def edit_table(k: int, edit_distance: int):
    """Static neighbor-edit table: arrays pos1, delta1 (1..3), pos2,
    delta2, with pos2 = -1 rows for single edits. A delta is applied as
    newbase = (base + delta) & 3, which is not an XOR, so callers
    compute the XOR per element."""
    p1, d1, p2, d2 = [], [], [], []
    for a in range(k):
        for va in (1, 2, 3):
            p1.append(a); d1.append(va); p2.append(-1); d2.append(0)
            if edit_distance >= 2:
                for b in range(a):
                    for vb in (1, 2, 3):
                        p1.append(a); d1.append(va); p2.append(b); d2.append(vb)
    return (np.array(p1, np.int32), np.array(d1, np.uint32),
            np.array(p2, np.int32), np.array(d2, np.uint32))


def edit_table_t(k: int, edit_distance: int, device) -> tuple:
    """edit_table as int64 tensors on `device`."""
    return tuple(torch.from_numpy(a.astype(np.int64)).to(device)
                 for a in edit_table(k, edit_distance))


def _apply_edit_pair(fhi, flo, rhi, rlo, pos, delta, k: int):
    """Apply one substitution at `pos` (delta in 1..3; 0 is a no-op) to
    (fwd, rc) codes held as int64 tensors of u32 halves. pos/delta may
    broadcast against the codes. Returns the updated (fhi, flo, rhi,
    rlo)."""
    b = 2 * pos
    in_hi = b >= 32
    sh = torch.where(in_hi, b - 32, b)
    base = (torch.where(in_hi, fhi, flo) >> sh) & 3
    x = base ^ ((base + delta) & 3)
    fhi = fhi ^ torch.where(in_hi, x << sh, 0)
    flo = flo ^ torch.where(in_hi, 0, x << sh)
    # reverse complement: the same XOR pattern at the mirrored position
    br = 2 * (k - 1 - pos)
    rin_hi = br >= 32
    xr = x << torch.where(rin_hi, br - 32, br)
    rhi = rhi ^ torch.where(rin_hi, xr, 0)
    rlo = rlo ^ torch.where(rin_hi, 0, xr)
    return fhi, flo, rhi, rlo


def _neighbor_canon(khi, klo, rkhi, rklo, p1, d1, p2, d2, k: int):
    """Canonical (hi, lo) of every (k-mer, edit) pair: flat int64[N*M]
    tensors, query-major. khi/klo: the queries' codes, rkhi/rklo their
    exact reverse complements (int64 u32 halves); p1/d1/p2/d2: the edit
    table as tensors on the same device."""
    n, m = khi.shape[0], p1.shape[0]
    codes = [t[:, None].expand(n, m) for t in (khi, klo, rkhi, rklo)]
    codes = _apply_edit_pair(*codes, p1[None, :], d1[None, :], k)
    # single edits carry pos2 -1 and delta2 0: a no-op at position 0
    codes = _apply_edit_pair(*codes, p2.clamp(min=0)[None, :], d2[None, :],
                             k)
    fhi, flo, rhi, rlo = codes
    fwd_less = (fhi < rhi) | ((fhi == rhi) & (flo <= rlo))
    return (torch.where(fwd_less, fhi, rhi).reshape(-1),
            torch.where(fwd_less, flo, rlo).reshape(-1))


def neighbor_occr_sum(khi, klo, rkhi, rklo, table_hi, table_lo, occr,
                      p1, d1, p2, d2, *, k: int, hash_size: int,
                      max_steps: int = 4096) -> torch.Tensor:
    """Sum of neighbor occurrence counts for a batch of k-mers against
    the reference's linear-probe table (ops.hash.probe_lookup: DJB start
    slot, scan toward the middle until a match or an empty slot, at most
    max_steps steps, slots read as the JAX package's gathers read them).

    khi/klo: canonical codes, rkhi/rklo: their exact reverse
    complements (int64 u32 halves, [N]); table_hi/table_lo: the table's
    u32 halves (int64 [hash_size]); occr: per-slot counts [hash_size];
    p1/d1/p2/d2: the edit table (edit_table_t). Returns int64[N] sums.
    Memory is O(N*M); callers choose N. A neighbor of code 0 "matches"
    an empty slot, whose occr is 0, so it adds nothing."""
    n, m = khi.shape[0], p1.shape[0]
    chi, clo = _neighbor_canon(khi, klo, rkhi, rklo, p1, d1, p2, d2, k)
    idx, match = qhash.probe_lookup(table_hi, table_lo, chi, clo, hash_size,
                                    max_steps)
    occ = occr[qhash.slot_at(idx, hash_size)].to(torch.int64)
    return torch.where(match, occ, 0).view(n, m).sum(1)


# ---------------------------------------------------------------------------
# Host quirk-compat path (mod-32 shift UB emulation, k=30 only)
# ---------------------------------------------------------------------------

def quirk_permute_np(fwd: np.ndarray, rc: np.ndarray, pos: int, delta: int,
                     k: int):
    """Bit-exact emulation of Permute_kmer (QuicKmer.c:78-88) including
    the 32-bit `3 << (pos<<1)` UB (x86: count mod 32, sign-extended).

    fwd/rc: u64 arrays (rc in the reference's 60-bit-register layout,
    identical to the exact rc at k=30). Returns mutated (fwd, rc).
    """
    U64 = (1 << 64) - 1
    kmask = (1 << (2 * k)) - 1

    def clear_mask(bitpos: int) -> np.uint64:
        # int32 `3 << bitpos`: hardware masks the count mod 32; the int
        # result sign-extends to 64 bits; then Kmer_mask MINUS it (a
        # wrapping subtract, not an and-not) forms the "clear" mask.
        v32 = (3 << (bitpos & 31)) & 0xFFFFFFFF
        v = v32 - (1 << 32) if v32 & 0x80000000 else v32
        return np.uint64((kmask - v) & U64)

    base = (fwd >> np.uint64(2 * pos)) & np.uint64(3)  # 64-bit shift: correct in ref
    nb = (base + np.uint64(delta)) & np.uint64(3)
    fwd = (fwd & clear_mask(2 * pos)) | (nb << np.uint64(2 * pos))
    rb = (nb - np.uint64(2)) & np.uint64(3)
    rpos = 2 * (k - 1 - pos)
    rc = (rc & clear_mask(rpos)) | (rb << np.uint64(rpos))
    return fwd, rc


def neighbor_occr_sum_quirk_np(kmers: np.ndarray, table: np.ndarray,
                               occr: np.ndarray, hash_size: int,
                               k: int, edit_distance: int) -> np.ndarray:
    """Host quirk-compat neighbor sum (vectorized over the k-mer batch,
    python loop over the O(k^2) edit table), against the pass-1 linear
    probe table; u64 sums. Deletion decisions match the reference binary
    bit for bit."""
    kmers = np.asarray(kmers, dtype=np.uint64)
    # the reference recomputes the exact rc register before filtering
    # (Reverse_strand_encoded, QuicKmer.c:728)
    rc = np.zeros_like(kmers)
    tmp = kmers.copy()
    for _ in range(k):
        rc = (rc << np.uint64(2)) | ((tmp - np.uint64(2)) & np.uint64(3))
        tmp >>= np.uint64(2)
    rc &= np.uint64((1 << (2 * k)) - 1)

    total = np.zeros(len(kmers), dtype=np.uint64)

    def probe_and_add(f, r):
        canon = np.minimum(f, r)
        slots, found = qhash.probe_lookup_np(table, canon, hash_size)
        total[:] = total + np.where(found, occr[slots].astype(np.uint64),
                                    np.uint64(0))

    for p1 in range(k):
        for v1 in (1, 2, 3):
            f1, r1 = quirk_permute_np(kmers.copy(), rc.copy(), p1, v1, k)
            if edit_distance >= 2:
                for p2 in range(p1):
                    for v2 in (1, 2, 3):
                        f2, r2 = quirk_permute_np(f1.copy(), r1.copy(), p2, v2, k)
                        probe_and_add(f2, r2)
            probe_and_add(f1, r1)
    return total
