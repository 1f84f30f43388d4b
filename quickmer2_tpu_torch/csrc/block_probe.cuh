// The probe of one bucket block of the packed table, shared by
// csrc/count_flat.cu (K8b: a flat batch binned by slice, depth in the
// block's slot space), csrc/count_mono.cu (K12: read rows in one pass,
// plain counts at the key's rank), csrc/emit_member.cu (K10: the whole
// table as one block, membership only) and csrc/anchored.cu (K3a: the
// entry's genome position too, probe_pos), so that no copy drifts.
//
// BlockProbe holds the candidates of one code local to the bucket block
// [blk_lo, blk_lo + blk_last] (rows holds the block's rows only), in the
// block's slot space 2 * (bucket - blk_lo) + entry. A candidate outside
// the block (the u32 wrap of bucket - blk_lo) reads no row. A key sits at
// h2 only where h1's bucket was full at build (~1 % of keys on the smoke's
// table); `displaced` is a bitmap of those keys' hashes in this block
// (kernels/block_probe.py::block_displaced_filter, no false negatives), so
// h2 is a candidate only where its bit is set (and, where h1's row is
// read, only where that row is full). K8b puts a window in the slice of
// its first candidate, or in the trash unprobed when it has none: the
// windows whose h1 lies in another block, about half of those that have a
// local candidate at ds = 2, mostly go unprobed.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_probe.cuh"

namespace {

constexpr unsigned short kNoPart = 0xFFFF;     // a window no slice takes

struct BlockProbe {
  const uint4* rows;
  const unsigned* displaced;
  unsigned bucket_mask, blk_lo, blk_last;
  int shift;         // slice of a local bucket: (bucket - blk_lo) >> shift
  int filter_shift;  // 32 - log2 of the bitmap's bits

  __device__ __forceinline__ unsigned local(unsigned h, int c) const {
    return ((c ? (h * qm2t::kH2Mult) >> 7 : h) & bucket_mask) - blk_lo;
  }

  __device__ __forceinline__ bool maybe_displaced(unsigned h) const {
    const unsigned i = (h * qm2t::kFilterMult) >> filter_shift;
    return (__ldg(displaced + (i >> 5)) >> (i & 31u)) & 1u;
  }

  // The h2 bucket, where it is local and may hold the key; else past
  // blk_last.
  __device__ __forceinline__ unsigned second(unsigned h) const {
    const unsigned o2 = local(h, 1);
    return o2 <= blk_last && maybe_displaced(h) ? o2 : blk_last + 1;
  }

  __device__ __forceinline__ unsigned short part(
      unsigned long long canon) const {
    if (canon == 0) return kNoPart;
    const unsigned h =
        qm2t::djb_pair((unsigned)(canon >> 32), (unsigned)canon);
    const unsigned o1 = local(h, 0);
    if (o1 <= blk_last) return (unsigned short)(o1 >> shift);
    const unsigned o2 = second(h);
    return o2 <= blk_last ? (unsigned short)(o2 >> shift) : kNoPart;
  }

  // The matching entry of local bucket o: its slot (-1 for none, or o
  // outside the block) and its rank (POS: its genome position, the w
  // word, too); *full says whether both entries of the bucket are in use
  // (an empty entry is all zero: code 0 is no key, quirk Q3).
  template <bool POS = false>
  __device__ __forceinline__ long long entry_of(unsigned o,
                                                unsigned long long canon,
                                                unsigned* rank, bool* full,
                                                unsigned* pos = nullptr) const {
    if (o > blk_last) return -1;
    const unsigned hi = (unsigned)(canon >> 32);
    const unsigned lo = (unsigned)canon;
    long long slot = -1;
    *full = true;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint4 v = __ldg(rows + 2ull * o + e);
      if (v.x == hi && v.y == lo) {
        slot = 2LL * o + e;
        *rank = v.z;
        if (POS) *pos = v.w;
      }
      *full = *full && (v.x | v.y | v.z | v.w) != 0u;
    }
    return slot;
  }

  // A nonzero code: h1's row where local, then h2's where that misses and
  // h2 is a candidate. A key sits at h2 only where its h1 bucket was full
  // when it was placed, and a bucket never empties (ops/packed_table.py::
  // _try_place, its cuckoo moves included), so where h1's row is read and
  // has an empty entry h2 is not read at all, and its bitmap word neither.
  // Keys are unique, so the first match is the one.
  template <bool POS = false>
  __device__ __forceinline__ long long probe(unsigned long long canon,
                                             unsigned* rank,
                                             unsigned* pos = nullptr) const {
    const unsigned h =
        qm2t::djb_pair((unsigned)(canon >> 32), (unsigned)canon);
    const unsigned o1 = local(h, 0);
    bool full = true;
    const long long s1 = entry_of<POS>(o1, canon, rank, &full, pos);
    if (s1 >= 0 || !full) return s1;
    return entry_of<POS>(second(h), canon, rank, &full, pos);
  }

  // probe, and the matching entry's genome position in *pos (K3a; K8b,
  // K10 and K12 need the slot or the rank alone).
  __device__ __forceinline__ long long probe_pos(unsigned long long canon,
                                                 unsigned* rank,
                                                 unsigned* pos) const {
    return probe<true>(canon, rank, pos);
  }
};

}  // namespace
