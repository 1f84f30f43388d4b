// Two-choice packed-table probe, shared by csrc/anchored.cu (K3) and
// csrc/neighbor_bits.cu (K4).
//
// Replaces quickmer2_tpu/ops/packed_table.py::probe_packed (with
// hash.djb_pair and packed_table.bucket_hashes_jnp), an XLA device function
// of two row gathers per query. Layout (ops/packed_table.py): bucket b is
// one 32-B row of two entries (hi, lo, rank, pos), read here as two 16-B
// loads; a key lives in bucket h1 = DJB & (B-1) or h2 = (DJB * 2654435761
// >> 7) & (B-1). A query of 0 never matches (quirk Q3: empty entries are
// (0, 0)). Where both candidates hold the key (h1 == h2) the later entry
// wins, as the JAX probe's sequence of `where`s does; keys are unique, so
// both carry the same rank and position.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace qm2t {

// DJB2 mod 2^32 over the 4 bytes of lo, then the 4 bytes of hi.
__device__ __forceinline__ unsigned djb_pair(unsigned hi, unsigned lo) {
  unsigned h = 5381u;
#pragma unroll
  for (int s = 0; s < 32; s += 8) h = h * 33u + ((lo >> s) & 0xFFu);
#pragma unroll
  for (int s = 0; s < 32; s += 8) h = h * 33u + ((hi >> s) & 0xFFu);
  return h;
}

// Probe the canonical code; on a hit set *rank and *pos and return true,
// on a miss leave them as they are and return false.
__device__ __forceinline__ bool packed_probe(const uint4* __restrict__ rows,
                                             unsigned long long code,
                                             unsigned bucket_mask,
                                             unsigned* rank, unsigned* pos) {
  if (code == 0ull) return false;
  const unsigned hi = (unsigned)(code >> 32);
  const unsigned lo = (unsigned)code;
  const unsigned h = djb_pair(hi, lo);
  const unsigned cand[2] = {h & bucket_mask,
                            ((h * 2654435761u) >> 7) & bucket_mask};
  bool found = false;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint4 v = __ldg(rows + 2ull * cand[c] + e);
      if (v.x == hi && v.y == lo) {
        found = true;
        *rank = v.z;
        *pos = v.w;
      }
    }
  }
  return found;
}

// Canonical code (min of forward and reverse complement) of k 2-bit bases
// b(0..k-1), MSB-first as in ops/codec.py.
template <typename Base>
__device__ __forceinline__ unsigned long long canonical(int k, Base b) {
  const unsigned long long mask = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
  const int top = 2 * k - 2;
  unsigned long long fwd = 0, rc = 0;
  for (int i = 0; i < k; ++i) {
    const unsigned long long c = b(i) & 3u;
    fwd = ((fwd << 2) | c) & mask;
    rc = (rc >> 2) | (((c + 2) & 3u) << top);   // complement = (c-2)&3
  }
  return fwd <= rc ? fwd : rc;
}

}  // namespace qm2t
