// Two-choice packed-table probe, the table's key filter and DJB by deltas,
// shared by csrc/anchored.cu (K3), csrc/neighbor_bits.cu (K4) and
// csrc/neighbor_sum.cu (K6).
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
//
// The key filter (kernels/neighbor_bits.py::key_filter_plain is its plain
// version) is a blocked Bloom filter of 2^wbits u32 words over the table's
// keys: a key sets three bits of one word, the word chosen by the top bits
// of DJB * 2654435761 and the bits by the top 15 bits of DJB * kFilterMult.
// It has no false negatives, so a probe that fails the filter is a miss.
//
// DJB mod 2^32 is linear in the code's bytes: byte i (byte 0 the low byte
// of lo) weighs 33^(7 - i). A substitution rewrites one 2-bit field, which
// lies inside one byte, so the hash of a neighbor is the hash of the code
// plus djb_delta of each substituted field.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace qm2t {

constexpr unsigned kH2Mult = 2654435761u;
constexpr unsigned kFilterMult = 0x85EBCA77u;

// 33^(7 - i): the weight of byte i of the code in DJB mod 2^32.
__constant__ unsigned kDjbWeight[8] = {
    33u * 33u * 33u * 33u * 33u * 33u * 33u, 33u * 33u * 33u * 33u * 33u * 33u,
    33u * 33u * 33u * 33u * 33u, 33u * 33u * 33u * 33u, 33u * 33u * 33u,
    33u * 33u, 33u, 1u};

// The change of djb_pair when the 2-bit field at bit sh (even) of the
// 64-bit code goes from old_base to new_base (mod 2^32, so a fall wraps).
__device__ __forceinline__ unsigned djb_delta(int sh, unsigned old_base,
                                              unsigned new_base) {
  return (new_base - old_base) * (kDjbWeight[sh >> 3] << (sh & 7));
}

// DJB2 mod 2^32 over the 4 bytes of lo, then the 4 bytes of hi.
__device__ __forceinline__ unsigned djb_pair(unsigned hi, unsigned lo) {
  unsigned h = 5381u;
#pragma unroll
  for (int s = 0; s < 32; s += 8) h = h * 33u + ((lo >> s) & 0xFFu);
#pragma unroll
  for (int s = 0; s < 32; s += 8) h = h * 33u + ((hi >> s) & 0xFFu);
  return h;
}

__device__ __forceinline__ unsigned filter_word(unsigned h, int wbits) {
  return (h * kH2Mult) >> (32 - wbits);
}

__device__ __forceinline__ unsigned filter_bits(unsigned h) {
  const unsigned p = h * kFilterMult;
  return (1u << (p >> 27)) | (1u << ((p >> 22) & 31u)) |
         (1u << ((p >> 17) & 31u));
}

// Probe the canonical code whose DJB hash is h; on a hit set *rank and
// *pos and return true, on a miss leave them as they are and return false.
__device__ __forceinline__ bool packed_probe_h(const uint4* __restrict__ rows,
                                               unsigned long long code,
                                               unsigned h,
                                               unsigned bucket_mask,
                                               unsigned* rank, unsigned* pos) {
  if (code == 0ull) return false;
  const unsigned hi = (unsigned)(code >> 32);
  const unsigned lo = (unsigned)code;
  const unsigned cand[2] = {h & bucket_mask, ((h * kH2Mult) >> 7) & bucket_mask};
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

__device__ __forceinline__ bool packed_probe(const uint4* __restrict__ rows,
                                             unsigned long long code,
                                             unsigned bucket_mask,
                                             unsigned* rank, unsigned* pos) {
  return packed_probe_h(rows, code,
                        djb_pair((unsigned)(code >> 32), (unsigned)code),
                        bucket_mask, rank, pos);
}

// Canonical code (min of forward and reverse complement) of the k bases
// held LSB-first as 2-bit lanes of x (base q at bits 2q; lanes at and
// above k are ignored). The forward code is MSB-first as in ops/codec.py:
// reversing the 32 lanes of x puts base q at lane 31 - q, and the shift
// brings it to lane k - 1 - q. The complement of a base is base ^ 2.
__device__ __forceinline__ unsigned long long canonical_lsb(
    unsigned long long x, int k) {
  unsigned long long r = __brevll(x);
  r = ((r >> 1) & 0x5555555555555555ull) | ((r & 0x5555555555555555ull) << 1);
  const unsigned long long fwd = r >> (64 - 2 * k);
  const unsigned long long mask = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
  const unsigned long long rc = (x ^ 0xAAAAAAAAAAAAAAAAull) & mask;
  return fwd <= rc ? fwd : rc;
}

}  // namespace qm2t
