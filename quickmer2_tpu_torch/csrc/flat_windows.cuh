// The flat batch's window map and word-parallel codec, shared by
// csrc/count_mono.cu (K2, and the staging that K2r and K12 reuse),
// csrc/count_flat.cu (K7, K8, K8b and K9) and csrc/emit_member.cu (K10), so
// that no copy drifts.
//
// A batch is ops/rowpack.py's layout with one row: base t at bits 2 (t & 3)
// of byte t >> 2, and its invalid (separator) bit at bit t & 7 of byte
// t >> 3 of the bitmask. As 64-bit words base t sits at bit 2t, so the
// window of k <= 32 bases at t is one funnel shift of two consecutive
// words, and its validity the same shift of the bitmask tested on k bits.
// A block of kThreads threads takes kTile windows, stages the words they
// read once in shared memory (the tail padded: 2-bit lanes with 0, invalid
// bits with 1) and reads each window from there.
//
// Each source that includes this header is its own library, so the
// anonymous namespace gives each its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_probe.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 32;
constexpr int kTile = 4096;                 // windows per block, K2's tiles
constexpr int kTileWords = kTile / 32 + 2;  // 2-bit lanes, 32 bases a word
constexpr int kTileBitWords = kTile / 64 + 2;

typedef unsigned long long u64;

// 64-bit word j of a byte array of n_bytes (8-B aligned); bytes past the
// end read as the matching byte of pad.
__device__ __forceinline__ u64 load_word(const uint8_t* __restrict__ p,
                                         long long j, long long n_bytes,
                                         u64 pad) {
  const long long off = 8 * j;
  if (off + 8 <= n_bytes) return __ldg((const u64*)p + j);
  u64 w = pad;
  for (int b = 0; b < 8; ++b) {
    if (off + b < n_bytes) {
      w = (w & ~(0xFFull << (8 * b))) | ((u64)p[off + b] << (8 * b));
    }
  }
  return w;
}

// Bits [s, s + 64) of the 128-bit value (hi:lo), 0 <= s < 64.
__device__ __forceinline__ u64 funnel(u64 lo, u64 hi, int s) {
  return s ? (lo >> s) | (hi << (64 - s)) : lo;
}

// Bits [b, b + 64) of a run of words.
__device__ __forceinline__ u64 bits_at(const u64* w, int b) {
  return funnel(w[b >> 6], w[(b >> 6) + 1], b & 63);
}

// Words w0 .. w0 + count - 1 of a byte array into dst, by the block.
__device__ __forceinline__ void stage_words(u64* dst, int count,
                                            const uint8_t* __restrict__ src,
                                            long long w0, long long n_bytes,
                                            u64 pad) {
  for (int j = threadIdx.x; j < count; j += kThreads) {
    dst[j] = load_word(src, w0 + j, n_bytes, pad);
  }
}

// Canonical code of the window at bit pb of the staged 2-bit lanes, if
// none of the k invalid bits at bit ib of the staged bitmask is set (the
// valid windows).
__device__ __forceinline__ bool staged_valid(const u64* pk, int pb,
                                             const u64* inval, int ib, int k,
                                             u64* canon) {
  if (bits_at(inval, ib) & ((1ull << k) - 1)) return false;
  *canon = qm2t::canonical_lsb(bits_at(pk, pb), k);
  return true;
}

// The same, for the valid windows whose code is nonzero (those that can
// hit a table: quirk Q3 keeps code 0 out of every one).
__device__ __forceinline__ bool staged_window(const u64* pk, int pb,
                                              const u64* inval, int ib, int k,
                                              u64* canon) {
  return staged_valid(pk, pb, inval, ib, k, canon) && *canon != 0;
}

// The window map of a flat batch (K2, K7, K8, K9): lane i is window i of
// one row.
struct FlatWindows {
  const uint8_t* pk;
  const uint8_t* bits;
  long long pk_bytes, bits_bytes;
  long long n;          // windows: n_bases - k + 1
  int k;

  struct Tile {
    u64 pk[kTileWords];
    u64 bits[kTileBitWords];
  };
  struct Span {};

  __host__ __device__ __forceinline__ int lanes() const { return kTile; }

  __device__ __forceinline__ Span stage(Tile& t, long long base) const {
    stage_words(t.pk, kTileWords, pk, base / 32, pk_bytes, 0);
    stage_words(t.bits, kTileBitWords, bits, base / 64, bits_bytes, ~0ull);
    __syncthreads();
    return Span{};
  }

  __device__ __forceinline__ bool window(const Tile& t, const Span&,
                                         long long base, int j,
                                         u64* canon) const {
    if (base + j >= n) return false;
    return staged_window(t.pk, 2 * j, t.bits, j, k, canon);
  }

  // Whether window base + j (< n) is valid, and its canonical code.
  __device__ __forceinline__ bool valid(const Tile& t, int j,
                                        u64* canon) const {
    return staged_valid(t.pk, 2 * j, t.bits, j, k, canon);
  }

  // Canonical code of a binned (valid) lane, from global memory.
  __device__ __forceinline__ u64 decode(long long i) const {
    const u64 x = funnel(load_word(pk, i >> 5, pk_bytes, 0),
                         load_word(pk, (i >> 5) + 1, pk_bytes, 0),
                         2 * (int)(i & 31));
    return qm2t::canonical_lsb(x, k);
  }
};

// A flat batch's C entry checks (K7, K8, K9, K10): 1 <= k <= 32, at most
// 2^32 - 1 windows, pk and bits 8-B aligned.
inline bool bad_batch(const void* pk, const void* bits, long long n_bases,
                      int k) {
  return k < 1 || k > kMaxK || n_bases < k ||
         n_bases - k + 1 > 0xFFFFFFFFLL ||
         (((uintptr_t)pk | (uintptr_t)bits) & 7) != 0;
}

inline FlatWindows flat_windows(const void* pk, const void* bits,
                                long long n_bases, int k) {
  return {(const uint8_t*)pk, (const uint8_t*)bits, (n_bases + 3) / 4,
          (n_bases + 7) / 8, n_bases - k + 1, k};
}

inline unsigned tiles_of(const FlatWindows& m) {
  return (unsigned)((m.n + kTile - 1) / kTile);
}

}  // namespace
