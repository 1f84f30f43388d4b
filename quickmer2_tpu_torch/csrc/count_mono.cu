// Fused mono-table count steps: the flat count path's (K2) and the
// anchored path's exact recount over read rows (K2r).
//
// K2 replaces quickmer2_tpu/pipelines/count.py::count_step_mono_pk (:137-142),
// an XLA device function: rowpack.unpack_rows + codec.sliding_kmers +
// monotable.probe_mono (with hash.djb_pair) + the depth scatter-add + a
// packbits of the unresolved lanes. For each window i < n_bases - k + 1:
//   1. its canonical 2k-bit code (the minimum of the forward and the
//      reverse-complement code, ops/codec.py) and valid = no separator in
//      the window (ops/rowpack.py layout, one row = the batch; SEP = 4);
//   2. DJB2 mod 2^32 over the 4 lo bytes, then the 4 hi bytes;
//   3. bucket = h & (n_buckets - 1); its 64-B row is four 16-B loads;
//   4. the 8 entries (hi, lo) are compared under the nonzero-query mask
//      (quirk Q3: code 0 never matches an empty entry);
//   5. a hit adds 1 to depth[bucket * 8 + entry] (atomicAdd, u32 wrap);
//   6. unresolved = valid & nonzero & miss & every entry used, as LSB-first
//      u32 mask words: lane i is bit i & 31 of word i >> 5.
// A miss adds nothing. The JAX step sends misses to a trash counter whose
// value no caller reads, so depth[:-1] is the whole contract.
//
// K2's design. The codec is word-parallel: the layout stores base p at bits
// 2 (p & 3) of byte p >> 2, so as 64-bit words base p sits at bit 2p of
// the stream, and window i is one funnel shift of two consecutive words,
// X = sum_j b_{i+j} << 2j. With A = 0xAAAA... over 2k bits (complement is
// b ^ 2 in the alphabet A=0, C=1, T=2, G=3), RC = X ^ A and F = rev2(X) >>
// (64 - 2k), rev2 reversing the 2-bit lanes (packed_probe.cuh::
// canonical_lsb). Validity is the same funnel shift over the invalid
// bitmask, tested on k bits, and i + k <= n_bases. No loop over k.
//
// The table (2^22 buckets on the main path: 256 MiB of rows and 128 MiB of
// depth) is 5x the 50 MB L2, so one random 64-B row per window is an HBM
// access. With P > 1 the buckets are cut into P slices by the top log2 P
// bits of the bucket index, each slice's rows and depth words ~24 MB
// (kernels/count_mono.py::partitions_for), and one call runs three passes:
//   count   — codec and DJB per window, a per-block shared histogram over
//             the P slices, added once per block into the slice totals;
//   scatter — the same per window; each block reserves a run in each
//             slice's bin (the slice's start is the exclusive scan of the
//             totals, the run one atomicAdd on the slice's fill) and writes
//             the 4-B lane index of every valid nonzero window there;
//   probe   — a thread per binned window, in slice order: decode the
//             code again from the packed batch (6 MB, L2-resident), probe,
//             add to depth and set unresolved lanes by atomicOr into the
//             zeroed mask. A slice's rows and depth words come from HBM at
//             their first touch and from L2 after it.
// With P = 1 (a table that fits L2 already) one pass probes every window
// where it is decoded and writes each mask word by ballot.
//
// K2r replaces quickmer2_tpu/ops/anchored.py::exact_count_rows_mono_packed
// (:940-949), the spill recount of AnchoredDepthCounter: steps 2-6 over R
// read rows of pitch L, one thread per window lane i < R*W (W = L - k + 1,
// row i / W, offset i % W), so no window crosses a row end. A thread reads
// its k bases from the row's 2-bit lanes and its lens (u16 length) or mask
// (invalid bitmask) aux, as ops/rowpack.py::pack_batch lays them out. The
// unresolved mask is LSB-first u32 words over the R*W lanes (the JAX
// function's packbits order is not kept; the drain decodes this one).
//
// Bound on the H100 (3.35 TB/s HBM): the least K2 must move is the packed
// batch, each touched row once and each touched depth word read and
// written once; chip_smoke.py computes it from each run's batch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_probe.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 32;
constexpr unsigned kEntries = 8;
constexpr int kTile = 4096;                 // windows per block, K2's tiles
constexpr int kTileWords = kTile / 32 + 2;  // 2-bit lanes, 32 bases a word
constexpr int kTileBitWords = kTile / 64 + 2;
constexpr int kMaxParts = 256;
constexpr unsigned short kNoPart = 0xFFFF;

typedef unsigned long long u64;

// Probe one valid window's canonical code: depth[slot] += 1 on a hit;
// returns unresolved = nonzero & miss & every entry of the bucket used.
__device__ __forceinline__ bool mono_probe(u64 canon,
                                           const uint4* __restrict__ rows,
                                           unsigned* __restrict__ depth,
                                           unsigned bucket_mask) {
  const unsigned hi = (unsigned)(canon >> 32);
  const unsigned lo = (unsigned)canon;
  const unsigned bucket = qm2t::djb_pair(hi, lo) & bucket_mask;
  const uint4* row = rows + 4ull * bucket;
  const bool nonzero = canon != 0;
  bool found = false, full = true;
  unsigned ent = 0;
#pragma unroll
  for (unsigned q = 0; q < 4; ++q) {
    const uint4 v = __ldg(row + q);   // entries 2q (x, y), 2q+1 (z, w)
    if (nonzero && v.x == hi && v.y == lo) { found = true; ent = 2 * q; }
    if (nonzero && v.z == hi && v.w == lo) { found = true; ent = 2 * q + 1; }
    full = full && (v.x | v.y) != 0u && (v.z | v.w) != 0u;
  }
  if (found) {
    atomicAdd(depth + (u64)bucket * kEntries + ent, 1u);
  }
  return nonzero && !found && full;
}

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

struct Batch {
  const uint8_t* pk;
  const uint8_t* bits;
  long long pk_bytes, bits_bytes;
  long long n;          // windows: n_bases - k + 1
  int k;
};

// The words a block's kTile windows read, staged once (tail padded: 2-bit
// lanes with 0, invalid bits with 1).
struct Tile {
  u64 pk[kTileWords];
  u64 bits[kTileBitWords];
};

__device__ __forceinline__ void stage_tile(Tile& t, const Batch& b,
                                           long long base) {
  for (int j = threadIdx.x; j < kTileWords; j += kThreads) {
    t.pk[j] = load_word(b.pk, base / 32 + j, b.pk_bytes, 0);
  }
  for (int j = threadIdx.x; j < kTileBitWords; j += kThreads) {
    t.bits[j] = load_word(b.bits, base / 64 + j, b.bits_bytes, ~0ull);
  }
  __syncthreads();
}

// Canonical code of window base + j of the staged tile, if it is a window
// of the batch, valid and nonzero (the windows that can hit): one funnel
// shift of the invalid bits, tested on k bits, and one of the 2-bit lanes.
__device__ __forceinline__ bool tile_window(const Tile& t, const Batch& b,
                                            long long base, int j, u64* canon) {
  if (base + j >= b.n) return false;
  const u64 inval = funnel(t.bits[j >> 6], t.bits[(j >> 6) + 1], j & 63);
  if (inval & ((1ull << b.k) - 1)) return false;
  *canon = qm2t::canonical_lsb(
      funnel(t.pk[j >> 5], t.pk[(j >> 5) + 1], 2 * (j & 31)), b.k);
  return *canon != 0;
}

// P = 1: decode and probe in one pass; one mask word per warp and round.
__global__ void __launch_bounds__(kThreads)
count_mono_direct_kernel(Batch b, const uint4* __restrict__ rows,
                         unsigned* __restrict__ depth,
                         unsigned* __restrict__ mask, unsigned bucket_mask) {
  __shared__ Tile tile;
  const long long base = (long long)blockIdx.x * kTile;
  stage_tile(tile, b, base);
  const long long n_words = (b.n + 31) >> 5;
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    u64 canon;
    bool unresolved = false;
    if (tile_window(tile, b, base, j, &canon)) {
      unresolved = mono_probe(canon, rows, depth, bucket_mask);
    }
    const unsigned word = __ballot_sync(0xFFFFFFFFu, unresolved);
    const long long w = (base + j) >> 5;
    if ((threadIdx.x & 31) == 0 && w < n_words) mask[w] = word;
  }
}

// Slice of each window of the tile (kNoPart where it cannot hit) into
// part[], and the block's histogram over the slices into hist[].
__device__ __forceinline__ void tile_parts(const Tile& t, const Batch& b,
                                           long long base, int part_shift,
                                           unsigned bucket_mask,
                                           unsigned short* part,
                                           unsigned* hist, int n_parts) {
  for (int p = threadIdx.x; p < n_parts; p += kThreads) hist[p] = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    u64 canon;
    unsigned short s = kNoPart;
    if (tile_window(t, b, base, j, &canon)) {
      const unsigned h = qm2t::djb_pair((unsigned)(canon >> 32), (unsigned)canon);
      s = (unsigned short)((h & bucket_mask) >> part_shift);
      atomicAdd(&hist[s], 1u);
    }
    part[j] = s;
  }
  __syncthreads();
}

// Pass 1 (P > 1): the slices' window totals.
__global__ void __launch_bounds__(kThreads)
count_mono_hist_kernel(Batch b, unsigned* __restrict__ totals, int n_parts,
                       int part_shift, unsigned bucket_mask) {
  __shared__ Tile tile;
  __shared__ unsigned short part[kTile];
  __shared__ unsigned hist[kMaxParts];
  const long long base = (long long)blockIdx.x * kTile;
  stage_tile(tile, b, base);
  tile_parts(tile, b, base, part_shift, bucket_mask, part, hist, n_parts);
  for (int p = threadIdx.x; p < n_parts; p += kThreads) {
    if (hist[p]) atomicAdd(totals + p, hist[p]);
  }
}

// Pass 2: each valid nonzero window's lane index into its slice's bin.
// bins holds the slices one after another, slice p from the sum of the
// totals before it (an exclusive scan); a block reserves its run in each
// slice by one atomicAdd on the slice's fill.
__global__ void __launch_bounds__(kThreads)
count_mono_scatter_kernel(Batch b, const unsigned* __restrict__ totals,
                          unsigned* __restrict__ fill,
                          unsigned* __restrict__ bins, int n_parts,
                          int part_shift, unsigned bucket_mask) {
  __shared__ Tile tile;
  __shared__ unsigned short part[kTile];
  __shared__ unsigned hist[kMaxParts];
  __shared__ unsigned cursor[kMaxParts];
  const long long base = (long long)blockIdx.x * kTile;
  for (int p = threadIdx.x; p < n_parts; p += kThreads) cursor[p] = totals[p];
  stage_tile(tile, b, base);
  tile_parts(tile, b, base, part_shift, bucket_mask, part, hist, n_parts);
  if (threadIdx.x == 0) {
    unsigned start = 0;
    for (int p = 0; p < n_parts; ++p) {
      const unsigned total = cursor[p];
      cursor[p] = start;
      start += total;
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < n_parts; p += kThreads) {
    if (hist[p]) cursor[p] += atomicAdd(fill + p, hist[p]);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const unsigned short s = part[j];
    if (s != kNoPart) bins[atomicAdd(&cursor[s], 1u)] = (unsigned)(base + j);
  }
}

// Pass 3: probe the binned windows, a thread an entry, each code decoded
// again from the packed batch (L2-resident). The bins hold the slices in
// order and blocks start in about that order, so the rows and depth words
// of about one slice are in use at a time and come from L2 after their
// first touch. The grid covers every window; threads past the binned
// count return.
__global__ void __launch_bounds__(kThreads)
count_mono_probe_kernel(Batch b, const unsigned* __restrict__ totals,
                        const unsigned* __restrict__ bins,
                        const uint4* __restrict__ rows,
                        unsigned* __restrict__ depth,
                        unsigned* __restrict__ mask, int n_parts,
                        unsigned bucket_mask) {
  __shared__ unsigned n_binned;
  if (threadIdx.x == 0) n_binned = 0;
  __syncthreads();
  for (int p = threadIdx.x; p < n_parts; p += kThreads) {
    atomicAdd(&n_binned, __ldg(totals + p));
  }
  __syncthreads();
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n_binned) return;
  const long long i = __ldg(bins + e);
  const u64 x = funnel(load_word(b.pk, i >> 5, b.pk_bytes, 0),
                       load_word(b.pk, (i >> 5) + 1, b.pk_bytes, 0),
                       2 * (int)(i & 31));
  if (mono_probe(qm2t::canonical_lsb(x, b.k), rows, depth, bucket_mask)) {
    atomicOr(mask + (i >> 5), 1u << (i & 31));
  }
}

template <bool LENS>
__global__ void __launch_bounds__(kThreads)
count_mono_rows_kernel(const uint8_t* __restrict__ pk,
                       const uint8_t* __restrict__ aux,
                       const uint4* __restrict__ rows,
                       unsigned* __restrict__ depth,
                       unsigned* __restrict__ mask,
                       int n_rows, int L, int k, unsigned bucket_mask) {
  const int W = L - k + 1;
  const long long n = (long long)n_rows * W;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  bool unresolved = false;
  if (i < n) {
    const int r = (int)(i / W), j = (int)(i % W);
    const uint8_t* prow = pk + (size_t)r * ((L + 3) >> 2);
    const uint8_t* arow = aux + (size_t)r * ((L + 7) >> 3);
    const int len = LENS ? ((const uint16_t*)aux)[r] : 0;
    const u64 code_mask = k == 32 ? ~0ULL : (1ULL << (2 * k)) - 1;
    const int top = 2 * k - 2;
    u64 fwd = 0, rc = 0;
    bool valid = true;
    for (int q = 0; q < k; ++q) {
      const int t = j + q;
      valid = valid && (LENS ? t < len : !((__ldg(arow + (t >> 3)) >> (t & 7)) & 1u));
      const u64 b = (__ldg(prow + (t >> 2)) >> (2 * (t & 3))) & 3u;
      fwd = ((fwd << 2) | b) & code_mask;
      rc = (rc >> 2) | (((b + 2) & 3u) << top);
    }
    if (valid) {
      unresolved = mono_probe(fwd <= rc ? fwd : rc, rows, depth, bucket_mask);
    }
  }
  const unsigned word = __ballot_sync(0xFFFFFFFFu, unresolved);
  if ((threadIdx.x & 31) == 0 && i < n) mask[i >> 5] = word;
}

int log2_of(long long x) {
  int s = 0;
  while ((1LL << s) < x) ++s;
  return s;
}

}  // namespace

extern "C" const char* qm2t_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// pk u8[ceil(n_bases/4)] and bits u8[ceil(n_bases/8)], both 8-B aligned;
// rows u32[n_buckets, 16]; depth u32[n_buckets * 8 + 1] (updated in place);
// mask u32[ceil((n_bases - k + 1) / 32)] (written in full); n_parts the
// slice count P (a power of two, 1 <= P <= min(256, n_buckets)); work
// u32[2 * P + n_bases - k + 1] scratch (P > 1 only; may be null for P = 1).
extern "C" int qm2t_count_mono(const void* pk, const void* bits,
                               const void* rows, void* depth, void* mask,
                               long long n_bases, int k, long long n_buckets,
                               int n_parts, void* work, void* stream) {
  if (k < 1 || k > kMaxK || n_bases < k || n_buckets < 1 ||
      n_buckets > (1LL << 32) || (n_buckets & (n_buckets - 1)) != 0 ||
      n_parts < 1 || n_parts > kMaxParts || n_parts > n_buckets ||
      (n_parts & (n_parts - 1)) != 0 || n_bases - k + 1 > 0xFFFFFFFFLL ||
      (n_parts > 1 && work == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (((uintptr_t)pk | (uintptr_t)bits) & 7) {
    return (int)cudaErrorMisalignedAddress;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const Batch b = {(const uint8_t*)pk, (const uint8_t*)bits,
                   (n_bases + 3) / 4, (n_bases + 7) / 8, n_bases - k + 1, k};
  const unsigned bucket_mask = (unsigned)(n_buckets - 1);
  const long long tiles = (b.n + kTile - 1) / kTile;
  if (n_parts == 1) {
    count_mono_direct_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
        b, (const uint4*)rows, (unsigned*)depth, (unsigned*)mask, bucket_mask);
    return (int)cudaGetLastError();
  }
  const int part_shift = log2_of(n_buckets) - log2_of(n_parts);
  unsigned* totals = (unsigned*)work;
  unsigned* fill = totals + n_parts;
  unsigned* bins = fill + n_parts;
  cudaError_t rc = cudaMemsetAsync(totals, 0, 2 * n_parts * sizeof(unsigned), s);
  if (rc == cudaSuccess) {
    rc = cudaMemsetAsync(mask, 0, ((b.n + 31) >> 5) * sizeof(unsigned), s);
  }
  if (rc != cudaSuccess) return (int)rc;
  count_mono_hist_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      b, totals, n_parts, part_shift, bucket_mask);
  count_mono_scatter_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      b, totals, fill, bins, n_parts, part_shift, bucket_mask);
  count_mono_probe_kernel<<<(unsigned)((b.n + kThreads - 1) / kThreads),
                            kThreads, 0, s>>>(
      b, totals, bins, (const uint4*)rows, (unsigned*)depth, (unsigned*)mask,
      n_parts, bucket_mask);
  return (int)cudaGetLastError();
}

// pk u8[R, ceil(L/4)]; aux u16[R] (lens = 1) or u8[R, ceil(L/8)] (lens = 0);
// rows u32[n_buckets, 16]; depth u32[n_buckets * 8 + 1] (updated in place);
// mask u32[ceil(R * (L - k + 1) / 32)] (written in full).
extern "C" int qm2t_count_mono_rows(const void* pk, const void* aux, int lens,
                                    const void* rows, void* depth, void* mask,
                                    int n_rows, int L, int k,
                                    long long n_buckets, void* stream) {
  if (k < 1 || k > kMaxK || L < k || L > 65535 || n_rows < 1 ||
      n_buckets < 1 || n_buckets > (1LL << 32) ||
      (n_buckets & (n_buckets - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n = (long long)n_rows * (L - k + 1);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (lens) {
    count_mono_rows_kernel<true><<<(unsigned)blocks, kThreads, 0,
                                   (cudaStream_t)stream>>>(
        (const uint8_t*)pk, (const uint8_t*)aux, (const uint4*)rows,
        (unsigned*)depth, (unsigned*)mask, n_rows, L, k,
        (unsigned)(n_buckets - 1));
  } else {
    count_mono_rows_kernel<false><<<(unsigned)blocks, kThreads, 0,
                                    (cudaStream_t)stream>>>(
        (const uint8_t*)pk, (const uint8_t*)aux, (const uint4*)rows,
        (unsigned*)depth, (unsigned*)mask, n_rows, L, k,
        (unsigned)(n_buckets - 1));
  }
  return (int)cudaGetLastError();
}
