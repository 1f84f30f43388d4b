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
// K2r replaces quickmer2_tpu/ops/anchored.py::exact_count_rows_mono_packed
// (:942-949) over exact_count_rows_mono (:916-939), the spill recount of
// AnchoredDepthCounter: steps 2-6 over R read rows of pitch L in the
// ops/rowpack.py::pack_batch layout, lane i = r * W + j for window j < W =
// L - k + 1 of row r (no window crosses a row end). Window j is valid when
// j + k <= len_r (lens format: u16 length a row) or none of its k invalid
// bits is set (mask format: a bitmask of ceil(L / 8) bytes a row). The
// unresolved mask is LSB-first u32 words over the R * W lanes (the JAX
// function's packbits order is not kept; the drain decodes this one).
//
// The codec is word-parallel. The layout stores base t of a stream at bits
// 2 (t & 3) of byte t >> 2, so as 64-bit words base t sits at bit 2t, and a
// window of k <= 32 bases is one funnel shift of two consecutive words, X =
// sum_j b_{i+j} << 2j. With A = 0xAAAA... over 2k bits (complement is b ^ 2
// in the alphabet A=0, C=1, T=2, G=3), RC = X ^ A and F = rev2(X) >> (64 -
// 2k), rev2 reversing the 2-bit lanes (packed_probe.cuh::canonical_lsb).
// Validity is the same funnel shift over the invalid bitmask, tested on k
// bits. No loop over k. The codec and K2's window map live in
// flat_windows.cuh, which csrc/count_flat.cu (K7, K8, K9) shares. A window
// map (FlatWindows for K2, RowWindows for K2r) says where a lane's window
// starts: K2's lane i at bit 2i of the batch and i of its bitmask; K2r's
// lane r * W + j at bit 8 * pitch * r + 2j of
// the packed rows (pitch = ceil(L / 4) bytes, so a row may start inside a
// word: L = 150 gives 38 B) and at bit 8 * ceil(L / 8) * r + j of the mask.
// K2r finds r by a 32-bit multiply-high by a reciprocal of W and one
// correction, not by a divide. A block of lanes stages the words its lanes
// read once, in shared memory (tail padded: 2-bit lanes with 0, invalid
// bits with 1), and reads each window from there. K2r's blocks take 512
// lanes (kRowTile): on the main path's exact batch, tiles of 512 and 1024
// ran ~17 % faster than 4096, whose 838 blocks leave SMs idle at the end
// (PERF.md, PR 5). K2r probes in one pass (P = 1): the touched rows of
// its exact batches fit L2, where slices only add passes.
//
// The table (2^22 buckets on the main paths: 256 MiB of rows and 128 MiB
// of depth) is 5x the 50 MB L2, so one random 64-B row per window is an
// HBM access at its first touch. With P > 1 K2 cuts the buckets into P
// slices by the top log2 P bits of the bucket index, each slice's rows and
// depth words ~24 MB (kernels/count_mono.py::partitions_for), and one call
// runs three passes:
//   count   — codec and DJB per window, a per-block shared histogram over
//             the P slices, added once per block into the slice totals;
//   scatter — the same per window; each block reserves a run in each
//             slice's bin (the slice's start is the exclusive scan of the
//             totals, the run one atomicAdd on the slice's fill) and writes
//             the 4-B lane index of every valid nonzero window there;
//   probe   — a thread per binned window, in slice order: decode the
//             code again from the packed batch (L2-resident), probe, add to
//             depth and set unresolved lanes by atomicOr into the zeroed
//             mask. A slice's rows and depth words come from HBM at their
//             first touch and from L2 after it.
// With P = 1 one pass probes every window where it is decoded and writes
// each mask word by ballot (a block's lanes are whole mask words).
//
// K12 replaces quickmer2_tpu/ops/anchored.py::exact_count_rows (:870) as
// exact_count_rows_packed (:905) runs it, and its dict-sharded form (the
// block-restricted probe, :880-887): the anchored path's exact recount
// through the PACKED table, for a counter without the mono table
// (mono_spill off, and every sharded anchored counter). A valid nonzero
// window found in the bucket block adds 1 to acc at its rank, a plain
// count (the caller adds acc to the cumsum of diff at finish). A miss or
// an invalid window adds nothing: the JAX function sends those to a trash
// word no caller reads. Its first design was K2r's one pass with the
// block probe reading both candidate rows of every window. It is K2r's
// one pass still, with K8b's probe (block_probe.cuh::BlockProbe): h2's
// row is read only where h1's misses, is full and the block's bitmap of
// keys at h2 allows, so on the smoke's exact batch (99 % misses) a window
// reads one row where it read two. K8b's bin and probe passes over this
// map (512 windows a tile, a slice's runs of 32 tiles a probe block) ran
// slower at every slice count from 2 to 256 (PERF.md, section 6): the
// batch's windows re-read the rows they touch ~6 times and those rows fit
// L2, so binning by slice only adds a pass.
//
// Bound on the H100 (3.35 TB/s HBM): the least a call must move is the
// packed batch, each touched row once, the 32-B sector of each bucket's
// depth words with a hit read and written once, and the mask;
// chip_smoke.py computes it from each run's batch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_probe.cuh"
#include "flat_windows.cuh"
#include "packed_probe.cuh"

namespace {

constexpr unsigned kEntries = 8;
constexpr int kRowTile = 512;               // K2r's lanes per block
constexpr int kRowStageWords = 576;         // K2r's staged words, each stream
constexpr int kMaxParts = 256;

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

// The most words a K2r block of `tile` lanes stages in either stream (see
// RowWindows::stage): its lanes span at most D + 1 rows, D = (tile + W -
// 2) / W; a row holds at most 2 (W + k + 2) bits of 2-bit lanes and W + k
// + 6 invalid bits, and a stream of span bits takes at most (span + 62) /
// 64 + 2 words. D, and so the count, is largest at W = 1, and the 2-bit
// lanes outgrow the invalid bits, so W = 1 and k = 32 bound every shape.
constexpr long long row_stage_words(long long tile, long long W, int k,
                                    bool lens) {
  const long long D = (tile + W - 2) / W;
  const long long pk_bits = 2 * (tile - 1) + 2LL * (k + 2) * D + 2 * k;
  const long long aux_bits = lens ? 16 * D + 16 : tile - 1 + (k + 6) * D + k;
  const long long bits = pk_bits > aux_bits ? pk_bits : aux_bits;
  return (bits + 62) / 64 + 2;
}
static_assert(row_stage_words(kRowTile, 1, kMaxK, false) <= kRowStageWords,
              "K2r's staged words overflow kRowStageWords");

// K2r's window map: lane i = r * W + j is window j of read row r. aux is
// the lens (LENS: u16 a row, pitch 2) or the invalid bitmask (pitch
// ceil(L / 8)); n = R * W < 2^32.
template <bool LENS>
struct RowWindows {
  const uint8_t* pk;
  const uint8_t* aux;
  long long pk_bytes, aux_bytes;
  long long n;
  unsigned W, recip;    // recip = floor((2^32 - 1) / W)
  int pitch, aux_pitch, k;

  struct Tile {
    u64 pk[kRowStageWords];
    u64 aux[kRowStageWords];
  };
  // The block's first row, and the bit where that row starts in each
  // staged stream (negative where the block starts inside it).
  struct Span {
    unsigned r0;
    int pk_off, aux_off;
  };

  // Row of lane i: the multiply-high gives r or r - 1 (i < 2^32).
  __device__ __forceinline__ unsigned row_of(unsigned i) const {
    const unsigned q = __umulhi(i, recip);
    return i - q * W >= W ? q + 1 : q;
  }

  __host__ __device__ __forceinline__ int lanes() const { return kRowTile; }

  // Stage the bits the block's lanes read: 2-bit lanes [8 pitch r0 + 2 j0,
  // 8 pitch r1 + 2 (j1 + k)) and the aux bits of rows r0 .. r1, the first
  // lane (r0, j0) to the last (r1, j1); both fit kRowStageWords
  // (row_stage_words).
  __device__ __forceinline__ Span stage(Tile& t, long long base) const {
    const unsigned b0 = (unsigned)base;
    const unsigned b1 =
        (unsigned)(base + kRowTile < n ? base + kRowTile - 1 : n - 1);
    const unsigned r0 = row_of(b0), r1 = row_of(b1);
    const unsigned j0 = b0 - r0 * W, j1 = b1 - r1 * W;
    const long long p0 = 8LL * pitch * r0, p1 = 8LL * pitch * r1;
    const long long ps = p0 + 2 * j0, pe = p1 + 2 * (j1 + k);
    const long long a0 = 8LL * aux_pitch * r0, a1 = 8LL * aux_pitch * r1;
    const long long as = a0 + (LENS ? 0 : j0);
    const long long ae = a1 + (LENS ? 16 : j1 + k);
    stage_words(t.pk, (int)(((pe - 1) >> 6) - (ps >> 6) + 2), pk, ps >> 6,
                pk_bytes, 0);
    stage_words(t.aux, (int)(((ae - 1) >> 6) - (as >> 6) + 2), aux, as >> 6,
                aux_bytes, ~0ull);
    __syncthreads();
    return Span{r0, (int)(p0 - 64 * (ps >> 6)), (int)(a0 - 64 * (as >> 6))};
  }

  __device__ __forceinline__ bool window(const Tile& t, const Span& sp,
                                         long long base, int jj,
                                         u64* canon) const {
    if (base + jj >= n) return false;
    const unsigned i = (unsigned)(base + jj);
    const unsigned r = row_of(i), j = i - r * W;
    const int dr = (int)(r - sp.r0);
    const int pb = sp.pk_off + 8 * pitch * dr + 2 * (int)j;
    const int ab = sp.aux_off + 8 * aux_pitch * dr;
    if (LENS) {
      const unsigned len = (unsigned)(t.aux[ab >> 6] >> (ab & 63)) & 0xFFFFu;
      if (j + k > len) return false;
      *canon = qm2t::canonical_lsb(bits_at(t.pk, pb), k);
      return *canon != 0;
    }
    return staged_window(t.pk, pb, t.aux, ab + (int)j, k, canon);
  }
};

// P = 1: decode and probe in one pass; one mask word per warp and round
// (a block's lanes start at a multiple of 32).
template <class Map>
__global__ void __launch_bounds__(kThreads)
count_mono_direct_kernel(Map m, const uint4* __restrict__ rows,
                         unsigned* __restrict__ depth,
                         unsigned* __restrict__ mask, unsigned bucket_mask) {
  __shared__ typename Map::Tile tile;
  const long long base = (long long)blockIdx.x * m.lanes();
  const typename Map::Span sp = m.stage(tile, base);
  const long long n_words = (m.n + 31) >> 5;
  for (int j = threadIdx.x; j < m.lanes(); j += kThreads) {
    u64 canon;
    bool unresolved = false;
    if (m.window(tile, sp, base, j, &canon)) {
      unresolved = mono_probe(canon, rows, depth, bucket_mask);
    }
    const unsigned word = __ballot_sync(0xFFFFFFFFu, unresolved);
    const long long w = (base + j) >> 5;
    if ((threadIdx.x & 31) == 0 && w < n_words) mask[w] = word;
  }
}

// K12: the packed exact recount over read rows in one pass. A valid
// nonzero window whose canonical code sits in the block's rows (h1's row,
// then h2's where it may hold the key) adds 1 to acc at its rank (plain
// counts, not slots). Misses add nothing.
template <class Map>
__global__ void __launch_bounds__(kThreads)
exact_packed_kernel(Map m, BlockProbe eng, unsigned* __restrict__ acc) {
  __shared__ typename Map::Tile tile;
  const long long base = (long long)blockIdx.x * m.lanes();
  const typename Map::Span sp = m.stage(tile, base);
  for (int j = threadIdx.x; j < m.lanes(); j += kThreads) {
    u64 canon;
    unsigned rank;
    if (m.window(tile, sp, base, j, &canon) && eng.probe(canon, &rank) >= 0) {
      atomicAdd(acc + rank, 1u);
    }
  }
}

// K2's sliced passes (P > 1). Slice of each window of the tile (kNoPart
// where it cannot hit) into part[], and the block's histogram over the
// slices into hist[].
__device__ __forceinline__ void tile_parts(
    const FlatWindows& m, const FlatWindows::Tile& t,
    const FlatWindows::Span& sp, long long base, int part_shift,
    unsigned bucket_mask, unsigned short* part, unsigned* hist,
    int n_parts) {
  for (int p = threadIdx.x; p < n_parts; p += kThreads) hist[p] = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < m.lanes(); j += kThreads) {
    u64 canon;
    unsigned short s = kNoPart;
    if (m.window(t, sp, base, j, &canon)) {
      const unsigned h = qm2t::djb_pair((unsigned)(canon >> 32), (unsigned)canon);
      s = (unsigned short)((h & bucket_mask) >> part_shift);
      atomicAdd(&hist[s], 1u);
    }
    part[j] = s;
  }
  __syncthreads();
}

// Pass 1: the slices' window totals.
__global__ void __launch_bounds__(kThreads)
count_mono_hist_kernel(FlatWindows m, unsigned* __restrict__ totals,
                       int n_parts, int part_shift, unsigned bucket_mask) {
  __shared__ FlatWindows::Tile tile;
  __shared__ unsigned short part[kTile];
  __shared__ unsigned hist[kMaxParts];
  const long long base = (long long)blockIdx.x * m.lanes();
  const FlatWindows::Span sp = m.stage(tile, base);
  tile_parts(m, tile, sp, base, part_shift, bucket_mask, part, hist, n_parts);
  for (int p = threadIdx.x; p < n_parts; p += kThreads) {
    if (hist[p]) atomicAdd(totals + p, hist[p]);
  }
}

// Pass 2: each valid nonzero window's lane index into its slice's bin.
// bins holds the slices one after another, slice p from the sum of the
// totals before it (an exclusive scan); a block reserves its run in each
// slice by one atomicAdd on the slice's fill.
__global__ void __launch_bounds__(kThreads)
count_mono_scatter_kernel(FlatWindows m, const unsigned* __restrict__ totals,
                          unsigned* __restrict__ fill,
                          unsigned* __restrict__ bins, int n_parts,
                          int part_shift, unsigned bucket_mask) {
  __shared__ FlatWindows::Tile tile;
  __shared__ unsigned short part[kTile];
  __shared__ unsigned hist[kMaxParts];
  __shared__ unsigned cursor[kMaxParts];
  const long long base = (long long)blockIdx.x * m.lanes();
  for (int p = threadIdx.x; p < n_parts; p += kThreads) cursor[p] = totals[p];
  const FlatWindows::Span sp = m.stage(tile, base);
  tile_parts(m, tile, sp, base, part_shift, bucket_mask, part, hist, n_parts);
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
  for (int j = threadIdx.x; j < m.lanes(); j += kThreads) {
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
count_mono_probe_kernel(FlatWindows m, const unsigned* __restrict__ totals,
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
  if (mono_probe(m.decode(i), rows, depth, bucket_mask)) {
    atomicOr(mask + (i >> 5), 1u << (i & 31));
  }
}

int log2_of(long long x) {
  int s = 0;
  while ((1LL << s) < x) ++s;
  return s;
}

// One pass over the m.n lanes of a window map (P = 1).
template <class Map>
int count_direct(const Map& m, const void* rows, void* depth, void* mask,
                 long long n_buckets, cudaStream_t s) {
  const long long tiles = (m.n + m.lanes() - 1) / m.lanes();
  count_mono_direct_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      m, (const uint4*)rows, (unsigned*)depth, (unsigned*)mask,
      (unsigned)(n_buckets - 1));
  return (int)cudaGetLastError();
}

// One K2 call at P = n_parts slices; work u32[2 * P + m.n] (P > 1 only).
int count_windows(const FlatWindows& m, const void* rows, void* depth,
                  void* mask, long long n_buckets, int n_parts, void* work,
                  cudaStream_t s) {
  if (n_parts == 1) return count_direct(m, rows, depth, mask, n_buckets, s);
  const unsigned bucket_mask = (unsigned)(n_buckets - 1);
  const long long tiles = (m.n + m.lanes() - 1) / m.lanes();
  const int part_shift = log2_of(n_buckets) - log2_of(n_parts);
  unsigned* totals = (unsigned*)work;
  unsigned* fill = totals + n_parts;
  unsigned* bins = fill + n_parts;
  cudaError_t rc = cudaMemsetAsync(totals, 0, 2 * n_parts * sizeof(unsigned), s);
  if (rc == cudaSuccess) {
    rc = cudaMemsetAsync(mask, 0, ((m.n + 31) >> 5) * sizeof(unsigned), s);
  }
  if (rc != cudaSuccess) return (int)rc;
  count_mono_hist_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      m, totals, n_parts, part_shift, bucket_mask);
  count_mono_scatter_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      m, totals, fill, bins, n_parts, part_shift, bucket_mask);
  count_mono_probe_kernel<<<(unsigned)((m.n + kThreads - 1) / kThreads),
                            kThreads, 0, s>>>(
      m, totals, bins, (const uint4*)rows, (unsigned*)depth, (unsigned*)mask,
      n_parts, bucket_mask);
  return (int)cudaGetLastError();
}

bool bad_table(long long n_buckets, int n_parts) {
  return n_buckets < 1 || n_buckets > (1LL << 32) ||
         (n_buckets & (n_buckets - 1)) != 0 || n_parts < 1 ||
         n_parts > kMaxParts || n_parts > n_buckets ||
         (n_parts & (n_parts - 1)) != 0;
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
  if (k < 1 || k > kMaxK || n_bases < k || bad_table(n_buckets, n_parts) ||
      n_bases - k + 1 > 0xFFFFFFFFLL || (n_parts > 1 && work == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (((uintptr_t)pk | (uintptr_t)bits) & 7) {
    return (int)cudaErrorMisalignedAddress;
  }
  const FlatWindows m = {(const uint8_t*)pk, (const uint8_t*)bits,
                         (n_bases + 3) / 4, (n_bases + 7) / 8,
                         n_bases - k + 1, k};
  return count_windows(m, rows, depth, mask, n_buckets, n_parts, work,
                       (cudaStream_t)stream);
}

// pk u8[R, ceil(L/4)]; aux u16[R] (lens = 1) or u8[R, ceil(L/8)] (lens =
// 0), both 8-B aligned; rows u32[n_buckets, 16]; depth u32[n_buckets * 8 +
// 1] (updated in place); mask u32[ceil(R * (L - k + 1) / 32)] (written in
// full).
extern "C" int qm2t_count_mono_rows(const void* pk, const void* aux, int lens,
                                    const void* rows, void* depth, void* mask,
                                    int n_rows, int L, int k,
                                    long long n_buckets, void* stream) {
  const long long W = (long long)L - k + 1;
  if (k < 1 || k > kMaxK || L < k || L > 65535 || n_rows < 1 ||
      n_rows * W > 0xFFFFFFFFLL || bad_table(n_buckets, 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (((uintptr_t)pk | (uintptr_t)aux) & 7) {
    return (int)cudaErrorMisalignedAddress;
  }
  const int pitch = (L + 3) / 4, aux_pitch = lens ? 2 : (L + 7) / 8;
  const long long pk_bytes = (long long)n_rows * pitch;
  const long long aux_bytes = (long long)n_rows * aux_pitch;
  const unsigned recip = (unsigned)(0xFFFFFFFFu / (unsigned)W);
  cudaStream_t s = (cudaStream_t)stream;
  if (lens) {
    const RowWindows<true> m = {(const uint8_t*)pk, (const uint8_t*)aux,
                                pk_bytes, aux_bytes, n_rows * W,
                                (unsigned)W, recip, pitch, aux_pitch, k};
    return count_direct(m, rows, depth, mask, n_buckets, s);
  }
  const RowWindows<false> m = {(const uint8_t*)pk, (const uint8_t*)aux,
                               pk_bytes, aux_bytes, n_rows * W, (unsigned)W,
                               recip, pitch, aux_pitch, k};
  return count_direct(m, rows, depth, mask, n_buckets, s);
}

namespace {

template <class Map>
int exact_direct(const Map& m, const BlockProbe& eng, void* acc,
                 cudaStream_t s) {
  const long long tiles = (m.n + m.lanes() - 1) / m.lanes();
  exact_packed_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(m, eng,
                                                           (unsigned*)acc);
  return (int)cudaGetLastError();
}

}  // namespace

// K12. pk, aux as qm2t_count_mono_rows; rows u32[block_buckets, 8], the
// packed table's buckets [blk_lo, blk_lo + block_buckets) (the whole table:
// blk_lo = 0, block_buckets = n_buckets); displaced u32[2^filter_bits /
// 32] the block's bitmap of keys at h2 (kernels/block_probe.py::
// block_displaced_filter); acc u32[n_acc] (updated in place; every rank in
// the rows < n_acc).
extern "C" int qm2t_exact_rows_packed(const void* pk, const void* aux,
                                      int lens, const void* rows,
                                      const void* displaced, int filter_bits,
                                      long long n_buckets, long long blk_lo,
                                      long long block_buckets, void* acc,
                                      int n_rows, int L, int k,
                                      void* stream) {
  const long long W = (long long)L - k + 1;
  if (k < 1 || k > kMaxK || L < k || L > 65535 || n_rows < 1 ||
      n_rows * W > 0xFFFFFFFFLL || bad_table(n_buckets, 1) ||
      block_buckets < 1 || blk_lo < 0 || blk_lo + block_buckets > n_buckets ||
      filter_bits < 5 || filter_bits > 32) {
    return (int)cudaErrorInvalidValue;
  }
  if (((uintptr_t)pk | (uintptr_t)aux) & 7) {
    return (int)cudaErrorMisalignedAddress;
  }
  const int pitch = (L + 3) / 4, aux_pitch = lens ? 2 : (L + 7) / 8;
  const long long pk_bytes = (long long)n_rows * pitch;
  const long long aux_bytes = (long long)n_rows * aux_pitch;
  const unsigned recip = (unsigned)(0xFFFFFFFFu / (unsigned)W);
  const BlockProbe eng = {(const uint4*)rows, (const unsigned*)displaced,
                          (unsigned)(n_buckets - 1), (unsigned)blk_lo,
                          (unsigned)(block_buckets - 1), 0,
                          32 - filter_bits};
  cudaStream_t s = (cudaStream_t)stream;
  if (lens) {
    const RowWindows<true> m = {(const uint8_t*)pk, (const uint8_t*)aux,
                                pk_bytes, aux_bytes, n_rows * W,
                                (unsigned)W, recip, pitch, aux_pitch, k};
    return exact_direct(m, eng, acc, s);
  }
  const RowWindows<false> m = {(const uint8_t*)pk, (const uint8_t*)aux,
                               pk_bytes, aux_bytes, n_rows * W, (unsigned)W,
                               recip, pitch, aux_pitch, k};
  return exact_direct(m, eng, acc, s);
}
