// Fused mono-table count steps: the flat count path's (K2) and the
// anchored path's exact recount over read rows (K2r).
//
// K2 replaces quickmer2_tpu/pipelines/count.py::count_step_mono_pk (:137-142),
// an XLA device function: rowpack.unpack_rows + codec.sliding_kmers +
// monotable.probe_mono (with hash.djb_pair) + the depth scatter-add + a
// packbits of the unresolved lanes. XLA ran that as a chain of whole-array
// passes over the batch; here one thread owns one k-mer window and keeps
// every intermediate in registers.
//
// For each window i < n_bases - k + 1:
//   1. its k codes come from the block's shared tile, which the block
//      unpacks once from the 2-bit lanes and the invalid bitmask
//      (ops/rowpack.py layout, one row = the batch; SEP = 4);
//   2. forward and reverse-complement 2k-bit codes (ops/codec.py), and the
//      canonical code = their minimum;
//   3. valid = no separator in the window;
//   4. DJB2 mod 2^32 over the 4 lo bytes, then the 4 hi bytes;
//   5. bucket = h & (n_buckets - 1); its 64-B row is four 16-B loads;
//   6. the 8 entries (hi, lo) are compared under the nonzero-query mask
//      (quirk Q3: code 0 never matches an empty entry);
//   7. a hit adds 1 to depth[bucket * 8 + entry] (atomicAdd, u32 wrap);
//   8. unresolved = nonzero & miss & every entry used; each warp's 32
//      flags become one u32 mask word by ballot, LSB first: lane i is bit
//      i & 31 of word i >> 5.
// A miss adds nothing. The JAX step sends misses to a trash counter whose
// value no caller reads, so depth[:-1] is the whole contract.
//
// K2r replaces quickmer2_tpu/ops/anchored.py::exact_count_rows_mono_packed
// (:940-949), the spill recount of AnchoredDepthCounter: the same steps over
// R read rows of pitch L, one thread per window lane i < R*W (W = L - k + 1,
// row i / W, offset i % W), so no window crosses a row end. A thread reads
// its k bases from the row's 2-bit lanes and its lens (u16 length) or mask
// (invalid bitmask) aux, as ops/rowpack.py::pack_batch lays them out. The
// unresolved mask is LSB-first u32 words over the R*W lanes (the JAX
// function's packbits order is not kept; the drain decodes this one).
//
// Bound on the H100 (3.35 TB/s HBM): per window ~0.375 B of packed input,
// one 64-B row read and one 4-B depth read-modify-write, against ~8k + 60
// integer operations. A main-path table (~4 M buckets, 256 MB) is larger
// than the 50 MB L2, so the row reads are random HBM accesses: the kernel
// is bound by bytes. The least it must move is the packed batch, each
// touched row once and each touched depth word read and written once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 32;
constexpr unsigned kEntries = 8;
constexpr unsigned kSep = 4;

// Probe one valid window's canonical code: depth[slot] += 1 on a hit;
// returns unresolved = nonzero & miss & every entry of the bucket used.
__device__ __forceinline__ bool mono_probe(unsigned long long canon,
                                           const uint4* __restrict__ rows,
                                           unsigned* __restrict__ depth,
                                           unsigned bucket_mask) {
  const unsigned hi = (unsigned)(canon >> 32);
  const unsigned lo = (unsigned)canon;
  unsigned h = 5381u;
  for (int s = 0; s < 32; s += 8) h = h * 33u + ((lo >> s) & 0xFFu);
  for (int s = 0; s < 32; s += 8) h = h * 33u + ((hi >> s) & 0xFFu);
  const unsigned bucket = h & bucket_mask;
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
    atomicAdd(depth + (unsigned long long)bucket * kEntries + ent, 1u);
  }
  return nonzero && !found && full;
}

__global__ void __launch_bounds__(kThreads)
count_mono_kernel(const uint8_t* __restrict__ pk,
                  const uint8_t* __restrict__ bits,
                  const uint4* __restrict__ rows,
                  unsigned* __restrict__ depth,
                  unsigned* __restrict__ mask,
                  long long n_bases, int k, unsigned bucket_mask) {
  __shared__ uint8_t tile[kThreads + kMaxK];
  const long long n = n_bases - k + 1;
  const long long base = (long long)blockIdx.x * kThreads;
  for (int t = threadIdx.x; t < kThreads + k - 1; t += kThreads) {
    const long long p = base + t;
    unsigned c = kSep;
    if (p < n_bases && !((bits[p >> 3] >> (p & 7)) & 1u)) {
      c = (pk[p >> 2] >> (2 * (p & 3))) & 3u;
    }
    tile[t] = (uint8_t)c;
  }
  __syncthreads();

  const long long i = base + threadIdx.x;
  bool unresolved = false;
  if (i < n) {
    const unsigned long long code_mask =
        k == 32 ? ~0ULL : (1ULL << (2 * k)) - 1;
    const int top = 2 * k - 2;
    unsigned long long fwd = 0, rc = 0;
    bool valid = true;
    for (int j = 0; j < k; ++j) {
      const unsigned c = tile[threadIdx.x + j];
      valid = valid && c < kSep;
      const unsigned long long b = c & 3u;
      fwd = ((fwd << 2) | b) & code_mask;
      rc = (rc >> 2) | (((b + 2) & 3u) << top);   // complement = (b-2)&3
    }
    if (valid) {
      unresolved = mono_probe(fwd <= rc ? fwd : rc, rows, depth, bucket_mask);
    }
  }
  const unsigned word = __ballot_sync(0xFFFFFFFFu, unresolved);
  if ((threadIdx.x & 31) == 0 && i < n) mask[i >> 5] = word;
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
    const unsigned long long code_mask =
        k == 32 ? ~0ULL : (1ULL << (2 * k)) - 1;
    const int top = 2 * k - 2;
    unsigned long long fwd = 0, rc = 0;
    bool valid = true;
    for (int q = 0; q < k; ++q) {
      const int t = j + q;
      valid = valid && (LENS ? t < len : !((__ldg(arow + (t >> 3)) >> (t & 7)) & 1u));
      const unsigned long long b = (__ldg(prow + (t >> 2)) >> (2 * (t & 3))) & 3u;
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

}  // namespace

extern "C" const char* qm2t_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// pk u8[ceil(n_bases/4)], bits u8[ceil(n_bases/8)], rows u32[n_buckets, 16],
// depth u32[n_buckets * 8 + 1] (updated in place),
// mask u32[ceil((n_bases - k + 1) / 32)] (written in full).
extern "C" int qm2t_count_mono(const void* pk, const void* bits,
                               const void* rows, void* depth, void* mask,
                               long long n_bases, int k, long long n_buckets,
                               void* stream) {
  if (k < 1 || k > kMaxK || n_bases < k || n_buckets < 1 ||
      n_buckets > (1LL << 32) || (n_buckets & (n_buckets - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n = n_bases - k + 1;
  const long long blocks = (n + kThreads - 1) / kThreads;
  count_mono_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)pk, (const uint8_t*)bits, (const uint4*)rows,
      (unsigned*)depth, (unsigned*)mask, n_bases, k,
      (unsigned)(n_buckets - 1));
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
