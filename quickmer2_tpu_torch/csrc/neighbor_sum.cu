// Per-neighbor packed-table sum of the search's edit filter (K6).
//
// Replaces quickmer2_tpu/ops/editdist.py::neighbor_occr_sum_packed (:152,
// with _neighbor_canon :126 and _apply_edit_pair :58), an XLA device
// function that materialises every (query, edit) pair, probes the packed
// table with two row gathers each and sums over the edit axis. The
// function is the same: for each query q (its canonical code and the
// exact reverse complement of that code) and each of the M edits of
// ops/editdist.py::edit_table(k, e),
//
//   out[q] = sum over edits of pos(canonical(edit(q)))  where it is found
//
// An edit substitutes base (b + d1) & 3 at position p1 and, for a double
// edit, (b + d2) & 3 at p2 < p1 on the forward code; the reverse
// complement takes the same XOR at 2 (k - 1 - p). The canonical code is
// the smaller of the two. The table carries each k-mer's occurrence count
// in its entries' pos field, so the sum is the neighbors' occurrences.
// The probe is csrc/packed_probe.cuh's: a code of 0 never matches (empty
// entries are (0, 0)), and where both candidate buckets hold the key the
// later entry wins. M * 255 < 2^32, so the u32 sum cannot wrap.
//
// The edit table travels as one u32 per edit (p1 in bits 0-5, d1 in 6-7,
// p2 in 8-13, d2 in 14-15; a single edit has p2 = d2 = 0, a no-op): 16 KB
// at k = 30, e = 2, read through the read-only cache. Four u32 arrays of
// M entries would pass the 64 KB of __constant__ memory at k = 32, and a
// constant bank serialises the lanes' different addresses anyway.
//
// Design: a warp per query, a block per eight queries. The lanes stride
// over the edits (edit m at lane m % 32), apply them on the 64-bit (fwd,
// rc) pair held in registers, hash and probe; each lane keeps one sum, a
// shuffle reduction leaves the total in lane 0, and lane 0 stores it: one
// store per query, no atomics, no shared memory.
//
// Bound on the H100: the table (2^24 buckets, 512 MB, on the smoke) is
// far larger than L2, so every probe reads two random 32-B rows from HBM;
// the least traffic counts each row that some probe names once, against
// ~70 integer operations a neighbor (two edits on a 64-bit pair, the
// canonical min, DJB over 8 bytes, two bucket indices, four entry
// compares). chip_smoke.py computes both from each run's inputs.

#include <cuda_runtime.h>

#include "packed_probe.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Args {
  const unsigned* qh;
  const unsigned* ql;
  const unsigned* rh;
  const unsigned* rl;
  const unsigned* edits;
  const uint4* rows;
  unsigned* out;
  long long n;
  int m;
  int k;
  unsigned bucket_mask;
};

// Substitute (base + d) & 3 at position p of the forward code and the
// complementary change at k - 1 - p of the reverse complement.
__device__ __forceinline__ void apply_edit(unsigned long long& f,
                                           unsigned long long& r, int p,
                                           unsigned d, int k) {
  const unsigned long long base = (f >> (2 * p)) & 3ull;
  const unsigned long long x = base ^ ((base + d) & 3ull);
  f ^= x << (2 * p);
  r ^= x << (2 * (k - 1 - p));
}

__global__ void __launch_bounds__(kThreads) neighbor_sum_kernel(const Args a) {
  const long long q = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (q >= a.n) return;                      // warp-uniform
  const int lane = threadIdx.x & 31;
  const unsigned long long f0 =
      ((unsigned long long)__ldg(a.qh + q) << 32) | __ldg(a.ql + q);
  const unsigned long long r0 =
      ((unsigned long long)__ldg(a.rh + q) << 32) | __ldg(a.rl + q);
  unsigned acc = 0;
  for (int i = lane; i < a.m; i += 32) {
    const unsigned ed = __ldg(a.edits + i);
    unsigned long long f = f0, r = r0;
    apply_edit(f, r, ed & 63u, (ed >> 6) & 3u, a.k);
    apply_edit(f, r, (ed >> 8) & 63u, (ed >> 14) & 3u, a.k);
    unsigned rank, pos;
    if (qm2t::packed_probe(a.rows, f <= r ? f : r, a.bucket_mask, &rank,
                           &pos)) {
      acc += pos;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
  if (lane == 0) a.out[q] = acc;
}

}  // namespace

extern "C" const char* qm2t_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// qh, ql, rh, rl u32[n]: the queries' codes and their exact reverse
// complements; edits u32[m] (packed as above); rows: the packed table,
// u32[n_buckets, 8] with occurrence counts in pos; out u32[n].
extern "C" int qm2t_neighbor_sum(const void* qh, const void* ql,
                                 const void* rh, const void* rl,
                                 const void* edits, int m, const void* rows,
                                 long long n_buckets, int k, long long n,
                                 void* out, void* stream) {
  if (k < 1 || k > 32 || m < 1 || n < 0 || n_buckets < 1 ||
      n_buckets > (1ll << 32) || (n_buckets & (n_buckets - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  const long long blocks = (n + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const Args a = {(const unsigned*)qh, (const unsigned*)ql,
                  (const unsigned*)rh, (const unsigned*)rl,
                  (const unsigned*)edits, (const uint4*)rows,
                  (unsigned*)out, n, m, k,
                  (unsigned)(n_buckets - 1)};
  neighbor_sum_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
