// Per-neighbor packed-table sum of the search's edit filter (K6), behind
// the table's L2-resident key filter.
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
// p2 in 8-13, d2 in 14-15; a single edit has p2 = d2 = 0, a no-op with a
// zero hash delta): 16 KB at k = 30, e = 2, read through the read-only
// cache. Four u32 arrays of M entries would pass the 64 KB of __constant__
// memory at k = 32, and a constant bank serialises the lanes' different
// addresses anyway.
//
// Design: a warp per query, a block per eight queries; the lanes stride
// over the edits (edit m at lane m % 32). Each lane hashes the query's
// two strands once. For an edit it builds both strands' codes by XOR,
// takes the canonical one, and gets its DJB hash as that strand's hash
// plus one delta per substituted field (packed_probe.cuh's djb_delta).
// It does that for kBatch edits and loads their key-filter words before
// it tests any, so that kBatch L2 loads a lane are in flight together;
// only a probe whose three filter bits are all set reads the two table
// rows. Each lane keeps one sum, a shuffle reduction leaves the total in
// lane 0, and lane 0 stores it: one store per query, no atomics, no
// shared memory.
//
// Bound on the H100. The smoke's table (2^25 buckets, 1.07 GB) is 20x the
// 50 MB L2, so an unfiltered probe reads two random 32-B rows from HBM;
// a kernel that probed every neighbor so ran at the card's random-sector
// rate, 17x its bound.
// Most substitution neighbors of a k-mer do not occur in the genome. The
// key filter (8 bits a key, 16 MB at the smoke's 11.7 M keys) stays in
// L2: a probe costs one 32-B L2 sector, and only the probes that pass it
// (2.5 % on the smoke's slow set, chip_smoke.py on an H100 80GB HBM3 at
// 700 W) read the table. There K6 probes at ~122 G probes/s, K4's rate:
// the L2's rate of sector requests, not its bytes, sets both. What is
// left is ~42 integer operations a probe (two substituted bases put into
// both strands' codes, the canonical min, the hash by two deltas, the
// filter word and its three bits) and ~16 more a passing probe (two
// bucket indices, four entry compares), which is what chip_smoke.py's
// operations bound counts; its
// byte bound counts each table row that a passing probe names and each
// filter sector that a probe names, once. The filter is capped at 32 MB
// (2^28 bits) to stay in L2, so past ~33 M keys its bits per key fall
// below 8 and its pass rate climbs (~15 % at 4 bits a key); there a probe
// costs one L2 load more than an unfiltered probe's two row reads.

#include <cuda_runtime.h>

#include "packed_probe.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 4;           // edits a lane takes per filter round
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Args {
  const unsigned* qh;
  const unsigned* ql;
  const unsigned* rh;
  const unsigned* rl;
  const unsigned* edits;
  const uint4* rows;
  const unsigned* filt;
  unsigned* out;
  long long n;
  int m;
  int k;
  unsigned bucket_mask;
  int wbits;
};

// The canonical code of edit `ed` of the query (f0 forward, r0 its
// reverse complement, hf and hr their DJB hashes); its hash goes to *h.
// For a double edit p2 < p1, so the base at p2 is still the query's.
__device__ __forceinline__ unsigned long long edit_canon(
    unsigned ed, unsigned long long f0, unsigned long long r0, unsigned hf,
    unsigned hr, int k, unsigned* h) {
  const int p1 = ed & 63u, p2 = (ed >> 8) & 63u;
  const unsigned b1 = (unsigned)(f0 >> (2 * p1)) & 3u;
  const unsigned b2 = (unsigned)(f0 >> (2 * p2)) & 3u;
  const unsigned n1 = (b1 + ((ed >> 6) & 3u)) & 3u;
  const unsigned n2 = (b2 + ((ed >> 14) & 3u)) & 3u;
  const int s1 = 2 * (k - 1 - p1), s2 = 2 * (k - 1 - p2);
  const unsigned long long x1 = b1 ^ n1, x2 = b2 ^ n2;
  const unsigned long long f = f0 ^ (x1 << (2 * p1)) ^ (x2 << (2 * p2));
  const unsigned long long r = r0 ^ (x1 << s1) ^ (x2 << s2);
  const bool use_f = f <= r;
  const unsigned c = use_f ? 0u : 2u;      // the complement of a base is ^2
  *h = (use_f ? hf : hr) +
       qm2t::djb_delta(use_f ? 2 * p1 : s1, b1 ^ c, n1 ^ c) +
       qm2t::djb_delta(use_f ? 2 * p2 : s2, b2 ^ c, n2 ^ c);
  return use_f ? f : r;
}

__global__ void __launch_bounds__(kThreads) neighbor_sum_kernel(const Args a) {
  const long long q = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (q >= a.n) return;                      // warp-uniform
  const int lane = threadIdx.x & 31;
  const unsigned fh = __ldg(a.qh + q), fl = __ldg(a.ql + q);
  const unsigned rh = __ldg(a.rh + q), rl = __ldg(a.rl + q);
  const unsigned long long f0 = ((unsigned long long)fh << 32) | fl;
  const unsigned long long r0 = ((unsigned long long)rh << 32) | rl;
  const unsigned hf = qm2t::djb_pair(fh, fl), hr = qm2t::djb_pair(rh, rl);
  unsigned acc = 0;
  for (int i0 = lane; i0 < a.m; i0 += 32 * kBatch) {
    unsigned long long code[kBatch];
    unsigned h[kBatch], word[kBatch];
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {       // every filter load in flight
      const int i = i0 + 32 * t;
      code[t] = edit_canon(i < a.m ? __ldg(a.edits + i) : 0u, f0, r0, hf, hr,
                           a.k, &h[t]);
      // an edit past the table gets word 0, which no probe passes
      word[t] = i < a.m ? __ldg(a.filt + qm2t::filter_word(h[t], a.wbits))
                        : 0u;
    }
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {
      const unsigned fb = qm2t::filter_bits(h[t]);
      unsigned rank, pos;
      if ((word[t] & fb) == fb &&
          qm2t::packed_probe_h(a.rows, code[t], h[t], a.bucket_mask, &rank,
                               &pos)) {
        acc += pos;
      }
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
// u32[n_buckets, 8] with occurrence counts in pos; filt u32[2^wbits]:
// the key filter of the same rows (neighbor_bits.cu's qm2t_key_filter);
// out u32[n].
extern "C" int qm2t_neighbor_sum(const void* qh, const void* ql,
                                 const void* rh, const void* rl,
                                 const void* edits, int m, const void* rows,
                                 long long n_buckets, const void* filt,
                                 int wbits, int k, long long n, void* out,
                                 void* stream) {
  if (k < 1 || k > 32 || m < 1 || n < 0 || n_buckets < 1 ||
      n_buckets > (1ll << 32) || (n_buckets & (n_buckets - 1)) != 0 ||
      wbits < 5 || wbits > 23) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  const long long blocks = (n + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const Args a = {(const unsigned*)qh, (const unsigned*)ql,
                  (const unsigned*)rh, (const unsigned*)rl,
                  (const unsigned*)edits, (const uint4*)rows,
                  (const unsigned*)filt, (unsigned*)out, n, m, k,
                  (unsigned)(n_buckets - 1), wbits};
  neighbor_sum_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
