// Compare chain of the search phase's Hamming-join edit-distance filter.
//
// Replaces the slab loop of quickmer2_tpu/ops/hamming_join.py::
// _part_chunk_join (:151-182) and its fused Pallas form,
// tools/proto_join2d.py::kernel (pl.pallas_call at :55), which Mosaic never
// compiled. The function is the same: for every bucket b and every query
// lane of b,
//
//   scaled[qidx] += sum over b's word lanes w with 1 <= H <= e of
//                   occ(w) * (6 / m)
//
// where x = q ^ w on the (hi, lo) code pair, H = popcount((x | x >> 1) &
// 0x55555555...) counts the differing bases, and m counts the three
// pigeonhole parts on which x is 0 (a pair with m exact parts is found by
// m part joins, so each adds 6/m and the caller divides the total by 6).
// Sums wrap as u32.
//
// Layouts (built in plain PyTorch by ops/hamming_join.py::_bucket_layouts):
//   dh, dl, docc  u32[B * cpad + 1]    word lanes; bucket b holds
//                                      [b * cpad, (b + 1) * cpad)
//   qh, ql        u32[B * cpad_q + 1]  query lanes
//   qidx          i32[B * cpad_q + 1]  query index, nq on holes
// Holes carry occ 0 (they add nothing) and qidx nq (skipped). Within one
// call each query holds one lane, so the plain += on scaled[qidx] never
// collides. H >= 1 excludes self-pairs.
//
// Design: one block per G buckets (G * cpad_q <= 256 threads). The block
// stages its buckets' word lanes (12 B each) in shared memory once; each
// thread owns one query lane and loops over its bucket's words up to the
// last one with nonzero occ, which is exact on any layout (the search
// fills each bucket from lane 0, so the loop ends after the live words).
// The Pallas kernel's (slab, cpad_q, cpad) intermediates never exist:
// every term lives in registers.
//
// Bound on the H100: sum_b live_words(b) * live_queries(b) pair compares
// of ~20 integer operations each (two of them popcounts), against the
// least traffic: docc of every word lane and qidx of every query lane
// (4 B each; they tell which lanes are live), 8 B of (hi, lo) per live
// word and per live query, and each live query's sum read and written
// once. At the search's shapes (2^20 buckets at k = 30, a few live lanes
// per bucket) the layouts are mostly holes and the bytes bound it;
// chip_smoke.py computes both bounds from each run's layouts.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxStagedWords = 2048;   // 24 KB of shared memory

struct PartMasks {
  unsigned hi[3];
  unsigned lo[3];
};

__global__ void __launch_bounds__(kMaxThreads)
hamming_join_kernel(const unsigned* __restrict__ dh,
                    const unsigned* __restrict__ dl,
                    const unsigned* __restrict__ docc,
                    const unsigned* __restrict__ qh,
                    const unsigned* __restrict__ ql,
                    const int* __restrict__ qidx,
                    unsigned* __restrict__ scaled,
                    long long n_buckets, int cpad, int cpad_q, int group,
                    int nq, unsigned e, PartMasks pm) {
  extern __shared__ unsigned smem[];
  unsigned* wh = smem;
  unsigned* wl = wh + group * cpad;
  unsigned* wo = wl + group * cpad;
  int* nlive = (int*)(wo + group * cpad);

  const long long b0 = (long long)blockIdx.x * group;
  if ((int)threadIdx.x < group) nlive[threadIdx.x] = 0;
  __syncthreads();
  for (int t = threadIdx.x; t < group * cpad; t += blockDim.x) {
    const long long b = b0 + t / cpad;
    unsigned h = 0, l = 0, o = 0;
    if (b < n_buckets) {
      const long long off = b * cpad + t % cpad;
      o = docc[off];
      if (o) {
        h = dh[off];
        l = dl[off];
      }
    }
    wh[t] = h;
    wl[t] = l;
    wo[t] = o;
    if (o) atomicMax(&nlive[t / cpad], t % cpad + 1);
  }
  __syncthreads();

  const int g = threadIdx.x / cpad_q;
  const long long b = b0 + g;
  if (g >= group || b >= n_buckets) return;
  const long long qo = b * cpad_q + threadIdx.x % cpad_q;
  const int qi = qidx[qo];
  if (qi < 0 || qi >= nq) return;
  const unsigned q_h = qh[qo];
  const unsigned q_l = ql[qo];
  const unsigned* bh = wh + g * cpad;
  const unsigned* bl = wl + g * cpad;
  const unsigned* bo = wo + g * cpad;
  const int live = nlive[g];
  unsigned sum = 0;
  for (int j = 0; j < live; ++j) {
    const unsigned xh = q_h ^ bh[j];
    const unsigned xl = q_l ^ bl[j];
    const unsigned ham = __popc((xh | (xh >> 1)) & 0x55555555u) +
                         __popc((xl | (xl >> 1)) & 0x55555555u);
    if (ham >= 1u && ham <= e) {
      const unsigned m = (((xh & pm.hi[0]) | (xl & pm.lo[0])) == 0u) +
                         (((xh & pm.hi[1]) | (xl & pm.lo[1])) == 0u) +
                         (((xh & pm.hi[2]) | (xl & pm.lo[2])) == 0u);
      const unsigned scale = m == 3u ? 2u : m == 2u ? 3u : m == 1u ? 6u : 0u;
      sum += bo[j] * scale;
    }
  }
  if (sum) scaled[qi] += sum;
}

}  // namespace

extern "C" const char* qm2t_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// scaled u32[nq + 1] is updated in place; see the layouts above.
extern "C" int qm2t_hamming_join(const void* dh, const void* dl,
                                 const void* docc, const void* qh,
                                 const void* ql, const void* qidx,
                                 void* scaled, long long n_buckets, int cpad,
                                 int cpad_q, int nq, int e,
                                 unsigned mh0, unsigned ml0, unsigned mh1,
                                 unsigned ml1, unsigned mh2, unsigned ml2,
                                 void* stream) {
  if (n_buckets < 1 || cpad < 1 || cpad > 255 || cpad_q < 1 ||
      cpad_q > 255 || nq < 0 || e < 1) {
    return (int)cudaErrorInvalidValue;
  }
  int group = kMaxThreads / cpad_q;
  if (group > kMaxStagedWords / cpad) group = kMaxStagedWords / cpad;
  if (group < 1) group = 1;
  const long long blocks = (n_buckets + group - 1) / group;
  const size_t smem = (size_t)group * cpad * 3 * sizeof(unsigned) +
                      (size_t)group * sizeof(int);
  PartMasks pm = {{mh0, mh1, mh2}, {ml0, ml1, ml2}};
  hamming_join_kernel<<<(unsigned)blocks, group * cpad_q, smem,
                        (cudaStream_t)stream>>>(
      (const unsigned*)dh, (const unsigned*)dl, (const unsigned*)docc,
      (const unsigned*)qh, (const unsigned*)ql, (const int*)qidx,
      (unsigned*)scaled, n_buckets, cpad, cpad_q, group, nq, (unsigned)e, pm);
  return (int)cudaGetLastError();
}
