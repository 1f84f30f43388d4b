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
// Holes carry occ 0 (they add nothing) and qidx nq (skipped); a lane is
// live where occ != 0 (words) or 0 <= qidx < nq (queries), wherever it
// sits in its bucket. H >= 1 excludes self-pairs.
//
// Design: a warp per bucket, a block per eight buckets. Lane j holds lane
// 32t + j of its bucket in slot t (WS = ceil(cpad / 32) word slots, QS =
// ceil(cpad_q / 32) query slots, both template parameters), so each slot
// is one coalesced 128-B load. The warp loads qidx, then docc only where
// the bucket has a live query, then the (hi, lo) codes of the live lanes
// only. Ballots give the live lanes and their span, the lanes up to the
// last live one. The search fills each bucket from lane 0, so the spans
// are the live lanes; holes inside a span add nothing, so any layout is
// exact. The span pairs are dealt round the lanes (join_bucket): the warp
// splits into 32 / Q groups of Q lanes, Q the query span rounded up to a
// power of two, so a pair's lane comes from shifts and masks, no divide;
// each lane compares one query against every (32 / Q)-th word, codes by
// shuffle, keeps one sum and adds it by atomicAdd (sums are integers, so
// the order does not matter). No shared memory and no __syncthreads. The
// card keeps many such warps in flight, and that hides the three
// dependent loads: on the H100 this grid ran faster than persistent
// blocks that pipelined buckets in registers.
//
// Bound on the H100: sum_b live_words(b) * live_queries(b) pair compares
// of ~20 integer operations each (two of them popcounts), against the
// least traffic this design needs: qidx of every query lane, docc of every
// word lane of a bucket with a live query, 8 B of (hi, lo) per live word
// of such a bucket and per live query, and each live query's sum read and
// written once. At
// the search's shapes (2^20 buckets at k = 30, a few live lanes per bucket)
// the bytes bound it; chip_smoke.py computes both bounds from each run's
// layouts.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct PartMasks {
  unsigned hi[3];
  unsigned lo[3];
};

struct Layout {
  const unsigned* dh;
  const unsigned* dl;
  const unsigned* docc;     // occ (K1) or the live flag (K5)
  const unsigned* qh;
  const unsigned* ql;
  const unsigned* qfw;      // K5: strand flag of each query lane
  const int* qidx;
  unsigned* out;            // K1: scaled u32[nq + 1]; K5: planes [nq + 1][4]
  long long n_buckets;
  int cpad, cpad_q, nq;
  unsigned e;               // K1: the largest distance
  int k;                    // K5: the k-mer length
  PartMasks pm;             // K1: the three part masks
};

__device__ __forceinline__ unsigned pair_term(const Layout& L, unsigned q_h,
                                              unsigned q_l, unsigned w_h,
                                              unsigned w_l, unsigned occ) {
  const unsigned xh = q_h ^ w_h;
  const unsigned xl = q_l ^ w_l;
  const unsigned ham = __popc((xh | (xh >> 1)) & 0x55555555u) +
                       __popc((xl | (xl >> 1)) & 0x55555555u);
  if (ham < 1u || ham > L.e) return 0u;
  const unsigned m = (((xh & L.pm.hi[0]) | (xl & L.pm.lo[0])) == 0u) +
                     (((xh & L.pm.hi[1]) | (xl & L.pm.lo[1])) == 0u) +
                     (((xh & L.pm.hi[2]) | (xl & L.pm.lo[2])) == 0u);
  const unsigned scale = m == 3u ? 2u : m == 2u ? 3u : m == 1u ? 6u : 0u;
  return occ * scale;
}

// K5's term of a pair: the bit 1 << j of plane *b where H(q, w) = 1,
// else 0.
__device__ __forceinline__ unsigned pair_bit(const Layout& L, unsigned q_h,
                                             unsigned q_l, unsigned q_f,
                                             unsigned w_h, unsigned w_l,
                                             unsigned* b) {
  const unsigned xh = q_h ^ w_h;
  const unsigned xl = q_l ^ w_l;
  const unsigned yh = (xh | (xh >> 1)) & 0x55555555u;
  const unsigned yl = (xl | (xl >> 1)) & 0x55555555u;
  if (__popc(yh) + __popc(yl) != 1u) return 0u;
  const bool in_lo = yl != 0u;
  const unsigned s = in_lo ? (unsigned)(__ffs(yl) - 1) >> 1
                           : ((unsigned)(__ffs(yh) - 1) >> 1) + 16u;
  const unsigned t = ((in_lo ? w_l : w_h) >> ((s & 15u) << 1)) & 3u;
  *b = q_f ? t : (t - 2u) & 3u;
  return 1u << ((q_f ? (unsigned)(L.k - 1) - s : s) & 31u);
}

// One query's running result: K1's sum (added by atomicAdd) or K5's four
// plane words (ORed in by atomicOr), both flushed once.
template <bool BITS>
struct Acc;

template <>
struct Acc<false> {
  unsigned sum = 0;
  __device__ __forceinline__ void add(const Layout& L, unsigned q_h,
                                      unsigned q_l, unsigned, unsigned w_h,
                                      unsigned w_l, unsigned w_o) {
    sum += pair_term(L, q_h, q_l, w_h, w_l, w_o);
  }
  __device__ __forceinline__ void flush(const Layout& L, int qi) {
    if (sum) atomicAdd(L.out + qi, sum);
  }
};

template <>
struct Acc<true> {
  unsigned p[4] = {0u, 0u, 0u, 0u};
  __device__ __forceinline__ void add(const Layout& L, unsigned q_h,
                                      unsigned q_l, unsigned q_f,
                                      unsigned w_h, unsigned w_l,
                                      unsigned w_o) {
    if (w_o == 0u) return;                  // a hole, code (0, 0)
    unsigned b = 0;
    const unsigned bit = pair_bit(L, q_h, q_l, q_f, w_h, w_l, &b);
#pragma unroll
    for (int c = 0; c < 4; ++c) p[c] |= b == (unsigned)c ? bit : 0u;
  }
  __device__ __forceinline__ void flush(const Layout& L, int qi) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (p[c]) atomicOr(L.out + 4ll * qi + c, p[c]);
    }
  }
};

// One bucket's lanes as a warp holds them: lane j has bucket lane 32t + j
// in slot t.
template <int WS, int QS>
struct Bucket {
  int qi[QS];
  unsigned occ[WS], wh[WS], wl[WS], qh[QS], ql[QS], qf[QS];
};

__device__ __forceinline__ bool live_query(const Layout& L, int qi) {
  return (unsigned)qi < (unsigned)L.nq;
}

template <int WS, int QS>
__device__ __forceinline__ void load_qidx(const Layout& L, long long b,
                                          int lane, Bucket<WS, QS>& k) {
#pragma unroll
  for (int t = 0; t < QS; ++t) {
    const int j = 32 * t + lane;
    k.qi[t] = j < L.cpad_q ? __ldg(L.qidx + b * L.cpad_q + j) : L.nq;
  }
}

// occ of every word lane, where the bucket has a live query.
template <int WS, int QS>
__device__ __forceinline__ void load_occ(const Layout& L, long long b,
                                         int lane, Bucket<WS, QS>& k) {
  bool any = false;
#pragma unroll
  for (int t = 0; t < QS; ++t) any = any || live_query(L, k.qi[t]);
  any = __any_sync(kFull, any);
#pragma unroll
  for (int t = 0; t < WS; ++t) {
    const int j = 32 * t + lane;
    k.occ[t] = (any && j < L.cpad) ? __ldg(L.docc + b * L.cpad + j) : 0u;
  }
}

// (hi, lo) codes of the live lanes, and K5's strand flags.
template <bool BITS, int WS, int QS>
__device__ __forceinline__ void load_codes(const Layout& L, long long b,
                                           int lane, Bucket<WS, QS>& k) {
#pragma unroll
  for (int t = 0; t < WS; ++t) {
    const long long o = b * L.cpad + 32 * t + lane;
    k.wh[t] = k.occ[t] ? __ldg(L.dh + o) : 0u;
    k.wl[t] = k.occ[t] ? __ldg(L.dl + o) : 0u;
  }
#pragma unroll
  for (int t = 0; t < QS; ++t) {
    const long long o = b * L.cpad_q + 32 * t + lane;
    const bool live = live_query(L, k.qi[t]);
    k.qh[t] = live ? __ldg(L.qh + o) : 0u;
    k.ql[t] = live ? __ldg(L.ql + o) : 0u;
    k.qf[t] = (BITS && live) ? __ldg(L.qfw + o) : 0u;
  }
}

// Bucket lane w of a value held S slots a lane, for every lane of the warp
// (only the slots below the warp-uniform span are read).
template <int S>
__device__ __forceinline__ unsigned fetch(const unsigned (&v)[S], int w,
                                          int span) {
  unsigned x = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (32 * s >= span) break;
    const unsigned y = __shfl_sync(kFull, v[s], w & 31);
    if ((w >> 5) == s) x = y;
  }
  return x;
}

// Lanes [0, span) hold every live lane of a ballot set: span = one past
// the highest live lane, 0 if none.
template <int S>
__device__ __forceinline__ int live_span(const unsigned (&live)[S]) {
  int span = 0;
#pragma unroll
  for (int t = 0; t < S; ++t) {
    if (live[t]) span = 32 * t + 32 - __clz(live[t]);
  }
  return span;
}

// Every live pair of a bucket whose lanes have arrived. The search fills
// a bucket from lane 0, so the live lanes are a prefix; the pairs of the
// query span x word span are dealt (holes add nothing, so any layout is
// exact). With Q, the query span rounded up to a power of two, at most
// 32, the warp is G = 32 / Q groups of Q lanes: lane r of group g takes
// query lane r and word lanes g, g + G, ...; each lane keeps one sum and
// adds it once. A wider query span (cpad_q > 32) takes the words one at a
// time, each lane its own query slots.
template <bool BITS, int WS, int QS>
__device__ __forceinline__ void join_bucket(const Layout& L, int lane,
                                            const Bucket<WS, QS>& k) {
  unsigned lq[QS], lw[WS];
#pragma unroll
  for (int t = 0; t < QS; ++t) lq[t] = __ballot_sync(kFull, live_query(L, k.qi[t]));
#pragma unroll
  for (int t = 0; t < WS; ++t) lw[t] = __ballot_sync(kFull, k.occ[t] != 0u);
  const int q_span = live_span<QS>(lq), w_span = live_span<WS>(lw);
  if (q_span == 0 || w_span == 0) return;
  if (q_span <= 32) {
    const int qbits = 32 - __clz(q_span - 1);   // Q = 1 << qbits
    const int r = lane & ((1 << qbits) - 1);
    const int G = 32 >> qbits;
    const unsigned q_h = __shfl_sync(kFull, k.qh[0], r);
    const unsigned q_l = __shfl_sync(kFull, k.ql[0], r);
    const unsigned q_f = __shfl_sync(kFull, k.qf[0], r);
    const int q_i = __shfl_sync(kFull, k.qi[0], r);
    const bool live = live_query(L, q_i);
    Acc<BITS> acc;
    for (int w = lane >> qbits; w - (lane >> qbits) < w_span; w += G) {
      const unsigned w_h = fetch<WS>(k.wh, w, w_span);
      const unsigned w_l = fetch<WS>(k.wl, w, w_span);
      const unsigned w_o = fetch<WS>(k.occ, w, w_span);
      if (live && w < w_span) acc.add(L, q_h, q_l, q_f, w_h, w_l, w_o);
    }
    if (live) acc.flush(L, q_i);
    return;
  }
  Acc<BITS> acc[QS];
  for (int w = 0; w < w_span; ++w) {
    const unsigned w_o = fetch<WS>(k.occ, w, w_span);
    if (w_o == 0u) continue;                  // warp-uniform: w is
    const unsigned w_h = fetch<WS>(k.wh, w, w_span);
    const unsigned w_l = fetch<WS>(k.wl, w, w_span);
#pragma unroll
    for (int t = 0; t < QS; ++t) {
      if (live_query(L, k.qi[t])) {
        acc[t].add(L, k.qh[t], k.ql[t], k.qf[t], w_h, w_l, w_o);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < QS; ++t) {
    if (live_query(L, k.qi[t])) acc[t].flush(L, k.qi[t]);
  }
}

template <bool BITS, int WS, int QS>
__global__ void __launch_bounds__(kThreads)
hamming_join_kernel(const Layout L) {
  const long long b = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (b >= L.n_buckets) return;              // warp-uniform
  const int lane = threadIdx.x & 31;
  Bucket<WS, QS> k;
  load_qidx(L, b, lane, k);
  load_occ(L, b, lane, k);
  load_codes<BITS>(L, b, lane, k);
  join_bucket<BITS>(L, lane, k);
}

template <bool BITS, int WS, int QS>
int launch(const Layout& L, cudaStream_t stream) {
  const long long blocks = (L.n_buckets + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  hamming_join_kernel<BITS, WS, QS>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(L);
  return (int)cudaGetLastError();
}

// Slots a lane needs for `pad` lanes: 1, 2, 4 or 8.
int slots_for(int pad) {
  int s = 1;
  while (32 * s < pad) s <<= 1;
  return s;
}

template <bool BITS, int WS>
int launch_ws(const Layout& L, cudaStream_t stream) {
  switch (slots_for(L.cpad_q)) {
    case 1: return launch<BITS, WS, 1>(L, stream);
    case 2: return launch<BITS, WS, 2>(L, stream);
    case 4: return launch<BITS, WS, 4>(L, stream);
    default: return launch<BITS, WS, 8>(L, stream);
  }
}

template <bool BITS>
int launch_pads(const Layout& L, cudaStream_t stream) {
  switch (slots_for(L.cpad)) {
    case 1: return launch_ws<BITS, 1>(L, stream);
    case 2: return launch_ws<BITS, 2>(L, stream);
    case 4: return launch_ws<BITS, 4>(L, stream);
    default: return launch_ws<BITS, 8>(L, stream);
  }
}

bool bad_pads(long long n_buckets, int cpad, int cpad_q, int nq) {
  return n_buckets < 1 || cpad < 1 || cpad > 255 || cpad_q < 1 ||
         cpad_q > 255 || nq < 0;
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
  if (bad_pads(n_buckets, cpad, cpad_q, nq) || e < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const Layout L = {(const unsigned*)dh, (const unsigned*)dl,
                    (const unsigned*)docc, (const unsigned*)qh,
                    (const unsigned*)ql, nullptr, (const int*)qidx,
                    (unsigned*)scaled, n_buckets, cpad, cpad_q, nq,
                    (unsigned)e, 0, {{mh0, mh1, mh2}, {ml0, ml1, ml2}}};
  return launch_pads<false>(L, (cudaStream_t)stream);
}

// K5: planes u32[nq + 1][4] are ORed in place; dlive u32[B * cpad + 1]
// is 1 on a word lane and 0 on a hole; qfw u32[B * cpad_q + 1] is 1 where
// the query lane's canonical code is its forward strand.
extern "C" int qm2t_hamming_join_bits(const void* dh, const void* dl,
                                      const void* dlive, const void* qh,
                                      const void* ql, const void* qfw,
                                      const void* qidx, void* planes,
                                      long long n_buckets, int cpad,
                                      int cpad_q, int nq, int k,
                                      void* stream) {
  if (bad_pads(n_buckets, cpad, cpad_q, nq) || k < 1 || k > 32) {
    return (int)cudaErrorInvalidValue;
  }
  const Layout L = {(const unsigned*)dh, (const unsigned*)dl,
                    (const unsigned*)dlive, (const unsigned*)qh,
                    (const unsigned*)ql, (const unsigned*)qfw,
                    (const int*)qidx, (unsigned*)planes, n_buckets, cpad,
                    cpad_q, nq, 1u, k, {{0u, 0u, 0u}, {0u, 0u, 0u}}};
  return launch_pads<true>(L, (cudaStream_t)stream);
}
