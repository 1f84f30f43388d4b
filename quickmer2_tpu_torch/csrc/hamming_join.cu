// The Hamming joins: K1, the compare chain of the search phase's
// edit-distance filter, and K5, the anchored index's neighbor bits, with
// the counting sort that builds K5's inputs.
//
// K1 replaces the slab loop of quickmer2_tpu/ops/hamming_join.py::
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
// K1's layouts (built in plain PyTorch by ops/hamming_join.py::
// _bucket_layouts):
//   dh, dl, docc  u32[B * cpad + 1]    word lanes; bucket b holds
//                                      [b * cpad, (b + 1) * cpad)
//   qh, ql        u32[B * cpad_q + 1]  query lanes
//   qidx          i32[B * cpad_q + 1]  query index, nq on holes
// Holes carry occ 0 (they add nothing) and qidx nq (skipped); a lane is
// live where occ != 0 (words) or 0 <= qidx < nq (queries), wherever it
// sits in its bucket. H >= 1 excludes self-pairs.
//
// K1's design: a warp per bucket, a block per eight buckets. Lane j holds
// lane 32t + j of its bucket in slot t (WS = ceil(cpad / 32) word slots,
// QS = ceil(cpad_q / 32) query slots, both template parameters), so each
// slot is one coalesced 128-B load. The warp loads qidx, then docc only
// where the bucket has a live query, then the (hi, lo) codes of the live
// lanes only. Ballots give the live lanes and their span, the lanes up to
// the last live one. The search fills each bucket from lane 0, so the
// spans are the live lanes; holes inside a span add nothing, so any layout
// is exact. The span pairs are dealt round the lanes (join_bucket): the
// warp splits into 32 / Q groups of Q lanes, Q the query span rounded up
// to a power of two, so a pair's lane comes from shifts and masks, no
// divide; each lane compares one query against every (32 / Q)-th word,
// codes by shuffle, keeps one sum and adds it by atomicAdd (sums are
// integers, so the order does not matter). No shared memory and no
// __syncthreads. The card keeps many such warps in flight, and that hides
// the three dependent loads: on the H100 this grid ran faster than
// persistent blocks that pipelined buckets in registers.
//
// K1's bound on the H100: sum_b live_words(b) * live_queries(b) pair
// compares of ~20 integer operations each (two of them popcounts), against
// the least traffic this design needs: qidx of every query lane, docc of
// every word lane of a bucket with a live query, 8 B of (hi, lo) per live
// word of such a bucket and per live query, and each live query's sum read
// and written once. At the search's shapes (2^20 buckets at k = 30, a few
// live lanes per bucket) the bytes bound it; chip_smoke.py computes both
// bounds from each run's layouts.
//
// K5 replaces quickmer2_tpu/ops/hamming_join.py::_part_chunk_join_bits
// (:190-287): for every (query window, word) pair of one pigeonhole part's
// bucket at Hamming distance exactly 1, the differing symbol s and the
// word's 2-bit value t there name the substitution that turns the window
// into the word: window offset j = k - 1 - s and base t where the query's
// canonical code is its forward strand, else j = s and base (t - 2) & 3;
// bit j of the query's base plane is set (planes u32[nq + 1][4], ORed).
//
// K5's inputs are bucket RUNS, not padded lanes: the entries of one side
// sorted by their part key (bucket), as a CSR with offsets u32[B + 1]. They
// are built on the card by a counting sort (qm2t_bucket_runs: a per-key
// count, an exclusive scan of the counts, a scatter). An entry's position
// in its run is its in-bucket slot, given by the caller (its rank among
// the equal keys in entry order, ops/hamming_join.py::_slots_u8, 255 where
// it is left out); an entry enters iff its slot is below the cap (the pad
// of the padded layout), so the runs hold exactly the lanes the padded
// layout held, in the same order. Word runs are (hi, lo) pairs; query runs
// add a tag u32, the query's index with its strand flag in bit 31.
//
// K5's design: a warp per 32 consecutive query run entries. The query
// runs hold only live queries and come sorted by bucket, so they are the
// list of the buckets that hold a live query, and a warp's entries cover
// several small buckets or a share of a large one. Each lane recomputes
// its query's part key from its code and reads its bucket's word run
// bounds through the offsets; the warp scans the run lengths and deals
// all its pairs round its lanes (pair p is word p - first[i] of query i's
// run; a lane walks i forward as its p grows by 32, reading one 16-B
// entry of the warp's query table in shared memory), so a long run does not
// hold the other lanes idle. The words of one bucket are read by the
// lanes at once and neighbouring buckets' runs are neighbours in memory,
// so the word reads are coalesced over the runs and no lane outside a run
// is read. A pair at distance 1 ORs its bit into the warp's per-query
// words in shared memory; then each lane ORs its query's four words into
// its planes row with one 16-B read and write, only where a bit was
// found: a query sits in one bucket of a call, so its lane owns the row.
// On the smoke's tile this ran faster than a thread per query looping
// over its run, with or without the warp's word range staged in shared
// memory first.
//
// K5's bound on the H100: bytes. The least traffic of this design is the
// live queries' codes and tags, the offsets of the buckets that hold a live
// query, the live words of those buckets, each live query's planes row
// read and written once, and the counting sort's reads of the keys;
// ~16 integer operations a live pair. chip_smoke.py computes it from each
// run's runs, beside the padded design's count.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

// ---------------------------------------------------------------- K1 -----

struct PartMasks {
  unsigned hi[3];
  unsigned lo[3];
};

struct Layout {
  const unsigned* dh;
  const unsigned* dl;
  const unsigned* docc;
  const unsigned* qh;
  const unsigned* ql;
  const int* qidx;
  unsigned* out;            // scaled u32[nq + 1]
  long long n_buckets;
  int cpad, cpad_q, nq;
  unsigned e;               // the largest distance
  PartMasks pm;             // the three part masks
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

// One bucket's lanes as a warp holds them: lane j has bucket lane 32t + j
// in slot t.
template <int WS, int QS>
struct Bucket {
  int qi[QS];
  unsigned occ[WS], wh[WS], wl[WS], qh[QS], ql[QS];
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

// (hi, lo) codes of the live lanes.
template <int WS, int QS>
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
template <int WS, int QS>
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
    const int q_i = __shfl_sync(kFull, k.qi[0], r);
    const bool live = live_query(L, q_i);
    unsigned sum = 0;
    for (int w = lane >> qbits; w - (lane >> qbits) < w_span; w += G) {
      const unsigned w_h = fetch<WS>(k.wh, w, w_span);
      const unsigned w_l = fetch<WS>(k.wl, w, w_span);
      const unsigned w_o = fetch<WS>(k.occ, w, w_span);
      if (live && w < w_span) sum += pair_term(L, q_h, q_l, w_h, w_l, w_o);
    }
    if (live && sum) atomicAdd(L.out + q_i, sum);
    return;
  }
  unsigned sum[QS];
#pragma unroll
  for (int t = 0; t < QS; ++t) sum[t] = 0u;
  for (int w = 0; w < w_span; ++w) {
    const unsigned w_o = fetch<WS>(k.occ, w, w_span);
    if (w_o == 0u) continue;                  // warp-uniform: w is
    const unsigned w_h = fetch<WS>(k.wh, w, w_span);
    const unsigned w_l = fetch<WS>(k.wl, w, w_span);
#pragma unroll
    for (int t = 0; t < QS; ++t) {
      if (live_query(L, k.qi[t])) {
        sum[t] += pair_term(L, k.qh[t], k.ql[t], w_h, w_l, w_o);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < QS; ++t) {
    if (live_query(L, k.qi[t]) && sum[t]) atomicAdd(L.out + k.qi[t], sum[t]);
  }
}

template <int WS, int QS>
__global__ void __launch_bounds__(kThreads)
hamming_join_kernel(const Layout L) {
  const long long b = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (b >= L.n_buckets) return;              // warp-uniform
  const int lane = threadIdx.x & 31;
  Bucket<WS, QS> k;
  load_qidx(L, b, lane, k);
  load_occ(L, b, lane, k);
  load_codes(L, b, lane, k);
  join_bucket(L, lane, k);
}

template <int WS, int QS>
int launch(const Layout& L, cudaStream_t stream) {
  const long long blocks = (L.n_buckets + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  hamming_join_kernel<WS, QS><<<(unsigned)blocks, kThreads, 0, stream>>>(L);
  return (int)cudaGetLastError();
}

// Slots a lane needs for `pad` lanes: 1, 2, 4 or 8.
int slots_for(int pad) {
  int s = 1;
  while (32 * s < pad) s <<= 1;
  return s;
}

template <int WS>
int launch_ws(const Layout& L, cudaStream_t stream) {
  switch (slots_for(L.cpad_q)) {
    case 1: return launch<WS, 1>(L, stream);
    case 2: return launch<WS, 2>(L, stream);
    case 4: return launch<WS, 4>(L, stream);
    default: return launch<WS, 8>(L, stream);
  }
}

int launch_pads(const Layout& L, cudaStream_t stream) {
  switch (slots_for(L.cpad)) {
    case 1: return launch_ws<1>(L, stream);
    case 2: return launch_ws<2>(L, stream);
    case 4: return launch_ws<4>(L, stream);
    default: return launch_ws<8>(L, stream);
  }
}

// -------------------------------------------- K5's counting sort ---------

constexpr int kScanItems = 8;                       // counts a thread
constexpr int kScanTile = kThreads * kScanItems;    // counts a block
constexpr int kTopThreads = 1024;

// Bits [lo_bit, lo_bit + width) of the 64-bit code (hi:lo), width <= 32.
__device__ __forceinline__ unsigned part_key(unsigned hi, unsigned lo,
                                             int lo_bit, int width) {
  const unsigned long long c = ((unsigned long long)hi << 32) | lo;
  return (unsigned)((c >> lo_bit) & ((1ull << width) - 1));
}

// The entries one side contributes to the runs: codes (hi[i], lo[i]), the
// in-bucket slot of each (an entry enters iff slot < cap), and, on the
// query side, the strand flag of each (fwd != nullptr).
struct Entries {
  const unsigned* hi;
  const unsigned* lo;
  const uint8_t* slot;
  const uint8_t* fwd;
  long long n;
  int lo_bit, width, cap;
};

__global__ void __launch_bounds__(kThreads)
run_count_kernel(const Entries E, unsigned* __restrict__ cnt) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < E.n;
       i += (long long)gridDim.x * kThreads) {
    if (__ldg(E.slot + i) < E.cap) {
      atomicAdd(cnt + part_key(__ldg(E.hi + i), __ldg(E.lo + i), E.lo_bit,
                               E.width), 1u);
    }
  }
}

// Exclusive scan of the block's 256 thread values; *total gets their sum.
__device__ __forceinline__ unsigned block_scan(unsigned v, unsigned* total) {
  __shared__ unsigned warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned s = lane < kThreads / 32 ? warp_sums[lane] : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, s, d);
      if (lane >= d) s += y;
    }
    if (lane < kThreads / 32) warp_sums[lane] = s;
  }
  __syncthreads();
  const unsigned before = (warp ? warp_sums[warp - 1] : 0u) + x - v;
  *total = warp_sums[kThreads / 32 - 1];
  __syncthreads();
  return before;
}

// Scan pass 1: each block's kScanTile counts summed into sums[block].
__global__ void __launch_bounds__(kThreads)
scan_reduce_kernel(const unsigned* __restrict__ cnt, long long n,
                   unsigned* __restrict__ sums) {
  const long long base = (long long)blockIdx.x * kScanTile;
  unsigned v = 0;
#pragma unroll
  for (int r = 0; r < kScanItems; ++r) {
    const long long i = base + r * kThreads + threadIdx.x;
    if (i < n) v += cnt[i];
  }
  unsigned total;
  block_scan(v, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// Scan pass 2, one block: the block sums scanned in place (exclusive).
__global__ void __launch_bounds__(kTopThreads)
scan_top_kernel(unsigned* __restrict__ sums, int n_tiles) {
  __shared__ unsigned part[kTopThreads];
  const int per = (n_tiles + kTopThreads - 1) / kTopThreads;
  const int lo = threadIdx.x * per;
  unsigned v = 0;
  for (int i = lo; i < lo + per && i < n_tiles; ++i) v += sums[i];
  part[threadIdx.x] = v;
  __syncthreads();
  for (int d = 1; d < kTopThreads; d <<= 1) {     // Hillis-Steele
    const unsigned y = threadIdx.x >= d ? part[threadIdx.x - d] : 0u;
    __syncthreads();
    part[threadIdx.x] += y;
    __syncthreads();
  }
  unsigned run = part[threadIdx.x] - v;
  for (int i = lo; i < lo + per && i < n_tiles; ++i) {
    const unsigned s = sums[i];
    sums[i] = run;
    run += s;
  }
}

// Scan pass 3: off[i] = the counts before i; off[n] = their total. A
// thread scans kScanItems consecutive counts.
__global__ void __launch_bounds__(kThreads)
scan_apply_kernel(const unsigned* __restrict__ cnt, long long n,
                  const unsigned* __restrict__ sums,
                  unsigned* __restrict__ off) {
  const long long first =
      (long long)blockIdx.x * kScanTile + (long long)threadIdx.x * kScanItems;
  unsigned c[kScanItems];
  unsigned v = 0;
#pragma unroll
  for (int r = 0; r < kScanItems; ++r) {
    c[r] = first + r < n ? cnt[first + r] : 0u;
    v += c[r];
  }
  unsigned total;
  unsigned run = sums[blockIdx.x] + block_scan(v, &total);
#pragma unroll
  for (int r = 0; r < kScanItems; ++r) {
    if (first + r < n) off[first + r] = run;
    run += c[r];
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == kThreads - 1) off[n] = run;
}

// Each entering entry to position off[key] + slot of the runs.
__global__ void __launch_bounds__(kThreads)
run_scatter_kernel(const Entries E, const unsigned* __restrict__ off,
                   uint2* __restrict__ codes, unsigned* __restrict__ tags) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < E.n;
       i += (long long)gridDim.x * kThreads) {
    const unsigned s = __ldg(E.slot + i);
    if (s >= (unsigned)E.cap) continue;
    const unsigned hi = __ldg(E.hi + i), lo = __ldg(E.lo + i);
    const unsigned p = __ldg(off + part_key(hi, lo, E.lo_bit, E.width)) + s;
    codes[p] = make_uint2(hi, lo);
    if (tags) tags[p] = (unsigned)i | ((unsigned)(__ldg(E.fwd + i) != 0) << 31);
  }
}

// ---------------------------------------------------------------- K5 -----

// K5's term of a pair: the bit 1 << j of plane *b where H(q, w) = 1,
// else 0.
__device__ __forceinline__ unsigned pair_bit(unsigned q_h, unsigned q_l,
                                             bool q_f, unsigned w_h,
                                             unsigned w_l, int k,
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
  return 1u << ((q_f ? (unsigned)(k - 1) - s : s) & 31u);
}

struct Runs {
  const uint2* words;          // word runs (hi, lo)
  const unsigned* woff;        // u32[B + 1]
  const uint2* queries;        // query runs (hi, lo)
  const unsigned* tags;        // query index | strand flag << 31
  const unsigned* n_queries;   // the query runs' length, on the card
  uint4* planes;               // [nq + 1] rows of four u32 planes
  int lo_bit, width, k;
};

// A warp takes 32 consecutive query run entries and deals the pairs of
// their word runs round its lanes (see above). Bits go to the warp's
// per-query words in shared memory (atomicOr, only where a pair is at
// distance 1) and each lane then ORs its query's four words into its
// planes row.
__global__ void __launch_bounds__(kThreads)
join_runs_kernel(const Runs R) {
  constexpr int kWarps = kThreads / 32;
  // query i of a warp: its code, (the index of its run's first word less
  // first[i]) mod 2^31 with its strand flag in bit 31, and first[i + 1],
  // first[] the warp's exclusive scan of the run lengths
  __shared__ uint4 info[kWarps][32];
  __shared__ unsigned acc[kWarps][32][4];
  const int wp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  const unsigned n = __ldg(R.n_queries);
  if (blockIdx.x * kThreads + (threadIdx.x & ~31u) >= n) return;  // warp
  const bool live = t < n;
  const uint2 q = live ? __ldg(R.queries + t) : make_uint2(0u, 0u);
  const unsigned key = part_key(q.x, q.y, R.lo_bit, R.width);
  const unsigned a = live ? __ldg(R.woff + key) : 0u;
  const unsigned z = live ? __ldg(R.woff + key + 1) : 0u;
  const unsigned tag = live ? __ldg(R.tags + t) : 0u;
  unsigned x = z - a;                 // inclusive scan of the run lengths
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  const unsigned first = x - (z - a);
  info[wp][lane] = make_uint4(q.x, q.y,
                              ((a - first) & 0x7FFFFFFFu) | (tag & 0x80000000u),
                              x);
#pragma unroll
  for (int c = 0; c < 4; ++c) acc[wp][lane][c] = 0u;
  const unsigned total = __shfl_sync(kFull, x, 31);
  __syncwarp();
  int i = 0;
  uint4 qi = info[wp][0];
  for (unsigned p = lane; p < total; p += 32) {
    while (qi.w <= p) qi = info[wp][++i];     // the query of pair p
    // a + p - first mod 2^31: word indices stay below 2^31
    const uint2 w = __ldg(R.words + ((qi.z + p) & 0x7FFFFFFFu));
    unsigned b = 0;
    const unsigned bit = pair_bit(qi.x, qi.y, qi.z >> 31, w.x, w.y, R.k, &b);
    if (bit) atomicOr(&acc[wp][i][b], bit);
  }
  __syncwarp();
  const unsigned p0 = acc[wp][lane][0], p1 = acc[wp][lane][1];
  const unsigned p2 = acc[wp][lane][2], p3 = acc[wp][lane][3];
  if (live && (p0 | p1 | p2 | p3)) {
    uint4* row = R.planes + (tag & 0x7FFFFFFFu);
    uint4 v = *row;
    v.x |= p0;
    v.y |= p1;
    v.z |= p2;
    v.w |= p3;
    *row = v;
  }
}

unsigned grid_for(long long n) {
  const long long g = (n + kThreads - 1) / kThreads;
  return (unsigned)(g < 1 ? 1 : (g > 65536 ? 65536 : g));
}

bool bad_pads(long long n_buckets, int cpad, int cpad_q, int nq) {
  return n_buckets < 1 || cpad < 1 || cpad > 255 || cpad_q < 1 ||
         cpad_q > 255 || nq < 0;
}

bool bad_part(int lo_bit, int width) {
  return width < 1 || width > 32 || lo_bit < 0 || lo_bit + width > 64;
}

}  // namespace

extern "C" const char* qm2t_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K1: scaled u32[nq + 1] is updated in place; see the layouts above.
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
                    (const unsigned*)ql, (const int*)qidx,
                    (unsigned*)scaled, n_buckets, cpad, cpad_q, nq,
                    (unsigned)e, {{mh0, mh1, mh2}, {ml0, ml1, ml2}}};
  return launch_pads(L, (cudaStream_t)stream);
}

// K5's counting sort. hi, lo u32[n] codes; slot u8[n] in-bucket slots;
// fwd u8[n] strand flags, or null for the word side; cnt u32[2^width]
// scratch; sums u32[ceil(2^width / 2048)] scratch; off u32[2^width
// + 1] the runs' offsets; codes u32[n][2] and (with fwd) tags u32[n] the
// runs, of which the first off[2^width] entries are written.
extern "C" int qm2t_bucket_runs(const void* hi, const void* lo,
                                const void* slot, const void* fwd,
                                long long n, int lo_bit, int width, int cap,
                                void* cnt, void* sums, void* off, void* codes,
                                void* tags, void* stream) {
  if (n < 0 || n > 0x7FFFFFFFLL || bad_part(lo_bit, width) || width > 24 ||
      cap < 1 || cap > 255 || (fwd == nullptr) != (tags == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const long long B = 1LL << width;
  const int n_tiles = (int)((B + kScanTile - 1) / kScanTile);
  const Entries E = {(const unsigned*)hi, (const unsigned*)lo,
                     (const uint8_t*)slot, (const uint8_t*)fwd, n, lo_bit,
                     width, cap};
  const cudaError_t rc = cudaMemsetAsync(cnt, 0, B * sizeof(unsigned), s);
  if (rc != cudaSuccess) return (int)rc;
  if (n > 0) run_count_kernel<<<grid_for(n), kThreads, 0, s>>>(E, (unsigned*)cnt);
  scan_reduce_kernel<<<n_tiles, kThreads, 0, s>>>((const unsigned*)cnt, B,
                                                  (unsigned*)sums);
  scan_top_kernel<<<1, kTopThreads, 0, s>>>((unsigned*)sums, n_tiles);
  scan_apply_kernel<<<n_tiles, kThreads, 0, s>>>(
      (const unsigned*)cnt, B, (const unsigned*)sums, (unsigned*)off);
  if (n > 0) {
    run_scatter_kernel<<<grid_for(n), kThreads, 0, s>>>(
        E, (const unsigned*)off, (uint2*)codes, (unsigned*)tags);
  }
  return (int)cudaGetLastError();
}

// K5: planes u32[nq + 1][4] are ORed in place; words u32[][2] and woff
// u32[2^width + 1] one part's word runs, queries u32[n_max][2] and tags
// u32[n_max] its query runs, of which the first *n_queries are live
// (n_queries on the card, the query offsets' last word).
extern "C" int qm2t_hamming_join_bits(const void* words, const void* woff,
                                      const void* queries, const void* tags,
                                      const void* n_queries, long long n_max,
                                      void* planes, int lo_bit, int width,
                                      int k, void* stream) {
  if (n_max < 0 || n_max > 0x7FFFFFFFLL || bad_part(lo_bit, width) ||
      k < 1 || k > 32) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_max == 0) return 0;
  const Runs R = {(const uint2*)words, (const unsigned*)woff,
                  (const uint2*)queries, (const unsigned*)tags,
                  (const unsigned*)n_queries, (uint4*)planes, lo_bit, width,
                  k};
  const long long blocks = (n_max + kThreads - 1) / kThreads;
  join_runs_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(R);
  return (int)cudaGetLastError();
}
