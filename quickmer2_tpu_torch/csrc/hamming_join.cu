// The Hamming joins: K1, the compare chain of the search phase's
// edit-distance filter, with i', the stable counting sort and expand that
// build K1's layouts, and K5, the anchored index's neighbor bits, with the
// counting sort that builds K5's inputs.
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
// K1's layouts (built by qm2t_bucket_layouts below, i'):
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
// are built on the card by a counting sort (qm2t_bucket_runs). An entry's
// position in its run is its in-bucket slot, given by the caller (its rank
// among the equal keys in entry order, ops/hamming_join.py::_slots_u8, 255
// where it is left out); an entry enters iff its slot is below the cap (the
// pad of the padded layout), so the runs hold exactly the lanes the padded
// layout held, in the same order. Word runs are (hi, lo) pairs; query runs
// add a tag u32, the query's index with its strand flag in bit 31.
//
// The counting sort replaces the scatters of _part_chunk_join_bits
// (:210-236). Its first design (a per-key count, a three-launch
// scan, a scatter) placed each entry at offsets[key] + slot straight from
// the entry list: a random 8-B (and 4-B) store an entry, into ~24 MB on
// the query side and ~94 MB on the word side, more than the 50 MB L2, and
// most of its time went there (PERF.md). So it places in two levels, over
// coarse bins, the top bits of the part key (kernels/hamming_join.py::
// runs_plan picks the bins from n and width), in three passes:
//   hist  - each block counts its share of the entering entries by bin in
//           shared memory and adds them to the bins' totals;
//   part  - a block stages a tile of 4,096 to 16,384 entries in shared
//           memory, sorts their places by bin there, reserves each bin's
//           run in that bin's range of a scratch laid out as the runs are
//           (one atomic add per tile and bin) and writes the runs out
//           coalesced (16 B an entry: code, tag, slot); a tile holds ~8
//           entries a bin, so that a bin's run is a 128-B line;
//   place - a block per bin counts its range's entries by key in shared
//           memory, writes its keys' offsets, and puts each entry at its
//           key's offset + slot inside the same range, staged in 192 KB of
//           shared memory and written out coalesced; a bin of skewed keys
//           larger than the stage stores straight to the runs inside its
//           small range.
// No per-key counter lives in global memory and no scan runs over the
// 2^width keys; the final positions come from the counts and the slots
// alone, so no order of the intermediate passes can change the runs. The
// place pass zeroes the bins' totals and fill counters after their last
// reader, so the cached scratch needs no clearing between calls.
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

// Bits [lo_bit, lo_bit + width) of the 64-bit code (hi:lo), width <= 32.
__device__ __forceinline__ unsigned part_key(unsigned hi, unsigned lo,
                                             int lo_bit, int width) {
  const unsigned long long c = ((unsigned long long)hi << 32) | lo;
  return (unsigned)((c >> lo_bit) & ((1ull << width) - 1));
}

// The entries one side contributes to the runs: codes (hi[i], lo[i]), the
// in-bucket slot of each (an entry enters iff slot < cap), and, on the
// query side, the strand flag of each (fwd != nullptr). A coarse bin is
// the top bits of the part key: key >> bin_shift.
struct Entries {
  const unsigned* hi;
  const unsigned* lo;
  const uint8_t* slot;
  const uint8_t* fwd;
  long long n;
  int lo_bit, width, cap, bin_shift;

  // Entry i's part key, reading only the code words that hold its bits.
  __device__ __forceinline__ unsigned key(long long i) const {
    if (lo_bit + width <= 32) return part_key(0u, __ldg(lo + i), lo_bit, width);
    if (lo_bit >= 32) return part_key(__ldg(hi + i), 0u, lo_bit, width);
    return part_key(__ldg(hi + i), __ldg(lo + i), lo_bit, width);
  }
};

// The runs' scratch, cached by the caller: the bins' totals and fill
// counters (zero between calls: the place pass zeroes them after their
// last reader), the bins' starts in the runs, and the partitioned entries,
// laid out as the runs are (each bin's entries in its own range, unordered
// inside it), each (hi, lo, tag, slot).
struct RunScratch {
  unsigned* total;                     // u32[kMaxBins]
  unsigned* fill;                      // u32[kMaxBins]
  unsigned* bin_start;                 // u32[kMaxBins + 1]
  uint4* mid;                          // u32[n][4]
};

constexpr int kHistThreads = 512;
constexpr int kHistBlocks = 512;                       // at most
constexpr int kPartThreads = 1024;
constexpr int kMaxPartItems = 16;        // entries a thread, at most
constexpr int kMaxBins = 2048;
constexpr int kPlaceThreads = 1024;
constexpr int kStageBytes = 192 * 1024;    // the place pass's stage
constexpr int kMaxBinKeys = 8192;          // keys a bin
// dynamic shared memory: the part pass's tile of `items` entries a
// thread (hi, lo, slot, strand, the sorted places) and its bins' run
// starts and bases; the place pass's stage and its keys' counters
constexpr int part_smem_bytes(int items) {
  return kPartThreads * items * (4 + 4 + 1 + 1 + 2) + (2 * kMaxBins + 1) * 4;
}
constexpr int kPlaceSmem = kStageBytes + kMaxBinKeys * 4;

// Exclusive scan of the block's NT thread values; *total gets their sum.
template <int NT>
__device__ __forceinline__ unsigned block_scan(unsigned v, unsigned* total) {
  constexpr int kWarps = NT / 32;
  static_assert(kWarps <= 32, "one warp scans the warps' sums");
  __shared__ unsigned warp_sums[kWarps];
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
    unsigned s = lane < kWarps ? warp_sums[lane] : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, s, d);
      if (lane >= d) s += y;
    }
    if (lane < kWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  const unsigned before = (warp ? warp_sums[warp - 1] : 0u) + x - v;
  *total = warp_sums[kWarps - 1];
  __syncthreads();
  return before;
}

// Pass 1, the bins' totals: each block counts its share of the entering
// entries by coarse bin in shared memory and adds its counts to the
// totals, one atomic add per block and bin.
__global__ void __launch_bounds__(kHistThreads)
run_hist_kernel(const Entries E, unsigned* __restrict__ total, int n_bins) {
  __shared__ unsigned hist[kMaxBins];
  for (int b = threadIdx.x; b < n_bins; b += kHistThreads) hist[b] = 0u;
  __syncthreads();
  for (long long i = (long long)blockIdx.x * kHistThreads + threadIdx.x;
       i < E.n; i += (long long)gridDim.x * kHistThreads) {
    if (__ldg(E.slot + i) < E.cap) {
      atomicAdd(&hist[E.key(i) >> E.bin_shift], 1u);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += kHistThreads) {
    if (hist[b]) atomicAdd(total + b, hist[b]);
  }
}

// Pass 2, the partition: block t stages tile t (kItems entries a thread:
// codes, slots, strands) in shared memory, takes the bins' starts (a scan
// of the totals; block 0 writes them for the place pass), counts the
// tile's entering entries by bin (each its place in its bin's run),
// reserves each bin's run in the bin's range by one atomic add on its
// fill counter, sorts the places by bin, and writes each run out
// coalesced. The tile holds 8 entries a bin on average (a 128-B line of
// the scratch, part_items), 4,096 entries at least.
template <int kItems>
__global__ void __launch_bounds__(kPartThreads)
run_part_kernel(const Entries E, RunScratch S, int n_bins) {
  constexpr int kPartTile = kPartThreads * kItems;
  static_assert(kPartTile <= 1 << 14, "a place fits 14 bits");
  extern __shared__ uint4 part_smem[];
  unsigned* s_hi = (unsigned*)part_smem;                   // [kPartTile]
  unsigned* s_lo = s_hi + kPartTile;                       // [kPartTile]
  unsigned* s_run = s_lo + kPartTile;                      // [kMaxBins + 1]
  unsigned* s_base = s_run + kMaxBins + 1;                 // [kMaxBins]
  unsigned short* s_order = (unsigned short*)(s_base + kMaxBins);
  uint8_t* s_slot = (uint8_t*)(s_order + kPartTile);       // [kPartTile]
  uint8_t* s_fwd = s_slot + kPartTile;                     // [kPartTile]
  const int per = (n_bins + kPartThreads - 1) / kPartThreads;
  const int b0 = threadIdx.x * per;
  const long long base = (long long)blockIdx.x * kPartTile;
  unsigned v = 0;
  for (int b = b0; b < b0 + per && b < n_bins; ++b) {
    v += __ldcg(S.total + b);
    s_run[b] = 0u;
  }
  unsigned sum;
  unsigned run = block_scan<kPartThreads>(v, &sum);
  for (int b = b0; b < b0 + per && b < n_bins; ++b) {
    s_base[b] = run;                 // the bin's start in the runs
    if (blockIdx.x == 0) S.bin_start[b] = run;
    run += __ldcg(S.total + b);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) S.bin_start[n_bins] = sum;
  unsigned place[kItems];            // bin << 14 | place in the bin's run
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int j = r * kPartThreads + threadIdx.x;
    const long long i = base + j;
    place[r] = kFull;
    if (i < E.n) {
      const unsigned h = __ldg(E.hi + i), l = __ldg(E.lo + i);
      const uint8_t sl = __ldg(E.slot + i);
      s_hi[j] = h;
      s_lo[j] = l;
      s_slot[j] = sl;
      if (E.fwd) s_fwd[j] = __ldg(E.fwd + i);
      if (sl < E.cap) {
        const unsigned b = part_key(h, l, E.lo_bit, E.width) >> E.bin_shift;
        place[r] = b << 14 | atomicAdd(&s_run[b], 1u);
      }
    }
  }
  __syncthreads();
  v = 0;
  for (int b = b0; b < b0 + per && b < n_bins; ++b) v += s_run[b];
  unsigned n_local;
  run = block_scan<kPartThreads>(v, &n_local);
  for (int b = b0; b < b0 + per && b < n_bins; ++b) {
    const unsigned c = s_run[b];
    s_run[b] = run;                  // the bin's run starts here
    if (c) s_base[b] += atomicAdd(S.fill + b, c);
    run += c;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (place[r] != kFull) {
      s_order[s_run[place[r] >> 14] + (place[r] & 0x3FFFu)] =
          (unsigned short)(r * kPartThreads + threadIdx.x);
    }
  }
  __syncthreads();
  for (unsigned q = threadIdx.x; q < n_local; q += kPartThreads) {
    const unsigned j = s_order[q];
    const unsigned h = s_hi[j], l = s_lo[j];
    const unsigned b = part_key(h, l, E.lo_bit, E.width) >> E.bin_shift;
    const unsigned tag =
        E.fwd ? (unsigned)(base + j) | ((unsigned)(s_fwd[j] != 0) << 31) : 0u;
    S.mid[s_base[b] + (q - s_run[b])] = make_uint4(h, l, tag, s_slot[j]);
  }
}

// Pass 3, the place: block b takes bin b's range [start, end) of the
// partitioned entries, counts them by key in shared memory, writes the
// offsets of the bin's keys (start plus their counts' exclusive scan), and
// puts each entry at its key's offset + its slot inside that same range:
// staged in shared memory and written out coalesced where the range fits
// the stage; else (a bin of skewed keys) stored straight to the runs,
// inside its small range. The second read of the range comes from L2. It
// zeroes the bin's total and fill counter for the next call.
__global__ void __launch_bounds__(kPlaceThreads)
run_place_kernel(const Entries E, RunScratch S, unsigned* __restrict__ off,
                 uint2* __restrict__ codes, unsigned* __restrict__ tags,
                 int stage_cap) {
  extern __shared__ uint4 place_smem[];
  uint2* st_codes = (uint2*)place_smem;                    // [stage_cap]
  unsigned* st_tags = (unsigned*)(st_codes + stage_cap);   // [stage_cap]
  unsigned* kc = (unsigned*)((uint8_t*)place_smem + kStageBytes);
  const unsigned b = blockIdx.x;
  const int n_keys = 1 << E.bin_shift;
  const long long k0 = (long long)b << E.bin_shift;
  const unsigned s = __ldcg(S.bin_start + b);
  const unsigned e = __ldcg(S.bin_start + b + 1);
  if (threadIdx.x == 0) {            // their last readers are done
    S.total[b] = 0u;
    S.fill[b] = 0u;
  }
  for (int i = threadIdx.x; i < n_keys; i += kPlaceThreads) kc[i] = 0u;
  __syncthreads();
  for (unsigned j = s + threadIdx.x; j < e; j += kPlaceThreads) {
    const uint4 m = __ldcg(S.mid + j);
    atomicAdd(&kc[part_key(m.x, m.y, E.lo_bit, E.width) & (n_keys - 1)], 1u);
  }
  __syncthreads();
  const int per = (n_keys + kPlaceThreads - 1) / kPlaceThreads;
  const int i0 = threadIdx.x * per;
  unsigned v = 0;
  for (int i = i0; i < i0 + per && i < n_keys; ++i) v += kc[i];
  unsigned sum;
  unsigned run = block_scan<kPlaceThreads>(v, &sum);
  for (int i = i0; i < i0 + per && i < n_keys; ++i) {
    const unsigned c = kc[i];
    kc[i] = run;
    off[k0 + i] = s + run;
    run += c;
  }
  if (b == gridDim.x - 1 && threadIdx.x == 0) off[k0 + n_keys] = e;
  __syncthreads();
  const unsigned len = e - s;
  const bool staged = len <= (unsigned)stage_cap;
  for (unsigned j = s + threadIdx.x; j < e; j += kPlaceThreads) {
    const uint4 m = __ldcg(S.mid + j);
    const unsigned p =
        kc[part_key(m.x, m.y, E.lo_bit, E.width) & (n_keys - 1)] + m.w;
    if (p >= len) continue;           // a slot past its key's run
    if (staged) {
      st_codes[p] = make_uint2(m.x, m.y);
      if (tags) st_tags[p] = m.z;
    } else {
      codes[s + p] = make_uint2(m.x, m.y);
      if (tags) tags[s + p] = m.z;
    }
  }
  if (!staged) return;
  __syncthreads();
  for (unsigned j = threadIdx.x; j < len; j += kPlaceThreads) {
    codes[s + j] = st_codes[j];
    if (tags) tags[s + j] = st_tags[j];
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

// ------------------------------------------ i', K1's bucket layouts -----
//
// i' replaces the first half of quickmer2_tpu/ops/hamming_join.py::
// _part_chunk_join (:114, the key recompute and scatters at :126-149),
// whose plain version is kernels/hamming_join.py::bucket_layouts_plain:
// one word chunk and one query chunk placed into K1's padded layouts,
// each entry at lane key * pad + its rank among the live entries of its
// key in entry order, where that rank is below the pad. The JAX package
// takes those ranks (slots) from the host, a stable argsort per part and
// chunk; i' takes none. Each side is sorted by part key with a counting
// sort that keeps entry order within a key, into bucket runs (entries in
// key order, u32 offsets a key), and then one expand pass writes every
// lane of the six arrays once: lane b * pad + s takes run entry
// off[b] + s where s < min(count_b, pad), else the hole value (0; nq for
// qidx). An entry's place in its run is its slot, so no slot is computed.
// Scattering each entry's lanes instead (after a fill) writes every lane
// twice, the second time as a random partial sector in arrays of up to
// 268 MB that the fill has pushed out of the L2: 1.9x this design's time
// on the smoke's search (PERF.md).
//
// The sort is K5's two-level design (bins, then keys inside a bin) made
// stable; it runs four passes a side:
//   hist  - block t counts tile t's live entries (8,192 entries) by coarse
//           bin (the part key's top bits, at most 2,048 bins) and writes
//           its row of counts[tile][bin];
//   scan  - turns each bin's column of counts into its exclusive scan
//           over the tiles, and the bin's total;
//   part  - block t stages tile t's codes in shared memory, orders the
//           tile by bin keeping tile order (stable_order) and writes each
//           bin's share, 16 B an entry, at the bin's start (a scan of the
//           totals) + its tile's prefix: each bin's range then holds its
//           entries in entry order, with no atomics in global memory;
//   place - a block a bin stages its range (8,192 entries at most),
//           counts it by key (the offsets), orders it by key keeping
//           range order and writes it out coalesced as its keys' runs; a
//           skewed bin past the stage is counted from the partition and
//           then taken in rounds of 8,192 entries in order, each appended
//           to the keys' runs.
// A thread issues all its loads of a pass before it uses the first.
// stable_order is a counting sort of a staged tile by a small digit: W
// warps each take a contiguous segment of it and walk it 32 entries at a
// time (an entry's rank is the count of equal digits on lower lanes plus
// those seen before in the segment), then every thread places its
// entries: the order of equal digits is the staged order, with no
// block-wide sort and no per-thread counters. Equal digits of a chunk are
// grouped by one ballot a digit bit (match_digit), and only in a chunk
// that a bitmap test finds a repeat in: on the H100 a ballot costs ~4
// cycles of an SM's issue, __match_any_sync ~600-1,400 cycles where the
// digits are distinct, and most of a tile's chunks hold 32 distinct bins.
// Words whose live flag is 0 (palindromes' rc words) take a dead digit
// and stay out. Nothing is kept between calls and no scratch needs
// clearing: the wrapper passes one buffer a call.
// The expand is a thread per four lanes with 16-B stores, coalesced, and
// reads the runs in lane order. Bound: bytes, each lane written once and
// each entry's code, occ and live flag read once (chip_smoke.py).

constexpr int kLayTile = 8192;          // entries a tile of hist and part
constexpr int kLayMaxBins = 2048;       // coarse bins, at most
constexpr int kLayHistThreads = 512;
constexpr int kLayPartThreads = 1024;
constexpr int kLayPartWarps = 16;       // part's ranking warps
constexpr int kLayPlaceThreads = 1024;
constexpr int kLayRound = 8192;         // entries place stages at once
// dynamic shared memory a block may take: 227 KB less the static kind
constexpr int kLaySmemMax = 227 * 1024 - 1024;
constexpr int kLayExpandThreads = 256;
constexpr int kDigitBits = 14;          // digits (bins, keys) < 2^14 - 1
constexpr unsigned kNoDigit = (1u << kDigitBits) - 1u;

// One side of a layouts call: its entries (codes hi, lo and, for the word
// side, u8 occ and live flags, entry i at i * stride; on the query side
// occ and live are null, every entry is live and its tag is its index),
// its part bits, its coarse bins (key >> shift) and its share of the
// call's scratch.
struct LaySide {
  const unsigned* hi;
  const unsigned* lo;
  const uint8_t* occ;
  const uint8_t* live;
  long long stride, n;
  int lo_bit, width, shift, n_bins, n_tiles;
  unsigned* counts;         // u32[n_tiles][n_bins]: counts, then prefixes
  unsigned* total;          // u32[n_bins]
  unsigned* bin_start;      // u32[n_bins + 1]
  uint4* mid;               // the partition: each bin's entries in order,
                            // (hi, lo, tag, 0)
  uint2* run_code;          // the runs: entries in key order
  unsigned* run_tag;        // occ (words) or the entry's index (queries)
  unsigned* off;            // u32[2^width + 1] the runs' offsets

  __device__ __forceinline__ bool is_live(long long i) const {
    return live == nullptr || __ldg(live + i * stride) != 0;
  }
  // entry i's part key, reading only the code words that hold its bits
  __device__ __forceinline__ unsigned key(long long i) const {
    const long long j = i * stride;
    if (lo_bit + width <= 32) return part_key(0u, __ldg(lo + j), lo_bit, width);
    if (lo_bit >= 32) return part_key(__ldg(hi + j), 0u, lo_bit, width);
    return part_key(__ldg(hi + j), __ldg(lo + j), lo_bit, width);
  }
  __device__ __forceinline__ unsigned key_of(uint2 c) const {
    return part_key(c.x, c.y, lo_bit, width);
  }
};

__device__ __forceinline__ int leader_of(unsigned peers) {
  return 31 - __clz(peers);
}

// The lanes of the warp whose digit equals this lane's, for digits below
// 2^bits - 1 (kNoDigit, none, matches none of them): one ballot a bit,
// where __match_any_sync costs more (see above).
__device__ __forceinline__ unsigned match_digit(unsigned d, int bits) {
  unsigned peers = kFull;
#pragma unroll
  for (int b = 0; b < kDigitBits; ++b) {
    if (b < bits) {
      const unsigned on = __ballot_sync(kFull, (d >> b) & 1u);
      peers &= (d >> b) & 1u ? on : ~on;
    }
  }
  return peers;
}

// Bits that tell apart the digits below n (and kNoDigit from them).
__device__ __forceinline__ int digit_bits(int n) { return 32 - __clz(n); }

// Orders the `len` staged entries by digit (u16 digit[j] < n_dig, or
// kNoDigit for none), keeping staged order among equal digits: perm[p]
// is the stage position of the p-th entry and first[d] the place of
// digit d's first entry (first[n_dig] the entries with a digit). W warps
// rank, each a contiguous segment of the stage, 32 entries at a time:
// rank[j] counts the equal digits before j in its segment and cnt[w][d]
// (W x n_dig u16) the segment's digits; then every thread places its
// entries. A chunk of 32 whose digits are distinct (each lane sets its
// digit's bit in the warp's bitmap, bits[w] of (n_dig + 31) / 32 words,
// and none finds it set) needs no match; the others group equal digits
// by match_digit. Called by every thread of the block (NT of them); ends
// synchronized.
template <int NT>
__device__ void stable_order(int len, int n_dig, int W,
                             const unsigned short* digit,
                             unsigned short* cnt, unsigned short* rank,
                             unsigned* bits, unsigned* first,
                             unsigned short* perm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int words = (n_dig + 31) >> 5;
  for (int i = threadIdx.x; i < W * n_dig; i += NT) cnt[i] = 0;
  for (int i = threadIdx.x; i < W * words; i += NT) bits[i] = 0u;
  __syncthreads();
  const int seg = ((len + W - 1) / W + 31) & ~31;
  const int n_bits = digit_bits(n_dig);
  if (warp < W) {
    unsigned short* c = cnt + warp * n_dig;
    unsigned* bm = bits + warp * words;
    const unsigned below = (1u << lane) - 1u;
    const int lo = warp * seg, hi = min(len, lo + seg);
    for (int j0 = lo; j0 < hi; j0 += 32) {
      const int j = j0 + lane;
      const unsigned d = j < hi ? digit[j] : kNoDigit;
      const bool ok = d != kNoDigit;
      const unsigned seen = ok ? c[d] : 0u;
      const unsigned bit = 1u << (d & 31u);
      const bool dup = ok && (atomicOr(&bm[d >> 5], bit) & bit);
      const unsigned peers = __any_sync(kFull, dup) ? match_digit(d, n_bits)
                                                     : 1u << lane;
      if (ok) bm[d >> 5] = 0u;
      if (ok) {
        rank[j] = (unsigned short)(seen + __popc(peers & below));
        if (lane == leader_of(peers)) c[d] = (unsigned short)(seen + __popc(peers));
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < n_dig; d += NT) {
    unsigned run = 0;                   // each warp's offset in digit d
    for (int w = 0; w < W; ++w) {
      const unsigned v = cnt[w * n_dig + d];
      cnt[w * n_dig + d] = (unsigned short)run;
      run += v;
    }
    first[d] = run;
  }
  __syncthreads();
  const int per = (n_dig + NT - 1) / NT;
  const int d0 = threadIdx.x * per;
  unsigned v = 0;
  for (int d = d0; d < d0 + per && d < n_dig; ++d) v += first[d];
  unsigned sum;
  unsigned run = block_scan<NT>(v, &sum);
  for (int d = d0; d < d0 + per && d < n_dig; ++d) {
    const unsigned t = first[d];
    first[d] = run;
    run += t;
  }
  if (threadIdx.x == 0) first[n_dig] = sum;
  __syncthreads();
  for (int j = threadIdx.x; j < len; j += NT) {
    const unsigned d = digit[j];
    if (d != kNoDigit) {
      perm[first[d] + cnt[(j / seg) * n_dig + d] + rank[j]] = (unsigned short)j;
    }
  }
  __syncthreads();
}

// Pass 1: tile t's live entries by bin into counts[t][*]; a thread's
// loads are all issued before the first is used.
__global__ void __launch_bounds__(kLayHistThreads)
    lay_hist_kernel(const LaySide S) {
  constexpr int kItems = kLayTile / kLayHistThreads;
  __shared__ unsigned hist[kLayMaxBins];
  const long long base = (long long)blockIdx.x * kLayTile;
  const long long rest = S.n - base;
  const int len = rest < kLayTile ? (int)(rest > 0 ? rest : 0) : kLayTile;
  for (int b = threadIdx.x; b < S.n_bins; b += kLayHistThreads) hist[b] = 0u;
  unsigned bin[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int j = r * kLayHistThreads + threadIdx.x;
    bool ok = false;
    unsigned key = 0u;
    if (j < len) {
      ok = S.is_live(base + j);
      key = S.key(base + j);
    }
    bin[r] = ok ? key >> S.shift : kNoDigit;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (bin[r] != kNoDigit) atomicAdd(&hist[bin[r]], 1u);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < S.n_bins; b += kLayHistThreads) {
    S.counts[(long long)blockIdx.x * S.n_bins + b] = hist[b];
  }
}

// Pass 2: a block per 32 bins, lane = bin, warp = a segment of tiles;
// each bin's counts over the tiles become their exclusive scan in place,
// and its total.
__global__ void __launch_bounds__(1024) lay_scan_kernel(const LaySide S) {
  __shared__ unsigned seg[32][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * 32 + lane;
  const int per = (S.n_tiles + 31) / 32;
  const int t0 = warp * per, t1 = min(S.n_tiles, t0 + per);
  unsigned* col = S.counts + b;
  unsigned s = 0;
  if (b < S.n_bins) {
    for (int t = t0; t < t1; ++t) s += col[(long long)t * S.n_bins];
  }
  seg[warp][lane] = s;
  __syncthreads();
  if (warp == 0) {
    unsigned run = 0;
    for (int w = 0; w < 32; ++w) {
      const unsigned v = seg[w][lane];
      seg[w][lane] = run;
      run += v;
    }
    if (b < S.n_bins) S.total[b] = run;
  }
  __syncthreads();
  if (b < S.n_bins) {
    unsigned run = seg[warp][lane];
    for (int t = t0; t < t1; ++t) {
      const unsigned v = col[(long long)t * S.n_bins];
      col[(long long)t * S.n_bins] = run;
      run += v;
    }
  }
}

// part's dynamic shared memory: the staged tile (code, digit, perm,
// rank), the bins' bases and firsts, the ranking counters and bitmaps
constexpr int kLayPartSmem =
    kLayTile * (8 + 2 + 2 + 2) + (kLayMaxBins + 1) * 4 +
    (kLayMaxBins + 2) * 4 + kLayPartWarps * (kLayMaxBins + 1) * 2 +
    kLayPartWarps * ((kLayMaxBins + 32) / 32) * 4;
static_assert(kLayPartSmem <= kLaySmemMax, "part's stage fits a block");

// Pass 3: block t stages tile t (a dead word takes the digit n_bins),
// orders it by bin keeping tile order, and writes bin b's share at
// bin_start[b] + its prefix in counts + its place among them. Block 0
// writes bin_start for the place pass.
__global__ void __launch_bounds__(kLayPartThreads)
    lay_part_kernel(const LaySide S) {
  extern __shared__ uint4 lay_smem[];
  uint2* s_code = (uint2*)lay_smem;                          // [kLayTile]
  unsigned* s_base = (unsigned*)(s_code + kLayTile);         // [bins + 1]
  unsigned* s_first = s_base + kLayMaxBins + 1;              // [bins + 2]
  unsigned short* s_digit = (unsigned short*)(s_first + kLayMaxBins + 2);
  unsigned short* s_perm = s_digit + kLayTile;               // [kLayTile]
  unsigned short* s_rank = s_perm + kLayTile;                // [kLayTile]
  unsigned short* s_cnt = s_rank + kLayTile;       // [W][kLayMaxBins + 1]
  unsigned* s_bits =                               // [W][(bins + 32) / 32]
      (unsigned*)(s_cnt + kLayPartWarps * (kLayMaxBins + 1));
  constexpr int kItems = kLayTile / kLayPartThreads;
  const int nb = S.n_bins;
  const long long base = (long long)blockIdx.x * kLayTile;
  const long long rest = S.n - base;
  const int len = rest < kLayTile ? (int)(rest > 0 ? rest : 0) : kLayTile;
  uint2 code[kItems];               // the thread's entries, loads issued
  bool live[kItems];                // before the first is used
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int j = r * kLayPartThreads + threadIdx.x;
    if (j < len) {
      const long long i = base + j;
      const long long o = i * S.stride;
      code[r] = make_uint2(__ldg(S.hi + o), __ldg(S.lo + o));
      live[r] = S.is_live(i);
    }
  }
  const int per = (nb + kLayPartThreads - 1) / kLayPartThreads;
  const int b0 = threadIdx.x * per;
  unsigned v = 0;
  for (int b = b0; b < b0 + per && b < nb; ++b) v += __ldcg(S.total + b);
  unsigned sum;
  unsigned run = block_scan<kLayPartThreads>(v, &sum);
  const unsigned* row = S.counts + (long long)blockIdx.x * nb;
  for (int b = b0; b < b0 + per && b < nb; ++b) {
    s_base[b] = run + __ldcg(row + b);
    if (blockIdx.x == 0) S.bin_start[b] = run;
    run += __ldcg(S.total + b);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) S.bin_start[nb] = sum;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int j = r * kLayPartThreads + threadIdx.x;
    if (j < len) {
      s_code[j] = code[r];
      s_digit[j] = live[r] ? (unsigned short)(S.key_of(code[r]) >> S.shift)
                           : (unsigned short)nb;
    }
  }
  __syncthreads();
  stable_order<kLayPartThreads>(len, nb + 1, kLayPartWarps, s_digit, s_cnt,
                                s_rank, s_bits, s_first, s_perm);
  const unsigned n_live = s_first[nb];
  for (unsigned p = threadIdx.x; p < n_live; p += kLayPartThreads) {
    const unsigned j = s_perm[p];
    const unsigned b = s_digit[j];
    const unsigned d = s_base[b] + (p - s_first[b]);
    const long long i = base + j;   // a word's occ is read again (L2)
    const unsigned tag =
        S.occ ? (unsigned)__ldg(S.occ + i * S.stride) : (unsigned)i;
    S.mid[d] = make_uint4(s_code[j].x, s_code[j].y, tag, 0u);
  }
}

// place's ranking warps and dynamic shared memory for bins of n_keys keys:
// the staged round (code, tag, digit, perm, rank), the keys' run ends and
// firsts, and the ranking counters and bitmaps, as many warps' as the rest
// leaves room for (32 at 512 keys a bin, 1 at 8,192)
int lay_place_fixed(int n_keys) {
  return kLayRound * (8 + 4 + 2 + 2 + 2) + n_keys * 4 + (n_keys + 2) * 4;
}

// one ranking warp's counters and bitmap
int lay_place_per_warp(int n_keys) {
  return 2 * n_keys + 4 * ((n_keys + 31) / 32);
}

int lay_place_warps(int n_keys) {
  const int w = (kLaySmemMax - lay_place_fixed(n_keys)) /
                lay_place_per_warp(n_keys);
  return w < 1 ? 1 : (w > kLayPlaceThreads / 32 ? kLayPlaceThreads / 32 : w);
}

int lay_place_smem(int n_keys) {
  return lay_place_fixed(n_keys) +
         lay_place_warps(n_keys) * lay_place_per_warp(n_keys);
}

// Stages place's `len` (at most kLayRound) partition entries from r0:
// codes, tags and each one's key in its bin; a thread's loads are all
// issued before the first is used. Ends synchronized.
__device__ __forceinline__ void lay_stage(const LaySide& S, unsigned r0,
                                          int len, unsigned mask,
                                          uint2* s_code, unsigned* s_tag,
                                          unsigned short* s_digit) {
  constexpr int kItems = kLayRound / kLayPlaceThreads;
  uint2 c[kItems];
  unsigned t[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int j = r * kLayPlaceThreads + threadIdx.x;
    if (j < len) {
      const uint4 m = __ldcg(S.mid + r0 + j);
      c[r] = make_uint2(m.x, m.y);
      t[r] = m.z;
    }
  }
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int j = r * kLayPlaceThreads + threadIdx.x;
    if (j < len) {
      s_code[j] = c[r];
      s_tag[j] = t[r];
      s_digit[j] = (unsigned short)(S.key_of(c[r]) & mask);
    }
  }
  __syncthreads();
}

// Adds each key's count among kItems keys a thread (kNoDigit: none) to
// s_count.
template <int kItems>
__device__ __forceinline__ void lay_count(const unsigned (&k)[kItems],
                                          unsigned* s_count) {
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (k[r] != kNoDigit) atomicAdd(&s_count[k[r]], 1u);
  }
}

// Pass 4: block b takes bin b's range [start, end) of the partition (in
// entry order), counts it by key, writes its keys' offsets, and appends
// each round of the range to the keys' runs in range order. A range of
// one round is staged once and counted in shared memory; a longer one is
// counted from the partition first.
__global__ void __launch_bounds__(kLayPlaceThreads)
    lay_place_kernel(const LaySide S, int W) {
  constexpr int kItems = kLayRound / kLayPlaceThreads;
  extern __shared__ uint4 lay_smem[];
  const int n_keys = 1 << S.shift;
  uint2* s_code = (uint2*)lay_smem;                          // [kLayRound]
  unsigned* s_tag = (unsigned*)(s_code + kLayRound);         // [kLayRound]
  unsigned* s_end = s_tag + kLayRound;                       // [n_keys]
  unsigned* s_first = s_end + n_keys;                        // [n_keys + 1]
  unsigned short* s_digit = (unsigned short*)(s_first + n_keys + 1);
  unsigned short* s_perm = s_digit + kLayRound;              // [kLayRound]
  unsigned short* s_rank = s_perm + kLayRound;               // [kLayRound]
  unsigned* s_bits = (unsigned*)(s_rank + kLayRound);  // [W][n_keys / 32]
  unsigned short* s_cnt =                                    // [W][n_keys]
      (unsigned short*)(s_bits + W * ((n_keys + 31) / 32));
  const unsigned b = blockIdx.x;
  const long long k0 = (long long)b << S.shift;
  const unsigned s = __ldcg(S.bin_start + b);
  const unsigned e = __ldcg(S.bin_start + b + 1);
  const bool one = e - s <= (unsigned)kLayRound;
  const unsigned mask = (unsigned)n_keys - 1u;
  for (int i = threadIdx.x; i < n_keys; i += kLayPlaceThreads) s_end[i] = 0u;
  __syncthreads();
  if (one) {
    lay_stage(S, s, (int)(e - s), mask, s_code, s_tag, s_digit);
    unsigned k[kItems];
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const unsigned j = r * kLayPlaceThreads + threadIdx.x;
      k[r] = j < e - s ? s_digit[j] : kNoDigit;
    }
    lay_count<kItems>(k, s_end);
  } else {
    for (unsigned j0 = s; j0 < e; j0 += kLayRound) {
      unsigned k[kItems];
#pragma unroll
      for (int r = 0; r < kItems; ++r) {
        const unsigned j = j0 + r * kLayPlaceThreads + threadIdx.x;
        const uint4 m = j < e ? __ldcg(S.mid + j) : make_uint4(0u, 0u, 0u, 0u);
        k[r] = j < e ? S.key_of(make_uint2(m.x, m.y)) & mask : kNoDigit;
      }
      lay_count<kItems>(k, s_end);
    }
  }
  __syncthreads();
  const int per = (n_keys + kLayPlaceThreads - 1) / kLayPlaceThreads;
  const int i0 = threadIdx.x * per;
  unsigned v = 0;
  for (int i = i0; i < i0 + per && i < n_keys; ++i) v += s_end[i];
  unsigned sum;
  unsigned run = block_scan<kLayPlaceThreads>(v, &sum);
  for (int i = i0; i < i0 + per && i < n_keys; ++i) {
    const unsigned c = s_end[i];
    s_end[i] = s + run;               // where key i's next entry goes
    S.off[k0 + i] = s + run;
    run += c;
  }
  if (b == gridDim.x - 1 && threadIdx.x == 0) S.off[k0 + n_keys] = e;
  __syncthreads();
  for (unsigned r0 = s; r0 < e; r0 += kLayRound) {
    const int len = (int)min(e - r0, (unsigned)kLayRound);
    if (!one) lay_stage(S, r0, len, mask, s_code, s_tag, s_digit);
    stable_order<kLayPlaceThreads>(len, n_keys, W, s_digit, s_cnt, s_rank,
                                   s_bits, s_first, s_perm);
    for (int p = threadIdx.x; p < len; p += kLayPlaceThreads) {
      const unsigned j = s_perm[p];
      const unsigned k = s_digit[j];
      const unsigned d = s_end[k] + (p - s_first[k]);
      S.run_code[d] = s_code[j];
      S.run_tag[d] = s_tag[j];
    }
    __syncthreads();
    for (int k = threadIdx.x; k < n_keys; k += kLayPlaceThreads) {
      s_end[k] += s_first[k + 1] - s_first[k];
    }
    __syncthreads();
  }
}

// One side's padded arrays from its runs: a0, a1, a2 u32[n_lanes] (code
// hi, lo, tag), n_lanes = n_buckets * pad + 1 (the last lane a hole);
// magic = ceil(2^64 / pad) for pad >= 2, so that L / pad is
// __umul64hi(L, magic) for every lane L < 2^56.
struct LayExpand {
  const uint2* code;
  const unsigned* tag;
  const unsigned* off;
  unsigned* a0;
  unsigned* a1;
  unsigned* a2;
  unsigned long long n_lanes, n_buckets, magic;
  unsigned pad, hole;
};

__device__ __forceinline__ void lay_bucket(const LayExpand& X,
                                           unsigned long long b, unsigned* o,
                                           unsigned* c) {
  if (b < X.n_buckets) {
    *o = __ldg(X.off + b);
    *c = min(__ldg(X.off + b + 1) - *o, X.pad);
  } else {
    *o = 0u;
    *c = 0u;
  }
}

// Pass 5, both sides (blockIdx.y: 0 words, 1 queries): a thread per four
// lanes; lane b * pad + s takes run entry off[b] + s where s is below
// min(count_b, pad), else the hole value.
__global__ void __launch_bounds__(kLayExpandThreads)
    lay_expand_kernel(const LayExpand w, const LayExpand q) {
  const LayExpand X = blockIdx.y ? q : w;
  const unsigned long long quads = (X.n_lanes + 3) >> 2;
  for (unsigned long long t = (unsigned long long)blockIdx.x *
                                  kLayExpandThreads + threadIdx.x;
       t < quads; t += (unsigned long long)gridDim.x * kLayExpandThreads) {
    const unsigned long long L0 = t << 2;
    unsigned long long b = X.pad == 1u ? L0 : __umul64hi(L0, X.magic);
    unsigned s = (unsigned)(L0 - b * X.pad);
    unsigned o, c;
    lay_bucket(X, b, &o, &c);
    unsigned h[4], l[4], g[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (s < c) {
        const uint2 v = __ldg(X.code + o + s);
        h[u] = v.x;
        l[u] = v.y;
        g[u] = __ldg(X.tag + o + s);
      } else {
        h[u] = 0u;
        l[u] = 0u;
        g[u] = X.hole;
      }
      if (++s == X.pad) {
        s = 0u;
        lay_bucket(X, ++b, &o, &c);
      }
    }
    if (L0 + 4 <= X.n_lanes) {
      ((uint4*)X.a0)[t] = make_uint4(h[0], h[1], h[2], h[3]);
      ((uint4*)X.a1)[t] = make_uint4(l[0], l[1], l[2], l[3]);
      ((uint4*)X.a2)[t] = make_uint4(g[0], g[1], g[2], g[3]);
    } else {
      for (int u = 0; L0 + u < X.n_lanes; ++u) {
        X.a0[L0 + u] = h[u];
        X.a1[L0 + u] = l[u];
        X.a2[L0 + u] = g[u];
      }
    }
  }
}

bool bad_pads(long long n_buckets, int cpad, int cpad_q, int nq) {
  return n_buckets < 1 || cpad < 1 || cpad > 255 || cpad_q < 1 ||
         cpad_q > 255 || nq < 0;
}

// The part pass's entries a thread: 8 entries a bin a tile on average,
// 4 to 16, so a tile holds 4,096 to 16,384 entries.
int part_items(int n_bins) {
  const int items = n_bins * 8 / kPartThreads;
  return items <= 4 ? 4 : (items <= 8 ? 8 : kMaxPartItems);
}

template <int kItems>
void launch_part(const Entries& E, const RunScratch& S, int n_bins,
                 cudaStream_t s) {
  const long long tile = (long long)kPartThreads * kItems;
  const long long tiles = (E.n + tile - 1) / tile;
  run_part_kernel<kItems><<<(unsigned)(tiles > 0 ? tiles : 1), kPartThreads,
                            part_smem_bytes(kItems), s>>>(E, S, n_bins);
}

// The passes that stage more than 48 KB in shared memory must be allowed
// to, once on each device.
cudaError_t allow_dynamic_smem() {
  static bool done[64] = {};
  int d = 0;
  cudaError_t rc = cudaGetDevice(&d);
  if (rc != cudaSuccess || (d < 64 && done[d])) return rc;
  rc = cudaFuncSetAttribute(run_part_kernel<4>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            part_smem_bytes(4));
  if (rc == cudaSuccess) {
    rc = cudaFuncSetAttribute(run_part_kernel<8>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              part_smem_bytes(8));
  }
  if (rc == cudaSuccess) {
    rc = cudaFuncSetAttribute(run_part_kernel<16>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              part_smem_bytes(16));
  }
  if (rc == cudaSuccess) {
    rc = cudaFuncSetAttribute(run_place_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kPlaceSmem);
  }
  if (rc == cudaSuccess && d < 64) done[d] = true;
  return rc;
}

bool bad_part(int lo_bit, int width) {
  return width < 1 || width > 32 || lo_bit < 0 || lo_bit + width > 64;
}

// i''s plan for one side: coarse bins of the part key's top bits (2,048,
// or a key a bin below 11 bits; at most 8,192 keys a bin at width 24)
// and tiles of kLayTile entries, one at least.
struct LayPlan {
  int shift, n_bins, n_tiles;
};

LayPlan lay_plan(long long n, int width) {
  const int bits = width < 11 ? width : 11;
  const long long tiles = (n + kLayTile - 1) / kLayTile;
  return {width - bits, 1 << bits, (int)(tiles > 0 ? tiles : 1)};
}

// One side's scratch at p (16-B aligned): counts, totals, bin starts, the
// partition, the runs, the offsets. Returns its bytes; with S, points S's
// scratch into it.
long long lay_scratch(LaySide* S, uint8_t* p, long long n, int width) {
  const LayPlan P = lay_plan(n, width);
  long long at = 0;
  auto take = [&](long long bytes) {
    uint8_t* q = p ? p + at : nullptr;
    at += (bytes + 15) & ~15LL;
    return q;
  };
  uint8_t* counts = take(4LL * P.n_tiles * P.n_bins);
  uint8_t* total = take(4LL * P.n_bins);
  uint8_t* bin_start = take(4LL * (P.n_bins + 1));
  uint8_t* mid = take(16 * n);
  uint8_t* run_code = take(8 * n);
  uint8_t* run_tag = take(4 * n);
  uint8_t* off = take(4 * ((1LL << width) + 1));
  if (S) {
    S->shift = P.shift;
    S->n_bins = P.n_bins;
    S->n_tiles = P.n_tiles;
    S->counts = (unsigned*)counts;
    S->total = (unsigned*)total;
    S->bin_start = (unsigned*)bin_start;
    S->mid = (uint4*)mid;
    S->run_code = (uint2*)run_code;
    S->run_tag = (unsigned*)run_tag;
    S->off = (unsigned*)off;
  }
  return at;
}

// part and place stage more than 48 KB in shared memory: allowed once on
// each device (place at its largest, 8,192 keys a bin).
cudaError_t allow_layout_smem() {
  static bool done[64] = {};
  int d = 0;
  cudaError_t rc = cudaGetDevice(&d);
  if (rc != cudaSuccess || (d < 64 && done[d])) return rc;
  int place = 0;
  for (int keys = 1; keys <= 8192; keys <<= 1) {
    place = lay_place_smem(keys) > place ? lay_place_smem(keys) : place;
  }
  rc = cudaFuncSetAttribute(lay_part_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            kLayPartSmem);
  if (rc == cudaSuccess) {
    rc = cudaFuncSetAttribute(lay_place_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              place);
  }
  if (rc == cudaSuccess && d < 64) done[d] = true;
  return rc;
}

// One side's bucket runs: hist, scan, part, place.
void lay_sort(const LaySide& S, cudaStream_t st) {
  lay_hist_kernel<<<S.n_tiles, kLayHistThreads, 0, st>>>(S);
  lay_scan_kernel<<<(S.n_bins + 31) / 32, 1024, 0, st>>>(S);
  lay_part_kernel<<<S.n_tiles, kLayPartThreads, kLayPartSmem, st>>>(S);
  const int n_keys = 1 << S.shift;
  lay_place_kernel<<<S.n_bins, kLayPlaceThreads, lay_place_smem(n_keys),
                     st>>>(S, lay_place_warps(n_keys));
}

// ceil(2^64 / pad) for pad >= 2 (see LayExpand), 0 for pad 1.
unsigned long long lay_magic(int pad) {
  return pad >= 2 ? ~0ULL / (unsigned long long)pad + 1ULL : 0ULL;
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

// K5's counting sort. hi, lo u32[n] codes; slot u8[n] in-bucket slots
// (the rank of the entry among the entering entries of its key); fwd u8[n]
// strand flags, or null for the word side; bin_shift the coarse bins'
// shift (2^(width - bin_shift) <= 2048 bins of 2^bin_shift <= 8192 keys);
// total and fill u32[2048] zero at entry and left zero, and bin_start
// u32[2049], scratch cached by the caller; mid u32[n][4] scratch; off
// u32[2^width + 1] the runs' offsets; codes u32[n][2] and (with fwd) tags
// u32[n] the runs, of which the first off[2^width] entries are written.
// Calls that share the cached scratch run on one stream, one after
// another.
extern "C" int qm2t_bucket_runs(const void* hi, const void* lo,
                                const void* slot, const void* fwd,
                                long long n, int lo_bit, int width, int cap,
                                int bin_shift, void* total, void* fill,
                                void* bin_start, void* mid, void* off,
                                void* codes, void* tags, void* stream) {
  if (n < 0 || n > 0x7FFFFFFFLL || bad_part(lo_bit, width) || width > 24 ||
      cap < 1 || cap > 255 || (fwd == nullptr) != (tags == nullptr) ||
      bin_shift < 0 || bin_shift > width ||
      (1 << (width - bin_shift)) > kMaxBins ||
      (1 << bin_shift) > kMaxBinKeys) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t attr = allow_dynamic_smem();
  if (attr != cudaSuccess) return (int)attr;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_bins = 1 << (width - bin_shift);
  const Entries E = {(const unsigned*)hi, (const unsigned*)lo,
                     (const uint8_t*)slot, (const uint8_t*)fwd, n, lo_bit,
                     width, cap, bin_shift};
  const RunScratch S = {(unsigned*)total, (unsigned*)fill,
                        (unsigned*)bin_start, (uint4*)mid};
  const long long hist_blocks = (n + 4 * kHistThreads - 1) /
                                (4 * kHistThreads);
  if (n > 0) {
    run_hist_kernel<<<(unsigned)(hist_blocks < kHistBlocks ? hist_blocks
                                                           : kHistBlocks),
                      kHistThreads, 0, s>>>(E, S.total, n_bins);
  }
  switch (part_items(n_bins)) {
    case 4: launch_part<4>(E, S, n_bins, s); break;
    case 8: launch_part<8>(E, S, n_bins, s); break;
    default: launch_part<kMaxPartItems>(E, S, n_bins, s);
  }
  run_place_kernel<<<n_bins, kPlaceThreads, kPlaceSmem, s>>>(
      E, S, (unsigned*)off, (uint2*)codes, (unsigned*)tags,
      kStageBytes / (tags ? 12 : 8));
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

// i''s scratch for a call: bytes, or -1 for a bad width.
extern "C" long long qm2t_layout_scratch_bytes(long long n_w, long long nq,
                                               int width) {
  if (width < 1 || width > 24 || n_w < 0 || nq < 0) return -1;
  return lay_scratch(nullptr, nullptr, n_w, width) +
         lay_scratch(nullptr, nullptr, nq, width);
}

// i': K1's layouts of one part (bits [lo_bit, lo_bit + width), 2^width
// buckets) from a word chunk (whi, wlo u32 and wocc, wlive u8, entry i at
// i * w_stride; a word whose live flag is 0 stays out) and a query chunk
// (qhi, qlo u32[nq]): dh, dl, docc u32[2^width * cpad + 1] and qh, ql,
// qidx [2^width * cpad_q + 1], each 16-B aligned and written in full;
// scratch of qm2t_layout_scratch_bytes(n_w, nq, width) bytes, 16-B aligned,
// nothing in it read before it is written.
extern "C" int qm2t_bucket_layouts(const void* whi, const void* wlo,
                                   const void* wocc, const void* wlive,
                                   long long w_stride, long long n_w,
                                   const void* qhi, const void* qlo,
                                   long long nq, int lo_bit, int width,
                                   int cpad, int cpad_q, void* scratch,
                                   long long scratch_bytes, void* dh,
                                   void* dl, void* docc, void* qh, void* ql,
                                   void* qidx, void* stream) {
  void* outs[7] = {dh, dl, docc, qh, ql, qidx, scratch};
  bool aligned = true;
  for (void* o : outs) aligned = aligned && (uintptr_t)o % 16 == 0;
  if (bad_part(lo_bit, width) || width > 24 ||
      bad_pads(1LL << width, cpad, cpad_q, 0) || n_w < 0 ||
      n_w > 0x7FFFFFFFLL || w_stride < 1 || nq < 0 || nq > 0x7FFFFFFFLL ||
      !aligned ||
      scratch_bytes < qm2t_layout_scratch_bytes(n_w, nq, width)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t attr = allow_layout_smem();
  if (attr != cudaSuccess) return (int)attr;
  cudaStream_t st = (cudaStream_t)stream;
  LaySide W = {(const unsigned*)whi, (const unsigned*)wlo,
               (const uint8_t*)wocc, (const uint8_t*)wlive, w_stride, n_w,
               lo_bit, width};
  LaySide Q = {(const unsigned*)qhi, (const unsigned*)qlo, nullptr, nullptr,
               1, nq, lo_bit, width};
  const long long w_bytes = lay_scratch(&W, (uint8_t*)scratch, n_w, width);
  lay_scratch(&Q, (uint8_t*)scratch + w_bytes, nq, width);
  lay_sort(W, st);
  lay_sort(Q, st);
  const unsigned long long B = 1ULL << width;
  const LayExpand xw = {W.run_code, W.run_tag, W.off, (unsigned*)dh,
                        (unsigned*)dl, (unsigned*)docc, B * cpad + 1, B,
                        lay_magic(cpad), (unsigned)cpad, 0u};
  const LayExpand xq = {Q.run_code, Q.run_tag, Q.off, (unsigned*)qh,
                        (unsigned*)ql, (unsigned*)qidx, B * cpad_q + 1, B,
                        lay_magic(cpad_q), (unsigned)cpad_q, (unsigned)nq};
  const unsigned long long quads =
      ((cpad > cpad_q ? xw.n_lanes : xq.n_lanes) + 3) / 4;
  unsigned long long blocks =
      (quads + kLayExpandThreads - 1) / kLayExpandThreads;
  if (blocks > 2112) blocks = 2112;     // 16 a streaming multiprocessor
  lay_expand_kernel<<<dim3((unsigned)blocks, 2), kLayExpandThreads, 0, st>>>(
      xw, xq);
  return (int)cudaGetLastError();
}
