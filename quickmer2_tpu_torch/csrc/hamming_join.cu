// The Hamming joins: K1, the compare chain of the search phase's
// edit-distance filter, with i', the scatter that builds K1's layouts, and
// K5, the anchored index's neighbor bits, with the counting sort that
// builds K5's inputs.
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
// whose plain version is ops/hamming_join.py::_bucket_layouts: one word
// chunk and one query chunk scattered into K1's padded layouts. Two
// launches: a fill of the six arrays (zeros, qidx = nq, the hole lanes
// too) in 16-B stores, then a thread an entry, which recomputes the
// entry's part key from its code and, where its slot is below the pad,
// writes its lane key * pad + slot. The word chunk is read by its stride
// from the whole word side (the join plan interleaves its chunks), so no
// chunk is gathered first. Slots are ranks among a chunk's equal keys, so
// no two entries share a lane; dead entries (palindromic rc words, slot
// 255) stay out. Bound: bytes, each output lane written once and each
// entry's code, occ and slot read once.

struct LayoutFill {
  unsigned* a[6];           // dh, dl, docc, qh, ql, qidx
  long long n[6];           // lanes of each
  unsigned v[6];            // fill value of each
};

__global__ void __launch_bounds__(kThreads)
    layout_fill_kernel(const LayoutFill f) {
  const int j = blockIdx.y;
  unsigned* a = f.a[j];
  const long long n = f.n[j];
  const unsigned v = f.v[j];
  const uint4 q = {v, v, v, v};
  const long long n4 = n >> 2;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += (long long)gridDim.x * kThreads) {
    ((uint4*)a)[i] = q;
  }
  if (blockIdx.x == 0 && threadIdx.x < (n & 3)) a[(n4 << 2) + threadIdx.x] = v;
}

struct LayoutScatter {
  const unsigned* whi;      // word side, entry i at i * w_stride
  const unsigned* wlo;
  const uint8_t* wocc;
  const uint8_t* wslot;     // u8[n_w], contiguous
  const unsigned* qhi;      // query chunk, contiguous
  const unsigned* qlo;
  const uint8_t* qslot;
  long long w_stride, n_w, nq;
  int lo_bit, width, cpad, cpad_q;
  unsigned* dh;
  unsigned* dl;
  unsigned* docc;
  unsigned* qh;
  unsigned* ql;
  int* qidx;
};

__global__ void __launch_bounds__(kThreads)
    layout_scatter_kernel(const LayoutScatter s) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < s.n_w) {
    const int slot = __ldg(s.wslot + i);
    if (slot < s.cpad) {
      const long long j = i * s.w_stride;
      const unsigned h = __ldg(s.whi + j), l = __ldg(s.wlo + j);
      const long long lane =
          (long long)part_key(h, l, s.lo_bit, s.width) * s.cpad + slot;
      s.dh[lane] = h;
      s.dl[lane] = l;
      s.docc[lane] = __ldg(s.wocc + j);
    }
  } else if (i < s.n_w + s.nq) {
    const long long q = i - s.n_w;
    const int slot = __ldg(s.qslot + q);
    if (slot < s.cpad_q) {
      const unsigned h = __ldg(s.qhi + q), l = __ldg(s.qlo + q);
      const long long lane =
          (long long)part_key(h, l, s.lo_bit, s.width) * s.cpad_q + slot;
      s.qh[lane] = h;
      s.ql[lane] = l;
      s.qidx[lane] = (int)q;
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

// i': K1's layouts of one part (bits [lo_bit, lo_bit + width), 2^width
// buckets) from a word chunk (whi, wlo u32 and wocc u8, entry i at
// i * w_stride; wslot u8[n_w]) and a query chunk (qhi, qlo u32[nq], qslot
// u8[nq]): dh, dl, docc u32[2^width * cpad + 1] and qh, ql, qidx
// [2^width * cpad_q + 1], each 16-B aligned and written in full.
extern "C" int qm2t_bucket_layouts(const void* whi, const void* wlo,
                                   const void* wocc, long long w_stride,
                                   const void* wslot, long long n_w,
                                   const void* qhi, const void* qlo,
                                   const void* qslot, long long nq,
                                   int lo_bit, int width, int cpad,
                                   int cpad_q, void* dh, void* dl,
                                   void* docc, void* qh, void* ql,
                                   void* qidx, void* stream) {
  void* outs[6] = {dh, dl, docc, qh, ql, qidx};
  bool aligned = true;
  for (void* o : outs) aligned = aligned && (uintptr_t)o % 16 == 0;
  if (bad_part(lo_bit, width) || width > 24 ||
      bad_pads(1LL << width, cpad, cpad_q, 0) || n_w < 0 || w_stride < 1 ||
      nq < 0 || nq > 0x7FFFFFFFLL || !aligned) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const long long nd = (1LL << width) * cpad + 1;
  const long long nql = (1LL << width) * cpad_q + 1;
  LayoutFill f;
  for (int j = 0; j < 6; ++j) {
    f.a[j] = (unsigned*)outs[j];
    f.n[j] = j < 3 ? nd : nql;
    f.v[j] = j == 5 ? (unsigned)nq : 0u;
  }
  const long long quads = (nd > nql ? nd : nql) >> 2;
  long long fill_blocks = (quads + kThreads - 1) / kThreads;
  if (fill_blocks > 4096) fill_blocks = 4096;
  layout_fill_kernel<<<dim3((unsigned)(fill_blocks > 0 ? fill_blocks : 1), 6),
                       kThreads, 0, st>>>(f);
  const long long n = n_w + nq;
  if (n > 0) {
    const LayoutScatter sc = {
        (const unsigned*)whi, (const unsigned*)wlo, (const uint8_t*)wocc,
        (const uint8_t*)wslot, (const unsigned*)qhi, (const unsigned*)qlo,
        (const uint8_t*)qslot, w_stride, n_w, nq, lo_bit, width, cpad,
        cpad_q, (unsigned*)dh, (unsigned*)dl, (unsigned*)docc,
        (unsigned*)qh, (unsigned*)ql, (int*)qidx};
    layout_scatter_kernel<<<(unsigned)((n + kThreads - 1) / kThreads),
                            kThreads, 0, st>>>(sc);
  }
  return (int)cudaGetLastError();
}
