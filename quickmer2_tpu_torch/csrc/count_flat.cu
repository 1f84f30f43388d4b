// The flat count's other exact engines: the reference's linear probe (K7),
// the two-choice packed table (K8) and the sort-join engine's codec (K9).
// Each reads one flat batch through flat_windows.cuh (K2's window map and
// word-parallel codec): a block of 256 threads stages the 2-bit lanes and
// invalid bits of 4096 windows in shared memory, a thread takes every
// 256th window of them.
//
// K7 replaces quickmer2_tpu/pipelines/count.py::count_kernel (:40-72),
// `count_step`, an XLA device function: codec.sliding_kmers + the DJB
// linear probe of ops/hash.py::probe_lookup + the rank gather + the depth
// scatter-add. For each window: DJB2 mod 2^32 of its canonical code; idx =
// h & (H - 1); the scan steps -1 from a start in the upper half and +1 from
// the lower half, and stops at a match or an empty slot (0, 0), after at
// most max_steps steps. Slot i of a gather is the JAX package's: i < 0 wraps
// once by +H, then clamps to [0, H - 1] (slot_at). The table is one u32
// pair (hi, lo) a slot, interleaved, so a probe step is one 8-B load.
//
// K8 replaces count_kernel_packed (:80-91) through count_step_packed_pk
// (:131-136): the probe of both candidate buckets h1 = DJB & (B - 1), h2 =
// (DJB * 2654435761 >> 7) & (B - 1) of the packed table (two entries (hi,
// lo, rank, pos) a 32-B row; code 0 never matches). Keys are unique, so at
// most one entry of the two rows matches.
//
// Both count in SLOT space, where the probe stops, as K2 does: depth is
// u32[S + 1] over the table's S slots (K7: S = H, slot slot_at(idx); K8:
// S = 2B, slot 2 * bucket + entry), and depth[S] is a trash counter that
// takes the invalid windows, the misses and K7's stops on an empty slot.
// A K7 scan cut at max_steps on a live slot adds to that slot. The JAX
// counter's rank-space depth u32[n_kmers + 1] is the image of this one
// under slot -> rank (kernels/count_flat.py::slot_depth_to_rank, plain
// torch, once per snapshot or finish): the adds are integer adds mod
// 2^32, so the two agree bit for bit. So no rank gather stands between a
// probe and its atomic.
//
// Bound on the H100: bytes. The smoke's tables (K7: 2^25 slots of table
// and depth, 12 B each; K8: 2^25 buckets of row and depth, 40 B each) are
// 8-27x the 50 MB L2, so a probe's row and its depth word are HBM
// accesses at their first touch, and a window's loads are dependent. With
// P > 1 both cut the table into P slices by the top log2 P bits of the
// home slot (K7) or of the h1 bucket (K8), each slice's table and depth
// bytes at most ~24 MB (kernels/count_flat.py::*_partitions_for), and one
// call runs K2's three passes over the windows that are probed (K7: every
// valid window; K8: the valid nonzero ones):
//   count   - codec and DJB per window, a per-block shared histogram over
//             the slices, added once per block into the slice totals;
//   scatter - the same per window; each block reserves a run in each
//             slice's bin and writes the window's 4-B lane index there;
//   probe   - a thread per binned window, in slice order: decode the code
//             again from the packed batch (L2-resident), probe, add 1 to
//             the stop slot's depth word. A slice's rows and depth words
//             come from HBM at their first touch and from L2 after it. A
//             K7 scan that runs past its slice's edge, or wraps through
//             slot_at, reads on (rare, and right). K8 reads the h2 row
//             only where h1's misses: a key sits in one bucket, and the
//             build puts all but a few in h1's (binning each window under
//             both candidates doubled the binned lanes and ran slower than
//             the one-pass kernel on a smoke-sized table).
// The count and scatter passes add to their shared slice counters once
// per distinct slice of a warp (__match_any_sync), not once per lane. The
// probe pass sums its slot adds a block at a time into 64 counters, and a
// last one-warp kernel adds n windows less those to the trash, mod 2^32.
// With P = 1 one pass probes each window where it is decoded (K8 both
// rows at once) and counts its trash windows a warp at a time.
//
// K8b replaces quickmer2_tpu/parallel/count_parallel.py::
// make_sharded_count_step's local_step (:63-92), the flat count of one
// data shard against one bucket block [blk_lo, blk_lo + Bb) of a
// dict-sharded packed table, in the block's slot space 2 * Bb + 1 (trash
// last: every window the block does not count); kernels/count_flat.py
// translates it to the JAX step's rank-space partial depth[dp, ds, n + 1].
// K8's passes decoded every window of the shard three times to probe the
// share whose candidate bucket is local (3/4 of the shard at ds = 2), so
// K8b has its own design for the block (its probe, BlockProbe, lives in
// block_probe.cuh, which K12, K10 and K3a share; its bin pass and its
// probe pass's run lookup in block_bins.cuh, which K10 shares):
//   candidates - h1's bucket where it is local; h2's only where it is
//           local and the key may sit there: a bitmap of the block's keys
//           placed at h2 (~1 % of them; BlockProbe) rules out the rest,
//           so at ds = 2 about half the shard is probed, not 3/4;
//   bin   - a block of 256 threads decodes its 4096 windows once (the
//           staged tile, K8's codec), keeps those with a candidate and
//           writes their canonical codes (8 B) sorted by slice at the
//           tile's own place in the runs buffer, with the tile's P + 1
//           run offsets. No pass over the shard counts first and no
//           global fill counter is shared;
//   probe - block (p, g) takes slice p's runs of 8 consecutive tiles, a
//           thread an entry, probes h1's row and, where it misses, h2's
//           if it is a candidate, and adds 1 to the slot's depth word.
//           Blocks run in about slice order, so the rows and depth words
//           of about one slice (~24 MB, kernels/count_flat.py::
//           packed_partitions_for) are in use at a time, as in K8.
// The probe pass sums its hits into 64 counters, and K8's one-warp trash
// kernel adds the windows less those to the trash, mod 2^32. Both passes
// are bound by bytes: the probe by its random 32-B row reads and the
// depth sectors' first touch, the bin by the codes it writes.
// A probe pass that holds a slice's depth words in shared memory (P up to
// 2048, so that 2 * Bb / P words fit in 128 KB, and each nonzero word
// added to depth once) ran slower at every ds (PERF.md section 6): a
// batch hits a depth word about once, so the shared adds spare few global
// ones and the flush touches the same sectors, while gathering a slice's
// short runs from every tile reads offsets and codes a sector at a time.

// K9 replaces _kmerize_step_pk (:152-156), the sort-join engine's codec:
// (chi, clo, valid) for every window, an invalid window written as key 0
// (ops/sortjoin.py's contract), so the plain codec stays off the card.
//
// The counts are integer atomics, so depth is the same bit for bit in any
// order. chip_smoke.py counts each kernel's bound from each run's batch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_bins.cuh"
#include "flat_windows.cuh"
#include "packed_probe.cuh"

namespace {

constexpr int kSpread = 64;              // the probe pass's hit counters

// The JAX package's gather index: -H <= i < 0 wraps to i + H, then the
// index clamps to [0, H - 1].
__device__ __forceinline__ long long slot_at(long long i, long long H) {
  if (i < 0) i += H;
  return i < 0 ? 0 : (i >= H ? H - 1 : i);
}

// K7: the linear scan of one code over the .qm table. Every valid window
// is probed (a code-0 window too: a scan cut at max_steps can stop on a
// live slot), in the slice of its home slot. probe() gives the slot to
// add 1 to, or -1 for the trash (an empty slot).
struct CountLinear {
  const uint2* table;
  long long H;
  int max_steps;
  int shift;     // slice of a home slot: home >> shift

  __device__ __forceinline__ unsigned home(u64 canon) const {
    return qm2t::djb_pair((unsigned)(canon >> 32), (unsigned)canon) &
           (unsigned)(H - 1);
  }

  __device__ __forceinline__ unsigned short part(u64 canon) const {
    return (unsigned short)(home(canon) >> shift);
  }

  __device__ __forceinline__ long long probe(u64 canon) const {
    const unsigned hi = (unsigned)(canon >> 32);
    const unsigned lo = (unsigned)canon;
    long long idx = home(canon);
    const int step = (idx & (H >> 1)) ? -1 : 1;
    uint2 e;
    for (int it = 0;; ++it) {
      e = __ldg(table + slot_at(idx, H));
      if ((e.x == hi && e.y == lo) || (e.x | e.y) == 0u || it == max_steps) {
        break;
      }
      idx += step;
    }
    return (e.x | e.y) != 0u ? slot_at(idx, H) : -1;
  }

  __device__ __forceinline__ long long probe_binned(u64 canon) const {
    return probe(canon);
  }
};

// K8: the two candidate buckets of one code; code 0 matches nothing and
// goes to the trash unprobed. A key sits in one bucket, h1's for all but a
// few (first fit at build), so a binned window is probed in its slice and
// reads h2's row only where h1's misses (the misses, and the keys placed
// at h2: a read outside the slice).
struct CountPacked {
  const uint4* rows;
  unsigned bucket_mask;
  int shift;     // slice of a bucket: bucket >> shift

  __device__ __forceinline__ unsigned bucket(u64 canon, int c) const {
    const unsigned h =
        qm2t::djb_pair((unsigned)(canon >> 32), (unsigned)canon);
    return (c ? (h * qm2t::kH2Mult) >> 7 : h) & bucket_mask;
  }

  __device__ __forceinline__ unsigned short part(u64 canon) const {
    if (canon == 0) return kNoPart;
    return (unsigned short)(bucket(canon, 0) >> shift);
  }

  // The matching slot of bucket o, or -1.
  __device__ __forceinline__ long long entry_of(unsigned o, u64 canon) const {
    const unsigned hi = (unsigned)(canon >> 32);
    const unsigned lo = (unsigned)canon;
    long long slot = -1;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint4 v = __ldg(rows + 2ull * o + e);
      if (v.x == hi && v.y == lo) slot = 2LL * o + e;
    }
    return slot;
  }

  // P = 1: both rows, their loads independent. Where h1 == h2 both give
  // the one matching entry, as the JAX probe's later-wins order does.
  __device__ __forceinline__ long long probe(u64 canon) const {
    if (canon == 0) return -1;
    const long long s1 = entry_of(bucket(canon, 0), canon);
    const long long s2 = entry_of(bucket(canon, 1), canon);
    return s2 >= 0 ? s2 : s1;
  }

  __device__ __forceinline__ long long probe_binned(u64 canon) const {
    const long long s1 = entry_of(bucket(canon, 0), canon);
    return s1 >= 0 ? s1 : entry_of(bucket(canon, 1), canon);
  }
};

// One warp-aggregated add of the threads' counts to *trash.
__device__ __forceinline__ void add_trash(unsigned* trash, unsigned n) {
  const unsigned sum = __reduce_add_sync(0xFFFFFFFFu, n);
  if ((threadIdx.x & 31) == 0 && sum) atomicAdd(trash, sum);
}

// cnt[s] += 1 for each lane of the warp (all 32 call it) whose s is not
// kNoPart, by one shared atomic per distinct s (the slices are few, so
// lanes collide); returns the lane's slot in the run that the warp
// reserved in cnt[s].
__device__ __forceinline__ unsigned warp_add(unsigned* cnt,
                                             unsigned short s) {
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, s);
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(peers) - 1;
  unsigned base = 0;
  if (lane == leader && s != kNoPart) base = atomicAdd(&cnt[s], __popc(peers));
  base = __shfl_sync(0xFFFFFFFFu, base, leader);
  return base + __popc(peers & ((1u << lane) - 1u));
}

// P = 1: a window a thread, 4096 windows a block.
template <class Eng>
__global__ void __launch_bounds__(kThreads)
direct_kernel(FlatWindows m, Eng eng, unsigned* __restrict__ depth,
              long long trash) {
  __shared__ FlatWindows::Tile tile;
  const long long base = (long long)blockIdx.x * kTile;
  m.stage(tile, base);
  unsigned n_trash = 0;
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    if (base + j >= m.n) break;
    u64 canon;
    const long long s = m.valid(tile, j, &canon) ? eng.probe(canon) : -1;
    if (s < 0) {
      ++n_trash;
    } else {
      atomicAdd(depth + s, 1u);
    }
  }
  add_trash(depth + trash, n_trash);
}

// The sliced passes (P > 1). The slice of each window of the tile
// (kNoPart where it is not probed) into part[], and the block's
// histogram over the slices into hist[].
template <class Eng>
__device__ __forceinline__ void tile_parts(
    const FlatWindows& m, const FlatWindows::Tile& t, long long base,
    const Eng& eng, unsigned short* part, unsigned* hist, int n_parts) {
  for (int p = threadIdx.x; p < n_parts; p += kThreads) hist[p] = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < kTile; j += kThreads) {   // whole warps
    u64 canon;
    const unsigned short s =
        base + j < m.n && m.valid(t, j, &canon) ? eng.part(canon) : kNoPart;
    warp_add(hist, s);
    part[j] = s;
  }
  __syncthreads();
}

// Pass 1: the slices' entry totals.
template <class Eng>
__global__ void __launch_bounds__(kThreads)
hist_kernel(FlatWindows m, Eng eng, unsigned* __restrict__ totals,
            int n_parts) {
  __shared__ FlatWindows::Tile tile;
  __shared__ unsigned short part[kTile];
  __shared__ unsigned hist[kMaxParts];
  const long long base = (long long)blockIdx.x * kTile;
  m.stage(tile, base);
  tile_parts(m, tile, base, eng, part, hist, n_parts);
  for (int p = threadIdx.x; p < n_parts; p += kThreads) {
    if (hist[p]) atomicAdd(totals + p, hist[p]);
  }
}

// Pass 2: each probed window's lane into its slice's bin. bins holds the slices
// one after another, slice p from the sum of the totals before it (an
// exclusive scan); a block reserves its run in each slice by one
// atomicAdd on the slice's fill.
template <class Eng>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(FlatWindows m, Eng eng, const unsigned* __restrict__ totals,
               unsigned* __restrict__ fill, unsigned* __restrict__ bins,
               int n_parts) {
  __shared__ FlatWindows::Tile tile;
  __shared__ unsigned short part[kTile];
  __shared__ unsigned hist[kMaxParts];
  __shared__ unsigned cursor[kMaxParts];
  const long long base = (long long)blockIdx.x * kTile;
  for (int p = threadIdx.x; p < n_parts; p += kThreads) cursor[p] = totals[p];
  m.stage(tile, base);
  tile_parts(m, tile, base, eng, part, hist, n_parts);
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
  for (int j = threadIdx.x; j < kTile; j += kThreads) {   // whole warps
    const unsigned short s = part[j];
    const unsigned at = warp_add(cursor, s);
    if (s != kNoPart) bins[at] = (unsigned)(base + j);
  }
}

// Pass 3: probe the binned windows, a thread an entry, each code decoded
// again from the packed batch (L2-resident). The bins hold the slices in
// order and blocks start in about that order, so the rows and depth words
// of about one slice are in use at a time. The grid covers every possible
// entry; blocks past the binned count return. A block adds its slot adds
// to one of kSpread counters (one counter for all would serialise).
template <class Eng>
__global__ void __launch_bounds__(kThreads)
probe_kernel(FlatWindows m, Eng eng, const unsigned* __restrict__ totals,
             const unsigned* __restrict__ bins, unsigned* __restrict__ depth,
             unsigned* __restrict__ spread, int n_parts) {
  __shared__ unsigned n_binned, n_hits;
  if (threadIdx.x == 0) n_binned = n_hits = 0;
  __syncthreads();
  for (int p = threadIdx.x; p < n_parts; p += kThreads) {
    atomicAdd(&n_binned, __ldg(totals + p));
  }
  __syncthreads();
  const long long first = (long long)blockIdx.x * kThreads;
  if (first >= n_binned) return;
  const long long e = first + threadIdx.x;
  unsigned hit = 0;
  if (e < n_binned) {
    const long long s = eng.probe_binned(m.decode(__ldg(bins + e)));
    if (s >= 0) {
      atomicAdd(depth + s, 1u);
      hit = 1;
    }
  }
  const unsigned hits = __reduce_add_sync(0xFFFFFFFFu, hit);
  if ((threadIdx.x & 31) == 0 && hits) atomicAdd(&n_hits, hits);
  __syncthreads();
  if (threadIdx.x == 0 && n_hits) {
    atomicAdd(spread + (blockIdx.x & (kSpread - 1)), n_hits);
  }
}

// The sliced call's trash: every window but those that added to a slot.
__global__ void trash_kernel(const unsigned* __restrict__ spread,
                             unsigned* __restrict__ trash, unsigned n) {
  unsigned hits = 0;
  for (int i = threadIdx.x; i < kSpread; i += 32) hits += spread[i];
  hits = __reduce_add_sync(0xFFFFFFFFu, hits);
  if (threadIdx.x == 0) *trash += n - hits;
}

// K8b's probe pass: block (p, g) probes slice p's runs of tiles [8g,
// 8g + 8) (block_bins.cuh, after bin_kernel<u64>), a thread an entry; the
// block's hits go to one of kSpread counters.
__global__ void __launch_bounds__(kThreads)
block_probe_kernel(BlockProbe eng, const u64* __restrict__ runs,
                   const unsigned* __restrict__ tile_off,
                   unsigned* __restrict__ depth, unsigned* __restrict__ spread,
                   int n_parts, int n_tiles) {
  __shared__ long long start[kGroupTiles];
  __shared__ unsigned first[kGroupTiles + 1];
  __shared__ unsigned n_hits;
  const RunGroup g(n_tiles);
  if (threadIdx.x == 0) n_hits = 0;
  g.load(start, first, tile_off, n_parts);
  __syncthreads();
  const unsigned total = first[g.nt];
  unsigned hit = 0;
  for (unsigned e = threadIdx.x; e < total; e += kThreads) {
    int r;
    unsigned rank;
    const long long s =
        eng.probe(__ldg(runs + g.at(start, first, e, &r)), &rank);
    if (s >= 0) {
      atomicAdd(depth + s, 1u);
      ++hit;
    }
  }
  const unsigned hits = __reduce_add_sync(0xFFFFFFFFu, hit);
  if ((threadIdx.x & 31) == 0 && hits) atomicAdd(&n_hits, hits);
  __syncthreads();
  if (threadIdx.x == 0 && n_hits) {
    atomicAdd(spread + (blockIdx.x & (kSpread - 1)), n_hits);
  }
}

// K9: (chi, clo, valid) of every window, invalid windows as key 0.
__global__ void __launch_bounds__(kThreads)
kmerize_kernel(FlatWindows m, unsigned* __restrict__ chi,
               unsigned* __restrict__ clo, uint8_t* __restrict__ valid) {
  __shared__ FlatWindows::Tile tile;
  const long long base = (long long)blockIdx.x * kTile;
  m.stage(tile, base);
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const long long i = base + j;
    if (i >= m.n) break;
    u64 canon;
    const bool ok = m.valid(tile, j, &canon);
    if (!ok) canon = 0;
    chi[i] = (unsigned)(canon >> 32);
    clo[i] = (unsigned)canon;
    valid[i] = ok;
  }
}

int log2_of(long long x) {
  int s = 0;
  while ((1LL << s) < x) ++s;
  return s;
}

// P: a power of two, 1 <= P <= min(kMaxParts, the table's units).
bool bad_parts(int n_parts, long long n_units, const void* work) {
  return n_parts < 1 || n_parts > kMaxParts || n_parts > n_units ||
         (n_parts & (n_parts - 1)) != 0 || (n_parts > 1 && work == nullptr);
}

// One call at P = n_parts slices (eng.shift set for P); work u32[2 * P +
// kSpread + m.n] (P > 1 only): slice totals, fills, the hit counters,
// bins.
template <class Eng>
int count_windows(const FlatWindows& m, const Eng& eng, void* depth,
                  long long trash, int n_parts, void* work, cudaStream_t s) {
  unsigned* d = (unsigned*)depth;
  if (n_parts == 1) {
    direct_kernel<<<tiles_of(m), kThreads, 0, s>>>(m, eng, d, trash);
    return (int)cudaGetLastError();
  }
  unsigned* totals = (unsigned*)work;
  unsigned* fill = totals + n_parts;
  unsigned* spread = fill + n_parts;
  unsigned* bins = spread + kSpread;
  const cudaError_t rc = cudaMemsetAsync(
      totals, 0, (2 * n_parts + kSpread) * sizeof(unsigned), s);
  if (rc != cudaSuccess) return (int)rc;
  hist_kernel<<<tiles_of(m), kThreads, 0, s>>>(m, eng, totals, n_parts);
  scatter_kernel<<<tiles_of(m), kThreads, 0, s>>>(m, eng, totals, fill, bins,
                                                  n_parts);
  probe_kernel<<<(unsigned)((m.n + kThreads - 1) / kThreads), kThreads, 0,
                 s>>>(m, eng, totals, bins, d, spread, n_parts);
  trash_kernel<<<1, 32, 0, s>>>(spread, d + trash, (unsigned)m.n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* qm2t_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// pk u8[ceil(n_bases/4)] and bits u8[ceil(n_bases/8)], both 8-B aligned;
// table u32[H, 2] (hi, lo a slot; H a power of
// two, 2 <= H <= 2^31); depth u32[H + 1] in slot space, depth[H] the
// trash counter (updated in place); n_parts the slice count P; work
// u32[2 * P + 64 + n_bases - k + 1] scratch (P > 1 only; may be null for
// P = 1).
extern "C" int qm2t_count_linear(const void* pk, const void* bits,
                                 const void* table, void* depth,
                                 long long n_bases, int k,
                                 long long hash_size, int max_steps,
                                 int n_parts, void* work, void* stream) {
  if (bad_batch(pk, bits, n_bases, k) || hash_size < 2 ||
      hash_size > (1LL << 31) || (hash_size & (hash_size - 1)) != 0 ||
      max_steps < 0 || bad_parts(n_parts, hash_size, work)) {
    return (int)cudaErrorInvalidValue;
  }
  const CountLinear eng = {(const uint2*)table, hash_size, max_steps,
                           log2_of(hash_size) - log2_of(n_parts)};
  return count_windows(flat_windows(pk, bits, n_bases, k), eng, depth,
                       hash_size, n_parts, work, (cudaStream_t)stream);
}

// pk, bits as above; rows u32[n_buckets, 8] (ops/packed_table.py; n_buckets
// a power of two, at most 2^32); depth u32[2 * n_buckets + 1] in slot space
// (slot 2 * bucket + entry), depth[2 * n_buckets] the trash counter; work
// as K7's.
extern "C" int qm2t_count_packed(const void* pk, const void* bits,
                                 const void* rows, void* depth,
                                 long long n_bases, int k, long long n_buckets,
                                 int n_parts, void* work, void* stream) {
  if (bad_batch(pk, bits, n_bases, k) || n_buckets < 1 ||
      n_buckets > (1LL << 32) || (n_buckets & (n_buckets - 1)) != 0 ||
      bad_parts(n_parts, n_buckets, work)) {
    return (int)cudaErrorInvalidValue;
  }
  const CountPacked eng = {(const uint4*)rows, (unsigned)(n_buckets - 1),
                           log2_of(n_buckets) - log2_of(n_parts)};
  return count_windows(flat_windows(pk, bits, n_bases, k), eng, depth,
                       2 * n_buckets, n_parts, work, (cudaStream_t)stream);
}

// K8b. pk, bits as above; rows u32[block_buckets, 8], buckets [blk_lo,
// blk_lo + block_buckets) of a table of n_buckets (block_buckets a power of
// two dividing n_buckets, blk_lo a multiple of it); depth u32[2 *
// block_buckets + 1] in the block's slot space, its last word the trash;
// displaced u32[2^filter_bits / 32] the block's bitmap of keys at h2;
// n_parts the slice count over the block's buckets; work 8-B aligned
// scratch: runs u64[tiles * 4096], tile offsets u32[tiles * (n_parts +
// 1)] and 64 hit counters, tiles = ceil((n_bases - k + 1) / 4096)
// (kernels/count_flat.py::block_workspace).
extern "C" int qm2t_count_packed_block(const void* pk, const void* bits,
                                       const void* rows,
                                       const void* displaced, int filter_bits,
                                       void* depth, long long n_bases, int k,
                                       long long n_buckets, long long blk_lo,
                                       long long block_buckets, int n_parts,
                                       void* work, void* stream) {
  if (bad_batch(pk, bits, n_bases, k) || n_buckets < 1 ||
      n_buckets > (1LL << 32) || (n_buckets & (n_buckets - 1)) != 0 ||
      block_buckets < 1 || (block_buckets & (block_buckets - 1)) != 0 ||
      n_buckets % block_buckets != 0 || blk_lo < 0 ||
      blk_lo % block_buckets != 0 || blk_lo + block_buckets > n_buckets ||
      bad_parts(n_parts, block_buckets, work) || work == nullptr ||
      ((uintptr_t)work & 7) != 0 || filter_bits < 5 || filter_bits > 32) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const BlockProbe eng = {(const uint4*)rows, (const unsigned*)displaced,
                          (unsigned)(n_buckets - 1), (unsigned)blk_lo,
                          (unsigned)(block_buckets - 1),
                          log2_of(block_buckets) - log2_of(n_parts),
                          32 - filter_bits};
  const FlatWindows m = flat_windows(pk, bits, n_bases, k);
  const int tiles = (int)tiles_of(m);
  u64* runs = (u64*)work;
  unsigned* tile_off = (unsigned*)(runs + (long long)tiles * kTile);
  unsigned* spread = tile_off + (long long)tiles * (n_parts + 1);
  const cudaError_t rc =
      cudaMemsetAsync(spread, 0, kSpread * sizeof(unsigned), s);
  if (rc != cudaSuccess) return (int)rc;
  bin_kernel<u64><<<tiles, kThreads, 0, s>>>(m, eng, runs, tile_off,
                                             n_parts);
  const long long groups = (tiles + kGroupTiles - 1) / kGroupTiles;
  block_probe_kernel<<<(unsigned)(groups * n_parts), kThreads, 0, s>>>(
      eng, runs, tile_off, (unsigned*)depth, spread, n_parts, tiles);
  trash_kernel<<<1, 32, 0, s>>>(spread, (unsigned*)depth + 2 * block_buckets,
                                (unsigned)m.n);
  return (int)cudaGetLastError();
}

// pk, bits as above; chi, clo u32[n_bases - k + 1] and valid u8[n_bases - k
// + 1], written in full.
extern "C" int qm2t_kmerize(const void* pk, const void* bits, void* chi,
                            void* clo, void* valid, long long n_bases, int k,
                            void* stream) {
  if (bad_batch(pk, bits, n_bases, k)) return (int)cudaErrorInvalidValue;
  const FlatWindows m = flat_windows(pk, bits, n_bases, k);
  kmerize_kernel<<<tiles_of(m), kThreads, 0, (cudaStream_t)stream>>>(
      m, (unsigned*)chi, (unsigned*)clo, (uint8_t*)valid);
  return (int)cudaGetLastError();
}
