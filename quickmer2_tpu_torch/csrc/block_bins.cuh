// The two passes of a flat batch probed slice by slice in one bucket block
// of the packed table, shared by csrc/count_flat.cu (K8b: a run entry is
// the window's 8-B canonical code, a hit adds to its slot's depth) and
// csrc/emit_member.cu (K10, the whole table as one block: a run entry is
// the window's 2-B offset in its tile, a hit sets its mask bit), so that
// no copy drifts:
//   bin   - bin_kernel: block b decodes tile b (kTile windows) once and
//           writes the entries of its windows that have a local candidate
//           (BlockProbe::part) to runs[b * kTile, ...) sorted by slice,
//           slice p's run from tile_off[b * (P + 1) + p] to the next
//           offset. One pass over the tile gives each window its place in
//           its slice's run (a shared atomic on the block's slice counter,
//           which ran faster than a warp's __match_any_sync), a block-wide
//           scan of the counts (a slice a thread) gives the run starts,
//           the entries are sorted in shared memory and the tile's runs,
//           one range, are written out coalesced. Four blocks an SM (64
//           registers) ran faster than three;
//   probe - block (p, g) takes slice p's runs of tiles [8g, 8g + 8), a
//           thread an entry; RunGroup finds the run that holds entry e.
//           Blocks run in about slice order, so the rows of about one
//           slice are in use at a time. 8 tiles a block ran faster than
//           16 and 32 on the smoke's K8b shard and K10 chunk, and as
//           fast as 4.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_probe.cuh"
#include "flat_windows.cuh"

namespace {

constexpr int kMaxParts = 256;
constexpr int kGroupTiles = 8;

// The bin pass. T = u64: an entry is the window's code, kept in shared
// memory while the scan runs; T = uint16_t: its offset j in the tile.
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
bin_kernel(FlatWindows m, BlockProbe eng, T* __restrict__ runs,
           unsigned* __restrict__ tile_off, int n_parts) {
  constexpr bool kCodes = sizeof(T) == sizeof(u64);
  constexpr int kPer = kTile / kThreads;
  constexpr int kWarps = kThreads / 32;
  __shared__ FlatWindows::Tile tile;
  __shared__ unsigned count[kMaxParts];  // a slice's count, then its start
  static_assert(kMaxParts <= kThreads, "a slice a thread in the scan");
  __shared__ unsigned warp_start[kWarps];
  __shared__ unsigned n_local;         // the tile's local windows
  __shared__ T entries[kTile];
  const long long base = (long long)blockIdx.x * kTile;
  for (int p = threadIdx.x; p < n_parts; p += kThreads) count[p] = 0;
  m.stage(tile, base);
  unsigned slot[kPer];      // slice << 16 | place in the slice's run
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int j = threadIdx.x + r * kThreads;
    u64 c = 0;
    const unsigned s = base + j < m.n && m.valid(tile, j, &c)
                           ? eng.part(c) : kNoPart;
    if (kCodes) entries[j] = (T)c;
    slot[r] = s << 16 | (s != kNoPart ? atomicAdd(&count[s], 1u) : 0u);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int p = threadIdx.x;
  const unsigned v = p < n_parts ? count[p] : 0u;
  unsigned x = v;                      // the warp's inclusive scan
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_start[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x < 32) {              // the warps' totals, exclusive
    const unsigned t = lane < kWarps ? warp_start[lane] : 0u;
    unsigned z = t;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const unsigned y = __shfl_up_sync(0xFFFFFFFFu, z, d);
      if (lane >= d) z += y;
    }
    if (lane < kWarps) warp_start[lane] = z - t;
  }
  __syncthreads();
  const unsigned at = warp_start[threadIdx.x >> 5] + x - v;
  unsigned* off = tile_off + (long long)blockIdx.x * (n_parts + 1);
  if (p < n_parts) {
    count[p] = at;
    off[p] = at;
  }
  if (threadIdx.x == kThreads - 1) {
    off[n_parts] = at + v;
    n_local = at + v;
  }
  T mine[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int j = threadIdx.x + r * kThreads;
    mine[r] = kCodes ? entries[j] : (T)j;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kPer; ++r) {     // sorted by slice, in place
    const unsigned s = slot[r] >> 16;
    if (s != kNoPart) entries[count[s] + (slot[r] & 0xFFFFu)] = mine[r];
  }
  __syncthreads();
  for (unsigned j = threadIdx.x; j < n_local; j += kThreads) {
    runs[base + j] = entries[j];       // coalesced
  }
}

// Probe block (p, g)'s runs: slice p of tiles [t0, t0 + nt), t0 = 8g.
// Its first warp fills start (where run r begins in runs) and first (the
// entries before run r) from tile_off; the caller syncs before at().
struct RunGroup {
  int p, t0, nt;

  __device__ __forceinline__ explicit RunGroup(int n_tiles) {
    const int groups = (n_tiles + kGroupTiles - 1) / kGroupTiles;
    p = blockIdx.x / groups;
    t0 = (blockIdx.x % groups) * kGroupTiles;
    nt = min(kGroupTiles, n_tiles - t0);
  }

  __device__ __forceinline__ void load(long long* start, unsigned* first,
                                       const unsigned* __restrict__ tile_off,
                                       int n_parts) const {
    if (threadIdx.x >= 32) return;
    unsigned len = 0;
    if ((int)threadIdx.x < nt) {
      const long long t = t0 + threadIdx.x;
      const unsigned* off = tile_off + t * (n_parts + 1) + p;
      start[threadIdx.x] = t * kTile + off[0];
      len = off[1] - off[0];
    }
    unsigned x = len;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned y = __shfl_up_sync(0xFFFFFFFFu, x, d);
      if ((int)threadIdx.x >= d) x += y;
    }
    if ((int)threadIdx.x < kGroupTiles) first[threadIdx.x + 1] = x;
    if (threadIdx.x == 0) first[0] = 0;
  }

  // Entry e (< first[nt]): its run r (its tile is t0 + r) and its index
  // in runs.
  __device__ __forceinline__ long long at(const long long* start,
                                          const unsigned* first, unsigned e,
                                          int* run) const {
    int r = 0;
#pragma unroll
    for (int step = kGroupTiles / 2; step > 0; step >>= 1) {
      if (r + step < nt && first[r + step] <= e) r += step;
    }
    *run = r;
    return start[r] + (e - first[r]);
  }
};

}  // namespace
