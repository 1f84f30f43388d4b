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
// once by +H, then clamps to [0, H - 1] (slot_at). r = rank[slot]; a valid
// window adds 1 to depth[r], an invalid one to the trash lane depth[n]
// (rank sends empty slots there too, so a window of code 0 lands in the
// trash, quirk Q3). The table is one u32 pair (hi, lo) a slot, interleaved,
// so a probe step is one 8-B load.
//
// K8 replaces count_kernel_packed (:80-91) through count_step_packed_pk
// (:131-136): the packed_probe.cuh probe of both candidate buckets (code 0
// never matches; where h1 == h2 the later entry wins); a hit adds 1 to
// depth[rank], an invalid window or a miss to the trash lane.
//
// K9 replaces _kmerize_step_pk (:152-156), the sort-join engine's codec:
// (chi, clo, valid) for every window, an invalid window written as key 0
// (ops/sortjoin.py's contract), so the plain codec stays off the card.
//
// K7 and K8 add each thread's trash windows in a register and then once a
// warp (a fifth of a read's windows are invalid at 150 bp and k = 30, and
// one counter taking each of them by atomic would serialise). The counts
// are integer atomics, so depth is the same bit for bit in any order.
//
// Bound on the H100: bytes. K7 moves the packed batch, one 32-B sector a
// probe step of the table, the 32-B sector of each rank read and the
// 32-B sector of each depth word with a hit, read and written; K8 the
// batch, both candidate rows (32 B each) and the depth sectors; K9 the
// batch in and 9 B a window out. chip_smoke.py counts them from each run's
// batch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flat_windows.cuh"
#include "packed_probe.cuh"

namespace {

// The JAX package's gather index: -H <= i < 0 wraps to i + H, then the
// index clamps to [0, H - 1].
__device__ __forceinline__ long long slot_at(long long i, long long H) {
  if (i < 0) i += H;
  return i < 0 ? 0 : (i >= H ? H - 1 : i);
}

// K7's probe: the rank at the slot where the linear scan of canon stops.
__device__ __forceinline__ unsigned linear_rank(
    u64 canon, const uint2* __restrict__ table,
    const unsigned* __restrict__ rank, long long H, int max_steps) {
  const unsigned hi = (unsigned)(canon >> 32);
  const unsigned lo = (unsigned)canon;
  long long idx = qm2t::djb_pair(hi, lo) & (unsigned)(H - 1);
  const int step = (idx & (H >> 1)) ? -1 : 1;
  for (int it = 0;; ++it) {
    const uint2 e = __ldg(table + slot_at(idx, H));
    if ((e.x == hi && e.y == lo) || (e.x | e.y) == 0u || it == max_steps) {
      break;
    }
    idx += step;
  }
  return __ldg(rank + slot_at(idx, H));
}

// One warp-aggregated add of the threads' trash counts to depth[trash].
__device__ __forceinline__ void add_trash(unsigned* depth, unsigned trash,
                                          unsigned n_trash) {
  const unsigned sum = __reduce_add_sync(0xFFFFFFFFu, n_trash);
  if ((threadIdx.x & 31) == 0 && sum) atomicAdd(depth + trash, sum);
}

// K7: a window a thread, 4096 windows a block.
__global__ void __launch_bounds__(kThreads)
count_linear_kernel(FlatWindows m, const uint2* __restrict__ table,
                    const unsigned* __restrict__ rank,
                    unsigned* __restrict__ depth, long long H,
                    unsigned trash, int max_steps) {
  __shared__ FlatWindows::Tile tile;
  const long long base = (long long)blockIdx.x * kTile;
  m.stage(tile, base);
  unsigned n_trash = 0;
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    if (base + j >= m.n) break;
    u64 canon;
    if (!m.valid(tile, j, &canon)) {
      ++n_trash;
      continue;
    }
    const unsigned r = linear_rank(canon, table, rank, H, max_steps);
    if (r == trash) {
      ++n_trash;
    } else {
      atomicAdd(depth + r, 1u);
    }
  }
  add_trash(depth, trash, n_trash);
}

// K8: a window a thread, 4096 windows a block.
__global__ void __launch_bounds__(kThreads)
count_packed_kernel(FlatWindows m, const uint4* __restrict__ rows,
                    unsigned* __restrict__ depth, unsigned bucket_mask,
                    unsigned trash) {
  __shared__ FlatWindows::Tile tile;
  const long long base = (long long)blockIdx.x * kTile;
  m.stage(tile, base);
  unsigned n_trash = 0;
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    if (base + j >= m.n) break;
    u64 canon;
    unsigned r, pos;
    if (m.valid(tile, j, &canon) &&
        qm2t::packed_probe(rows, canon, bucket_mask, &r, &pos)) {
      atomicAdd(depth + r, 1u);
    } else {
      ++n_trash;
    }
  }
  add_trash(depth, trash, n_trash);
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

bool bad_batch(const void* pk, const void* bits, long long n_bases, int k) {
  return k < 1 || k > kMaxK || n_bases < k ||
         n_bases - k + 1 > 0xFFFFFFFFLL ||
         (((uintptr_t)pk | (uintptr_t)bits) & 7) != 0;
}

FlatWindows flat_windows(const void* pk, const void* bits, long long n_bases,
                         int k) {
  return {(const uint8_t*)pk, (const uint8_t*)bits, (n_bases + 3) / 4,
          (n_bases + 7) / 8, n_bases - k + 1, k};
}

unsigned tiles_of(const FlatWindows& m) {
  return (unsigned)((m.n + kTile - 1) / kTile);
}

}  // namespace

extern "C" const char* qm2t_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// pk u8[ceil(n_bases/4)] and bits u8[ceil(n_bases/8)], both 8-B aligned;
// table u32[H, 2] (hi, lo a slot; H a power of two, 2 <= H <= 2^31); rank
// u32[H]; depth u32[n_kmers + 1] (updated in place; depth[trash], trash =
// n_kmers, is the trash lane).
extern "C" int qm2t_count_linear(const void* pk, const void* bits,
                                 const void* table, const void* rank,
                                 void* depth, long long n_bases, int k,
                                 long long hash_size, long long trash,
                                 int max_steps, void* stream) {
  if (bad_batch(pk, bits, n_bases, k) || hash_size < 2 ||
      hash_size > (1LL << 31) || (hash_size & (hash_size - 1)) != 0 ||
      trash < 0 || trash > 0xFFFFFFFFLL || max_steps < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const FlatWindows m = flat_windows(pk, bits, n_bases, k);
  count_linear_kernel<<<tiles_of(m), kThreads, 0, (cudaStream_t)stream>>>(
      m, (const uint2*)table, (const unsigned*)rank, (unsigned*)depth,
      hash_size, (unsigned)trash, max_steps);
  return (int)cudaGetLastError();
}

// pk, bits as above; rows u32[n_buckets, 8] (ops/packed_table.py; n_buckets
// a power of two); depth u32[n_kmers + 1] (trash = n_kmers).
extern "C" int qm2t_count_packed(const void* pk, const void* bits,
                                 const void* rows, void* depth,
                                 long long n_bases, int k, long long n_buckets,
                                 long long trash, void* stream) {
  if (bad_batch(pk, bits, n_bases, k) || n_buckets < 1 ||
      n_buckets > (1LL << 32) || (n_buckets & (n_buckets - 1)) != 0 ||
      trash < 0 || trash > 0xFFFFFFFFLL) {
    return (int)cudaErrorInvalidValue;
  }
  const FlatWindows m = flat_windows(pk, bits, n_bases, k);
  count_packed_kernel<<<tiles_of(m), kThreads, 0, (cudaStream_t)stream>>>(
      m, (const uint4*)rows, (unsigned*)depth, (unsigned)(n_buckets - 1),
      (unsigned)trash);
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
