// K10: the search's pass-2 membership scan on the card.
//
// Replaces quickmer2_tpu/parallel/emit_parallel.py::_member_chunk (:99), an
// XLA device function under DeviceMembershipScanner.scan (:72):
// codec.sliding_kmers over one genome chunk, then ops/packed_table.py::
// probe_packed of every window's canonical code against the survivor table.
// A window is a hit iff it is valid (no separator among its k codes), its
// code is nonzero and the code is in the table (found & valid & ((chi | clo)
// != 0), _member_chunk :100-102).
//
// Input: one chunk of n_bases codes packed by ops/rowpack.py::pack_rows (one
// row), read through flat_windows.cuh as K2, K7, K8 and K9 read a flat batch:
// a block of 256 threads stages the 2-bit lanes and invalid bits of 4096
// windows in shared memory, a thread takes every 256th window of them and
// probes the packed table (packed_probe.cuh's layout and hashes): bucket h1
// first, h2 only where h1 does not hold the code. A key sits in one bucket,
// and the build puts all but a few in h1's, so a hit reads one 32-B row.
// Output: the hit mask bit-packed, bit i & 31 of u32 word i >> 5 for window i,
// so that only n / 8 bytes go back to the host (the JAX docstring's promise,
// emit_parallel.py:12; its code returns bool). A warp's 32 threads take 32
// consecutive windows, so one __ballot_sync forms each word.
//
// Bound on the H100: bytes. The chunk's packed codes are read once (2.25
// bits a base), each window's candidate rows are 32-B random reads (a
// survivor table of a 12 Mb genome is several times the 50 MB L2), and the
// mask is n / 8 bytes. This is K8's one-pass kernel without its depth
// scatter: simple first; probing in L2-sized slices, as K8 does, is for a
// later change.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flat_windows.cuh"
#include "packed_probe.cuh"

namespace {

static_assert(kTile % kThreads == 0 && kThreads % 32 == 0,
              "a warp's threads must take 32 consecutive windows");

// Whether the nonzero code is a key of the packed table: the two entries
// of bucket h1, then of h2 where h1 does not hold it.
__device__ __forceinline__ bool member(const uint4* __restrict__ rows,
                                       u64 code, unsigned bucket_mask) {
  const unsigned hi = (unsigned)(code >> 32);
  const unsigned lo = (unsigned)code;
  const unsigned h = qm2t::djb_pair(hi, lo);
  unsigned b = h & bucket_mask;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const uint4 e0 = __ldg(rows + 2ull * b);
    const uint4 e1 = __ldg(rows + 2ull * b + 1);
    if ((e0.x == hi && e0.y == lo) || (e1.x == hi && e1.y == lo)) {
      return true;
    }
    b = ((h * qm2t::kH2Mult) >> 7) & bucket_mask;
  }
  return false;
}

__global__ void __launch_bounds__(kThreads)
member_kernel(FlatWindows m, const uint4* __restrict__ rows,
              unsigned bucket_mask, unsigned* __restrict__ mask) {
  __shared__ FlatWindows::Tile tile;
  const long long base = (long long)blockIdx.x * kTile;
  const FlatWindows::Span span = m.stage(tile, base);
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const long long i = base + j;
    bool hit = false;
    u64 canon;
    if (m.window(tile, span, base, j, &canon)) {
      hit = member(rows, canon, bucket_mask);
    }
    const unsigned word = __ballot_sync(0xFFFFFFFFu, hit);
    // lane 0's window is a multiple of 32: its word exists iff it is < n
    if ((threadIdx.x & 31) == 0 && i < m.n) mask[i >> 5] = word;
  }
}

}  // namespace

extern "C" const char* qm2t_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// pk u8[ceil(n_bases/4)] and bits u8[ceil(n_bases/8)], both 8-B aligned
// (ops/rowpack.py, one row); rows u32[n_buckets, 8] (ops/packed_table.py;
// n_buckets a power of two, at most 2^32); mask u32[ceil((n_bases - k + 1) /
// 32)], written in full.
extern "C" int qm2t_member_scan(const void* pk, const void* bits,
                                const void* rows, void* mask,
                                long long n_bases, int k, long long n_buckets,
                                void* stream) {
  if (bad_batch(pk, bits, n_bases, k) || n_buckets < 1 ||
      n_buckets > (1LL << 32) || (n_buckets & (n_buckets - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const FlatWindows m = flat_windows(pk, bits, n_bases, k);
  member_kernel<<<tiles_of(m), kThreads, 0, (cudaStream_t)stream>>>(
      m, (const uint4*)rows, (unsigned)(n_buckets - 1), (unsigned*)mask);
  return (int)cudaGetLastError();
}
