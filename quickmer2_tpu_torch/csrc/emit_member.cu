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
// row), read through flat_windows.cuh as K2, K7, K8 and K9 read a flat batch
// (a block stages the 2-bit lanes and invalid bits of 4096 windows in shared
// memory). Output: the hit mask bit-packed, bit i & 31 of u32 word i >> 5 for
// window i, so that only n / 8 bytes go back to the host (the JAX
// docstring's promise, emit_parallel.py:12; its code returns bool).
//
// The probe is K8b's and K12's (block_probe.cuh::BlockProbe) with the whole
// table as one block: bucket h1's 32-B row, then h2's only where h1's row
// lacks the code, is full, and the code's bit is set in the bitmap of the
// keys the build put at h2 (kernels/block_probe.py::block_displaced_filter,
// built once a device by the scanner). A key sits at h2 only where its h1
// bucket was full when it was placed, and a bucket never empties (ops/
// packed_table.py::PackedTable.build), so the gate drops no hit; on the
// smoke's chunk it cuts the h2 reads from 1.12 M to 0.22 M.
//
// Bound on the H100: bytes. The chunk's packed codes are read once (2.25
// bits a base), each window's candidate rows are 32-B random reads (the
// smoke's survivor table, 2^25 buckets of 32 B, is 20x the 50 MB L2), and
// the mask is n / 8 bytes. So the scan probes in L2-sized slices of the
// table, in K8b's two passes at full width (block_bins.cuh, shared with
// csrc/count_flat.cu):
//   bin   - bin_kernel<uint16_t>: a block decodes its tile of 4096 windows
//           once and writes the tile-local offsets (2 B) of its valid
//           nonzero windows sorted by the slice of their h1 bucket, with
//           the tile's P + 1 run offsets (kernels/emit_member.py::
//           member_partitions_for: 8 MB of rows a slice);
//   probe - block (p, g) takes slice p's runs of 8 tiles, a thread an
//           entry: it decodes the window again from the L2-resident chunk,
//           probes it and sets its bit by atomicOr in the mask (zeroed
//           first; 2 MB a 2^24-window chunk, L2-resident). Blocks run in
//           about slice order, so about two slices of rows are in use at a
//           time, and a row read twice (the chunk holds a k-mer more than
//           once) or the other half of a 64-B DRAM read is found in L2.
// On chip_smoke.py's 2^24-window chunk (an H100 80GB HBM3 at 700 W) the
// one-pass kernel, a thread a window and a ballot a mask word with every
// row read in genome order, took 0.545 ms queued against 0.452 for these
// passes at P = 128; P = 32, 64 and 256, and 32 tiles a probe block, were
// slower (PERF.md section 6). The bin pass is bound by its integer work
// (the codec and DJB of every window), the probe pass by its random row
// reads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_bins.cuh"
#include "flat_windows.cuh"

namespace {

// The probe pass: block (p, g) probes slice p's runs of tiles [8g, 8g +
// 8), a thread an entry, and sets each hit's mask bit.
__global__ void __launch_bounds__(kThreads)
member_probe_kernel(FlatWindows m, BlockProbe eng,
                    const uint16_t* __restrict__ runs,
                    const unsigned* __restrict__ tile_off,
                    unsigned* __restrict__ mask, int n_parts, int n_tiles) {
  __shared__ long long start[kGroupTiles];
  __shared__ unsigned first[kGroupTiles + 1];
  const RunGroup g(n_tiles);
  g.load(start, first, tile_off, n_parts);
  __syncthreads();
  const unsigned total = first[g.nt];
  for (unsigned e = threadIdx.x; e < total; e += kThreads) {
    int r;
    const long long at = g.at(start, first, e, &r);
    const long long i = (long long)(g.t0 + r) * kTile + __ldg(runs + at);
    unsigned rank;
    if (eng.probe(m.decode(i), &rank) >= 0) {
      atomicOr(mask + (i >> 5), 1u << (i & 31));
    }
  }
}

int log2_of(long long x) {
  int s = 0;
  while ((1LL << s) < x) ++s;
  return s;
}

}  // namespace

extern "C" const char* qm2t_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// pk u8[ceil(n_bases/4)] and bits u8[ceil(n_bases/8)], both 8-B aligned
// (ops/rowpack.py, one row); rows u32[n_buckets, 8] (ops/packed_table.py;
// n_buckets a power of two, at most 2^31); displaced u32[2^filter_bits /
// 32] the table's bitmap of keys at h2; mask u32[ceil((n_bases - k + 1) /
// 32)], written in full; n_parts the slice count P (a power of two, at most
// 256 and at most n_buckets); work 8-B aligned scratch: runs u16[tiles *
// 4096] and tile offsets u32[tiles * (P + 1)], tiles = ceil((n_bases - k +
// 1) / 4096) (kernels/emit_member.py::member_workspace).
extern "C" int qm2t_member_scan(const void* pk, const void* bits,
                                const void* rows, const void* displaced,
                                int filter_bits, void* mask,
                                long long n_bases, int k, long long n_buckets,
                                int n_parts, void* work, void* stream) {
  if (bad_batch(pk, bits, n_bases, k) || n_buckets < 1 ||
      n_buckets > (1LL << 31) || (n_buckets & (n_buckets - 1)) != 0 ||
      filter_bits < 5 || filter_bits > 32 || n_parts < 1 ||
      n_parts > kMaxParts || n_parts > n_buckets ||
      (n_parts & (n_parts - 1)) != 0 || work == nullptr ||
      ((uintptr_t)work & 7) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const FlatWindows m = flat_windows(pk, bits, n_bases, k);
  const BlockProbe eng = {(const uint4*)rows, (const unsigned*)displaced,
                          (unsigned)(n_buckets - 1), 0u,
                          (unsigned)(n_buckets - 1),
                          log2_of(n_buckets) - log2_of(n_parts),
                          32 - filter_bits};
  const int tiles = (int)tiles_of(m);
  uint16_t* runs = (uint16_t*)work;
  unsigned* tile_off = (unsigned*)(runs + (long long)tiles * kTile);
  const cudaError_t rc =
      cudaMemsetAsync(mask, 0, ((m.n + 31) / 32) * sizeof(unsigned), s);
  if (rc != cudaSuccess) return (int)rc;
  bin_kernel<uint16_t><<<tiles, kThreads, 0, s>>>(m, eng, runs, tile_off,
                                                  n_parts);
  const long long groups = (tiles + kGroupTiles - 1) / kGroupTiles;
  member_probe_kernel<<<(unsigned)(groups * n_parts), kThreads, 0, s>>>(
      m, eng, runs, tile_off, (unsigned*)mask, n_parts, tiles);
  return (int)cudaGetLastError();
}
