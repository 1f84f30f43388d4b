// Single-substitution neighbor sweep: the neighbor-hit bitmap of the
// anchored index (.qai) over one genome chunk, against an L2-resident key
// filter of the packed table.
//
// Replaces quickmer2_tpu/ops/anchored.py::_neighbor_bits_kernel (run by
// build_neighbor_bits_device), an XLA device function: a fori_loop over
// the k window offsets, each step mutating every window three ways with
// 32-bit field surgery on the strand words, probing the packed table and
// OR-ing the hits into four bit planes.
//
// Two kernels:
//   key_filter_kernel    - one thread per table entry: every non-empty
//                          entry sets its three bits in the key filter
//                          (csrc/packed_probe.cuh) with one atomicOr.
//   neighbor_bits_kernel - a block owns 256 windows; it stages their
//                          bases in shared memory, and each thread builds
//                          its window's forward and reverse-complement
//                          codes and their DJB hashes once. Then, for each
//                          offset i, it substitutes base (b + d) & 3,
//                          d = 1..3, takes the canonical code and its hash
//                          (DJB is linear in the code's bytes, so the hash
//                          of a one-base change is the window's hash plus
//                          a delta), loads the three filter words, and only
//                          where all three bits of a word are set reads the
//                          two table rows. Hit bits go into a shared byte
//                          map with shared atomics and leave the block as
//                          one atomicOr per non-zero 32-bit word. The
//                          identity substitution is never probed.
//
// Bound on the H100. A 2^23-base chunk at k = 30 makes ~755 M probes. The
// table (2^25 buckets, 1 GB at 11.7 M keys) is 20x the 50 MB L2, so an
// unfiltered sweep reads two random 32-B sectors from HBM per probe
// (~48 GB per chunk; 46 ms on an H100 80GB HBM3 at 700 W). Hits are rare
// in a unique-k-mer dictionary, so nearly all of that traffic was spent on
// misses. The filter (2^27 bits, 16 MB, at 11.7 M keys) stays in L2: a
// probe costs one 32-B L2 sector (~24 GB of L2 reads per chunk), and the
// probes that pass it (2.5 % on an H100 80GB HBM3 at 700 W, chip_smoke.py)
// two HBM sectors. What is left is ~30
// integer operations and one L2 load per probe, which is what the
// operations bound of chip_smoke.py counts (30 per probe, 16 more per
// probe that passes the filter). The filter is capped at 32 MB
// (2^28 bits) to stay in L2, so above ~33 M keys its bits per key fall
// below 8 and its pass rate climbs (~15 % at 4 bits a key); a dictionary
// of GRCh38's size needs another builder (ROADMAP, 2.j).

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_probe.cuh"

namespace {

constexpr int kWin = 256;       // windows per block (blockDim.x)
constexpr int kMaxK = 32;
constexpr unsigned kSep = 4;

__global__ void key_filter_kernel(const uint4* __restrict__ entries,
                                  unsigned* __restrict__ filt,
                                  long long n_entries, int wbits) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_entries) return;
  const uint4 v = __ldg(entries + e);
  if ((v.x | v.y) == 0u) return;
  const unsigned h = qm2t::djb_pair(v.x, v.y);
  atomicOr(filt + qm2t::filter_word(h, wbits), qm2t::filter_bits(h));
}

__global__ void __launch_bounds__(kWin)
neighbor_bits_kernel(const uint8_t* __restrict__ codes,
                     const uint4* __restrict__ rows,
                     const unsigned* __restrict__ filt,
                     unsigned* __restrict__ out, long long n, int k,
                     unsigned bucket_mask, int wbits) {
  __shared__ uint8_t tile[kWin + kMaxK];
  __shared__ unsigned hits_s[(kWin + kMaxK) / 4];
  const long long w0 = (long long)blockIdx.x * kWin;   // a multiple of 4
  const int x = threadIdx.x;
  for (int t = x; t < kWin + k - 1; t += kWin) {
    const long long q = w0 + t;
    tile[t] = q < n ? codes[q] : (uint8_t)kSep;
  }
  for (int t = x; t < (kWin + kMaxK) / 4; t += kWin) hits_s[t] = 0u;
  __syncthreads();

  const unsigned long long mask = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
  const int top = 2 * k - 2;
  unsigned long long fwd = 0, rc = 0;
  bool valid = w0 + x < n - k + 1;
  for (int j = 0; j < k; ++j) {
    const unsigned c = tile[x + j];
    valid = valid && c < kSep;
    fwd = ((fwd << 2) | (c & 3u)) & mask;
    rc = (rc >> 2) | ((unsigned long long)((c + 2) & 3u) << top);
  }
  if (valid) {
    const unsigned hf = qm2t::djb_pair((unsigned)(fwd >> 32), (unsigned)fwd);
    const unsigned hr = qm2t::djb_pair((unsigned)(rc >> 32), (unsigned)rc);
#pragma unroll 2
    for (int i = 0; i < k; ++i) {
      const unsigned b = tile[x + i];
      const int sh_f = 2 * (k - 1 - i), sh_r = 2 * i;
      const unsigned long long f_clr = fwd & ~(3ull << sh_f);
      const unsigned long long r_clr = rc & ~(3ull << sh_r);
      unsigned long long code[3];
      unsigned h[3], word[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {       // every filter load in flight
        const unsigned nb = (b + d + 1) & 3u;
        const unsigned long long mf = f_clr | ((unsigned long long)nb << sh_f);
        const unsigned long long mr =
            r_clr | ((unsigned long long)(nb ^ 2u) << sh_r);
        const bool use_f = mf <= mr;
        code[d] = use_f ? mf : mr;
        h[d] = use_f ? hf + qm2t::djb_delta(sh_f, b, nb)
                     : hr + qm2t::djb_delta(sh_r, b ^ 2u, nb ^ 2u);
        word[d] = __ldg(filt + qm2t::filter_word(h[d], wbits));
      }
      unsigned hit = 0;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const unsigned fb = qm2t::filter_bits(h[d]);
        unsigned rank, pos;
        if ((word[d] & fb) == fb &&
            qm2t::packed_probe_h(rows, code[d], h[d], bucket_mask, &rank,
                                 &pos)) {
          hit |= 1u << ((b + d + 1) & 3u);
        }
      }
      if (hit) atomicOr(hits_s + ((x + i) >> 2), hit << (8 * ((x + i) & 3)));
    }
  }
  __syncthreads();
  for (int t = x; t < (kWin + k - 1 + 3) / 4; t += kWin) {
    const unsigned v = hits_s[t];
    if (v) atomicOr(out + (w0 >> 2) + t, v);
  }
}

}  // namespace

extern "C" const char* qm2t_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// rows u32[n_buckets, 8] read as n_buckets * 2 entries; filt
// u32[2^wbits], zeroed by the caller.
extern "C" int qm2t_key_filter(const void* rows, long long n_buckets,
                               void* filt, int wbits, void* stream) {
  if (n_buckets < 1 || n_buckets > (1LL << 32) || wbits < 5 || wbits > 23) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n_entries = 2 * n_buckets;
  key_filter_kernel<<<(unsigned)((n_entries + 255) / 256), 256, 0,
                      (cudaStream_t)stream>>>(
      (const uint4*)rows, (unsigned*)filt, n_entries, wbits);
  return (int)cudaGetLastError();
}

// codes u8[n] (bases 0-3, separators >= 4); rows u32[n_buckets, 8]; filt
// u32[2^wbits] from qm2t_key_filter over the same rows; out u32[ceil(n/4)],
// zeroed by the caller: byte e (little-endian) gets bit b set iff
// substituting base b at position e inside a valid window gives a
// canonical k-mer in the table.
extern "C" int qm2t_neighbor_bits(const void* codes, const void* rows,
                                  const void* filt, int wbits, void* out,
                                  long long n, int k, long long n_buckets,
                                  void* stream) {
  if (k < 1 || k > kMaxK || n < k || n_buckets < 1 ||
      n_buckets > (1LL << 32) || (n_buckets & (n_buckets - 1)) != 0 ||
      wbits < 5 || wbits > 23) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n_win = n - k + 1;
  const long long blocks = (n_win + kWin - 1) / kWin;
  neighbor_bits_kernel<<<(unsigned)blocks, kWin, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const uint4*)rows, (const unsigned*)filt,
      (unsigned*)out, n, k, (unsigned)(n_buckets - 1), wbits);
  return (int)cudaGetLastError();
}
