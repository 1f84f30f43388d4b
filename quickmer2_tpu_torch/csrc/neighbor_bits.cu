// Single-substitution neighbor sweep: the neighbor-hit bitmap of the
// anchored index (.qai) over one genome chunk.
//
// Replaces quickmer2_tpu/ops/anchored.py::_neighbor_bits_kernel (run by
// build_neighbor_bits_device), an XLA device function: a fori_loop over
// the k window offsets, each step mutating every window three ways with
// 32-bit field surgery on the strand words, probing the packed table and
// OR-ing the hits into four bit planes.
//
// Here a block owns 32 consecutive windows and all k offsets: its first
// 32 threads build each window's forward and reverse-complement codes from
// a shared tile of the chunk, then thread (x, i) substitutes base (b + d) & 3,
// d = 1..3, at offset i of window x, canonicalizes, probes
// (csrc/packed_probe.cuh) and ORs bit b' of every hit into the byte of
// position x + i with an atomicOr on its 32-bit word. The identity
// substitution is never probed. Hits are rare in a unique-k-mer
// dictionary, so the atomics are too.
//
// Bound on the H100: 3k probes per valid window, each two random 32-B
// rows of a table larger than the 50 MB L2 (a 2^23-base chunk at k = 30
// makes ~750 M probes, touching every bucket), against ~60 integer
// operations per probe: the kernel is bound by operations (~45 G per
// chunk), and by the latency of the random row reads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_probe.cuh"

namespace {

constexpr int kWin = 32;        // windows per block (blockDim.x)
constexpr int kMaxK = 32;       // offsets per block (blockDim.y = k)
constexpr unsigned kSep = 4;

__global__ void neighbor_bits_kernel(const uint8_t* __restrict__ codes,
                                     const uint4* __restrict__ rows,
                                     unsigned* __restrict__ out,
                                     long long n, int k,
                                     unsigned bucket_mask) {
  __shared__ uint8_t tile[kWin + kMaxK];
  __shared__ unsigned long long fwd_s[kWin], rc_s[kWin];
  __shared__ bool valid_s[kWin];
  const long long n_win = n - k + 1;
  const long long w0 = (long long)blockIdx.x * kWin;
  const int x = threadIdx.x, i = threadIdx.y;
  const int tid = i * kWin + x;
  for (int t = tid; t < kWin + k - 1; t += kWin * k) {
    const long long q = w0 + t;
    tile[t] = q < n ? codes[q] : (uint8_t)kSep;
  }
  __syncthreads();
  if (i == 0) {
    const unsigned long long mask = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
    const int top = 2 * k - 2;
    unsigned long long fwd = 0, rc = 0;
    bool valid = w0 + x < n_win;
    for (int j = 0; j < k; ++j) {
      const unsigned c = tile[x + j];
      valid = valid && c < kSep;
      fwd = ((fwd << 2) | (c & 3u)) & mask;
      rc = (rc >> 2) | ((unsigned long long)((c + 2) & 3u) << top);
    }
    fwd_s[x] = fwd;
    rc_s[x] = rc;
    valid_s[x] = valid;
  }
  __syncthreads();
  if (!valid_s[x]) return;
  const unsigned b = tile[x + i];
  const int sh_f = 2 * (k - 1 - i), sh_r = 2 * i;
  const unsigned long long f_clr = fwd_s[x] & ~(3ull << sh_f);
  const unsigned long long r_clr = rc_s[x] & ~(3ull << sh_r);
  unsigned hits = 0;
#pragma unroll
  for (unsigned d = 1; d < 4; ++d) {
    const unsigned nb = (b + d) & 3u;
    const unsigned long long mf = f_clr | ((unsigned long long)nb << sh_f);
    const unsigned long long mr =
        r_clr | ((unsigned long long)((nb + 2) & 3u) << sh_r);
    unsigned rank, pos;
    if (qm2t::packed_probe(rows, mf <= mr ? mf : mr, bucket_mask, &rank,
                           &pos)) {
      hits |= 1u << nb;
    }
  }
  if (hits) {
    const long long e = w0 + x + i;
    atomicOr(out + (e >> 2), hits << (8 * (e & 3)));
  }
}

}  // namespace

extern "C" const char* qm2t_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// codes u8[n] (bases 0-3, separators >= 4); rows u32[n_buckets, 8];
// out u32[ceil(n/4)], zeroed by the caller: byte e (little-endian) gets
// bit b set iff substituting base b at position e inside a valid window
// gives a canonical k-mer in the table.
extern "C" int qm2t_neighbor_bits(const void* codes, const void* rows,
                                  void* out, long long n, int k,
                                  long long n_buckets, void* stream) {
  if (k < 1 || k > kMaxK || n < k || n_buckets < 1 ||
      n_buckets > (1LL << 32) || (n_buckets & (n_buckets - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n_win = n - k + 1;
  const long long blocks = (n_win + kWin - 1) / kWin;
  neighbor_bits_kernel<<<(unsigned)blocks, dim3(kWin, k), 0,
                         (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const uint4*)rows, (unsigned*)out, n, k,
      (unsigned)(n_buckets - 1));
  return (int)cudaGetLastError();
}
