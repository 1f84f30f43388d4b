// K11: est's GC-corrected window sums on the card.
//
// Replaces quickmer2_tpu/ops/est_device.py::corrected_window_sums (:39) with
// _segment_window_sums (:28), an XLA device function: the f32 product
// factors[gc & 0x1FF] * depth of every k-mer, summed in f32 over each
// window's k-mer range [kstart, kend) (a scatter-add by window id there, in
// an order XLA chooses). Where a GC bin lies past the last factor, the JAX
// gather clamps to the last one; so does this kernel.
//
// A warp per window. Lane l takes k-mers kstart + l, kstart + l + 32, ... in
// that order, forming each product with __fmul_rn and adding it with
// __fadd_rn (no contraction into an FMA), then the warp reduces its 32 sums
// by a fixed shuffle tree (offsets 16, 8, 4, 2, 1). So the sum of a window
// is the same bits in every launch, and kernels/est_windows.py::
// window_sums_plain repeats that order exactly. The factors sit in shared
// memory; depth and the .qgc entries are read as the u16 they are on disk.
//
// Bound on the H100: bytes. Each covered k-mer's depth and .qgc entry (4 B)
// are read once, each window's bounds (8 B) once and its sum (4 B) written
// once; the ~4 operations a k-mer are far below the card's rate. Lanes of a
// warp read 32 consecutive u16s (64 B) a step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxFactors = 512;   // gc & 0x1FF indexes at most 512 bins

__global__ void __launch_bounds__(kThreads)
window_sums_kernel(const uint16_t* __restrict__ depth,
                   const uint16_t* __restrict__ qgc,
                   const float* __restrict__ factors, int n_factors,
                   const int* __restrict__ kstarts,
                   const int* __restrict__ kends, float* __restrict__ sums,
                   long long n, int n_windows) {
  __shared__ float fac[kMaxFactors];
  for (int j = threadIdx.x; j < kMaxFactors; j += kThreads) {
    fac[j] = factors[j < n_factors ? j : n_factors - 1];
  }
  __syncthreads();
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= n_windows) return;
  const int lane = threadIdx.x & 31;
  const long long ks = max(__ldg(kstarts + w), 0);
  const long long ke = min((long long)__ldg(kends + w), n);
  float acc = 0.0f;
  for (long long i = ks + lane; i < ke; i += 32) {
    const float f = fac[__ldg(qgc + i) & 0x1FF];
    acc = __fadd_rn(acc, __fmul_rn(f, (float)__ldg(depth + i)));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_down_sync(0xFFFFFFFFu, acc, off));
  }
  if (lane == 0) sums[w] = acc;
}

}  // namespace

extern "C" const char* qm2t_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// depth, qgc u16[n]; factors f32[n_factors], 1 <= n_factors <= 512; kstarts,
// kends i32[n_windows] (each range clamped to [0, n)); sums f32[n_windows],
// written in full.
extern "C" int qm2t_window_sums(const void* depth, const void* qgc,
                                const void* factors, int n_factors,
                                const void* kstarts, const void* kends,
                                void* sums, long long n, int n_windows,
                                void* stream) {
  if (n < 0 || n_windows < 0 || n_factors < 1 || n_factors > kMaxFactors) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_windows == 0) return 0;
  const unsigned blocks = (unsigned)((n_windows + kWarps - 1) / kWarps);
  window_sums_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)depth, (const uint16_t*)qgc, (const float*)factors,
      n_factors, (const int*)kstarts, (const int*)kends, (float*)sums, n,
      n_windows);
  return (int)cudaGetLastError();
}
