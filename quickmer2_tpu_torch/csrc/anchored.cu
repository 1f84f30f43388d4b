// The anchored read pass of `count --mode anchored`: one launch per batch
// of fixed-width read rows.
//
// Replaces quickmer2_tpu/ops/anchored.py::anchored_count_kernel (as
// _anchored_count_kernel_packed runs it, with rowpack.unpack_batch,
// codec.sliding_kmers, packed_table.probe_packed, rank_at and
// fetch_genome_window inlined), an XLA device function that ran as a chain
// of whole-batch passes over (R, L) arrays. Here one thread owns one read
// row and walks it position by position, keeping per-read bit sets
// (invalid bases, valid windows, matches, clean and dirty windows) as
// 32-bit words; clean windows, runs and dirty runs are bit operations.
//
// Per read (the JAX function's steps, same order of decisions):
//   1. unpack the 2-bit lanes, in the lens (u16 length) or mask (invalid
//      bitmask) format of ops/rowpack.py::pack_batch;
//   2. probe the canonical k-mers at the anchor offsets (valid windows only)
//      and take the majority vote: each found anchor scores how many
//      anchors agree with its implied forward start or reverse end; the
//      first maximum wins;
//   3. compare the read with the genome on both strands, reading the tile
//      bytes in place (no fetch-and-roll: a strand whose window leaves the
//      genome matches nowhere, as the JAX in-range masks make it);
//      forward wins ties;
//   4. clean windows = valid windows whose k bases all match; clean runs
//      and dirty windows (valid, not clean);
//   5. the spill decision of the branch (template parameter):
//        kNeighbor - tier 1 with the neighbor bits (bits 3-6 of a tile
//                    byte): spill on any bad mismatch, two substitutions
//                    closer than k, or a set neighbor bit;
//        kPoint    - tier 1 without them: spill on more than max_dirty
//                    dirty windows, which are probed one by one;
//        kRuns     - tier 2: spill unless every dirty run is narrower than
//                    dirty_run_width and there are at most max_dirty_runs;
//      and in every branch on an unanchored read or more than max_runs
//      clean runs;
//   6. an unspilled read adds +1 / -1 (u32 wrap: 0xFFFFFFFF) into diff at
//      the ranks of each clean run's ends (rank_at over dblock), and, in
//      kPoint and kRuns, +1 / -1 around each dirty k-mer found in the
//      table;
//   7. spill code: 0 counted, 1 spilled, 2 spilled and unanchorable.
// The JAX function also sends the unused run slots and dirty misses to a
// trash word whose net change is zero; this kernel skips them, so diff is
// the same word for word.
//
// Bound on the H100: per read the packed row (~42 B at 160 bases), up to
// 4 anchor probes of two random 32-B rows, two genome windows (~3 random
// 64-B tiles each), a few 16-B dblock rows and 4-B diff words, against
// ~50 integer operations per base. The table and the genome are larger
// than the 50 MB L2, so the probes and windows are random HBM accesses;
// by the count of operations against bytes moved the kernel is bound by
// operations at the main path's batch (~26 k reads), by a small margin.
// This first version keeps one thread per read, so the random accesses of
// a read are issued one after another.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_probe.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxL = 1024;
constexpr int kWords = kMaxL / 32 + 2;   // + a zero word for 2-word reads
constexpr int kMaxAnchors = 4;
constexpr unsigned kSep = 4;

enum Branch { kNeighbor = 0, kPoint = 1, kRuns = 2 };

struct Params {
  const uint8_t* pk;        // u8[R, ceil(L/4)]
  const uint8_t* aux;       // u16[R] lengths or u8[R, ceil(L/8)] bits
  const uint4* rows;        // packed table, 2 x uint4 per bucket
  const uint8_t* tiles;     // u8[G]
  const uint4* dblock;      // [rank_base, mask_hi, mask_lo, 0] per block
  unsigned* diff;           // u32[n_diff]
  int8_t* code;             // i8[R]
  int R, L, k, G, n_diff;
  unsigned bucket_mask;
  int n_anchors;
  int anchors[kMaxAnchors];
  int max_runs, max_dirty, max_dirty_runs, dirty_run_width;
};

// n (<= 32) bits of bit set a starting at bit j.
__device__ __forceinline__ unsigned bits_at(const unsigned* a, int j, int n) {
  const unsigned long long w =
      ((unsigned long long)a[(j >> 5) + 1] << 32) | a[j >> 5];
  const unsigned m = n == 32 ? 0xFFFFFFFFu : (1u << n) - 1u;
  return (unsigned)(w >> (j & 31)) & m;
}

__device__ __forceinline__ bool bit(const unsigned* a, int j) {
  return (a[j >> 5] >> (j & 31)) & 1u;
}

// First set (want = true) or clear bit at or after `from`, or n.
__device__ __forceinline__ int next_bit(const unsigned* a, int from, int n,
                                        bool want) {
  for (int w = from >> 5; (w << 5) < n; ++w) {
    unsigned x = want ? a[w] : ~a[w];
    if (w == (from >> 5)) x &= 0xFFFFFFFFu << (from & 31);
    if (x) {
      const int j = (w << 5) + __ffs(x) - 1;
      return j < n ? j : n;
    }
  }
  return n;
}

// R(q): dictionary end positions <= q (ops/anchored.py::rank_at).
__device__ __forceinline__ unsigned rank_at(const uint4* __restrict__ dblock,
                                            int q) {
  const uint4 row = __ldg(dblock + (q >> 6));
  const unsigned b = q & 63;
  const unsigned lo_keep = b >= 32 ? 0xFFFFFFFFu : 0xFFFFFFFFu >> (31 - b);
  const unsigned hi_keep = b >= 32 ? 0xFFFFFFFFu >> (63 - b) : 0u;
  return row.x + __popc(row.z & lo_keep) + __popc(row.y & hi_keep);
}

__device__ __forceinline__ void add_range(unsigned* diff, unsigned lo,
                                          unsigned hi) {
  atomicAdd(diff + lo, 1u);
  atomicAdd(diff + hi, 0xFFFFFFFFu);
}

template <int BR, bool LENS>
__global__ void __launch_bounds__(kThreads) anchored_kernel(const Params p) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= p.R) return;
  const int L = p.L, k = p.k, W = L - k + 1;
  const uint8_t* prow = p.pk + (size_t)r * ((L + 3) >> 2);
  auto base = [&](int t) -> unsigned {
    return (__ldg(prow + (t >> 2)) >> (2 * (t & 3))) & 3u;
  };

  // 1. invalid bases (SEP, N; every bit from L on is set)
  unsigned bad[kWords];
  if (LENS) {
    const int len = ((const uint16_t*)p.aux)[r];
    for (int w = 0; w < kWords; ++w) {
      const int lo = w << 5;
      bad[w] = len <= lo ? 0xFFFFFFFFu
               : len >= lo + 32 ? 0u : 0xFFFFFFFFu << (len - lo);
    }
  } else {
    const int nb = (L + 7) >> 3;
    const uint8_t* arow = p.aux + (size_t)r * nb;
    for (int w = 0; w < kWords; ++w) {
      unsigned x = 0;
      for (int b = 0; b < 4; ++b) {
        const int i = 4 * w + b;
        x |= (unsigned)(i < nb ? __ldg(arow + i) : 0xFFu) << (8 * b);
      }
      bad[w] = x;
    }
  }
  for (int w = 0; w < kWords; ++w) {
    const int lo = w << 5;
    if (L <= lo) bad[w] = 0xFFFFFFFFu;
    else if (L < lo + 32) bad[w] |= 0xFFFFFFFFu << (L - lo);
  }
  auto code_at = [&](int t) -> unsigned { return bit(bad, t) ? kSep : base(t); };

  // valid windows (bits 0..W-1)
  unsigned vd[kWords];
  bool anyvalid = false;
  for (int w = 0; w < kWords; ++w) vd[w] = 0;
  for (int j = 0; j < W; ++j) {
    if (bits_at(bad, j, k) == 0) {
      vd[j >> 5] |= 1u << (j & 31);
      anyvalid = true;
    }
  }

  // 2. anchors and the majority vote
  bool av[kMaxAnchors];
  int ps[kMaxAnchors];
  for (int i = 0; i < p.n_anchors; ++i) {
    const int j = p.anchors[i];
    av[i] = false;
    ps[i] = 0;
    if (bit(vd, j)) {
      const unsigned long long c =
          qm2t::canonical(k, [&](int q) { return base(j + q); });
      unsigned rk, pos;
      if (qm2t::packed_probe(p.rows, c, p.bucket_mask, &rk, &pos)) {
        av[i] = true;
        ps[i] = (int)pos;
      }
    }
  }
  int best = 0, best_score = -1;
  bool a_found = false;
  for (int i = 0; i < p.n_anchors; ++i) {
    int score = 0;
    if (av[i]) {
      a_found = true;
      const int s_i = ps[i] - (k - 1) - p.anchors[i];
      const int g_i = ps[i] + p.anchors[i];
      int agree_f = 0, agree_r = 0;
      for (int j2 = 0; j2 < p.n_anchors; ++j2) {
        if (!av[j2]) continue;
        agree_f += ps[j2] - (k - 1) - p.anchors[j2] == s_i;
        agree_r += ps[j2] + p.anchors[j2] == g_i;
      }
      score = agree_f > agree_r ? agree_f : agree_r;
    }
    if (score > best_score) {
      best_score = score;
      best = i;
    }
  }
  if (!a_found) {                       // unanchored: nothing counted here
    p.code[r] = anyvalid ? 2 : 0;
    return;
  }

  // 3. both strands against the genome; forward wins ties
  const int a_pos = ps[best], a_off = p.anchors[best];
  const int s_f = a_pos - (k - 1) - a_off;
  const int ge = a_pos + a_off;
  const bool fwd_in = s_f >= 0 && s_f + L <= p.G;
  const bool rc_in = ge - (L - 1) >= 0 && ge < p.G;
  int cnt_f = 0, cnt_r = 0;
  for (int t = 0; t < L; ++t) {
    const unsigned c = code_at(t);
    if (c >= kSep) continue;
    if (fwd_in) cnt_f += (__ldg(p.tiles + s_f + t) & 7u) == c;
    if (rc_in) {
      const unsigned g = __ldg(p.tiles + ge - t) & 7u;
      cnt_r += g < 4 && ((g + 2) & 3u) == c;
    }
  }
  const bool use_fwd = cnt_f >= cnt_r;
  const bool in_range = use_fwd ? fwd_in : rc_in;
  // genome byte (code | neighbor bits << 3) aligned to read position t
  auto gbyte = [&](int t) -> unsigned {
    return __ldg(p.tiles + (use_fwd ? s_f + t : ge - t));
  };
  auto matches = [&](unsigned c, unsigned g) -> bool {
    g &= 7u;
    return c < 4 && g < 4 && c == (use_fwd ? g : (g + 2) & 3u);
  };

  // 4. clean windows, clean runs, dirty windows
  unsigned mt[kWords];
  for (int w = 0; w < kWords; ++w) mt[w] = 0;
  if (in_range) {
    for (int t = 0; t < L; ++t) {
      if (matches(code_at(t), gbyte(t))) mt[t >> 5] |= 1u << (t & 31);
    }
  }
  unsigned cl[kWords], dw[kWords];
  const unsigned full = k == 32 ? 0xFFFFFFFFu : (1u << k) - 1u;
  for (int w = 0; w < kWords; ++w) cl[w] = 0;
  for (int j = 0; j < W; ++j) {
    if (bit(vd, j) && bits_at(mt, j, k) == full) cl[j >> 5] |= 1u << (j & 31);
  }
  int n_runs = 0, n_dirty = 0, n_druns = 0;
  for (int w = 0; w < kWords; ++w) {
    dw[w] = vd[w] & ~cl[w];
    const unsigned cprev = (cl[w] << 1) | (w ? cl[w - 1] >> 31 : 0u);
    const unsigned dprev = (dw[w] << 1) | (w ? dw[w - 1] >> 31 : 0u);
    n_runs += __popc(cl[w] & ~cprev);
    n_dirty += __popc(dw[w]);
    n_druns += __popc(dw[w] & ~dprev);
  }

  // 5. the spill decision
  bool spilled = n_runs > p.max_runs, unanch = false;
  if (BR == kRuns) {
    bool covered = n_druns <= p.max_dirty_runs;
    for (int j = next_bit(dw, 0, W, true); covered && j < W;) {
      const int e = next_bit(dw, j, W, false) - 1;
      covered = e - j < p.dirty_run_width;
      j = next_bit(dw, e + 1, W, true);
    }
    spilled = spilled || !covered;
  } else if (BR == kNeighbor) {
    unanch = !in_range;                 // anyvalid holds: an anchor is valid
    bool bad_mm = false;
    int last_sub = -kMaxL;
    for (int t = 0; !unanch && !bad_mm && t < L; ++t) {
      const unsigned c = code_at(t);
      const unsigned g = gbyte(t);
      if (matches(c, g)) continue;
      // covered by a valid window j in [t-k+1, t] within [0, W)
      const int lo = t - k + 1 > 0 ? t - k + 1 : 0;
      const int hi = t + 1 < W ? t + 1 : W;
      if (lo >= hi || bits_at(vd, lo, hi - lo) == 0) continue;
      if (c >= 4 || (g & 7u) >= 4) {
        bad_mm = true;                  // a mismatch that is no substitution
        break;
      }
      // two substitutions closer than k (positions below W, as the JAX
      // prefix counts clip them)
      if (t < W) {
        if (t - last_sub <= k - 1) bad_mm = true;
        last_sub = t;
      }
      const unsigned b_gen = use_fwd ? c : (c + 2) & 3u;
      if ((g >> (3 + b_gen)) & 1u) bad_mm = true;
    }
    spilled = spilled || unanch || bad_mm;
  } else {
    spilled = spilled || n_dirty > p.max_dirty;
  }
  p.code[r] = spilled ? (unanch ? 2 : 1) : 0;
  if (spilled) return;

  // 6. clean runs → range-adds at rank boundaries
  for (int s = next_bit(cl, 0, W, true); s < W;) {
    const int e = next_bit(cl, s, W, false) - 1;
    const int q_start = use_fwd ? s_f + s + (k - 1) : ge - e;
    const int q_end = use_fwd ? s_f + e + (k - 1) : ge - s;
    int ql = q_start - 1;
    ql = ql < 0 ? 0 : ql > p.G - 1 ? p.G - 1 : ql;
    const int qh = q_end < 0 ? 0 : q_end > p.G - 1 ? p.G - 1 : q_end;
    const unsigned lo = q_start <= 0 ? 0u : rank_at(p.dblock, ql);
    add_range(p.diff, lo, rank_at(p.dblock, qh));
    s = next_bit(cl, e + 1, W, true);
  }
  //    dirty k-mers → exact point probes (every dirty window of an
  //    unspilled read fits the branch's caps)
  if (BR != kNeighbor) {
    const unsigned trash = (unsigned)p.n_diff - 1;
    for (int j = next_bit(dw, 0, W, true); j < W;
         j = next_bit(dw, j + 1, W, true)) {
      const unsigned long long c =
          qm2t::canonical(k, [&](int q) { return base(j + q); });
      unsigned rk, pos;
      if (qm2t::packed_probe(p.rows, c, p.bucket_mask, &rk, &pos)) {
        add_range(p.diff, rk, rk + 1 < trash ? rk + 1 : trash);
      }
    }
  }
}

template <int BR>
cudaError_t launch(const Params& p, bool lens, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((p.R + kThreads - 1) / kThreads);
  if (lens) {
    anchored_kernel<BR, true><<<blocks, kThreads, 0, stream>>>(p);
  } else {
    anchored_kernel<BR, false><<<blocks, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* qm2t_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// pk u8[R, ceil(L/4)]; aux u16[R] (lens = 1) or u8[R, ceil(L/8)] (lens = 0);
// rows u32[n_buckets, 8]; tiles u8[G]; dblock u32[>= G/64, 4];
// diff u32[n_diff] (updated in place); code i8[R] (written in full).
// branch: 0 neighbor, 1 point probes, 2 run-sliced (tier 2).
extern "C" int qm2t_anchored(const void* pk, const void* aux, int lens,
                             const void* rows, long long n_buckets,
                             const void* tiles, long long G,
                             const void* dblock, void* diff, long long n_diff,
                             void* code, int R, int L, int k, int n_anchors,
                             int a0, int a1, int a2, int a3, int max_runs,
                             int max_dirty, int max_dirty_runs,
                             int dirty_run_width, int branch, void* stream) {
  const int W = L - k + 1;
  const int anchors[kMaxAnchors] = {a0, a1, a2, a3};
  if (k < 1 || k > 32 || L > kMaxL || W < 1 || R < 1 || n_anchors < 1 ||
      n_anchors > kMaxAnchors || G < L || G > 0x7FFFFFFFLL || n_diff < 2 ||
      n_diff > 0x7FFFFFFFLL || n_buckets < 1 || n_buckets > (1LL << 32) ||
      (n_buckets & (n_buckets - 1)) != 0 || branch < 0 || branch > 2) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.pk = (const uint8_t*)pk;
  p.aux = (const uint8_t*)aux;
  p.rows = (const uint4*)rows;
  p.tiles = (const uint8_t*)tiles;
  p.dblock = (const uint4*)dblock;
  p.diff = (unsigned*)diff;
  p.code = (int8_t*)code;
  p.R = R;
  p.L = L;
  p.k = k;
  p.G = (int)G;
  p.n_diff = (int)n_diff;
  p.bucket_mask = (unsigned)(n_buckets - 1);
  p.n_anchors = n_anchors;
  for (int i = 0; i < kMaxAnchors; ++i) {
    if (i < n_anchors && (anchors[i] < 0 || anchors[i] >= W)) {
      return (int)cudaErrorInvalidValue;
    }
    p.anchors[i] = anchors[i];
  }
  p.max_runs = max_runs;
  p.max_dirty = max_dirty;
  p.max_dirty_runs = max_dirty_runs;
  p.dirty_run_width = dirty_run_width;
  cudaStream_t s = (cudaStream_t)stream;
  if (branch == kNeighbor) return (int)launch<kNeighbor>(p, lens != 0, s);
  if (branch == kPoint) return (int)launch<kPoint>(p, lens != 0, s);
  return (int)launch<kRuns>(p, lens != 0, s);
}
