// The anchored read pass of `count --mode anchored`: one launch per batch
// of fixed-width read rows.
//
// Replaces quickmer2_tpu/ops/anchored.py::anchored_count_kernel (as
// _anchored_count_kernel_packed runs it, with rowpack.unpack_batch,
// codec.sliding_kmers, packed_table.probe_packed, rank_at and
// fetch_genome_window inlined), an XLA device function that ran as a chain
// of whole-batch passes over (R, L) arrays.
//
// Layout: a read row of L <= 1,024 bases gets a group of G lanes, G the
// least power of two >= ceil(L / 32) (G = 8 at the 160-wide rows of 150 bp
// reads, so a warp holds 4 reads; G = 32 at 1024). Lane j owns bases
// 32j..32j+31: it loads their 2-bit codes as one 8-B word and their lens
// entry or mask bits, and holds every per-read bit set (invalid bases,
// valid windows, matches, clean and dirty windows) as one 32-bit register
// over windows or bases 32j..32j+31. No array is indexed at run time. What
// a lane needs of its neighbours (the next lane's bits for windows that
// cross into it, the previous lane's for runs) comes by shuffles within the
// group; counts are popcounts summed over the group.
//
// A row wider than 1,024 bases (up to 65,535, the lens format's u16 lengths)
// gets a block (anchored_wide_kernel): its T = ceil(L / 1,024) tiles, each
// laid out as the G = 32 group, on min(T, 16) warps, warp w holding tiles w,
// w + 16, ... (at most four). A warp loads its tiles' code and invalid
// words, and both strands' genome words, once, and keeps them in registers;
// the steps below run over them as phases of one pass, separated by block
// barriers (in the lens format a warp whose tiles lie past the read's length
// keeps only the barriers). Warp 0 probes the anchors (their k bases
// straight from the packed row, K3a's aligned loads) and votes while the
// other warps load; then both strands' matches (the genome bytes packed to
// 2-bit codes and compared 32 bases at a time), summed over the block; then
// the chosen strand's clean and dirty windows; then the runs' starts and the
// spill decision, its counts summed and its checks or-ed over the block;
// then the adds. What crosses a tile boundary goes through shared memory, an
// entry a tile: lane 0 publishes its codes, invalid bases and both strands'
// matches (the previous tile's next word), lane 31 its valid, clean and
// dirty windows and substitutions (the next tile's previous word). In tier 2
// a dirty run starts after the last window before its end that is not dirty:
// in the lane, an earlier lane (a scan) or an earlier tile (a maximum over
// the tiles' published last ones). Every count and cap is over the whole
// read. Clean runs are added edge by edge (+1 at a run's low rank, -1 at its
// high one, the lane that holds either edge adding it), and the dirty
// windows of a tile are dealt round its warp as in a group.
//
// Per read (the JAX function's steps, same order of decisions):
//   1. unpack the 2-bit lanes, in the lens (u16 length) or mask (invalid
//      bitmask) format of ops/rowpack.py::pack_batch;
//   2. probe the canonical k-mers at the anchor offsets (valid windows
//      only): lane i assembles anchor i's k bases from at most two lanes'
//      code words, and the probes go out together; every lane then takes
//      the majority vote: each found anchor scores how many anchors agree
//      with its implied forward start or reverse end; the first maximum
//      wins;
//   3. compare the read with the genome on both strands: each lane reads
//      the 32 genome bytes of its bases as nine aligned words and compares
//      four bases a word (a strand whose window leaves the genome matches
//      nowhere, as the JAX in-range masks make it); forward wins ties;
//   4. clean windows = valid windows whose k bases all match; clean runs
//      and dirty windows (valid, not clean);
//   5. the spill decision of the branch (template parameter):
//        kNeighbor - tier 1 with the neighbor bits (bits 3-6 of a tile
//                    byte): spill on any covered mismatch that is no
//                    substitution, two substitutions closer than k (below
//                    W; the previous lane's substitutions come by a
//                    shuffle), or a set neighbor bit (each lane reads the
//                    tile bytes of its own substitutions);
//        kPoint    - tier 1 without them: spill on more than max_dirty
//                    dirty windows, which are probed one by one;
//        kRuns     - tier 2: spill unless every dirty run is narrower than
//                    dirty_run_width and there are at most max_dirty_runs;
//      and in every branch on an unanchored read or more than max_runs
//      clean runs;
//   6. an unspilled read adds +1 / -1 (u32 wrap: 0xFFFFFFFF) into diff at
//      the ranks of each clean run's ends (rank_at over dblock): the lane
//      that holds a run's start issues it, the run's end found by a group
//      scan, so a read's runs go out in parallel; in kPoint and kRuns the
//      dirty windows are dealt round the group's lanes and probed in
//      parallel, +1 / -1 around each one found in the table;
//   7. spill code: 0 counted, 1 spilled, 2 spilled and unanchorable.
// The JAX function also sends the unused run slots and dirty misses to a
// trash word whose net change is zero; this kernel skips them, so diff is
// the same word for word.
//
// Under a dict-sharded table (quickmer2_tpu/ops/anchored.py::
// anchored_count_kernel with dict_axis, :548-558, :575-586, :760-763) a
// block holds only its buckets, so no block can vote on its anchors alone:
// the JAX function probes them per block and psums found and pos before
// the vote. Here that is two launches around the sum:
//   K3a (qm2t_anchor_probes) — a thread per (read, anchor), a read's
//       anchors on adjacent lanes: the anchor window's k bases from at
//       most two aligned 8-B words of the packed row (its invalid bits, in
//       the mask format, from two 4-B words; byte loads only for a row
//       that is not so aligned), its canonical code probed where the
//       window is valid with K8b's and K12's block probe
//       (block_probe.cuh::BlockProbe::probe_pos): h1's row where it is
//       local, h2's only where h1's is full and lacks the code and the
//       block's bitmap of keys at h2 (kernels/block_probe.py::
//       block_displaced_filter, which the sharded counter builds once a
//       block) allows; found u8[A, R] and pos u32[A, R]. A key sits at h2
//       only behind an h1 bucket that was full when it was placed (ops/
//       packed_table.py::PackedTable.build, which builds the .qai's
//       table), so the gate drops no hit;
//   (the caller combines found and pos over the blocks; a key sits in one
//       block, so their sum is their bitwise or)
//   K3 on the block (qm2t_anchored_block, template GIVEN) — steps 1-7 with
//       the summed anchors in place of its own probes; its dirty and tier-2
//       probes find the block's entries only (packed_probe_block_h), and
//       only the block with `ranges` set adds the clean runs, since they
//       come from the replicated dblock. Every block decides the same
//       spill codes.
// Unsharded, K3 stays the one launch (GIVEN false) it was.
//
// Bound on the H100: per read the packed row (~42 B at 160 bases), up to
// 4 anchor probes of two random 32-B rows, two genome windows (~3 random
// 64-B tiles each), a few 16-B dblock rows and 4-B diff words, against
// ~16 integer operations per base and ~60 per probe. The table and the
// genome are larger than the 50 MB L2, so each read is a chain of four
// dependent random accesses (row, probes, genome, dblock + atomics). One
// thread per read would fill ~10 % of the card's threads at a 26,214-row
// batch (205 blocks of 128) and keep the bit sets as 34-word arrays in
// local memory; at 8 lanes a read the batch fills ~6,500 warps, and the
// lanes of a read issue their accesses together. A wide read's row and
// genome words are read once, as the bound counts them, and its tiles run
// on separate warps, so its latency is a tile's and four barriers', not
// T tiles'; the card keeps up to 32 blocks and 64 warps an SM, so the
// 2-warp blocks of rows of 2,048 fill it as the 16-warp ones of 16,384
// do. What is left is integer work (~16 operations a base).

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_probe.cuh"
#include "packed_probe.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileL = 1024;          // bases a lane group covers
constexpr int kMaxRowL = 65535;       // the lens format's u16 lengths
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxAnchors = 4;
constexpr int kNoPos = 0x7FFFFFFF;

enum Branch { kNeighbor = 0, kPoint = 1, kRuns = 2 };

struct Params {
  const uint8_t* pk;        // u8[R, ceil(L/4)]
  const uint8_t* aux;       // u16[R] lengths or u8[R, ceil(L/8)] bits
  const uint4* rows;        // packed table, 2 x uint4 per bucket
  const uint8_t* tiles;     // u8[glen]
  const uint4* dblock;      // [rank_base, mask_hi, mask_lo, 0] per block
  unsigned* diff;           // u32[n_diff]
  int8_t* code;             // i8[R]
  int R, L, k, glen, n_diff;
  int lanes;                // G: lanes per read, a power of two <= 32
  bool pk8, aux4;           // rows of pk (aux) start 8-B (4-B) aligned
  unsigned bucket_mask;
  int n_anchors, a0, a1, a2, a3;
  int max_runs, max_dirty, max_dirty_runs, dirty_run_width;
};

// A dict-sharded launch (K3 with GIVEN anchors, K3a): rows holds buckets
// [blk_lo, blk_lo + blk_last]; afound u8[n_anchors, R] and apos
// u32[n_anchors, R] are the anchors' found / pos summed over every block;
// ranges: this block adds the clean runs. A separate type, so that the
// unsharded kernel's parameters and code stay what they were.
struct BlockParams : Params {
  const uint8_t* afound;
  const unsigned* apos;
  unsigned blk_lo, blk_last;
  bool ranges;
};

template <bool GIVEN>
struct LaunchParams {
  typedef Params type;
};
template <>
struct LaunchParams<true> {
  typedef BlockParams type;
};

// A probe of the block's rows.
__device__ __forceinline__ bool block_probe(const BlockParams& p,
                                            unsigned long long code,
                                            unsigned* rank, unsigned* pos) {
  return qm2t::packed_probe_block_h(
      p.rows, code, qm2t::djb_pair((unsigned)(code >> 32), (unsigned)code),
      p.bucket_mask, p.blk_lo, p.blk_last, rank, pos);
}

__device__ __forceinline__ int anchor_at(const Params& p, int i) {
  return i == 0 ? p.a0 : i == 1 ? p.a1 : i == 2 ? p.a2 : p.a3;
}

// Bits of positions t0..t0+31 that lie below n.
__device__ __forceinline__ unsigned below(int n, int t0) {
  n -= t0;
  return n <= 0 ? 0u : n >= 32 ? 0xFFFFFFFFu : (1u << n) - 1u;
}

// Bit b: bits b..b+n-1 of (next:cur) all set (1 <= n <= 32).
__device__ __forceinline__ unsigned win_and(unsigned cur, unsigned next,
                                            int n) {
  unsigned long long t = ((unsigned long long)next << 32) | cur;
  int len = 1;
  while (2 * len <= n) {
    t &= t >> len;
    len *= 2;
  }
  if (len < n) t &= t >> (n - len);
  return (unsigned)t;
}

// Bit b: any of bits 32+b-n+1..32+b of x set (1 <= n <= 32).
__device__ __forceinline__ unsigned dilate(unsigned long long x, int n) {
  int len = 1;
  while (2 * len <= n) {
    x |= x << len;
    len *= 2;
  }
  if (len < n) x |= x << (n - len);
  return (unsigned)(x >> 32);
}

// Four 2-bit codes (a byte) → one code a byte.
__device__ __forceinline__ unsigned spread4(unsigned v) {
  return (v & 3u) | ((v & 0xCu) << 6) | ((v & 0x30u) << 12) |
         ((v & 0xC0u) << 18);
}

// Bits 0, 8, 16, 24 → bits 0-3.
__device__ __forceinline__ unsigned nibble(unsigned x) {
  return ((x * 0x204081u) >> 21) & 0xFu;
}

// Genome bytes [a, a + 32) against the lane's 32 read codes: bit b of
// *match is set where the tile byte's code equals read base b (REV: the
// bytes run backwards from a + 31 and compare with the complement), bit b
// of *gbad where that code is no base. Words outside the genome are
// clamped to its ends; they only meet positions the caller masks.
template <bool REV>
__device__ __forceinline__ void strand_bits(const unsigned* __restrict__ tw,
                                            int n_words, int a,
                                            unsigned long long code,
                                            unsigned* match, unsigned* gbad) {
  const int w = a >> 2;
  const unsigned sh = 8u * (unsigned)(a & 3);
  unsigned wd[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const int q = w + i < 0 ? 0 : w + i >= n_words ? n_words - 1 : w + i;
    wd[i] = __ldg(tw + q);
  }
  unsigned m = 0, gb = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    unsigned g = __funnelshift_r(wd[i], wd[i + 1], sh);
    const int qi = REV ? 7 - i : i;
    if (REV) g = __byte_perm(g, 0, 0x0123);
    const unsigned c4 = spread4((unsigned)(code >> (8 * qi)) & 0xFFu) ^
                        (REV ? 0x02020202u : 0u);
    const unsigned g7 = g & 0x07070707u;
    const unsigned nz = ((g7 ^ c4) + 0x07070707u) & 0x08080808u;
    m |= nibble((~nz >> 3) & 0x01010101u) << (4 * qi);
    gb |= nibble((g7 >> 2) & 0x01010101u) << (4 * qi);
  }
  *match = m;
  *gbad = gb;
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

__device__ __forceinline__ int group_sum(unsigned gm, int v, int n) {
  for (int o = n >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(gm, v, o, n);
  return v;
}

// Position of the first set bit of `ends` in the lanes after this one
// (kNoPos if none): a suffix-minimum scan over the group.
__device__ __forceinline__ int next_end_after(unsigned gm, unsigned ends,
                                              int t0, int lane, int n) {
  int v = ends ? t0 + __ffs(ends) - 1 : kNoPos;
  for (int o = 1; o < n; o <<= 1) {
    const int y = __shfl_down_sync(gm, v, o, n);
    if (lane + o < n && y < v) v = y;
  }
  const int after = __shfl_down_sync(gm, v, 1, n);
  return lane + 1 < n ? after : kNoPos;
}

// The 2-bit codes of bases 32w..32w+31 of row r as one word (0 past the
// row).
__device__ __forceinline__ unsigned long long word_code(const Params& p,
                                                        int r, int w) {
  const int sb = (p.L + 3) >> 2;
  const uint8_t* prow = p.pk + (size_t)r * sb;
  unsigned long long code = 0;
  if (p.pk8) {
    if (8 * w < sb) code = __ldg((const unsigned long long*)prow + w);
  } else {
    for (int i = 0; i < 8; ++i) {
      const int b = 8 * w + i;
      if (b < sb) code |= (unsigned long long)__ldg(prow + b) << (8 * i);
    }
  }
  return code;
}

// The invalid bases among 32w..32w+31 of row r (SEP, N; every base from L
// on).
template <bool LENS>
__device__ __forceinline__ unsigned word_bad(const Params& p, int r, int w) {
  const int t0 = w << 5;
  unsigned bad;
  if (LENS) {
    bad = ~below(__ldg((const uint16_t*)p.aux + r), t0);
  } else {
    const int nb = (p.L + 7) >> 3;
    const uint8_t* arow = p.aux + (size_t)r * nb;
    if (p.aux4 && 4 * w < nb) {
      bad = __ldg((const unsigned*)arow + w);
    } else {
      bad = 0;
      for (int i = 0; i < 4; ++i) {
        const int b = 4 * w + i;
        bad |= (unsigned)(b < nb ? __ldg(arow + b) : 0xFFu) << (8 * i);
      }
    }
  }
  return bad | ~below(p.L, t0);
}

// Anchor window a of row r (a + k <= L): its k bases' codes from at most
// two aligned 8-B words of the packed row (byte loads where rows are not so
// aligned); *valid where none of them is invalid (the mask format's bits
// from two 4-B words, or bytes).
template <bool LENS>
__device__ __forceinline__ unsigned long long anchor_window(const Params& p,
                                                            int r, int a,
                                                            bool* valid) {
  const int k = p.k;
  if (LENS) {
    *valid = a + k <= (int)__ldg((const uint16_t*)p.aux + r);
  } else {
    const int nb = (p.L + 7) >> 3;
    unsigned long long inval = 0;
    if (p.aux4) {          // bits a.. of two 4-B words
      const unsigned* w = (const unsigned*)(p.aux + (size_t)r * nb);
      const int q = a >> 5, sh = a & 31;
      const unsigned hi = sh + k > 32 ? __ldg(w + q + 1) : 0u;
      inval = (((unsigned long long)hi << 32) | __ldg(w + q)) >> sh;
    } else {
      const uint8_t* arow = p.aux + (size_t)r * nb;
      for (int q = 0; q < 5 && (a >> 3) + q < nb; ++q) {
        inval |= (unsigned long long)__ldg(arow + (a >> 3) + q) << (8 * q);
      }
      inval >>= a & 7;
    }
    *valid = (inval & ((1ull << k) - 1)) == 0;
  }
  const int sb = (p.L + 3) >> 2;
  if (p.pk8) {             // bases a.. of two 8-B words
    const unsigned long long* w =
        (const unsigned long long*)(p.pk + (size_t)r * sb);
    const int q = a >> 5, sh = 2 * (a & 31);
    const unsigned long long lo = __ldg(w + q);
    return sh + 2 * k > 64 ? (lo >> sh) | (__ldg(w + q + 1) << (64 - sh))
                           : lo >> sh;
  }
  const uint8_t* prow = p.pk + (size_t)r * sb;
  unsigned long long lo = 0, hi = 0;
  for (int q = 0; q < 9 && (a >> 2) + q < sb; ++q) {
    const unsigned long long b = __ldg(prow + (a >> 2) + q);
    if (q < 8) {
      lo |= b << (8 * q);
    } else {
      hi = b;
    }
  }
  const int sh = 2 * (a & 3);
  return sh ? (lo >> sh) | (hi << (64 - sh)) : lo;
}

// The majority vote over the anchors (found av[i], position ps[i]): each
// found anchor scores how many found anchors agree with its implied forward
// start or reverse end; the first maximum wins. False where no anchor was
// found.
__device__ __forceinline__ bool vote(const Params& p,
                                     const bool (&av)[kMaxAnchors],
                                     const int (&ps)[kMaxAnchors],
                                     int* best_pos, int* best_off) {
  const int k = p.k;
  int best_score = -1;
  bool a_found = false;
  *best_pos = 0;
  *best_off = 0;
#pragma unroll
  for (int i = 0; i < kMaxAnchors; ++i) {
    if (i < p.n_anchors) {
      const int ai = anchor_at(p, i);
      int score = 0;
      if (av[i]) {
        a_found = true;
        const int s_i = ps[i] - (k - 1) - ai;
        const int g_i = ps[i] + ai;
        int agree_f = 0, agree_r = 0;
#pragma unroll
        for (int j = 0; j < kMaxAnchors; ++j) {
          if (j < p.n_anchors && av[j]) {
            const int aj = anchor_at(p, j);
            agree_f += ps[j] - (k - 1) - aj == s_i;
            agree_r += ps[j] + aj == g_i;
          }
        }
        score = agree_f > agree_r ? agree_f : agree_r;
      }
      if (score > best_score) {
        best_score = score;
        *best_pos = ps[i];
        *best_off = ai;
      }
    }
  }
  return a_found;
}

template <int BR, bool LENS, bool GIVEN>
__global__ void __launch_bounds__(kThreads)
    anchored_kernel(const typename LaunchParams<GIVEN>::type p) {
  const int n = p.lanes;
  const long long gt = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int r = (int)(gt / n);
  if (r >= p.R) return;                 // whole groups leave together
  const int lane = (int)(gt & (n - 1));
  const int wl = threadIdx.x & 31;
  const unsigned gm =
      n == 32 ? 0xFFFFFFFFu : ((1u << n) - 1u) << (wl & ~(n - 1));
  const bool first = lane == 0, last = lane == n - 1;
  const int L = p.L, k = p.k, W = L - k + 1;
  const int t0 = lane << 5;
  const unsigned in_l = below(L, t0), in_w = below(W, t0);

  // 1. the lane's codes and invalid bases (SEP, N; every bit from L on)
  const unsigned long long code = word_code(p, r, lane);
  const unsigned bad = word_bad<LENS>(p, r, lane);
  const unsigned bad_next_x = __shfl_down_sync(gm, bad, 1, n);
  const unsigned bad_next = last ? 0xFFFFFFFFu : bad_next_x;

  // valid windows (bits below W)
  const unsigned vd = win_and(~bad, ~bad_next, k) & in_w;
  const unsigned vd_prev_x = __shfl_up_sync(gm, vd, 1, n);
  const unsigned vd_prev = first ? 0u : vd_prev_x;
  const bool anyvalid = __any_sync(gm, vd != 0u);

  // 2. anchors (lane i probes anchor i; G < 4 takes rounds) and the vote
  bool av[kMaxAnchors] = {false, false, false, false};
  int ps[kMaxAnchors] = {0, 0, 0, 0};
  for (int base = 0; base < p.n_anchors; base += n) {
    const int ai = base + lane;
    const int a = anchor_at(p, ai < p.n_anchors ? ai : 0);
    const int src = a >> 5;
    const unsigned long long c0 = __shfl_sync(gm, code, src, n);
    const unsigned long long c1 =
        __shfl_sync(gm, code, src + 1 < n ? src + 1 : src, n);
    const unsigned v_src = __shfl_sync(gm, vd, src, n);
    bool f = false;
    unsigned pos = 0;
    if (ai < p.n_anchors && ((v_src >> (a & 31)) & 1u)) {
      if constexpr (GIVEN) {
        f = __ldg(p.afound + (size_t)ai * p.R + r) != 0;
        pos = f ? __ldg(p.apos + (size_t)ai * p.R + r) : 0u;
      } else {
        const int s = 2 * (a & 31);
        const unsigned long long x = s ? (c0 >> s) | (c1 << (64 - s)) : c0;
        unsigned rk;
        f = qm2t::packed_probe(p.rows, qm2t::canonical_lsb(x, k),
                               p.bucket_mask, &rk, &pos);
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxAnchors; ++i) {
      if (i >= base && i < base + n) {
        const int fi = __shfl_sync(gm, (int)f, i - base, n);
        const int pi = __shfl_sync(gm, (int)pos, i - base, n);
        if (i < p.n_anchors) {
          av[i] = fi != 0;
          ps[i] = pi;
        }
      }
    }
  }
  int best_pos, best_off;
  const bool a_found = vote(p, av, ps, &best_pos, &best_off);
  if (!a_found) {                       // unanchored: nothing counted here
    if (first) p.code[r] = anyvalid ? 2 : 0;
    return;
  }

  // 3. both strands against the genome; forward wins ties
  const int s_f = best_pos - (k - 1) - best_off;
  const int ge = best_pos + best_off;
  const bool fwd_in = s_f >= 0 && s_f + L <= p.glen;
  const bool rc_in = ge - (L - 1) >= 0 && ge < p.glen;
  const unsigned* tw = (const unsigned*)p.tiles;
  unsigned mf = 0, gbf = 0, mr = 0, gbr = 0;
  if (~bad) {
    if (fwd_in) strand_bits<false>(tw, p.glen >> 2, s_f + t0, code, &mf, &gbf);
    if (rc_in) strand_bits<true>(tw, p.glen >> 2, ge - t0 - 31, code, &mr, &gbr);
    mf &= ~bad;
    mr &= ~bad;
  }
  const int cnt_f = group_sum(gm, __popc(mf), n);
  const int cnt_r = group_sum(gm, __popc(mr), n);
  const bool use_fwd = cnt_f >= cnt_r;
  const bool in_range = use_fwd ? fwd_in : rc_in;
  const unsigned mt = use_fwd ? mf : mr;      // 0 when out of range
  const unsigned gbad = use_fwd ? gbf : gbr;

  // 4. clean windows, clean runs, dirty windows
  const unsigned mt_next_x = __shfl_down_sync(gm, mt, 1, n);
  const unsigned cl = vd & win_and(mt, last ? 0u : mt_next_x, k);
  const unsigned dw = vd & ~cl;
  const unsigned cl_prev_x = __shfl_up_sync(gm, cl, 1, n);
  const unsigned dw_prev_x = __shfl_up_sync(gm, dw, 1, n);
  const unsigned cl_next_x = __shfl_down_sync(gm, cl, 1, n);
  const unsigned dw_next_x = __shfl_down_sync(gm, dw, 1, n);
  const unsigned cl_prev = first ? 0u : cl_prev_x;
  const unsigned dw_prev = first ? 0u : dw_prev_x;
  const unsigned cl_next = last ? 0u : cl_next_x;
  const unsigned dw_next = last ? 0u : dw_next_x;
  const unsigned cstart = cl & ~((cl << 1) | (cl_prev >> 31));
  const unsigned cend = cl & ~((cl >> 1) | (cl_next << 31));
  const unsigned dstart = dw & ~((dw << 1) | (dw_prev >> 31));
  const unsigned dend = dw & ~((dw >> 1) | (dw_next << 31));
  const int n_runs = group_sum(gm, __popc(cstart), n);
  const int n_dirty = group_sum(gm, __popc(dw), n);
  const int n_druns = group_sum(gm, __popc(dstart), n);

  // 5. the spill decision
  bool spilled = n_runs > p.max_runs, unanch = false;
  if (BR == kRuns) {
    bool covered = n_druns <= p.max_dirty_runs;
    if (covered) {
      const int later = next_end_after(gm, dend, t0, lane, n);
      bool ok = true;
      for (unsigned s = dstart; s; s &= s - 1) {
        const int b = __ffs(s) - 1;
        const unsigned e_in = dend & (0xFFFFFFFFu << b);
        const int e = e_in ? t0 + __ffs(e_in) - 1 : later;
        ok = ok && e - (t0 + b) < p.dirty_run_width;
      }
      covered = __all_sync(gm, ok);
    }
    spilled = spilled || !covered;
  } else if (BR == kNeighbor) {
    unanch = !in_range;                 // anyvalid holds: an anchor is valid
    if (!unanch) {
      // mismatches covered by a valid window j in [t-k+1, t] within [0, W)
      const unsigned cmm =
          ~mt & in_l & dilate(((unsigned long long)vd << 32) | vd_prev, k);
      const unsigned sub = cmm & ~(bad | gbad);
      const unsigned sub_w = sub & in_w;
      const unsigned sub_prev_x = __shfl_up_sync(gm, sub_w, 1, n);
      const unsigned long long pair =
          ((unsigned long long)sub_w << 32) | (first ? 0u : sub_prev_x);
      // a mismatch that is no substitution, or two substitutions closer
      // than k (positions below W, as the JAX prefix counts clip them)
      bool bad_mm = (cmm & (bad | gbad)) != 0u ||
                    (k > 1 && (sub_w & dilate(pair << 1, k - 1)) != 0u);
      for (unsigned s = sub; s && !bad_mm; s &= s - 1) {
        const int b = __ffs(s) - 1;
        const unsigned c = (unsigned)(code >> (2 * b)) & 3u;
        const unsigned g =
            __ldg(p.tiles + (use_fwd ? s_f + t0 + b : ge - t0 - b));
        bad_mm = (g >> (3 + (use_fwd ? c : c ^ 2u))) & 1u;
      }
      spilled = spilled || __any_sync(gm, bad_mm);
    }
    spilled = spilled || unanch;
  } else {
    spilled = spilled || n_dirty > p.max_dirty;
  }
  if (first) p.code[r] = spilled ? (unanch ? 2 : 1) : 0;
  if (spilled) return;

  // 6. clean runs → range-adds at rank boundaries (GIVEN: on the first
  //    block only; they come from the replicated dblock)
  const int later = next_end_after(gm, cend, t0, lane, n);
  unsigned starts = cstart;
  if constexpr (GIVEN) {
    if (!p.ranges) starts = 0u;
  }
  for (unsigned s = starts; s; s &= s - 1) {
    const int b = __ffs(s) - 1;
    const unsigned e_in = cend & (0xFFFFFFFFu << b);
    const int st = t0 + b;
    const int e = e_in ? t0 + __ffs(e_in) - 1 : later;
    const int q_start = use_fwd ? s_f + st + (k - 1) : ge - e;
    const int q_end = use_fwd ? s_f + e + (k - 1) : ge - st;
    int ql = q_start - 1;
    ql = ql < 0 ? 0 : ql > p.glen - 1 ? p.glen - 1 : ql;
    const int qh = q_end < 0 ? 0 : q_end > p.glen - 1 ? p.glen - 1 : q_end;
    const unsigned lo = q_start <= 0 ? 0u : rank_at(p.dblock, ql);
    add_range(p.diff, lo, rank_at(p.dblock, qh));
  }
  //    dirty k-mers → exact point probes (every dirty window of an
  //    unspilled read fits the branch's caps), dealt round the lanes:
  //    lane l probes the read's dirty windows l, l + G, ...
  if (BR != kNeighbor) {
    const unsigned trash = (unsigned)p.n_diff - 1;
    const int mine = __popc(dw);
    int incl = mine;
    for (int o = 1; o < n; o <<= 1) {
      const int y = __shfl_up_sync(gm, incl, o, n);
      if (lane >= o) incl += y;
    }
    const int excl = incl - mine;
    for (int base = 0; base < n_dirty; base += n) {
      const int m = base + lane;
      int o = 0;                        // the last lane whose excl <= m
      for (int step = n >> 1; step > 0; step >>= 1) {
        const int ex = __shfl_sync(gm, excl, o + step, n);
        if (ex <= m) o += step;
      }
      unsigned d = __shfl_sync(gm, dw, o, n);
      const int ex_o = __shfl_sync(gm, excl, o, n);
      const unsigned long long c0 = __shfl_sync(gm, code, o, n);
      const unsigned long long c1 =
          __shfl_sync(gm, code, o + 1 < n ? o + 1 : o, n);
      if (m < n_dirty) {
        for (int j = m - ex_o; j > 0; --j) d &= d - 1;
        const int s = 2 * (__ffs(d) - 1);
        const unsigned long long x = s ? (c0 >> s) | (c1 << (64 - s)) : c0;
        unsigned rk, pos;
        bool hit;
        if constexpr (GIVEN) {
          hit = block_probe(p, qm2t::canonical_lsb(x, k), &rk, &pos);
        } else {
          hit = qm2t::packed_probe(p.rows, qm2t::canonical_lsb(x, k),
                                   p.bucket_mask, &rk, &pos);
        }
        if (hit) {
          add_range(p.diff, rk, rk + 1 < trash ? rk + 1 : trash);
        }
      }
    }
  }
}

// ------------------------------------------- rows wider than 1,024 -----

// A read of L > 1,024 bases, T = ceil(L / 1,024) tiles, takes a block of
// nw = min(T, kWideWarps) warps; warp w holds tiles w, w + nw, ... (at most
// TPW of them, in registers). kernels/anchored.py::WIDE_WARPS names the
// same cap.
constexpr int kWideWarps = 16;
constexpr int kMaxTiles = (kMaxRowL + kTileL - 1) / kTileL;
constexpr int kWideTPW = (kMaxTiles + kWideWarps - 1) / kWideWarps;

// What a tile's edge lanes publish for the tiles beside it (dynamic shared
// memory, an entry a tile): lane 0's codes, invalid bases and both
// strands' matches (the previous tile's lane 31 reads them as its next
// word), lane 31's valid, clean and dirty windows and substitutions below
// W (the next tile's lane 0 reads them as its previous word), and in kRuns
// the tile's last window that is not dirty (-1 if none).
struct TileEdge {
  unsigned long long code0;
  unsigned bad0, mf0, mr0;
  unsigned vd31, cl31, dw31, sub31;
  int clear;
};

// The read's vote, sums and flags, one a block.
struct WideSums {
  int found, best_pos, best_off;
  int cnt_f, cnt_r, n_runs, n_dirty, n_druns, over;
};

// The 32 bases of x (2-bit codes, base m at bits 2m) in reverse order,
// each complemented (base ^ 2).
__device__ __forceinline__ unsigned long long revcomp32(unsigned long long x) {
  unsigned long long r = __brevll(x);
  r = ((r >> 1) & 0x5555555555555555ull) | ((r & 0x5555555555555555ull) << 1);
  return r ^ 0xAAAAAAAAAAAAAAAAull;
}

// Bits 0, 2, ..., 30 of x as bits 0..15.
__device__ __forceinline__ unsigned even_bits(unsigned x) {
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0F0F0F0Fu;
  x = (x | (x >> 4)) & 0x00FF00FFu;
  return (x | (x >> 8)) & 0x0000FFFFu;
}

// Genome bytes [a, a + 32) against 32 bases x (2-bit codes, base m at bits
// 2m): bit m of the result is set where byte a + m holds base m of x, bit m
// of *gbad where that byte holds no base. Each 4-byte word's codes are
// packed into one byte by a multiply, the bytes gathered by byte permutes,
// and the 32 bases compared at once. Words outside the genome are clamped
// to its ends; they only meet positions the caller masks.
__device__ __forceinline__ unsigned genome_match(
    const unsigned* __restrict__ tw, int n_words, int a,
    unsigned long long x, unsigned* gbad) {
  const int w = a >> 2;
  const unsigned sh = 8u * (unsigned)(a & 3);
  unsigned wd[9];
  if (w >= 0 && w + 8 < n_words) {
#pragma unroll
    for (int i = 0; i < 9; ++i) wd[i] = __ldg(tw + w + i);
  } else {
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const int q = w + i < 0 ? 0 : w + i >= n_words ? n_words - 1 : w + i;
      wd[i] = __ldg(tw + q);
    }
  }
  unsigned top[8], any_n = 0;           // top byte: the word's four codes
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const unsigned g = __funnelshift_r(wd[i], wd[i + 1], sh);
    top[i] = (g & 0x03030303u) * 0x01041040u;
    any_n |= g & 0x04040404u;
  }
  const unsigned lo = __byte_perm(__byte_perm(top[0], top[1], 0x73),
                                  __byte_perm(top[2], top[3], 0x73), 0x5410);
  const unsigned hi = __byte_perm(__byte_perm(top[4], top[5], 0x73),
                                  __byte_perm(top[6], top[7], 0x73), 0x5410);
  const unsigned long long d = (((unsigned long long)hi << 32) | lo) ^ x;
  const unsigned long long e = ~(d | (d >> 1)) & 0x5555555555555555ull;
  const unsigned m =
      even_bits((unsigned)e) | (even_bits((unsigned)(e >> 32)) << 16);
  unsigned gb = 0;
  if (any_n) {                          // bit 2 of each byte, by a multiply
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const unsigned g = __funnelshift_r(wd[i], wd[i + 1], sh);
      gb |= (((g & 0x04040404u) * 0x04081020u) >> 28) << (4 * i);
    }
  }
  *gbad = gb;
  return m & ~gb;
}

// A word's mismatches covered by a valid window j in [t-k+1, t] within
// [0, W) (*cmm; vd_prev the previous word's valid windows), and of them the
// substitutions (the read and the genome base both valid).
__device__ __forceinline__ unsigned substitutions(unsigned mt, unsigned bad,
                                                  unsigned gbad, unsigned vd,
                                                  unsigned vd_prev, int L,
                                                  int t0, int k,
                                                  unsigned* cmm) {
  *cmm = ~mt & below(L, t0) &
         dilate(((unsigned long long)vd << 32) | vd_prev, k);
  return *cmm & ~(bad | gbad);
}

// One edge of a clean run mapped to genome position q: a low edge adds +1
// at R(q - 1) (0 where q <= 0), a high edge -1 at R(q), q clamped to the
// genome as the group kernel clamps its pairs.
__device__ __forceinline__ void run_edge(const Params& p, int q, bool low) {
  if (low) {
    const int ql = q - 1 < 0 ? 0 : q - 1 > p.glen - 1 ? p.glen - 1 : q - 1;
    atomicAdd(p.diff + (q <= 0 ? 0u : rank_at(p.dblock, ql)), 1u);
  } else {
    const int qh = q < 0 ? 0 : q > p.glen - 1 ? p.glen - 1 : q;
    atomicAdd(p.diff + rank_at(p.dblock, qh), 0xFFFFFFFFu);
  }
}

__device__ __forceinline__ int warp_sum(unsigned v) {
  return (int)__reduce_add_sync(kFull, v);
}

// A read of L > 1,024 bases per block: steps 1-7 of the group kernel, each
// warp on its tiles of 1,024 bases, the tiles' words loaded once and kept
// in registers, what crosses a tile boundary exchanged through shared
// memory between the phases (see the header).
// At most 32 registers a thread where a warp holds one tile, so that 32
// blocks of 2 warps (rows of 2,048) or 4 of 16 (rows of 16,384) fit an
// SM's 65,536 registers; at most 64 where it holds four.
template <int BR, bool LENS, bool GIVEN, int TPW>
__global__ void __launch_bounds__(32 * kWideWarps, TPW == 1 ? 4 : 2)
    anchored_wide_kernel(const typename LaunchParams<GIVEN>::type p) {
  extern __shared__ TileEdge edge[];    // [ceil(L / kTileL)]
  __shared__ WideSums sums;
  const int r = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int L = p.L, k = p.k, W = L - k + 1;
  // the tiles that hold a base of the read: in the lens format none past
  // its length, whose warps skip every phase and keep only the barriers
  int n_live = (L + kTileL - 1) / kTileL;
  if (LENS) {
    const int len = __ldg((const uint16_t*)p.aux + r);
    n_live = min(n_live, (len + kTileL - 1) / kTileL);
  }
  if (threadIdx.x == 0) sums = WideSums{};

  // 1. the codes and invalid bases of the warp's live tiles (all invalid
  //    past them); lane 0 publishes its own
  unsigned long long code[TPW];
  unsigned bad[TPW];
#pragma unroll
  for (int j = 0; j < TPW; ++j) {
    const int t = warp + j * nw, w = (t << 5) + lane;
    code[j] = 0ull;
    bad[j] = 0xFFFFFFFFu;
    if (t < n_live && (w << 5) < L) {
      code[j] = word_code(p, r, w);
      bad[j] = word_bad<LENS>(p, r, w);
    }
    if (t < n_live && lane == 0) {
      edge[t].code0 = code[j];
      edge[t].bad0 = bad[j];
    }
  }

  // 2. anchors (warp 0, lane i anchor i from the packed row) and the vote
  if (warp == 0) {
    bool f = false;
    unsigned pos = 0;
    if (lane < p.n_anchors) {
      bool valid;
      const unsigned long long x =
          anchor_window<LENS>(p, r, anchor_at(p, lane), &valid);
      if (valid) {
        if constexpr (GIVEN) {
          f = __ldg(p.afound + (size_t)lane * p.R + r) != 0;
          pos = f ? __ldg(p.apos + (size_t)lane * p.R + r) : 0u;
        } else {
          unsigned rk;
          f = qm2t::packed_probe(p.rows, qm2t::canonical_lsb(x, k),
                                 p.bucket_mask, &rk, &pos);
        }
      }
    }
    bool av[kMaxAnchors];
    int ps[kMaxAnchors];
#pragma unroll
    for (int i = 0; i < kMaxAnchors; ++i) {
      av[i] = __shfl_sync(kFull, (int)f, i) != 0 && i < p.n_anchors;
      ps[i] = __shfl_sync(kFull, (int)pos, i);
    }
    int best_pos, best_off;
    const bool found = vote(p, av, ps, &best_pos, &best_off);
    if (lane == 0) {
      sums.found = found;
      sums.best_pos = best_pos;
      sums.best_off = best_off;
    }
  }
  __syncthreads();

  if (!sums.found) {
    // unanchored: code 2 where the read has a valid window, else 0
    bool any = false;
#pragma unroll
    for (int j = 0; j < TPW; ++j) {
      const int t = warp + j * nw, t0 = ((t << 5) + lane) << 5;
      if (t < n_live) {
        const unsigned dn = __shfl_down_sync(kFull, bad[j], 1);
        const unsigned bn = lane < 31 ? dn
                            : t + 1 < n_live ? edge[t + 1].bad0
                                              : 0xFFFFFFFFu;
        any = any || (win_and(~bad[j], ~bn, k) & below(W, t0)) != 0u;
      }
    }
    any = __syncthreads_or(any);
    if (threadIdx.x == 0) p.code[r] = any ? 2 : 0;
    return;
  }

  // 3. both strands against the genome, each tile's genome words loaded
  //    once; the match counts summed over the block; forward wins ties
  const int s_f = sums.best_pos - (k - 1) - sums.best_off;
  const int ge = sums.best_pos + sums.best_off;
  const bool fwd_in = s_f >= 0 && s_f + L <= p.glen;
  const bool rc_in = ge - (L - 1) >= 0 && ge < p.glen;
  const unsigned* tw = (const unsigned*)p.tiles;
  unsigned mf[TPW], gbf[TPW], mr[TPW], gbr[TPW];
  int cnt_f = 0, cnt_r = 0;
#pragma unroll
  for (int j = 0; j < TPW; ++j) {
    const int t = warp + j * nw, t0 = ((t << 5) + lane) << 5;
    mf[j] = gbf[j] = mr[j] = gbr[j] = 0u;
    if (t < n_live && ~bad[j]) {
      if (fwd_in) {
        mf[j] = genome_match(tw, p.glen >> 2, s_f + t0, code[j], &gbf[j]);
      }
      if (rc_in) {                      // bit m there is read base 31 - m
        unsigned g;
        mr[j] = __brev(genome_match(tw, p.glen >> 2, ge - t0 - 31,
                                    revcomp32(code[j]), &g));
        gbr[j] = __brev(g);
      }
      mf[j] &= ~bad[j];
      mr[j] &= ~bad[j];
      cnt_f += __popc(mf[j]);
      cnt_r += __popc(mr[j]);
    }
    if (t < n_live && lane == 0) {
      edge[t].mf0 = mf[j];
      edge[t].mr0 = mr[j];
    }
  }
  cnt_f = warp_sum(cnt_f);
  cnt_r = warp_sum(cnt_r);
  if (lane == 0) {
    atomicAdd(&sums.cnt_f, cnt_f);
    atomicAdd(&sums.cnt_r, cnt_r);
  }
  __syncthreads();
  const bool fwd = sums.cnt_f >= sums.cnt_r;
  if (BR == kNeighbor && !(fwd ? fwd_in : rc_in)) {
    // spilled, unanchorable (anyvalid holds: an anchor is valid)
    if (threadIdx.x == 0) p.code[r] = 2;
    return;
  }

  // 4. the chosen strand's clean and dirty windows and their run ends
  //    (the next word of lane 31 is the next tile's lane 0); lane 31
  //    publishes its words, and in kRuns each tile its last window that is
  //    not dirty
  const unsigned kmask = k == 32 ? 0xFFFFFFFFu : (1u << k) - 1u;
  unsigned mt[TPW], gbad[TPW], vd[TPW], cl[TPW], dw[TPW], cend[TPW],
      dend[TPW];
#pragma unroll
  for (int j = 0; j < TPW; ++j) {
    const int t = warp + j * nw, t0 = ((t << 5) + lane) << 5;
    mt[j] = fwd ? mf[j] : mr[j];        // 0 when out of range
    gbad[j] = fwd ? gbf[j] : gbr[j];
    vd[j] = cl[j] = dw[j] = cend[j] = dend[j] = 0u;
    if (t < n_live) {
      const unsigned bad_dn = __shfl_down_sync(kFull, bad[j], 1);
      const unsigned mt_dn = __shfl_down_sync(kFull, mt[j], 1);
      unsigned bad_next = bad_dn, mt_next = mt_dn;
      if (lane == 31) {
        const bool last = t + 1 == n_live;
        bad_next = last ? 0xFFFFFFFFu : edge[t + 1].bad0;
        mt_next = last ? 0u : fwd ? edge[t + 1].mf0 : edge[t + 1].mr0;
      }
      vd[j] = win_and(~bad[j], ~bad_next, k) & below(W, t0);
      cl[j] = vd[j] & win_and(mt[j], mt_next, k);
      dw[j] = vd[j] & ~cl[j];
      // the next word's first window: that word's bits 0..k-1
      const unsigned vd_n = t0 + 32 < W && (~bad_next & kmask) == kmask;
      const unsigned cl_n = vd_n & ((mt_next & kmask) == kmask);
      const unsigned dw_n = vd_n & ~cl_n;
      cend[j] = cl[j] & ~((cl[j] >> 1) | (cl_n << 31));
      dend[j] = dw[j] & ~((dw[j] >> 1) | (dw_n << 31));
      unsigned sub31 = 0u;
      if (BR == kNeighbor) {            // lane 31's previous word: lane 30
        const unsigned vd_up = __shfl_up_sync(kFull, vd[j], 1);
        unsigned cmm;
        sub31 = substitutions(mt[j], bad[j], gbad[j], vd[j], vd_up, L, t0,
                              k, &cmm) &
                below(W, t0);
      }
      int clear = -1;
      if (BR == kRuns) {
        const unsigned nd = ~dw[j];
        clear = __reduce_max_sync(kFull, nd ? t0 + 31 - __clz(nd) : -1);
      }
      if (lane == 31) {
        edge[t].vd31 = vd[j];
        edge[t].cl31 = cl[j];
        edge[t].dw31 = dw[j];
        edge[t].sub31 = sub31;
        edge[t].clear = clear;
      }
    }
  }
  __syncthreads();

  // 5. the spill decision over the whole read: the runs' starts (lane 0's
  //    previous word is the previous tile's lane 31), the branch's counts
  //    and checks summed and or-ed over the block
  unsigned cstart[TPW];
  int n_runs = 0, n_dirty = 0, n_druns = 0;
  bool over = false;
#pragma unroll
  for (int j = 0; j < TPW; ++j) {
    const int t = warp + j * nw, t0 = ((t << 5) + lane) << 5;
    cstart[j] = 0u;
    if (t < n_live) {
      const unsigned vd_up = __shfl_up_sync(kFull, vd[j], 1);
      const unsigned cl_up = __shfl_up_sync(kFull, cl[j], 1);
      const unsigned dw_up = __shfl_up_sync(kFull, dw[j], 1);
      unsigned vd_prev = vd_up, cl_prev = cl_up, dw_prev = dw_up;
      if (lane == 0) {
        vd_prev = t == 0 ? 0u : edge[t - 1].vd31;
        cl_prev = t == 0 ? 0u : edge[t - 1].cl31;
        dw_prev = t == 0 ? 0u : edge[t - 1].dw31;
      }
      cstart[j] = cl[j] & ~((cl[j] << 1) | (cl_prev >> 31));
      n_runs += __popc(cstart[j]);
      if (BR == kPoint) {
        n_dirty += __popc(dw[j]);
      } else if (BR == kRuns) {
        const unsigned dstart = dw[j] & ~((dw[j] << 1) | (dw_prev >> 31));
        n_druns += __popc(dstart);
        // a dirty run ending at e starts after the last window at or
        // before e that is not dirty: in this lane, an earlier lane or an
        // earlier tile
        int before = -1;
        for (int i = lane; i < t; i += 32) {
          before = max(before, edge[i].clear);
        }
        before = __reduce_max_sync(kFull, before);
        const unsigned nd = ~dw[j];
        int last = nd ? t0 + 31 - __clz(nd) : -1;
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kFull, last, o);
          if (lane >= o && y > last) last = y;
        }
        const int up = __shfl_up_sync(kFull, last, 1);
        const int prior = lane > 0 && up > before ? up : before;
        for (unsigned e = dend[j]; e; e &= e - 1) {
          const int b = __ffs(e) - 1;
          const unsigned m = nd & ((1u << b) - 1u);
          const int q = m ? t0 + 31 - __clz(m) : prior;
          over = over || t0 + b - q > p.dirty_run_width;
        }
      } else {
        // a mismatch that is no substitution, two substitutions closer
        // than k (positions below W, as the JAX prefix counts clip them),
        // or a set neighbor bit
        unsigned cmm;
        const unsigned sub = substitutions(mt[j], bad[j], gbad[j], vd[j],
                                           vd_prev, L, t0, k, &cmm);
        const unsigned sub_w = sub & below(W, t0);
        const unsigned sub_up = __shfl_up_sync(kFull, sub_w, 1);
        const unsigned sub_prev =
            lane > 0 ? sub_up : t == 0 ? 0u : edge[t - 1].sub31;
        const unsigned long long pair =
            ((unsigned long long)sub_w << 32) | sub_prev;
        bool bad_mm = (cmm & (bad[j] | gbad[j])) != 0u ||
                      (k > 1 && (sub_w & dilate(pair << 1, k - 1)) != 0u);
        for (unsigned s = sub; s && !bad_mm; s &= s - 1) {
          const int b = __ffs(s) - 1;
          const unsigned cb = (unsigned)(code[j] >> (2 * b)) & 3u;
          const unsigned g =
              __ldg(p.tiles + (fwd ? s_f + t0 + b : ge - t0 - b));
          bad_mm = (g >> (3 + (fwd ? cb : cb ^ 2u))) & 1u;
        }
        over = over || bad_mm;
      }
    }
  }
  n_runs = warp_sum(n_runs);
  if (BR == kPoint) n_dirty = warp_sum(n_dirty);
  if (BR == kRuns) n_druns = warp_sum(n_druns);
  over = __any_sync(kFull, over);
  if (lane == 0) {
    atomicAdd(&sums.n_runs, n_runs);
    if (BR == kPoint) atomicAdd(&sums.n_dirty, n_dirty);
    if (BR == kRuns) atomicAdd(&sums.n_druns, n_druns);
    if (over) sums.over = 1;
  }
  __syncthreads();
  bool spilled = sums.n_runs > p.max_runs || sums.over != 0;
  if (BR == kPoint) spilled = spilled || sums.n_dirty > p.max_dirty;
  if (BR == kRuns) spilled = spilled || sums.n_druns > p.max_dirty_runs;
  if (threadIdx.x == 0) p.code[r] = spilled ? 1 : 0;
  if (spilled) return;

  // 6. the adds: each clean run's edges (GIVEN: on the first block only;
  //    they come from the replicated dblock) and, in kPoint and kRuns,
  //    each dirty window probed, a tile's dealt round its warp
  bool ranges = true;
  if constexpr (GIVEN) ranges = p.ranges;
  if (BR == kNeighbor && !ranges) return;
  const unsigned trash = (unsigned)p.n_diff - 1;
#pragma unroll
  for (int j = 0; j < TPW; ++j) {
    const int t = warp + j * nw, t0 = ((t << 5) + lane) << 5;
    if (t >= n_live) continue;
    if (ranges) {
      // forward: a start is the run's low edge at s_f + st + k - 1, an end
      // its high edge; reverse: an end is the low edge at ge - e, a start
      // the high edge at ge - st
      for (unsigned s = cstart[j]; s; s &= s - 1) {
        const int b = t0 + __ffs(s) - 1;
        run_edge(p, fwd ? s_f + b + (k - 1) : ge - b, fwd);
      }
      for (unsigned s = cend[j]; s; s &= s - 1) {
        const int b = t0 + __ffs(s) - 1;
        run_edge(p, fwd ? s_f + b + (k - 1) : ge - b, !fwd);
      }
    }
    if (BR != kNeighbor) {
      const int mine = __popc(dw[j]);
      int incl = mine;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      const int excl = incl - mine;
      const int n_tile = __shfl_sync(kFull, incl, 31);
      const unsigned long long code_n0 =
          t + 1 < n_live ? edge[t + 1].code0 : 0ull;
      for (int base = 0; base < n_tile; base += 32) {
        const int m = base + lane;
        int o = 0;                      // the last lane whose excl <= m
        for (int step = 16; step > 0; step >>= 1) {
          const int ex = __shfl_sync(kFull, excl, o + step);
          if (ex <= m) o += step;
        }
        unsigned d = __shfl_sync(kFull, dw[j], o);
        const int ex_o = __shfl_sync(kFull, excl, o);
        const unsigned long long c0 = __shfl_sync(kFull, code[j], o);
        const unsigned long long c1x =
            __shfl_sync(kFull, code[j], o + 1 < 32 ? o + 1 : o);
        const unsigned long long c1 = o == 31 ? code_n0 : c1x;
        if (m < n_tile) {
          for (int i = m - ex_o; i > 0; --i) d &= d - 1;
          const int s = 2 * (__ffs(d) - 1);
          const unsigned long long y = s ? (c0 >> s) | (c1 << (64 - s)) : c0;
          unsigned rk, at;
          bool hit;
          if constexpr (GIVEN) {
            hit = block_probe(p, qm2t::canonical_lsb(y, k), &rk, &at);
          } else {
            hit = qm2t::packed_probe(p.rows, qm2t::canonical_lsb(y, k),
                                     p.bucket_mask, &rk, &at);
          }
          if (hit) {
            add_range(p.diff, rk, rk + 1 < trash ? rk + 1 : trash);
          }
        }
      }
    }
  }
}

// The threads of a wide row's block: a warp a tile, at most kWideWarps.
inline int wide_threads(int L) {
  const int n_tiles = (L + kTileL - 1) / kTileL;
  return 32 * (n_tiles < kWideWarps ? n_tiles : kWideWarps);
}

template <int BR, bool LENS, bool GIVEN>
void launch_wide(const typename LaunchParams<GIVEN>::type& p,
                 cudaStream_t stream) {
  const int n_tiles = (p.L + kTileL - 1) / kTileL;
  const size_t smem = n_tiles * sizeof(TileEdge);
  if (n_tiles <= kWideWarps) {
    anchored_wide_kernel<BR, LENS, GIVEN, 1>
        <<<p.R, wide_threads(p.L), smem, stream>>>(p);
  } else {
    anchored_wide_kernel<BR, LENS, GIVEN, kWideTPW>
        <<<p.R, wide_threads(p.L), smem, stream>>>(p);
  }
}

template <int BR, bool GIVEN>
cudaError_t launch(const typename LaunchParams<GIVEN>::type& p, bool lens,
                   cudaStream_t stream) {
  if (p.L > kTileL) {                   // a block a read
    if (lens) {
      launch_wide<BR, true, GIVEN>(p, stream);
    } else {
      launch_wide<BR, false, GIVEN>(p, stream);
    }
    return cudaGetLastError();
  }
  const long long threads = (long long)p.R * p.lanes;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  if (lens) {
    anchored_kernel<BR, true, GIVEN><<<blocks, kThreads, 0, stream>>>(p);
  } else {
    anchored_kernel<BR, false, GIVEN><<<blocks, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

template <bool GIVEN>
int launch_branch(const typename LaunchParams<GIVEN>::type& p, int branch,
                  bool lens, cudaStream_t s) {
  if (branch == kNeighbor) return (int)launch<kNeighbor, GIVEN>(p, lens, s);
  if (branch == kPoint) return (int)launch<kPoint, GIVEN>(p, lens, s);
  return (int)launch<kRuns, GIVEN>(p, lens, s);
}

// K3a: anchor i of read r (thread r * A + i) in one bucket block: found[i,
// r] = 1 and pos[i, r] = the entry's genome end position where the anchor
// window is valid and its canonical code sits in the block, else 0 and 0.
template <bool LENS>
__global__ void __launch_bounds__(kThreads)
anchor_probe_kernel(const Params p, const BlockProbe eng,
                    uint8_t* __restrict__ found, unsigned* __restrict__ pos) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= (unsigned)(p.R * p.n_anchors)) return;   // < 2^31 (the entry)
  const int r = (int)(t / (unsigned)p.n_anchors);
  const int i = (int)t - r * p.n_anchors;
  const int a = anchor_at(p, i);     // a + k <= L
  bool valid;
  const unsigned long long x = anchor_window<LENS>(p, r, a, &valid);
  unsigned rk, ps = 0;
  bool f = false;
  if (valid) {
    const unsigned long long canon = qm2t::canonical_lsb(x, p.k);
    f = canon != 0 && eng.probe_pos(canon, &rk, &ps) >= 0;
  }
  found[(size_t)i * p.R + r] = f;
  pos[(size_t)i * p.R + r] = f ? ps : 0u;
}

// The checks and Params common to every launch; returns 0 or a CUDA error.
int setup(Params* p, const void* pk, const void* aux, const void* rows,
          long long n_buckets, int R, int L, int k, int n_anchors, int a0,
          int a1, int a2, int a3) {
  const int W = L - k + 1;
  const int anchors[kMaxAnchors] = {a0, a1, a2, a3};
  if (k < 1 || k > 32 || L > kMaxRowL || W < 1 || R < 1 || n_anchors < 1 ||
      n_anchors > kMaxAnchors || n_buckets < 1 || n_buckets > (1LL << 32) ||
      (n_buckets & (n_buckets - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < n_anchors; ++i) {
    if (anchors[i] < 0 || anchors[i] >= W) return (int)cudaErrorInvalidValue;
  }
  *p = Params{};
  p->pk = (const uint8_t*)pk;
  p->aux = (const uint8_t*)aux;
  p->rows = (const uint4*)rows;
  p->R = R;
  p->L = L;
  p->k = k;
  p->lanes = 1;           // the group's lanes (a wide row takes a warp)
  while (32 * p->lanes < L && p->lanes < 32) p->lanes *= 2;
  p->pk8 = (uintptr_t)pk % 8 == 0 && ((L + 3) >> 2) % 8 == 0;
  p->aux4 = (uintptr_t)aux % 4 == 0 && ((L + 7) >> 3) % 4 == 0;
  p->bucket_mask = (unsigned)(n_buckets - 1);
  p->n_anchors = n_anchors;
  p->a0 = a0;
  p->a1 = a1;
  p->a2 = a2;
  p->a3 = a3;
  return 0;
}

// The block [blk_lo, blk_lo + block_buckets) of a table of n_buckets.
bool bad_block(long long n_buckets, long long blk_lo,
               long long block_buckets) {
  return block_buckets < 1 || blk_lo < 0 || blk_lo + block_buckets > n_buckets;
}

// The rest of K3's Params and checks; returns 0 or a CUDA error.
int setup_pass(Params* p, const void* tiles, long long G, const void* dblock,
               void* diff, long long n_diff, void* code, int max_runs,
               int max_dirty, int max_dirty_runs, int dirty_run_width,
               int branch) {
  if (G < p->L || G > 0x7FFFFFFFLL || G % 64 != 0 || n_diff < 2 ||
      n_diff > 0x7FFFFFFFLL || branch < 0 || branch > 2 ||
      (uintptr_t)tiles % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  p->tiles = (const uint8_t*)tiles;
  p->dblock = (const uint4*)dblock;
  p->diff = (unsigned*)diff;
  p->code = (int8_t*)code;
  p->glen = (int)G;
  p->n_diff = (int)n_diff;
  p->max_runs = max_runs;
  p->max_dirty = max_dirty;
  p->max_dirty_runs = max_dirty_runs;
  p->dirty_run_width = dirty_run_width;
  return 0;
}

}  // namespace

extern "C" const char* qm2t_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// pk u8[R, ceil(L/4)]; aux u16[R] (lens = 1) or u8[R, ceil(L/8)] (lens = 0);
// rows u32[n_buckets, 8]; tiles u8[G] (G a multiple of 64);
// dblock u32[>= G/64, 4]; diff u32[n_diff] (updated in place); code i8[R]
// (written in full). branch: 0 neighbor, 1 point probes, 2 run-sliced
// (tier 2).
extern "C" int qm2t_anchored(const void* pk, const void* aux, int lens,
                             const void* rows, long long n_buckets,
                             const void* tiles, long long G,
                             const void* dblock, void* diff, long long n_diff,
                             void* code, int R, int L, int k, int n_anchors,
                             int a0, int a1, int a2, int a3, int max_runs,
                             int max_dirty, int max_dirty_runs,
                             int dirty_run_width, int branch, void* stream) {
  Params p;
  int rc = setup(&p, pk, aux, rows, n_buckets, R, L, k, n_anchors, a0, a1,
                 a2, a3);
  if (rc == 0) {
    rc = setup_pass(&p, tiles, G, dblock, diff, n_diff, code, max_runs,
                    max_dirty, max_dirty_runs, dirty_run_width, branch);
  }
  if (rc != 0) return rc;
  return launch_branch<false>(p, branch, lens != 0, (cudaStream_t)stream);
}

// K3 on one bucket block of a dict-sharded table: rows u32[block_buckets,
// 8] holds buckets [blk_lo, blk_lo + block_buckets) of n_buckets; afound
// u8[n_anchors, R] and apos u32[n_anchors, R] are the anchors' found / pos
// summed over every block (K3a's outputs); ranges 1 on the block that adds
// the clean runs. The rest as qm2t_anchored.
extern "C" int qm2t_anchored_block(
    const void* pk, const void* aux, int lens, const void* rows,
    long long n_buckets, long long blk_lo, long long block_buckets,
    const void* afound, const void* apos, int ranges, const void* tiles,
    long long G, const void* dblock, void* diff, long long n_diff,
    void* code, int R, int L, int k, int n_anchors, int a0, int a1, int a2,
    int a3, int max_runs, int max_dirty, int max_dirty_runs,
    int dirty_run_width, int branch, void* stream) {
  BlockParams p;
  int rc = setup(&p, pk, aux, rows, n_buckets, R, L, k, n_anchors, a0, a1,
                 a2, a3);
  if (rc == 0) {
    rc = setup_pass(&p, tiles, G, dblock, diff, n_diff, code, max_runs,
                    max_dirty, max_dirty_runs, dirty_run_width, branch);
  }
  if (rc == 0 && bad_block(n_buckets, blk_lo, block_buckets)) {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  p.afound = (const uint8_t*)afound;
  p.apos = (const unsigned*)apos;
  p.blk_lo = (unsigned)blk_lo;
  p.blk_last = (unsigned)(block_buckets - 1);
  p.ranges = ranges != 0;
  return launch_branch<true>(p, branch, lens != 0, (cudaStream_t)stream);
}

// K3a. pk, aux, rows (the block's), the block and the anchors as
// qm2t_anchored_block; displaced u32[2^filter_bits / 32] the block's bitmap
// of keys at h2; found u8[n_anchors, R] and pos u32[n_anchors, R] (written
// in full).
extern "C" int qm2t_anchor_probes(const void* pk, const void* aux, int lens,
                                  const void* rows, const void* displaced,
                                  int filter_bits, long long n_buckets,
                                  long long blk_lo, long long block_buckets,
                                  void* found, void* pos, int R, int L, int k,
                                  int n_anchors, int a0, int a1, int a2,
                                  int a3, void* stream) {
  Params p;
  int rc = setup(&p, pk, aux, rows, n_buckets, R, L, k, n_anchors, a0, a1,
                 a2, a3);
  if (rc == 0 && (bad_block(n_buckets, blk_lo, block_buckets) ||
                  filter_bits < 5 || filter_bits > 32 ||
                  (long long)R * n_anchors > 0x7FFFFFFFLL)) {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  const BlockProbe eng = {(const uint4*)rows, (const unsigned*)displaced,
                          p.bucket_mask, (unsigned)blk_lo,
                          (unsigned)(block_buckets - 1), 0,
                          32 - filter_bits};
  const long long threads = (long long)R * n_anchors;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (lens) {
    anchor_probe_kernel<true><<<blocks, kThreads, 0, s>>>(
        p, eng, (uint8_t*)found, (unsigned*)pos);
  } else {
    anchor_probe_kernel<false><<<blocks, kThreads, 0, s>>>(
        p, eng, (uint8_t*)found, (unsigned*)pos);
  }
  return (int)cudaGetLastError();
}
