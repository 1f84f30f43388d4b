"""The arithmetic of the card kernels' designs, pinned to the JAX package
on the CPU.

* K2's word-parallel codec: a window's bases are one funnel shift of two
  64-bit words of the packed batch, X = sum_j b_{i+j} << 2j; the reverse
  complement is X ^ 0xAAAA... and the forward code rev2(X) >> (64 - 2k)
  (a bit reverse, then the two bits of each pair swapped back); validity
  is the same funnel shift over the invalid bitmask. Written here in
  numpy, it equals quickmer2_tpu.ops.codec.sliding_kmers at every k the
  seams between the two 32-bit halves and the 64-bit words can cut.
* K2r's row-wise window map: lane i = r * W + j of R read rows of pitch
  L finds its row by a 32-bit multiply-high by floor((2^32 - 1) / W) and
  one correction, its window at bit 8 * ceil(L / 4) * r + 2j of the
  packed rows (a row starts inside a word where the pitch is not a
  multiple of 8 bytes) and its validity by the lens compare j + k <=
  len_r or a funnel shift of the mask bits at 8 * ceil(L / 8) * r + j,
  all read from the words a block of lanes stages. Written here in numpy,
  block by block, it equals quickmer2_tpu.ops.codec.sliding_kmers over
  rowpack.unpack_batch cut to W windows a row, and the staged words
  stay within the kernel's bound on them, whose worst case (W = 1, k =
  32) fits the shared memory the kernel gives them.
* The plain versions the card kernels are held against, at the shapes
  the new kernels branch on: join_compare_plain against the JAX
  _part_chunk_join with buckets of > 32 and > 1024 live pairs and words
  without a live query, at pads 64/32 and 128/64; count_mono_step_plain
  against the JAX count_step_mono_pk on one-slice (P = 1) and sliced
  (P >= 2) tables, at k = 15, 31 and 32, on batches that are not a
  multiple of 64 bases. Integer outputs: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickmer2_tpu.ops import codec as jcodec
from quickmer2_tpu.ops import hamming_join as jhj
from quickmer2_tpu.ops import monotable as jmono
from quickmer2_tpu.ops import rowpack as jrowpack
from quickmer2_tpu.pipelines import count as jcount
from quickmer2_tpu_torch.device import to_numpy_u32
from quickmer2_tpu_torch.kernels.count_mono import (
    count_mono_step_plain, partitions_for)
from quickmer2_tpu_torch.kernels.hamming_join import join_compare_plain
from quickmer2_tpu_torch.ops import hamming_join as thj
from quickmer2_tpu_torch.ops import rowpack

_REV8 = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)], np.uint8)
_M55 = np.uint64(0x5555555555555555)


def _batch(seed: int, n: int) -> np.ndarray:
    """Codes with read separators every 151 bases and 1 % N bases."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n).astype(np.uint8)
    g[150::151] = jcodec.SEP
    g[rng.random(n) < 0.01] = jcodec.SEP
    return g


def _words(a: np.ndarray, pad: int) -> np.ndarray:
    """Bytes → little-endian u64 words, two words of `pad` bytes past
    the end (K2 stages its span the same way)."""
    out = np.full(len(a) // 8 + 3, pad * 0x0101010101010101, np.uint64)
    out.view(np.uint8)[:len(a)] = a
    return out


def _funnel(w: np.ndarray, idx: np.ndarray, s: np.ndarray) -> np.ndarray:
    """Bits [s, s + 64) of the 128-bit value (w[idx + 1] : w[idx])."""
    lo, hi = w[idx], w[idx + 1]
    s = s.astype(np.uint64)
    up = hi << ((np.uint64(64) - s) & np.uint64(63))
    return np.where(s == 0, lo, (lo >> s) | up)


def _rev2(x: np.ndarray) -> np.ndarray:
    """The 32 2-bit lanes of x in reverse order: a bit reverse (bytes
    swapped, each byte's bits reversed), then each pair swapped back."""
    r = _REV8[x.byteswap().view(np.uint8)].view(np.uint64)
    return ((r >> np.uint64(1)) & _M55) | ((r & _M55) << np.uint64(1))


def word_parallel_kmers(batch: np.ndarray, k: int):
    """(canonical code u64[N], valid bool[N]), N = len - k + 1, by K2's
    word-parallel codec on the packed batch."""
    pk, bits = rowpack.pack_rows(batch[None, :])
    w2, wb = _words(pk[0], 0), _words(bits[0], 0xFF)
    i = np.arange(len(batch) - k + 1)
    x = _funnel(w2, i >> 5, 2 * (i & 31))
    inval = _funnel(wb, i >> 6, i & 63)
    valid = (inval & np.uint64((1 << k) - 1)) == 0
    mask = np.uint64((1 << (2 * k)) - 1)
    fwd = _rev2(x) >> np.uint64(64 - 2 * k)
    rc = (x ^ np.uint64(0xAAAAAAAAAAAAAAAA)) & mask
    return np.minimum(fwd, rc), valid


@pytest.mark.parametrize("k", [1, 15, 16, 17, 30, 31, 32])
def test_word_parallel_codec_matches_jax(k):
    batch = _batch(k, 3000 + 37)
    canon, valid = word_parallel_kmers(batch, k)
    chi, clo, jvalid = (np.asarray(a) for a in
                        jcodec.sliding_kmers(jnp.asarray(batch), k))
    want = (chi.astype(np.uint64) << np.uint64(32)) | clo.astype(np.uint64)
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_array_equal(canon[valid], want[jvalid])
    assert valid.any() and not valid.all()


ROW_TILE = 512           # csrc/count_mono.cu::kRowTile, K2r's lanes a block
ROW_STAGE_WORDS = 576    # csrc/count_mono.cu::kRowStageWords


def row_stage_words(tile: int, W: int, k: int, lens: bool) -> int:
    """csrc/count_mono.cu::row_stage_words: the most words a block of
    `tile` lanes stages in either stream."""
    D = (tile + W - 2) // W
    pk_bits = 2 * (tile - 1) + 2 * (k + 2) * D + 2 * k
    aux_bits = 16 * D + 16 if lens else tile - 1 + (k + 6) * D + k
    return (np.maximum(pk_bits, aux_bits) + 62) // 64 + 2


def row_window_kmers(fmt: str, pk: np.ndarray, aux: np.ndarray, L: int,
                     k: int, tile: int):
    """(canonical code u64[R*W], valid bool[R*W]) by K2r's window map,
    each lane reading the words its block of `tile` lanes stages (the
    arithmetic of csrc/count_mono.cu::RowWindows, in int64)."""
    R, W = pk.shape[0], L - k + 1
    lens = fmt == "lens"
    pitch, aux_pitch = -(-L // 4), 2 if lens else -(-L // 8)
    w2 = _words(pk.reshape(-1), 0)
    wa = _words(np.ascontiguousarray(aux).view(np.uint8).reshape(-1), 0xFF)
    n = R * W
    recip = (2**32 - 1) // W

    def row_of(i):
        q = (i * recip) >> 32
        return np.where(i - q * W >= W, q + 1, q)
    i = np.arange(n, dtype=np.int64)
    assert (row_of(i) == i // W).all()
    # the block's first and last lane, the bits it stages in each stream
    b0 = (i // tile) * tile
    b1 = np.minimum(b0 + tile, n) - 1
    r0, r1 = row_of(b0), row_of(b1)
    j0, j1 = b0 - r0 * W, b1 - r1 * W
    ps, pe = 8 * pitch * r0 + 2 * j0, 8 * pitch * r1 + 2 * (j1 + k)
    as_ = 8 * aux_pitch * r0 + (0 if lens else j0)
    ae = 8 * aux_pitch * r1 + (16 if lens else j1 + k)
    pk_count = ((pe - 1) >> 6) - (ps >> 6) + 2
    aux_count = ((ae - 1) >> 6) - (as_ >> 6) + 2
    bound = row_stage_words(tile, W, k, lens)
    assert pk_count.max() <= bound and aux_count.max() <= bound
    # each lane's bits, relative to its block's first staged word
    r = row_of(i)
    j = i - r * W
    pb = 8 * pitch * r0 - 64 * (ps >> 6) + 8 * pitch * (r - r0) + 2 * j
    ab = 8 * aux_pitch * r0 - 64 * (as_ >> 6) + 8 * aux_pitch * (r - r0)
    assert pb.min() >= 0 and ((pb >> 6) + 1 < pk_count).all()
    x = _funnel(w2, (ps >> 6) + (pb >> 6), pb & 63)
    if lens:
        assert (ab & 15).max() == 0 and ((ab >> 6) < aux_count).all()
        length = (wa[(as_ >> 6) + (ab >> 6)] >> (ab & 63).astype(np.uint64)
                  ) & np.uint64(0xFFFF)
        valid = j + k <= length.astype(np.int64)
    else:
        ab = ab + j
        assert ab.min() >= 0 and ((ab >> 6) + 1 < aux_count).all()
        inval = _funnel(wa, (as_ >> 6) + (ab >> 6), ab & 63)
        valid = (inval & np.uint64((1 << k) - 1)) == 0
    mask = np.uint64((1 << (2 * k)) - 1)
    fwd = _rev2(x) >> np.uint64(64 - 2 * k)
    rc = (x ^ np.uint64(0xAAAAAAAAAAAAAAAA)) & mask
    return np.minimum(fwd, rc), valid


def _read_rows(fmt: str, R: int, L: int, seed: int) -> np.ndarray:
    """Rows of random codes: lens, suffix-padded with SEP at random
    lengths (a third of the rows full); mask, SEP bases anywhere."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 4, (R, L)).astype(np.uint8)
    if fmt == "lens":
        cut = rng.integers(0, L + 1, R)
        cut[: R // 3] = L
        rows[np.arange(L)[None, :] >= cut[:, None]] = jcodec.SEP
    else:
        rows[rng.random(rows.shape) < 0.02] = jcodec.SEP
        rows[0] = jcodec.SEP
    return rows


@pytest.mark.parametrize("k", [15, 31, 32])
@pytest.mark.parametrize("L", [64, 150, 160])
@pytest.mark.parametrize("fmt", ["lens", "mask"])
def test_row_window_map_matches_jax(fmt, L, k):
    R = 93                                  # R * W is no multiple of 32
    rows = _read_rows(fmt, R, L, 1000 * L + k)
    got_fmt, pk, aux = rowpack.pack_batch(rows)
    assert got_fmt == fmt
    W = L - k + 1
    reads = jrowpack.unpack_batch(fmt, jnp.asarray(pk), jnp.asarray(aux),
                                  read_len=L)
    chi, clo, jvalid = (np.asarray(a) for a in
                        jcodec.sliding_kmers(reads.reshape(-1), k))

    def cut(a):
        out = np.zeros(R * L, a.dtype)
        out[: len(a)] = a
        return out.reshape(R, L)[:, :W].reshape(-1)
    chi, clo, jvalid = cut(chi), cut(clo), cut(jvalid)
    want = (chi.astype(np.uint64) << np.uint64(32)) | clo.astype(np.uint64)
    assert (R * W) % 32 and jvalid.any() and not jvalid.all()
    canon, valid = row_window_kmers(fmt, pk, aux, L, k, ROW_TILE)
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_array_equal(canon[valid], want[jvalid])


@pytest.mark.parametrize("lens", [True, False])
def test_row_stage_bound_fits_every_shape(lens):
    """The kernel's static_assert checks the bound at W = 1, k = 32
    only; over every row width and k it accepts, the bound peaks there."""
    W = np.arange(1, 65536, dtype=np.int64)
    worst = max(int(row_stage_words(ROW_TILE, W, k, lens).max())
                for k in range(1, 33))
    assert worst == row_stage_words(ROW_TILE, 1, 32, lens)
    assert row_stage_words(ROW_TILE, 1, 32, False) <= ROW_STAGE_WORDS


def _planted_join_world(seed: int, k: int = 15):
    """Words W = [uniq, rc(uniq)] and singleton queries of a random
    genome, plus three planted part-0 buckets: 70 words with 60 queries
    one base from them (> 1024 pairs at either pad pair), 3 words with
    12 queries (36 > 32 pairs), 10 words and no query."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, 1000).astype(np.uint8)
    canon, valid = jcodec.sliding_kmers_np(g, k)
    uniq, cnt = np.unique(canon[valid & (canon != 0)], return_counts=True)
    occ = np.minimum(cnt, 255).astype(np.uint8)
    w = np.concatenate([uniq, jhj._rc_np(uniq, k)])
    wocc = np.concatenate([occ, occ])
    queries = uniq[occ == 1]
    s, t = jhj.part_ranges(k)[0]
    width = 2 * (t - s)

    def part0(codes):
        return (codes >> np.uint64(2 * s)) & np.uint64((1 << width) - 1)
    used = set(part0(w).tolist()) | set(part0(queries).tolist())
    free = [v for v in range(1 << width) if v not in used][:3]
    assert len(free) == 3
    top = np.uint64(((1 << (2 * k)) - 1) ^ ((1 << width) - 1))

    def planted(v, n):
        rest = rng.integers(0, 1 << 62, n, dtype=np.int64).astype(np.uint64)
        return np.unique((rest & top) | np.uint64(v))[:n]

    def near(words, n):
        src = words[np.arange(n) % len(words)]
        pos = np.uint64(2) * rng.integers(width // 2, k, n).astype(np.uint64)
        return src ^ (np.uint64(1) << pos)
    big, small, lone = planted(free[0], 70), planted(free[1], 3), \
        planted(free[2], 10)
    w = np.concatenate([w, big, small, lone])
    wocc = np.concatenate([wocc, rng.integers(1, 256, 83).astype(np.uint8)])
    queries = np.concatenate([queries, near(big, 60), near(small, 12)])
    return w, wocc, queries


@pytest.mark.parametrize("cpad,cpad_q", [(64, 32), (128, 64)])
def test_join_plain_matches_jax_at_branch_shapes(cpad, cpad_q):
    k, e = 15, 2
    w, wocc, queries = _planted_join_world(cpad, k)
    whi, wlo = jcodec.split_u64(w)
    qhi, qlo = jcodec.split_u64(queries)
    s, t = jhj.part_ranges(k)[0]
    wslot = jhj._slots_u8(jhj._extract_part_np(whi, wlo, s, t))
    qslot = jhj._slots_u8(jhj._extract_part_np(qhi, qlo, s, t))
    B = 1 << (2 * (t - s))
    masks = jhj._part_masks(k)
    mask_kw = {f"mask_{x}{i}": int(masks[i][j])
               for i in range(3) for j, x in enumerate(("hi", "lo"))}
    want = np.asarray(jhj._part_chunk_join(
        jnp.asarray(whi), jnp.asarray(wlo), jnp.asarray(wocc),
        jnp.asarray(wslot), jnp.asarray(qhi), jnp.asarray(qlo),
        jnp.asarray(qslot), jnp.zeros(len(queries) + 1, jnp.uint32),
        jnp.uint32(2 * s), B=B, cpad=cpad, cpad_q=cpad_q, slab=64, e=e,
        width=2 * (t - s), **mask_kw))

    def i64(a):
        return torch.from_numpy(np.asarray(a).astype(np.int64))
    layouts = thj._bucket_layouts(
        i64(whi), i64(wlo), torch.from_numpy(wocc), torch.from_numpy(wslot),
        i64(qhi), i64(qlo), torch.from_numpy(qslot), lo_bit=2 * s,
        width=2 * (t - s), n_buckets=B, cpad=cpad, cpad_q=cpad_q)
    nq = len(queries)
    live_w = (layouts[2][:-1].view(B, cpad) != 0).sum(1)
    live_q = (layouts[5][:-1].view(B, cpad_q) != nq).sum(1)
    pairs = live_w * live_q
    assert int(pairs.max()) > 1024 and ((pairs > 32) & (pairs < 64)).any()
    assert ((live_w > 0) & (live_q == 0)).any()
    scaled = torch.zeros(nq + 1, dtype=torch.int64)
    join_compare_plain(*layouts, scaled, e=e, masks=thj._part_masks(k),
                       n_buckets=B, cpad=cpad, cpad_q=cpad_q)
    got = to_numpy_u32(scaled)
    # lane nq is the trash lane: JAX adds hole lanes there, the port not
    np.testing.assert_array_equal(got[:-1], want[:-1])
    assert want[-73:-1].any()


@pytest.mark.parametrize("k,n_bases,load,parts", [
    (15, 3 * 4096 + 13, 2.0, 1), (31, 5000 + 1, 0.001, 2),
    (32, 2 * 4096 + 37, 2.0, 1), (32, 4096 + 63, 0.0005, 4)])
def test_count_plain_matches_jax_at_branch_shapes(k, n_bases, load, parts):
    g = _batch(100 + k, 6000)
    canon, valid = jcodec.sliding_kmers_np(g, k)
    kmers = np.unique(canon[valid & (canon != 0)])
    hi, lo = jcodec.split_u64(kmers)
    table = jmono.MonoTable.build(hi, lo, load=load)
    assert partitions_for(table.n_buckets) == parts
    batch = _batch(200 + k, n_bases)
    batch[:3000] = g[:3000]                 # windows that hit
    pk, bits = rowpack.pack_rows(batch[None, :])
    n_slots = table.n_buckets * jmono.ENTRIES
    jdepth, jub = jcount.count_step_mono_pk(
        jnp.asarray(pk), jnp.asarray(bits), jnp.asarray(table.rows),
        jnp.zeros(n_slots + 1, jnp.uint32), k=k, n_buckets=table.n_buckets,
        n_bases=n_bases)
    depth = torch.zeros(n_slots + 1, dtype=torch.int64)
    mask = count_mono_step_plain(
        torch.from_numpy(pk[0]), torch.from_numpy(bits[0]),
        torch.from_numpy(table.rows.astype(np.int64)), depth, k=k,
        n_buckets=table.n_buckets, n_bases=n_bases)
    n = n_bases - k + 1
    want_depth = np.asarray(jdepth)[:-1]
    np.testing.assert_array_equal(to_numpy_u32(depth)[:-1], want_depth)
    got_unres = np.unpackbits(to_numpy_u32(mask).view(np.uint8),
                              bitorder="little")[:n]
    want_unres = np.unpackbits(np.asarray(jub))[:n]
    np.testing.assert_array_equal(got_unres, want_unres)
    assert want_depth.sum() > 0
    assert want_unres.any() == (load > 1)
