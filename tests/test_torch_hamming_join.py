"""Port Hamming join against the JAX package: the plain compare chain
on identical bucket layouts equals one _part_chunk_join call, the
layouts' wrapper (i') and its plain version on the CPU give the layouts
that the host's slots give, its ranks are the host's slots, and
hamming_neighbor_sums equals the JAX one (computing no host slots) with
forced slow paths, small query chunks, palindromes and self-pairs.
Integer sums: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickmer2_tpu.ops import codec as jcodec
from quickmer2_tpu.ops import hamming_join as jhj
from quickmer2_tpu_torch.device import to_numpy_u32
from quickmer2_tpu_torch.kernels.hamming_join import (
    bucket_layouts, bucket_layouts_plain, join_compare, rank_slots)
from quickmer2_tpu_torch.ops import hamming_join as thj
from tests import helpers
from tests.torch_threads import few_threads  # noqa: F401


def _world(seed: int, k: int, n_bases: int = 2500):
    """Distinct canonical k-mers + saturated counts of a genome with a
    mutated copy (dense ED1/ED2 neighborhoods), low-complexity tracts
    (bucket overflow) and planted palindromes."""
    rng = np.random.default_rng(seed)
    seq = helpers.random_genome(rng, n_bases)
    mutated = list(seq)
    for pos in rng.integers(0, len(seq), size=n_bases // 40):
        mutated[pos] = "ACGT"[rng.integers(0, 4)]
    half = helpers.random_genome(rng, k // 2)
    pal = half + helpers.revcomp(half)              # even k: palindrome
    genome = (seq + "".join(mutated) + "A" * 300 + "ACACACACAC" * 40
              + (pal + helpers.random_genome(rng, 7)) * 3)
    codes = jcodec.encode_bases(genome.encode())
    canon, valid = jcodec.sliding_kmers_np(codes, k)
    uniq, counts = np.unique(canon[valid & (canon != 0)], return_counts=True)
    return uniq, np.minimum(counts, 255).astype(np.uint8)


@pytest.mark.parametrize("k,e,part,cpad,cpad_q", [(15, 2, 0, 8, 4),
                                                  (16, 1, 1, 16, 8),
                                                  (17, 2, 2, 8, 8)])
def test_plain_chain_matches_part_chunk_join(k, e, part, cpad, cpad_q):
    uniq, occ = _world(k, k)
    w = np.concatenate([uniq, jhj._rc_np(uniq, k)])
    wocc = np.concatenate([occ, occ])
    queries = uniq[occ == 1]
    whi, wlo = jcodec.split_u64(w)
    qhi, qlo = jcodec.split_u64(queries)
    s, t = jhj.part_ranges(k)[part]
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
        jnp.uint32(2 * s), B=B, cpad=cpad, cpad_q=cpad_q, slab=min(B, 64),
        e=e, width=2 * (t - s), **mask_kw))

    def i64(a):
        return torch.from_numpy(np.asarray(a).astype(np.int64))
    layouts = thj._bucket_layouts(
        i64(whi), i64(wlo), torch.from_numpy(wocc), torch.from_numpy(wslot),
        i64(qhi), i64(qlo), torch.from_numpy(qslot), lo_bit=2 * s,
        width=2 * (t - s), n_buckets=B, cpad=cpad, cpad_q=cpad_q)
    scaled = torch.zeros(len(queries) + 1, dtype=torch.int64)
    join_compare(*layouts, scaled, e=e, masks=thj._part_masks(k),
                 n_buckets=B, cpad=cpad, cpad_q=cpad_q)
    got = to_numpy_u32(scaled)
    # lane nq is the trash lane: JAX adds hole lanes there, the port not
    np.testing.assert_array_equal(got[:-1], want[:-1])
    assert want[:-1].any()


def _layout_inputs(seed: int, n_crowd: int, query_stride: int):
    """One interleaved word chunk (a strided view of W = [uniq, rc(uniq)],
    as the join plan cuts it) and a query chunk at k = 16, part 0:
    n_crowd singletons share one part-0 key (a crowd past the pads) and
    planted palindromes make dead rc words. Returns (word codes, occ and
    live flags of the whole side, the chunk, query codes, part bits)."""
    k, part, n_chunks, c = 16, 0, 3, 1
    uniq, occ = _world(seed, k)
    rng = np.random.default_rng(seed)
    crowd = ((rng.integers(0, 1 << 20, n_crowd).astype(np.uint64)
              << np.uint64(12)) | np.uint64(0x5A5))
    half = rng.integers(0, 1 << 16, 30).astype(np.uint64)
    pal = (half << np.uint64(16)) | jhj._rc_np(half, 8)
    crowd = np.concatenate([crowd, pal[jhj._rc_np(pal, k) == pal]])
    uniq, first = np.unique(np.concatenate([uniq, crowd]), return_index=True)
    occ = np.concatenate([occ, np.ones(len(crowd), np.uint8)])[first]
    rc = jhj._rc_np(uniq, k)
    w = np.concatenate([uniq, rc])
    live = np.concatenate([np.ones(len(uniq), bool), rc != uniq])
    wocc = np.concatenate([occ, occ])
    whi, wlo = jcodec.split_u64(w)
    queries = uniq[occ == 1][::query_stride]
    qhi, qlo = jcodec.split_u64(queries)
    s, t = jhj.part_ranges(k)[part]
    return (whi, wlo, wocc, live, slice(c, len(w), n_chunks), qhi, qlo,
            (s, t))


def _i64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _host_slot_layouts(whi, wlo, wocc, live, chunk, qhi, qlo, s, t, cpad,
                       cpad_q):
    """The layouts from the host's slots (the JAX package's _slots_u8,
    dead words at 255) through _bucket_layouts: what the join took before
    i' ranked entries itself. Returns (layouts, word keys, word slots,
    query keys, query slots)."""
    keys = jhj._extract_part_np(whi, wlo, s, t)[chunk]
    wslot = np.full(len(keys), 255, np.uint8)
    wslot[live[chunk]] = jhj._slots_u8(keys[live[chunk]])
    qkeys = jhj._extract_part_np(qhi, qlo, s, t)
    qslot = jhj._slots_u8(qkeys)
    lay = thj._bucket_layouts(
        _i64(whi)[chunk], _i64(wlo)[chunk], torch.from_numpy(wocc)[chunk],
        torch.from_numpy(wslot), _i64(qhi), _i64(qlo),
        torch.from_numpy(qslot), lo_bit=2 * s, width=2 * (t - s),
        n_buckets=1 << (2 * (t - s)), cpad=cpad, cpad_q=cpad_q)
    return lay, keys, wslot, qkeys, qslot


@pytest.mark.parametrize("cpad,cpad_q", [(8, 4), (4, 8)])
def test_bucket_layouts_cpu_path_matches_plain(cpad, cpad_q):
    """i' (bucket_layouts) on the CPU, given each word's live flag and no
    slots, returns the tensors of _bucket_layouts fed the host's slots,
    exactly, on an interleaved word chunk (a strided view of the word
    side, as the join plan cuts it): every live entry whose rank among
    its key's live entries is below its pad at lane key * pad + rank,
    entries at and past the pads and the dead words (palindromes' rc
    words) out, the hole lanes empty, qidx the query's index in the
    chunk and nq elsewhere; cpad < cpad_q included."""
    whi, wlo, wocc, live, chunk, qhi, qlo, (s, t) = _layout_inputs(31, 60, 2)
    B = 1 << (2 * (t - s))
    want, keys, wslot, qkeys, qslot = _host_slot_layouts(
        whi, wlo, wocc, live, chunk, qhi, qlo, s, t, cpad, cpad_q)
    assert (wslot == 255).any() and ((wslot >= cpad) & (wslot < 255)).any()
    assert (qslot >= cpad_q).any()
    args = (_i64(whi)[chunk], _i64(wlo)[chunk], torch.from_numpy(wocc)[chunk],
            torch.from_numpy(live)[chunk], _i64(qhi), _i64(qlo))
    kw = dict(lo_bit=2 * s, width=2 * (t - s), n_buckets=B, cpad=cpad,
              cpad_q=cpad_q)
    got = bucket_layouts(*args, **kw)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype
        np.testing.assert_array_equal(g.numpy(), x.numpy())
    # the layouts by hand
    nq = len(qhi)
    lanes = [np.zeros(B * cpad + 1, np.int64) for _ in range(3)]
    qlanes = [np.zeros(B * cpad_q + 1, np.int64) for _ in range(2)]
    qidx = np.full(B * cpad_q + 1, nq, np.int64)
    sel = wslot < cpad
    lane = keys[sel].astype(np.int64) * cpad + wslot[sel]
    for a, v in zip(lanes, (whi[chunk], wlo[chunk], wocc[chunk])):
        a[lane] = v[sel]
    sel = qslot < cpad_q
    lane = qkeys[sel].astype(np.int64) * cpad_q + qslot[sel]
    for a, v in zip(qlanes, (qhi, qlo)):
        a[lane] = v[sel]
    qidx[lane] = np.flatnonzero(sel)
    for g, x in zip(got, lanes + qlanes + [qidx]):
        np.testing.assert_array_equal(g.numpy(), x)
    assert got[2][-1] == 0 and got[5][-1] == nq


@pytest.mark.parametrize("cpad,cpad_q,n_crowd", [(8, 4, 60), (4, 8, 60),
                                                 (64, 32, 220),
                                                 (240, 240, 760)])
def test_plain_layouts_match_host_slots(cpad, cpad_q, n_crowd):
    """i''s plain version (bucket_layouts_plain: a stable torch sort for
    the ranks, then _bucket_layouts) equals _bucket_layouts fed the
    host's _slots_u8 slots, exactly: interleaved strided chunks (every
    3rd word), dead palindrome words, a crowd past both pads (760
    singletons of one key: ~253 words of the chunk and 760 queries at the
    escalation pads of 240), cpad < cpad_q."""
    whi, wlo, wocc, live, chunk, qhi, qlo, (s, t) = _layout_inputs(
        41, n_crowd, 1)
    want, _, wslot, _, qslot = _host_slot_layouts(
        whi, wlo, wocc, live, chunk, qhi, qlo, s, t, cpad, cpad_q)
    assert ((wslot >= cpad) & (wslot < 255)).any() and (wslot == 255).any()
    assert (qslot >= cpad_q).any()
    got = bucket_layouts_plain(
        _i64(whi)[chunk], _i64(wlo)[chunk], torch.from_numpy(wocc)[chunk],
        torch.from_numpy(live)[chunk], _i64(qhi), _i64(qlo), lo_bit=2 * s,
        width=2 * (t - s), n_buckets=1 << (2 * (t - s)), cpad=cpad,
        cpad_q=cpad_q)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype
        np.testing.assert_array_equal(g.numpy(), x.numpy())


@pytest.mark.parametrize("n,n_keys,dead", [(5000, 7, 0.0), (20000, 3, 0.2),
                                           (3000, 2000, 0.1), (1, 1, 0.0),
                                           (0, 1, 0.0)])
def test_rank_slots_match_host_slots(n, n_keys, dead):
    """rank_slots (a stable torch sort) gives the host's _slots_u8 on
    keys with long runs of equal values (ranks past 255 saturate), 255
    for dead entries."""
    rng = np.random.default_rng(n + n_keys)
    keys = rng.integers(0, n_keys, n).astype(np.uint32)
    live = rng.random(n) >= dead
    want = np.full(n, 255, np.uint8)
    want[live] = thj._slots_u8(keys[live])
    np.testing.assert_array_equal(want[live], jhj._slots_u8(keys[live]))
    got = rank_slots(_i64(keys), torch.from_numpy(live))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(rank_slots(_i64(keys)).numpy(),
                                  thj._slots_u8(keys))
    if n > 300 * n_keys:                # runs past 255 saturate
        assert (want[live] == 255).sum() > 0


@pytest.mark.parametrize("k,e,cpad,chunk_q,chunk_w", [
    (15, 2, 4, 177, 12_000_000),
    (16, 1, 8, 64, 1000)])
def test_neighbor_sums_take_no_host_slots(monkeypatch, k, e, cpad, chunk_q,
                                          chunk_w):
    """The sums join computes no host slots: with the port's _slots_u8
    made to raise, hamming_neighbor_sums on the CPU still equals the JAX
    package's."""
    def no_host_slots(keys):
        raise AssertionError("the sums join computed host slots")
    monkeypatch.setattr(thj, "_slots_u8", no_host_slots)
    uniq, occ = _world(200 + k, k)
    targets = uniq[occ == 1]
    want = jhj.hamming_neighbor_sums(targets, uniq, occ, k, e, cpad=cpad,
                                     chunk_q=chunk_q, chunk_w=chunk_w)
    got = thj.hamming_neighbor_sums(targets, uniq, occ, k, e, cpad=cpad,
                                    chunk_q=chunk_q, chunk_w=chunk_w,
                                    device="cpu")
    np.testing.assert_array_equal(got, want)
    assert want.any()


@pytest.mark.parametrize("k,e,cpad,chunk_q,chunk_w", [
    (15, 1, 8, 4_000_000, 12_000_000),
    (15, 2, 4, 177, 12_000_000),
    (16, 2, 8, 64, 1000),
    (16, 1, 4, 4_000_000, 1000)])
def test_neighbor_sums_match_jax(k, e, cpad, chunk_q, chunk_w):
    uniq, occ = _world(100 + k, k)
    targets = uniq[occ == 1]
    want = jhj.hamming_neighbor_sums(targets, uniq, occ, k, e, cpad=cpad,
                                     chunk_q=chunk_q, chunk_w=chunk_w)
    got = thj.hamming_neighbor_sums(targets, uniq, occ, k, e, cpad=cpad,
                                    chunk_q=chunk_q, chunk_w=chunk_w,
                                    device="cpu")
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    assert want.any()


def test_rc_device_matches_host():
    for k in (3, 15, 16, 17, 30, 32):
        uniq, _ = _world(k, k, 600)
        hi, lo = jcodec.split_u64(uniq)
        rh, rl = thj._rc_device(torch.from_numpy(hi.astype(np.int64)),
                                torch.from_numpy(lo.astype(np.int64)), k=k)
        got = jcodec.join_u64(to_numpy_u32(rh), to_numpy_u32(rl))
        np.testing.assert_array_equal(got, thj._rc_np(uniq, k))


@pytest.mark.parametrize("cpad,cpad_q,chunk_q,chunk_w", [(4, 32, 64, 700),
                                                         (8, 4, 100, 12_000_000)])
def test_neighbor_sums_match_bruteforce(cpad, cpad_q, chunk_q, chunk_w):
    """Exact against enumeration where the pads and interleaved chunks
    route many queries through the join (cpad < cpad_q included)."""
    from tests.test_hamming_join import brute_sums
    k, e = 15, 2
    uniq, occ = _world(7, k)
    targets = uniq[occ == 1][::5]
    want = brute_sums(targets.tolist(), dict(zip(uniq.tolist(),
                                                 occ.astype(int).tolist())), k, e)
    stats = {}
    got = thj.hamming_neighbor_sums(targets, uniq, occ, k, e, cpad=cpad,
                                    cpad_q=cpad_q, chunk_q=chunk_q,
                                    chunk_w=chunk_w, device="cpu", stats=stats)
    np.testing.assert_array_equal(got, want)
    assert stats["n_joined"] > 0 and stats["join_calls"] > 0


def test_query_pad_above_word_pad_routes_to_slow_path():
    """With cpad < cpad_q the query layout holds only cpad lanes per
    bucket. Six queries share parts 0 and 1 with one genome k-mer u and
    differ from it in part 2, so each has u as a neighbor found only by
    the part-0 and part-1 joins. The JAX package routes on cpad_q = 32,
    joins them with 4 lanes and loses u for the fifth and sixth query;
    the port routes on min(cpad_q, cpad) and sends all six to the exact
    slow path."""
    from tests.test_hamming_join import brute_sums
    k, e = 30, 2
    rng = np.random.default_rng(11)
    codes = jcodec.encode_bases(helpers.random_genome(rng, 3000).encode())
    canon, valid = jcodec.sliding_kmers_np(codes, k)
    uniq, counts = np.unique(canon[valid & (canon != 0)], return_counts=True)
    occ = np.minimum(counts, 255).astype(np.uint8)
    u = int(uniq[len(uniq) // 2])
    s, t = jhj.part_ranges(k)[2]
    queries = np.array([u ^ (1 << (2 * p)) for p in range(s, s + 6)],
                       np.uint64)
    want = brute_sums(queries.tolist(), dict(zip(uniq.tolist(),
                                                 occ.astype(int).tolist())), k, e)
    assert (want > 0).all()
    jax_sums = jhj.hamming_neighbor_sums(queries, uniq, occ, k, e, cpad=4,
                                         cpad_q=32)
    np.testing.assert_array_equal(jax_sums[:4], want[:4])
    assert (jax_sums[4:] < want[4:]).all()
    stats = {}
    got = thj.hamming_neighbor_sums(queries, uniq, occ, k, e, cpad=4,
                                    cpad_q=32, device="cpu", stats=stats)
    np.testing.assert_array_equal(got, want)
    assert stats["n_slow"] == 6
