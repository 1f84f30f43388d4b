"""Port Hamming join against the JAX package: the plain compare chain
on identical bucket layouts equals one _part_chunk_join call, and
hamming_neighbor_sums equals the JAX one with forced slow paths, small
query chunks, palindromes and self-pairs. Integer sums: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickmer2_tpu.ops import codec as jcodec
from quickmer2_tpu.ops import hamming_join as jhj
from quickmer2_tpu_torch.device import to_numpy_u32
from quickmer2_tpu_torch.kernels.hamming_join import join_compare
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
