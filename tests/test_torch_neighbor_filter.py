"""The key filter in front of the port's neighbor sweep (K4), on the CPU:
its plain version against an independent numpy form of the same
definition, no false negatives over every table key, a low pass rate on
random non-keys, and the filtered sweep against the JAX package's host
builder across chunk seams. Integer outputs: exact equality."""

import jax.numpy as jnp  # noqa: F401  (JAX stays on the CPU)
import numpy as np
import pytest
import torch

from quickmer2_tpu.ops import anchored as janch
from quickmer2_tpu.ops import codec as jcodec
from quickmer2_tpu.ops import packed_table as jpacked
from quickmer2_tpu_torch.kernels import neighbor_bits as tkn
from quickmer2_tpu_torch.ops import anchored as tanch
from quickmer2_tpu_torch.ops import packed_table as tpacked
from quickmer2_tpu_torch.ops.hash import djb_pair, djb_pair_np
from tests import helpers


def _t64(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _random_table(rng, k: int, n: int):
    """n distinct nonzero random k-mer codes in a packed table."""
    top = (1 << (2 * k)) - 1
    codes = np.unique(rng.integers(1, 1 << 62, 2 * n, dtype=np.int64)
                      .astype(np.uint64) & np.uint64(top))
    codes = codes[codes != 0][:n]
    hi, lo = jcodec.split_u64(codes)
    table = tpacked.PackedTable.build(hi, lo,
                                      np.arange(len(hi), dtype=np.uint32))
    return codes, hi, lo, table


def _filter_np(hi, lo, n_words: int) -> np.ndarray:
    """The filter's definition in numpy: word from the top bits of
    DJB * 2654435761, three bits from the top 15 of DJB * 0x85EBCA77."""
    h = djb_pair_np(hi, lo)
    word = (h * np.uint32(2654435761)) >> np.uint32(
        32 - (n_words.bit_length() - 1))
    p = h * np.uint32(0x85EBCA77)
    out = np.zeros(n_words, np.uint32)
    for s in (27, 22, 17):
        np.bitwise_or.at(out, word, np.uint32(1) << ((p >> np.uint32(s))
                                                    & np.uint32(31)))
    return out


@pytest.mark.parametrize("k", [15, 30, 32])
def test_key_filter_holds_every_key(k):
    rng = np.random.default_rng(k)
    n = 5000 if k < 17 else 40000
    codes, hi, lo, table = _random_table(rng, k, n)
    n_words = tkn.filter_words_for(len(codes))
    assert 32 * n_words >= tkn.FILTER_BITS_PER_KEY * len(codes)
    filt = tkn.key_filter(_t64(table.rows), n_buckets=table.n_buckets,
                          n_words=n_words)
    assert filt.dtype == torch.int64 and filt.shape == (n_words,)
    np.testing.assert_array_equal(filt.numpy(), _filter_np(hi, lo, n_words))
    # no false negatives over every key of the table
    assert bool(tkn.filter_pass(filt, djb_pair(_t64(hi), _t64(lo))).all())
    # random non-keys pass rarely
    top = (1 << (2 * k)) - 1
    q = (rng.integers(1, 1 << 62, 200_000, dtype=np.int64).astype(np.uint64)
         & np.uint64(top))
    q = q[~np.isin(q, codes)]
    qhi, qlo = jcodec.split_u64(q)
    rate = float(tkn.filter_pass(filt, djb_pair(_t64(qhi), _t64(qlo)))
                 .double().mean())
    assert rate < 0.05, rate


def test_filter_size_is_bounded():
    assert tkn.filter_words_for(0) == tkn.MIN_FILTER_WORDS
    assert tkn.filter_words_for(11_727_336) == 1 << 22      # 16 MB
    assert tkn.filter_words_for(10 ** 9) == tkn.MAX_FILTER_WORDS  # 32 MB
    for n in (1, 1000, 12345, 4_000_000):
        w = tkn.filter_words_for(n)
        assert w & (w - 1) == 0 and 32 * w >= 8 * n
        assert w == tkn.MIN_FILTER_WORDS or 16 * w < 8 * n


@pytest.mark.parametrize("k", [15, 30, 32])
def test_filtered_sweep_matches_jax_across_seams(k):
    """build_neighbor_bits_device (the key filter, then the filtered
    sweep, chunk by chunk) against the JAX host builder, on a genome with
    planted one-substitution copies so that the bitmap has hits."""
    rng = np.random.default_rng(100 + k)
    genome = helpers.random_genome(rng, 3000)
    muts = []
    for at in (100, 900, 2000):
        blk = genome[at: at + 2 * k]
        muts.append(blk[:k] + ("A" if blk[k] != "A" else "C") + blk[k + 1:])
    genome = (genome + "N" + "".join(muts) + "NN"
              + helpers.random_genome(rng, 50))
    codes = jcodec.encode_bases(genome.encode())
    canon, valid = jcodec.sliding_kmers_np(codes, k)
    valid &= canon != 0
    uniq, counts = np.unique(canon[valid], return_counts=True)
    khi, klo = jcodec.split_u64(uniq[counts == 1])
    rank = np.arange(len(khi), dtype=np.uint32)
    jt = jpacked.PackedTable.build(khi, klo, rank)
    tt = tpacked.PackedTable.build(khi, klo, rank)
    want = janch.build_neighbor_bits(codes, jt.rows, jt.n_buckets, k)
    assert want.any()
    for chunk in (1 << 23, 500, 4 * k):
        got = tanch.build_neighbor_bits_device(codes, _t64(tt.rows),
                                               tt.n_buckets, k, chunk=chunk)
        np.testing.assert_array_equal(got, want)
    # the filter drops none of the sweep's hits (so the kernel, which
    # probes only what passes it, gives the plain sweep's bytes) and
    # sends few of its probes on to the table
    trace = {}
    n_words = tkn.filter_words_for(len(khi))
    filt = tkn.key_filter(_t64(tt.rows), n_buckets=tt.n_buckets,
                          n_words=n_words)
    seg = torch.from_numpy(codes)
    out = tkn.neighbor_bits_plain(seg, _t64(tt.rows), filt,
                                  n_buckets=tt.n_buckets, k=k, trace=trace)
    np.testing.assert_array_equal(out.numpy(), want)
    assert trace["missed"] == 0
    assert trace["passed"] < 0.05 * trace["probes"]
