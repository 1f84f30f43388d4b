"""Port count path against the JAX package: the mono table's arrays,
the plain mono probe, the 2-bit unpack and the mono DepthCounter's
depth, bit for bit, on dictionaries with a non-empty side table and on
reads with N bases."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickmer2_tpu import dictionary as jdict
from quickmer2_tpu.ops import codec as jcodec
from quickmer2_tpu.ops import monotable as jmono
from quickmer2_tpu.ops import packed_table as jpacked
from quickmer2_tpu.ops import rowpack as jrowpack
from quickmer2_tpu.pipelines import count as jcount
from quickmer2_tpu_torch import dictionary as tdict
from quickmer2_tpu_torch.ops import monotable as tmono
from quickmer2_tpu_torch.ops import packed_table as tpacked
from quickmer2_tpu_torch.ops import rowpack as trowpack
from quickmer2_tpu_torch.pipelines import count as tcount


def _genome(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n).astype(np.uint8)
    g[n // 2: n // 2 + 200] = 0                    # poly-A tract
    return g


def _dict_kmers(g: np.ndarray, k: int) -> np.ndarray:
    """Distinct nonzero canonical k-mers of g, in genome order."""
    canon, valid = jcodec.sliding_kmers_np(g, k)
    km = canon[valid & (canon != 0)]
    _, first = np.unique(km, return_index=True)
    return km[np.sort(first)]


def _reads(g: np.ndarray, seed: int, n_reads: int, read_len: int = 100):
    """Read code stream: SEP-separated windows of g, half reverse
    complemented, 1% substitutions, some N (SEP) bases."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(g) - read_len, n_reads)
    reads = g[starts[:, None] + np.arange(read_len)].copy()
    flip = rng.random(n_reads) < 0.5
    reads[flip] = (reads[flip, ::-1] + 2) % 4
    err = rng.random(reads.shape) < 0.01
    reads[err] = (reads[err] + 1) % 4
    reads[rng.random(reads.shape) < 0.002] = jcodec.SEP
    sep = np.full((n_reads, 1), jcodec.SEP, np.uint8)
    return np.concatenate([reads, sep], axis=1).reshape(-1)


def _tables(kmers: np.ndarray, load: float):
    hi, lo = jcodec.split_u64(kmers)
    return jmono.MonoTable.build(hi, lo, load=load), \
        tmono.MonoTable.build(hi, lo, load=load)


@pytest.mark.parametrize("k,load", [(15, 0.5), (31, 2.0), (32, 4.0)])
def test_monotable_build_matches_jax(k, load):
    want, got = _tables(_dict_kmers(_genome(k, 20000), k), load)
    assert want.side is not None and got.side is not None
    np.testing.assert_array_equal(got.rows, want.rows)
    np.testing.assert_array_equal(got.slot_rank, want.slot_rank)
    np.testing.assert_array_equal(got.side.rows, want.side.rows)
    np.testing.assert_array_equal(got.side_rank, want.side_rank)
    assert (got.n_buckets, got.n_kmers) == (want.n_buckets, want.n_kmers)


def test_packed_probe_np_matches_jax():
    kmers = _dict_kmers(_genome(3, 5000), 21)
    hi, lo = jcodec.split_u64(kmers)
    rank = np.arange(len(kmers), dtype=np.uint32)
    want = jpacked.PackedTable.build(hi, lo, rank)
    got = tpacked.PackedTable.build(hi, lo, rank)
    np.testing.assert_array_equal(got.rows, want.rows)
    qhi = np.concatenate([hi, hi[:50] ^ 1, [0]]).astype(np.uint32)
    qlo = np.concatenate([lo, lo[:50], [0]]).astype(np.uint32)
    np.testing.assert_array_equal(
        tpacked.probe_packed_np(got.rows, qhi, qlo, got.n_buckets),
        jpacked.probe_packed_np(want.rows, qhi, qlo, want.n_buckets))


@pytest.mark.parametrize("k,load", [(15, 0.5), (31, 2.0)])
def test_probe_mono_matches_jax(k, load):
    g = _genome(10 + k, 20000)
    jt, tt = _tables(_dict_kmers(g, k), load)
    canon, _ = jcodec.sliding_kmers_np(_reads(g, 1, 300), k)
    qhi, qlo = jcodec.split_u64(canon)
    want = [np.asarray(a) for a in jmono.probe_mono(
        jnp.asarray(jt.rows), jnp.asarray(qhi), jnp.asarray(qlo), jt.n_buckets)]
    found, slot, unresolved = tmono.probe_mono(
        torch.from_numpy(tt.rows.astype(np.int64)),
        torch.from_numpy(qhi.astype(np.int64)),
        torch.from_numpy(qlo.astype(np.int64)), tt.n_buckets)
    np.testing.assert_array_equal(found.numpy(), want[0])
    np.testing.assert_array_equal(slot.numpy()[want[0]], want[1][want[0]])
    np.testing.assert_array_equal(unresolved.numpy(), want[2])
    assert want[0].any() and want[2].any()


@pytest.mark.parametrize("length", [8, 37, 1000, 4099])
def test_unpack_matches_jax(length):
    rng = np.random.default_rng(length)
    rows = rng.integers(0, 4, (3, length)).astype(np.uint8)
    rows[rng.random(rows.shape) < 0.05] = jcodec.SEP
    pk, bits = trowpack.pack_rows(rows)
    jpk, jbits = jrowpack.pack_rows(rows)
    np.testing.assert_array_equal(pk, jpk)
    np.testing.assert_array_equal(bits, jbits)
    want = np.asarray(jrowpack.unpack_rows(jnp.asarray(jpk), jnp.asarray(jbits),
                                           read_len=length))
    got = trowpack.unpack_rows(torch.from_numpy(pk), torch.from_numpy(bits),
                               read_len=length).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, rows)


def _feed(counter, codes: np.ndarray, seed: int) -> None:
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.integers(0, len(codes), 12))
    for part in np.split(codes, cuts):
        counter.feed_codes(part)


@pytest.mark.parametrize("k,load,batch", [(15, 0.5, 1 << 13), (31, 2.0, 1 << 14),
                                          (32, 0.5, 1 << 15)])
def test_depth_counter_matches_jax(k, load, batch):
    g = _genome(20 + k, 30000)
    kmers = _dict_kmers(g, k)
    jd = jdict.Dictionary.from_kmers_in_order(kmers, 1 << 17, k)
    td = tdict.Dictionary.from_kmers_in_order(kmers, 1 << 17, k)
    jt, tt = _tables(kmers, load)
    assert jt.side is not None
    codes = _reads(g, 2, 1500)
    jc = jcount.DepthCounter(jd, batch_bases=batch, packed_table=jt)
    tc = tcount.DepthCounter(td, batch_bases=batch, packed_table=tt,
                             device="cpu")
    _feed(jc, codes, 3)
    _feed(tc, codes, 4)
    want = jc.finish()
    got = tc.finish()
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0 and tc._side_counts.sum() > 0
    assert tc.total_kmer_windows == jc.total_kmer_windows


def test_depth_counter_default_table():
    """Default MonoTable.from_dictionary (load ignored, as in JAX)."""
    k = 30
    g = _genome(41, 40000)
    kmers = _dict_kmers(g, k)
    jd = jdict.Dictionary.from_kmers_in_order(kmers, 1 << 17, k)
    td = tdict.Dictionary.from_kmers_in_order(kmers, 1 << 17, k)
    np.testing.assert_array_equal(td.chain_slots, jd.chain_slots)
    codes = _reads(g, 5, 2000)
    jc = jcount.DepthCounter(jd, batch_bases=1 << 14)
    tc = tcount.DepthCounter(td, batch_bases=1 << 14, device="cpu")
    jc.feed_codes(codes)
    tc.feed_codes(codes)
    np.testing.assert_array_equal(tc.finish(), jc.finish())


@pytest.mark.parametrize("mode", ["fastq", "fasta-lines", "fasta-record"])
def test_pypacker_matches_native_and_jax(mode):
    """The pure-Python packer (the port's fallback without gcc) emits the
    native packer's stream and the JAX package's, for any chunking."""
    from quickmer2_tpu.pipelines.count import PyPacker as JPyPacker
    from quickmer2_tpu_torch.utils import native
    rng = np.random.default_rng(len(mode))
    recs = []
    for i in range(60):
        seq = bytes(np.frombuffer(b"ACGTNacgt", np.uint8)[
            rng.integers(0, 9, int(rng.integers(1, 90)))])
        if mode == "fastq":
            recs.append(b"@r%d\n%s\n+\n%s\n" % (i, seq, b"@" * len(seq)))
        else:
            recs.append(b">r%d\n%s\n%s\n" % (i, seq[:40], seq[40:]))
    data = b"".join(recs)
    cuts = np.sort(rng.integers(0, len(data), 25))
    chunks = [data[a:b] for a, b in zip([0, *cuts], [*cuts, len(data)])]

    def run(packer):
        return np.concatenate([packer.feed(c) for c in chunks])
    want = run(native.StreamPacker(mode))
    np.testing.assert_array_equal(run(tcount.PyPacker(mode)), want)
    np.testing.assert_array_equal(run(JPyPacker(mode)), want)
