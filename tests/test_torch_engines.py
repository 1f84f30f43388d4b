"""The flat count's other engines against the JAX package: the
reference's linear probe (plain `probe_lookup`, K7's plain version with
its slot → rank translation and the repaired `neighbor_occr_sum`, on
tables whose scans pass either end),
the packed table's rows, the sort-join codec (K9's plain version), and
the DepthCounter of each layout (linear, packed, sortjoin, auto), depth
and snapshot, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickmer2_tpu import dictionary as jdict
from quickmer2_tpu.ops import codec as jcodec
from quickmer2_tpu.ops import editdist as jed
from quickmer2_tpu.ops import hamming_join as jhj
from quickmer2_tpu.ops import hash as jhash
from quickmer2_tpu.ops import packed_table as jpacked
from quickmer2_tpu.ops import rowpack as jrowpack
from quickmer2_tpu.pipelines import count as jcount
from quickmer2_tpu_torch import dictionary as tdict
from quickmer2_tpu_torch.device import words
from quickmer2_tpu_torch.kernels import count_flat
from quickmer2_tpu_torch.ops import editdist as ted
from quickmer2_tpu_torch.ops import hash as thash
from quickmer2_tpu_torch.ops import packed_table as tpacked
from quickmer2_tpu_torch.ops import rowpack as trowpack
from quickmer2_tpu_torch.ops import sortjoin as tsortjoin
from quickmer2_tpu_torch.pipelines import count as tcount
from tests.torch_threads import few_threads  # noqa: F401

CPU = torch.device("cpu")


def _dict_kmers(g: np.ndarray, k: int) -> np.ndarray:
    """Distinct nonzero canonical k-mers of g, in genome order."""
    canon, valid = jcodec.sliding_kmers_np(g, k)
    km = canon[valid & (canon != 0)]
    _, first = np.unique(km, return_index=True)
    return km[np.sort(first)]


def _reads(g: np.ndarray, seed: int, n_reads: int, read_len: int = 100):
    """SEP-separated windows of g, half reverse complemented, 1%
    substitutions, a few N bases, and one poly-A read (code 0)."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(g) - read_len, n_reads)
    reads = g[starts[:, None] + np.arange(read_len)].copy()
    flip = rng.random(n_reads) < 0.5
    reads[flip] = (reads[flip, ::-1] + 2) % 4
    err = rng.random(reads.shape) < 0.01
    reads[err] = (reads[err] + 1) % 4
    reads[rng.random(reads.shape) < 0.002] = jcodec.SEP
    reads[0] = 0
    sep = np.full((n_reads, 1), jcodec.SEP, np.uint8)
    return np.concatenate([reads, sep], axis=1).reshape(-1)


def _packed(codes: np.ndarray):
    pk, bits = trowpack.pack_rows(codes[None, :])
    return torch.from_numpy(pk[0]), torch.from_numpy(bits[0])


# -- the linear probe on tables whose scans pass either end ---------------

# (hash size, empty slots): scans from the upper half run down through
# slot 0 and wrap to H - 1 (empties high); scans from the lower half run
# past H - 1 and clamp (empties low); a full table sends every miss to
# max_steps, past -H and past H.
_TABLES = {"wrap": (4096, (3000, 3500)), "clamp": (4096, (1000,)),
           "full": (1024, ())}


def _scan_world(case: str, k: int = 15):
    """A table whose first keys sit where the reference's insert puts
    them (so their probes hit) and whose other slots hold genome k-mers
    at random (so scans run long), its rank map, per-slot counts, the
    placed keys, and reads over the genome."""
    hash_size, empty = _TABLES[case]
    rng = np.random.default_rng(hash_size + len(empty))
    g = rng.integers(0, 4, 3 * hash_size).astype(np.uint8)
    keys = _dict_kmers(g, k)
    table = np.zeros(hash_size, np.uint64)
    placed = keys[:hash_size // 4]
    jhash.probe_insert_np(table, placed, hash_size)
    table[list(empty)] = 0
    free = np.setdiff1d(np.flatnonzero(table == 0), empty)
    table[rng.permutation(free)] = keys[len(placed):len(placed) + len(free)]
    # a key whose scan starts in the upper half below the empties runs
    # down through slot 0 and finds it at H - 1 after the wrap
    spare = keys[len(placed) + len(free):]
    start = thash.djb_u64_np(spare) & (hash_size - 1)
    wrapped = spare[(start >= hash_size // 2)
                    & (start < min(empty, default=hash_size))]
    if len(wrapped):
        table[hash_size - 1] = wrapped[0]
    slots = np.flatnonzero(table)
    rank = tdict.make_rank(hash_size, rng.permutation(slots))
    occr = rng.integers(1, 255, hash_size).astype(np.uint8)
    occr[list(empty)] = 0
    return g, table, rank, occr, np.concatenate([wrapped[:1], placed]), \
        hash_size


@pytest.mark.parametrize("case", sorted(_TABLES))
def test_linear_probe_matches_jax(case):
    """probe_lookup, K7's plain version (the count step) and the
    repaired neighbor_occr_sum read the slots JAX's gathers read: -1
    wraps to H - 1, past the end clamps."""
    k = 15
    g, table, rank, occr, placed, hash_size = _scan_world(case, k)
    th, tl = jcodec.split_u64(table)
    # the reads, then the bases of the first placed key (the wrapped one
    # in the wrap table)
    first = (placed[0] >> (2 * np.arange(k - 1, -1, -1, dtype=np.uint64))
             & np.uint64(3)).astype(np.uint8)
    codes = np.concatenate([_reads(g, 7, 60), first, [jcodec.SEP]])
    canon, _ = jcodec.sliding_kmers_np(codes, k)
    qhi, qlo = jcodec.split_u64(canon)
    want_idx, want_found = (np.asarray(a) for a in jhash.probe_lookup(
        jnp.asarray(th), jnp.asarray(tl), jnp.asarray(qhi), jnp.asarray(qlo),
        hash_size=hash_size))
    t64 = [torch.from_numpy(a.astype(np.int64)) for a in (th, tl, qhi, qlo)]
    idx, found = thash.probe_lookup(*t64, hash_size)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(found.numpy(), want_found)
    if case == "wrap":
        assert want_found[-2] and want_idx[-2] == -1
    else:
        assert (want_idx >= hash_size).any()
    if case == "full":
        assert (want_idx < -hash_size).any()

    n = int(np.count_nonzero(table))        # the rank map's n_kmers
    want = np.asarray(jcount.count_step(
        jnp.asarray(codes), jnp.asarray(th), jnp.asarray(tl),
        jnp.asarray(rank), jnp.zeros(n + 1, jnp.uint32), k=k,
        hash_size=hash_size))
    slots = torch.zeros(hash_size + 1, dtype=torch.int64)
    pk, bits = _packed(codes)
    count_flat.count_linear_step(
        pk, bits, words(np.stack([th, tl], 1), CPU), slots, k=k,
        hash_size=hash_size, n_bases=len(codes))
    depth = count_flat.slot_depth_to_rank(
        slots, torch.from_numpy(np.argsort(rank)[:n].astype(np.int64)), n)
    np.testing.assert_array_equal(depth.numpy(), want.astype(np.int64))

    # one base off a placed key: a neighbor of each query is that key
    q = placed[:40] ^ np.uint64(1)
    halves = (*jcodec.split_u64(q), *jcodec.split_u64(jhj._rc_np(q, k)))
    want_sum = np.asarray(jed.neighbor_occr_sum(
        *(jnp.asarray(a) for a in halves), jnp.asarray(th), jnp.asarray(tl),
        jnp.asarray(occr), *(jnp.asarray(a) for a in jed.edit_table(k, 1)),
        k=k, hash_size=hash_size))
    i64 = [torch.from_numpy(a.astype(np.int64)) for a in (*halves, th, tl)]
    got_sum = ted.neighbor_occr_sum(*i64, torch.from_numpy(occr),
                                    *ted.edit_table_t(k, 1, CPU), k=k,
                                    hash_size=hash_size)
    np.testing.assert_array_equal(got_sum.numpy(), want_sum.astype(np.int64))
    assert want_sum.any()


# -- tables and the sort-join codec ----------------------------------------

def _dictionaries(k: int, seed: int, n_bases: int = 20000):
    g = np.random.default_rng(seed).integers(0, 4, n_bases).astype(np.uint8)
    kmers = _dict_kmers(g, k)
    return (g, jdict.Dictionary.from_kmers_in_order(kmers, 1 << 16, k),
            tdict.Dictionary.from_kmers_in_order(kmers, 1 << 16, k))


@pytest.mark.parametrize("k", [15, 32])
def test_packed_table_from_dictionary_matches_jax(k):
    _, jd, td = _dictionaries(k, 40 + k)
    want = jpacked.PackedTable.from_dictionary(jd)
    got = tpacked.PackedTable.from_dictionary(td)
    np.testing.assert_array_equal(got.rows, want.rows)
    assert (got.n_buckets, got.n_kmers) == (want.n_buckets, want.n_kmers)
    np.testing.assert_array_equal(got.device_rows(CPU).numpy(),
                                  want.rows.astype(np.int64))
    for a, b in zip(td.device_arrays(), jd.device_arrays()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k,n_bases", [(15, 4099), (31, 3001), (32, 6400 + 17)])
def test_kmerize_matches_jax(k, n_bases):
    """K9's plain version: JAX's _kmerize_step_pk with the invalid
    windows' keys set to 0, across separators and the batch's end."""
    g = np.random.default_rng(k).integers(0, 4, n_bases).astype(np.uint8)
    g[np.random.default_rng(1).random(n_bases) < 0.01] = jcodec.SEP
    g[-3] = jcodec.SEP
    jpk, jbits = jrowpack.pack_rows(g[None, :])
    chi, clo, valid = (np.asarray(a) for a in jcount._kmerize_step_pk(
        jnp.asarray(jpk), jnp.asarray(jbits), k=k, n_bases=n_bases))
    pk, bits = _packed(g)
    thi, tlo, tvalid = count_flat.kmerize_step(pk, bits, k=k, n_bases=n_bases)
    np.testing.assert_array_equal(tvalid.numpy(), valid)
    np.testing.assert_array_equal(thi.numpy(), np.where(valid, chi, 0))
    np.testing.assert_array_equal(tlo.numpy(), np.where(valid, clo, 0))
    assert (~valid).any() and valid.any()


def test_sort_keys_order_unsigned_codes():
    """At k = 32 a canonical code can have bit 63 set (G...C): the
    flipped int64 keys sort as the u64 codes do."""
    kmers = np.array([3 << 62, 1, (3 << 62) + 5, 1 << 63, 7], np.uint64)
    hi, lo = jcodec.split_u64(kmers)
    keys = tsortjoin.sort_keys(torch.from_numpy(hi.astype(np.int64)),
                               torch.from_numpy(lo.astype(np.int64)))
    np.testing.assert_array_equal(torch.argsort(keys).numpy(),
                                  np.argsort(kmers, kind="stable"))


# -- DepthCounter: every layout against the JAX counter of that layout ----

def _feed(counter, codes: np.ndarray, seed: int) -> None:
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.integers(0, len(codes), 12))
    for part in np.split(codes, cuts):
        counter.feed_codes(part)


@pytest.mark.parametrize("layout", ["linear", "packed", "sortjoin", "auto"])
@pytest.mark.parametrize("k", [15, 31, 32])
def test_depth_counter_layout_matches_jax(layout, k):
    """Depth at finish and the snapshot taken mid-stream (depth in the
    layout's order, trash lane included) equal the JAX counter's; a
    batch size that is no multiple of 64 bases."""
    g, jd, td = _dictionaries(k, 60 + k)
    codes = _reads(g, k, 900)
    batch = 10_007
    jc = jcount.DepthCounter(jd, batch_bases=batch, layout=layout)
    tc = tcount.DepthCounter(td, batch_bases=batch, layout=layout,
                             device="cpu")
    want_layout = ("sortjoin" if len(_dict_kmers(g, k))
                   <= tcount.AUTO_SORTJOIN_MAX_N else "mono")
    assert tc.layout == (want_layout if layout == "auto" else layout)
    m = len(codes) // 2
    jc.feed_codes(codes[:m])
    _feed(tc, codes[:m], 3)
    if jc.layout == tc.layout:
        js, ts = jc.snapshot(), tc.snapshot()
        np.testing.assert_array_equal(ts["depth"], np.asarray(js["depth"]))
        np.testing.assert_array_equal(ts["residual"], js["residual"])
        assert (ts["windows"], ts["layout"]) == (js["windows"], js["layout"])
    jc.feed_codes(codes[m:])
    _feed(tc, codes[m:], 4)
    want = jc.finish()
    got = tc.finish()
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0
    assert tc.total_kmer_windows == jc.total_kmer_windows
    if k == 32 and tc.layout == "sortjoin":
        assert (td.kmers_in_order >> np.uint64(63)).any()


@pytest.mark.parametrize("layout", ["linear", "packed", "sortjoin"])
def test_port_resumes_from_jax_layout_snapshot(layout):
    """The JAX counter's snapshot of a rank- or key-ordered layout
    resumes in the port, and the port's resumes in the JAX counter."""
    k = 30
    g, jd, td = _dictionaries(k, 77)
    codes = _reads(g, 5, 800)
    batch = 1 << 13
    full = jcount.DepthCounter(jd, batch_bases=batch, layout=layout)
    full.feed_codes(codes)
    want = full.finish()
    m = len(codes) // 3
    jhalf = jcount.DepthCounter(jd, batch_bases=batch, layout=layout)
    jhalf.feed_codes(codes[:m])
    tc = tcount.DepthCounter(td, batch_bases=batch, layout=layout,
                             device="cpu")
    tc.restore(jhalf.snapshot())
    tc.feed_codes(codes[m:])
    np.testing.assert_array_equal(tc.finish(), want)
    thalf = tcount.DepthCounter(td, batch_bases=batch, layout=layout,
                                device="cpu")
    thalf.feed_codes(codes[:m])
    jc = jcount.DepthCounter(jd, batch_bases=batch, layout=layout)
    jc.restore(thalf.snapshot())
    jc.feed_codes(codes[m:])
    np.testing.assert_array_equal(jc.finish(), want)


def test_restore_rejects_other_layout():
    _, _, td = _dictionaries(30, 9)
    tc = tcount.DepthCounter(td, batch_bases=1 << 13, layout="linear",
                             device="cpu")
    snap = tc.snapshot()
    other = tcount.DepthCounter(td, batch_bases=1 << 13, layout="packed",
                                device="cpu")
    with pytest.raises(ValueError, match="layout"):
        other.restore(snap)
    with pytest.raises(ValueError, match="unknown table layout"):
        tcount.DepthCounter(td, layout="radix", device="cpu")
