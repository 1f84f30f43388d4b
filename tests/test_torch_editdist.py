"""Port edit-distance neighbor sums against the JAX package: K6's plain
version against neighbor_occr_sum_packed (and, traced, its key filter:
no hit dropped, few probes passed), the linear-probe sum (2.l) and
the quirk-compat host sum against theirs, hamming_neighbor_sums with the
packed slow path (and with escalation) against the JAX one and brute
force, and run_search in every filter mode writing the JAX package's
bytes. Integer sums and files: exact equality."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickmer2_tpu.ops import codec as jcodec
from quickmer2_tpu.ops import editdist as jed
from quickmer2_tpu.ops import hamming_join as jhj
from quickmer2_tpu.ops import hash as jhash
from quickmer2_tpu.ops.packed_table import PackedTable as JPackedTable
from quickmer2_tpu_torch.device import to_numpy_u32, words
from quickmer2_tpu_torch.kernels.neighbor_bits import (
    filter_words_for, key_filter)
from quickmer2_tpu_torch.kernels.neighbor_sum import (
    edit_words, neighbor_sum, neighbor_sum_plain)
from quickmer2_tpu_torch.ops import editdist as ted
from quickmer2_tpu_torch.ops import hamming_join as thj
from quickmer2_tpu_torch.ops.packed_table import PackedTable
from tests import helpers
from tests.torch_threads import few_threads  # noqa: F401

CPU = torch.device("cpu")


def _world(seed: int, k: int, n_bases: int = 2000):
    """Distinct canonical k-mers + saturated counts of a genome with a
    mutated copy (dense ED1/ED2 neighborhoods), a poly-A tract and a
    dinucleotide repeat."""
    rng = np.random.default_rng(seed)
    seq = helpers.random_genome(rng, n_bases)
    mutated = list(seq)
    for pos in rng.integers(0, len(seq), size=n_bases // 40):
        mutated[pos] = "ACGT"[rng.integers(0, 4)]
    genome = seq + "".join(mutated) + "A" * 200 + "ACACACACAC" * 20
    codes = jcodec.encode_bases(genome.encode())
    canon, valid = jcodec.sliding_kmers_np(codes, k)
    uniq, counts = np.unique(canon[valid & (canon != 0)], return_counts=True)
    return uniq, np.minimum(counts, 255).astype(np.uint8)


def _queries(uniq, occ, n=120):
    """Singletons, repeated k-mers, and code 1 (one of whose neighbors
    is code 0, which never matches)."""
    return np.concatenate([uniq[occ == 1][:n], uniq[occ > 1][:20],
                           np.array([1], np.uint64)])


def _filtered_table(uniq, occ):
    """The port's packed table over uniq with counts in pos, and its key
    filter: (rows, n_buckets, filter), word tensors on the CPU."""
    uh, ul = jcodec.split_u64(uniq)
    tt = PackedTable.build(uh, ul, rank=np.arange(len(uniq), dtype=np.uint32),
                           pos=occ.astype(np.uint32))
    rows = words(tt.rows, CPU)
    return rows, tt.n_buckets, key_filter(
        rows, n_buckets=tt.n_buckets, n_words=filter_words_for(len(uniq)))


def _halves(q, k):
    kh, kl = jcodec.split_u64(q)
    rh, rl = jcodec.split_u64(jhj._rc_np(q, k))
    return kh, kl, rh, rl


@pytest.mark.parametrize("k,e", [(15, 1), (15, 2), (30, 1), (30, 2),
                                 (32, 1), (32, 2)])
def test_neighbor_sum_matches_jax_packed(k, e):
    """K6's plain version (and its wrapper on CPU tensors) equals JAX
    neighbor_occr_sum_packed, on a table with occurrence counts in pos."""
    uniq, occ = _world(k, k)
    q = _queries(uniq, occ)
    uh, ul = jcodec.split_u64(uniq)
    jt = JPackedTable.build(uh, ul, rank=np.arange(len(uniq), dtype=np.uint32),
                            pos=occ.astype(np.uint32))
    halves = _halves(q, k)
    want = np.asarray(jed.neighbor_occr_sum_packed(
        *(jnp.asarray(a) for a in halves), jnp.asarray(jt.rows),
        *(jnp.asarray(a) for a in jed.edit_table(k, e)), k=k,
        n_buckets=jt.n_buckets))
    rows, n_buckets, filt = _filtered_table(uniq, occ)
    args = [words(a, CPU) for a in halves] + [rows, filt]
    kw = dict(k=k, e=e, n_buckets=n_buckets)
    got = to_numpy_u32(neighbor_sum_plain(*args, slab_pairs=1 << 16, **kw))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(to_numpy_u32(neighbor_sum(*args, **kw)), want)
    assert want.any()
    # the kernel's packed edit words decode to the edit table
    p1, d1, p2, d2 = jed.edit_table(k, e)
    ew = edit_words(k, e)
    np.testing.assert_array_equal(ew & 63, p1)
    np.testing.assert_array_equal((ew >> 6) & 3, d1)
    np.testing.assert_array_equal((ew >> 8) & 63, np.maximum(p2, 0))
    np.testing.assert_array_equal((ew >> 14) & 3, d2)


@pytest.mark.parametrize("k,e", [(15, 2), (30, 2), (32, 1)])
def test_neighbor_sum_filter_trace(k, e):
    """K6's plain version traced with the table's key filter on singleton
    queries: the filter drops no hit (`missed` 0), passes every hit and
    few other probes, and the traced run gives the same sums."""
    uniq, occ = _world(600 + k, k)
    q = uniq[occ == 1][:150]
    rows, n_buckets, filt = _filtered_table(uniq, occ)
    args = [words(a, CPU) for a in _halves(q, k)] + [rows, filt]
    kw = dict(k=k, e=e, n_buckets=n_buckets)
    trace = {}
    got = to_numpy_u32(neighbor_sum_plain(*args, trace=trace, **kw))
    np.testing.assert_array_equal(
        got, to_numpy_u32(neighbor_sum_plain(*args, **kw)))
    m = len(ted.edit_table(k, e)[0])
    assert trace["probes"] == len(q) * m
    assert trace["missed"] == 0
    hits = int((got > 0).sum())
    assert 0 < hits <= trace["passed"] < 0.1 * trace["probes"]
    assert 0 < trace["rows_touched"] <= 2 * trace["passed"]
    assert 0 < trace["filter_sectors"] <= filt.shape[0] // 8


@pytest.mark.parametrize("k,e", [(15, 2), (31, 1), (32, 2)])
def test_neighbor_canon_matches_jax(k, e):
    uniq, occ = _world(50 + k, k, 600)
    q = uniq[:40]
    halves = _halves(q, k)
    tables = jed.edit_table(k, e)
    want = [np.asarray(a) for a in jed._neighbor_canon(
        *(jnp.asarray(a) for a in halves), *(jnp.asarray(a) for a in tables),
        k)]
    got = ted._neighbor_canon(*(torch.from_numpy(a.astype(np.int64))
                                for a in halves),
                              *ted.edit_table_t(k, e, CPU), k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))


def _probe_table(uniq, occ, k):
    """The reference's linear-probe table over uniq with per-slot occr."""
    hash_size = 1 << int(np.ceil(np.log2(len(uniq) / 0.4)))
    table = np.zeros(hash_size, np.uint64)
    slots = jhash.probe_insert_np(table, uniq, hash_size)
    occr = np.zeros(hash_size, np.uint8)
    occr[slots] = occ
    return table, occr, hash_size


@pytest.mark.parametrize("k,e", [(15, 1), (30, 2)])
def test_neighbor_occr_sum_matches_jax(k, e):
    """2.l: the sum through the reference's linear-probe table."""
    uniq, occ = _world(200 + k, k)
    q = _queries(uniq, occ, 60)
    table, occr, hash_size = _probe_table(uniq, occ, k)
    th, tl = jcodec.split_u64(table)
    halves = _halves(q, k)
    want = np.asarray(jed.neighbor_occr_sum(
        *(jnp.asarray(a) for a in halves), jnp.asarray(th), jnp.asarray(tl),
        jnp.asarray(occr), *(jnp.asarray(a) for a in jed.edit_table(k, e)),
        k=k, hash_size=hash_size))
    i64 = [torch.from_numpy(a.astype(np.int64)) for a in (*halves, th, tl)]
    got = ted.neighbor_occr_sum(*i64, torch.from_numpy(occr),
                                *ted.edit_table_t(k, e, CPU), k=k,
                                hash_size=hash_size)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert want.any()


@pytest.mark.parametrize("e", [1, 2])
def test_quirk_sum_matches_jax(e):
    k = 30
    uniq, occ = _world(300 + e, k)
    q = uniq[occ == 1][:80]
    table, occr, hash_size = _probe_table(uniq, occ, k)
    want = jed.neighbor_occr_sum_quirk_np(q, table, occr, hash_size, k, e)
    got = ted.neighbor_occr_sum_quirk_np(q, table, occr, hash_size, k, e)
    np.testing.assert_array_equal(got, want)
    f, r = ted.quirk_permute_np(q.copy(), jhj._rc_np(q, k), 20, 3, k)
    wf, wr = jed.quirk_permute_np(q.copy(), jhj._rc_np(q, k), 20, 3, k)
    np.testing.assert_array_equal(f, wf)
    np.testing.assert_array_equal(r, wr)


@pytest.mark.parametrize("k,e,cpad,escalate", [(15, 2, 4, 0), (15, 2, 4, 1),
                                               (30, 2, 8, 0), (16, 1, 4, 0)])
def test_neighbor_sums_packed_slow_path(k, e, cpad, escalate):
    """hamming_neighbor_sums with the packed table (slow queries through
    K6's plain version), with and without the escalation re-join at pads
    of 240, equals the JAX one with its packed table and brute force."""
    from tests.test_hamming_join import brute_sums
    uniq, occ = _world(400 + k, k)
    targets = uniq[occ == 1]
    uh, ul = jcodec.split_u64(uniq)
    kw = dict(rank=np.arange(len(uniq), dtype=np.uint32),
              pos=occ.astype(np.uint32))
    jt = JPackedTable.build(uh, ul, **kw)
    want = jhj.hamming_neighbor_sums(targets, uniq, occ, k, e, cpad=cpad,
                                     packed_rows=jnp.asarray(jt.rows),
                                     n_buckets_packed=jt.n_buckets,
                                     batch_slow=128, escalate=escalate,
                                     escalate_min=1)
    rows, n_buckets, filt = _filtered_table(uniq, occ)
    stats = {}
    got = thj.hamming_neighbor_sums(targets, uniq, occ, k, e, cpad=cpad,
                                    packed_rows=rows,
                                    n_buckets_packed=n_buckets,
                                    packed_filter=filt,
                                    escalate=escalate, escalate_min=1,
                                    device="cpu", stats=stats)
    np.testing.assert_array_equal(got, want)
    sample = slice(None, None, 7)
    brute = brute_sums(targets[sample].tolist(),
                       dict(zip(uniq.tolist(), occ.astype(int).tolist())), k, e)
    np.testing.assert_array_equal(got[sample], brute)
    assert stats["n_slow"] > 0
    if escalate:
        sub = stats["escalation"]
        assert sub["n_queries"] == stats["n_slow"]
        # the top-level split covers the re-join and its slow path
        assert stats["slow_s"] == sub["slow_s"]
        assert stats["join_s"] >= sub["join_s"] > 0


def _search_world(tmp_path, rng):
    """Two chromosomes: a sequence and its noisy copy (dense neighbor
    sums), and 100 windows that end in one 10-base motif, whose part-0
    bucket holds more words than the join's pad of 64 (slow queries)."""
    seq = helpers.random_genome(rng, 2500)
    noisy = list(seq)
    for pos in rng.integers(0, len(seq), size=100):
        noisy[pos] = "ACGT"[rng.integers(0, 4)]
    motif = helpers.random_genome(rng, 10)
    crowd = "".join(helpers.random_genome(rng, 20) + motif
                    for _ in range(100))
    fa = str(tmp_path / "g.fa")
    helpers.write_fasta(fa, {"c1": seq + "".join(noisy) + "A" * 80,
                             "c2": helpers.random_genome(rng, 1500) + crowd})
    ctrl = str(tmp_path / "ctrl.bed")
    with open(ctrl, "w") as f:
        f.write("c1\t0\t3000\nc2\t100\t4000\nc9\t0\t10\n")
    return fa, ctrl


def _outputs(prefix):
    out = {}
    for ext in (".qm", ".bed", ".qgc"):
        with open(prefix + ext, "rb") as f:
            out[ext] = f.read()
    return out


@pytest.mark.parametrize("mode", ["hamming", "hamming_packed", "probe",
                                  "host", "quirk"])
def test_run_search_filter_modes_match_jax(tmp_path, monkeypatch, mode):
    """run_search in each filter mode writes the .qm/.bed/.qgc of the JAX
    package's run_search in the same mode (the JAX hamming filter for the
    port's hamming filter with the packed slow path, which a card takes
    and "hamming_packed" gives the CPU); the filter removes k-mers. k = 15
    keeps the join's layouts small on the CPU; the quirk filter is
    defined at k = 30 only."""
    from quickmer2_tpu.config import SearchConfig as JSearchConfig
    from quickmer2_tpu.pipelines import search as jsearch
    from quickmer2_tpu_torch.config import SearchConfig
    from quickmer2_tpu_torch.pipelines import search as tsearch
    fa, ctrl = _search_world(tmp_path, np.random.default_rng(42))
    cfg_kw = dict(kmer_size=30 if mode == "quirk" else 15,
                  hash_size=1 << 14, edit_distance=2,
                  edit_depth_threshold=2, window_size=40, control_bed=ctrl,
                  quirk_mod32_editdist=mode == "quirk")
    impl = "probe" if mode == "probe" else "hamming"
    on_dev = mode not in ("host", "quirk")
    if mode == "hamming_packed":
        monkeypatch.setattr(tsearch, "PACKED_SLOW_PATH_DEVICES",
                            ("cuda", "cpu"))
    jp, tp = str(tmp_path / "jax"), str(tmp_path / "port")
    jsearch.run_search(fa, JSearchConfig(**cfg_kw), out_prefix=jp,
                       use_device_filter=on_dev, filter_impl=impl,
                       verbose=False)
    stats = {}
    tsearch.run_search(fa, SearchConfig(**cfg_kw), out_prefix=tp,
                       use_device_filter=on_dev, filter_impl=impl,
                       filter_batch=500, verbose=False, stats=stats,
                       device="cpu")
    assert _outputs(tp) == _outputs(jp)
    assert stats["n_filtered"] > 0
    phases = stats["phases"]
    assert set(phases) == {"tabulate_s", "filter_s", "join_s",
                           "slow_table_s", "slow_s", "emit_s"}
    assert (phases["slow_table_s"] > 0) == (mode in ("hamming_packed",
                                                     "probe"))
    if mode.startswith("hamming"):
        assert stats["filter"]["n_slow"] > 0


def test_quirk_filter_refuses_other_k(tmp_path):
    from quickmer2_tpu_torch.config import SearchConfig
    from quickmer2_tpu_torch.pipelines import search as tsearch
    fa, _ = _search_world(tmp_path, np.random.default_rng(1))
    with pytest.raises(ValueError, match="k=30 only"):
        tsearch.run_search(fa, SearchConfig(kmer_size=25, hash_size=1 << 14,
                                            quirk_mod32_editdist=True),
                           out_prefix=os.path.join(str(tmp_path), "q"),
                           verbose=False, device="cpu")
