"""The search's device emit in the port against the JAX package: K10's
plain version (kernels.emit_member) against JAX's `_member_chunk`, the
port's DeviceMembershipScanner against JAX's at a chunk of 2^12 windows
with seams inside N runs, `run_search(emit_devices=1)` against the
JAX search's host and device emits, and emit_devices=2 (the chunks
halo-split over two devices) against JAX's, byte for byte. Masks are booleans:
the tolerance is exact equality."""

import os

import numpy as np
import pytest
import torch

from quickmer2_tpu.config import SearchConfig as JaxSearchConfig
from quickmer2_tpu.ops import codec as jcodec
from quickmer2_tpu.ops.packed_table import PackedTable as JaxPackedTable
from quickmer2_tpu.parallel import emit_parallel as jemit
from quickmer2_tpu.pipelines import search as jsearch
from quickmer2_tpu_torch.config import SearchConfig
from quickmer2_tpu_torch.device import words
from quickmer2_tpu_torch.kernels.emit_member import (
    member_scan, member_scan_plain, pack_mask, unpack_mask)
from quickmer2_tpu_torch.ops import rowpack
from quickmer2_tpu_torch.ops.packed_table import PackedTable
from quickmer2_tpu_torch.parallel.emit_parallel import (
    DeviceMembershipScanner)
from quickmer2_tpu_torch.pipelines import search
from tests import helpers
from tests.torch_threads import few_threads  # noqa: F401

CPU = torch.device("cpu")


def _genome_codes(rng, n, n_runs):
    """Random codes with N runs (SEP) of 1-40 bases."""
    codes = rng.integers(0, 4, n).astype(np.uint8)
    for s in rng.integers(0, n - 40, n_runs):
        codes[s:s + rng.integers(1, 41)] = jcodec.SEP
    return codes


def _table(codes, k, rng, frac=0.5):
    """A packed table of part of the genome's distinct k-mers plus
    random keys, built by the JAX package, and its (hi, lo, rank)."""
    canon, valid = jcodec.sliding_kmers_np(codes, k)
    kmers = np.unique(canon[valid & (canon != 0)])
    keep = kmers[rng.random(len(kmers)) < frac]
    top = np.uint64((1 << (2 * k)) - 1)
    extra = rng.integers(1, 1 << 62, 500, dtype=np.int64).astype(
        np.uint64) & top
    keys = np.unique(np.concatenate([keep, extra]))
    keys = keys[keys != 0]
    hi, lo = jcodec.split_u64(keys)
    rank = np.arange(len(keys), dtype=np.uint32)
    return JaxPackedTable.build(hi, lo, rank=rank), (hi, lo, rank)


@pytest.mark.parametrize("k", [15, 30, 32])
def test_member_scan_plain_matches_jax(k):
    """K10's plain version on one chunk (codes packed as the flat batch)
    against JAX _member_chunk: equal masks; the port's PackedTable.build
    gives the JAX rows."""
    import jax.numpy as jnp
    rng = np.random.default_rng(k)
    codes = _genome_codes(rng, 6000 + k, 30)
    tab, keys = _table(codes, k, rng)
    np.testing.assert_array_equal(PackedTable.build(*keys).rows, tab.rows)
    want = np.asarray(jemit._member_chunk(
        jnp.asarray(codes), jnp.asarray(tab.rows), k=k,
        n_buckets=tab.n_buckets))
    pk, bits = rowpack.pack_rows(codes[None])
    got = member_scan_plain(torch.from_numpy(pk[0]),
                            torch.from_numpy(bits[0]), words(tab.rows, CPU),
                            k=k, n_buckets=tab.n_buckets, n_bases=len(codes))
    n = len(codes) - k + 1
    assert got.shape == (-(-n // 32),)
    np.testing.assert_array_equal(unpack_mask(got, n), want)
    assert want.sum() > 100
    # the wrapper takes the plain version for a CPU tensor
    again = member_scan(torch.from_numpy(pk[0]), torch.from_numpy(bits[0]),
                        words(tab.rows, CPU), k=k, n_buckets=tab.n_buckets,
                        n_bases=len(codes))
    assert torch.equal(again, got)


def test_pack_mask_round_trip():
    rng = np.random.default_rng(1)
    for n in (1, 31, 32, 33, 1000):
        hit = rng.random(n) < 0.4
        words_t = pack_mask(torch.from_numpy(hit))
        np.testing.assert_array_equal(unpack_mask(words_t, n), hit)


def test_scanner_chunks_match_jax():
    """The port's scanner at a chunk of 2^12 windows against JAX's
    DeviceMembershipScanner(chunk=1 << 12), with N runs across every
    seam and a tail chunk padded with SEP: equal masks, equal to the
    host probe."""
    from quickmer2_tpu.ops.packed_table import probe_packed_np
    rng = np.random.default_rng(7)
    k = 30
    codes = _genome_codes(rng, 3 * 4096 + 1777, 10)
    for seam in range(4096, len(codes) - k, 4096):
        codes[seam - 12: seam + 9] = jcodec.SEP     # an N run over the seam
        codes[seam + 20] = jcodec.SEP               # one inside the halo
    tab, _ = _table(codes, k, rng)
    canon, valid = jcodec.sliding_kmers_np(codes, k)
    chi, clo = jcodec.split_u64(canon)
    host = probe_packed_np(tab.rows, chi, clo, tab.n_buckets) \
        & valid & (canon != 0)
    want = jemit.DeviceMembershipScanner(tab, k, chunk=1 << 12).scan(codes)
    np.testing.assert_array_equal(want, host)
    port_tab = PackedTable(tab.rows, tab.n_buckets, tab.n_kmers)
    scanner = DeviceMembershipScanner(port_tab, k, chunk=1 << 12,
                                      device="cpu")
    chunks = list(scanner.chunks(codes))
    assert len(chunks) == 4 and len(chunks[-1][2]) == 4096 + k - 1
    np.testing.assert_array_equal(scanner.scan(codes), want)
    assert scanner.scan(codes[:k - 1]).shape == (0,)


def _genome(tmp_path, rng, name):
    """The multi-chromosome genome of tests/test_emit_parallel.py: an N
    gap, a repeat, and a control bed whose last row is another
    chromosome's."""
    rep = helpers.random_genome(rng, 900)
    chr1 = (helpers.random_genome(rng, 9000) + rep + "N" * 25
            + helpers.random_genome(rng, 5000) + rep)
    chr2 = helpers.random_genome(rng, 7000)
    fa = os.path.join(str(tmp_path), name + ".fa")
    helpers.write_fasta(fa, {"chr1": chr1, "chr2": chr2})
    with open(fa + ".ctrl.bed", "w") as f:
        f.write("chr1\t100\t8000\nchr2\t0\t6500\nchrZ\t0\t10\n")
    return fa


def test_search_device_emit_matches_jax(tmp_path):
    """run_search(emit_devices=1, device="cpu") writes the .qm, .bed and
    .qgc of the JAX search with its host emit and with emit_devices=1;
    emit_table_s is reported."""
    fas = {}
    for name in ("jax_host", "jax_dev", "port"):
        fas[name] = _genome(tmp_path, np.random.default_rng(5), name)
    # -e 0 skips the edit filter (the survivors are the unique k-mers),
    # which the emit does not see
    kw = dict(kmer_size=30, hash_size=1 << 16, edit_distance=0,
              window_size=100)
    jsearch.run_search(fas["jax_host"], JaxSearchConfig(
        **kw, control_bed=fas["jax_host"] + ".ctrl.bed"), verbose=False)
    jsearch.run_search(fas["jax_dev"], JaxSearchConfig(
        **kw, control_bed=fas["jax_dev"] + ".ctrl.bed"), verbose=False,
        emit_devices=1)
    stats = {}
    search.run_search(fas["port"], SearchConfig(
        **kw, control_bed=fas["port"] + ".ctrl.bed"), verbose=False,
        stats=stats, device="cpu", emit_devices=1)
    assert stats["phases"]["emit_table_s"] > 0
    assert stats["phases"]["emit_s"] >= stats["phases"]["emit_table_s"]
    for ext in (".qm", ".bed", ".qgc"):
        with open(fas["port"] + ext, "rb") as f:
            got = f.read()
        for ref in ("jax_host", "jax_dev"):
            with open(fas[ref] + ext, "rb") as f:
                assert f.read() == got, (ext, ref)


def test_emit_devices_above_one_not_ported(tmp_path):
    """Once a refusal, now the sharded emit: run_search(emit_devices=2,
    device="cpu") splits each chunk over two copies of the CPU with a
    k - 1 halo and writes the JAX search's bytes with emit_devices=2;
    the scanner's mask equals JAX's sharded scanner's."""
    fas = {name: _genome(tmp_path, np.random.default_rng(6), name)
           for name in ("jax", "port")}
    kw = dict(kmer_size=30, hash_size=1 << 16, edit_distance=0,
              window_size=100)
    jsearch.run_search(fas["jax"], JaxSearchConfig(
        **kw, control_bed=fas["jax"] + ".ctrl.bed"), verbose=False,
        emit_devices=2)
    search.run_search(fas["port"], SearchConfig(
        **kw, control_bed=fas["port"] + ".ctrl.bed"), verbose=False,
        device="cpu", emit_devices=2)
    for ext in (".qm", ".bed", ".qgc"):
        with open(fas["port"] + ext, "rb") as f, \
                open(fas["jax"] + ext, "rb") as h:
            assert f.read() == h.read(), ext
    rng = np.random.default_rng(6)
    codes = _genome_codes(rng, 30000, 12)
    jtab, (hi, lo, rank) = _table(codes, 30, rng)
    want = jemit.DeviceMembershipScanner(jtab, 30, data_devices=2,
                                         chunk=1 << 12).scan(codes)
    got = DeviceMembershipScanner(PackedTable.build(hi, lo, rank=rank), 30,
                                  data_devices=2, chunk=1 << 12,
                                  device="cpu").scan(codes)
    np.testing.assert_array_equal(got, want)
