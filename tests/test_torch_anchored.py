"""The port's anchored count against the JAX package, on the CPU: the
packed probe, row packing, rank_at and the genome window fetch, the
anchored read pass in all three branches (diff words and spill codes),
the exact recount over read rows, the neighbor-bit builders, the .qai
companion, the AnchoredDepthCounter (depth, spill counters, resume from
a JAX snapshot) and run_count(mode="anchored") output bytes. Integer
outputs throughout, so the tolerance is exact equality."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickmer2_tpu.config import SearchConfig
from quickmer2_tpu.io import formats as jformats
from quickmer2_tpu.ops import anchored as janch
from quickmer2_tpu.ops import codec as jcodec
from quickmer2_tpu.ops import monotable as jmono
from quickmer2_tpu.ops import packed_table as jpacked
from quickmer2_tpu.ops import rowpack as jrowpack
from quickmer2_tpu.pipelines import count as jcount
from quickmer2_tpu.pipelines import search as jsearch
from quickmer2_tpu_torch import dictionary as tdict
from quickmer2_tpu_torch.io import formats as tformats
from quickmer2_tpu_torch.kernels import anchored as tkanch
from quickmer2_tpu_torch.kernels.count_mono import (count_mono_rows,
                                                    count_mono_rows_plain)
from quickmer2_tpu_torch.ops import anchored as tanch
from quickmer2_tpu_torch.ops import monotable as tmono
from quickmer2_tpu_torch.ops import packed_table as tpacked
from quickmer2_tpu_torch.ops import rowpack as trowpack
from quickmer2_tpu_torch.pipelines import count as tcount
from tests import helpers
from tests.torch_threads import few_threads  # noqa: F401

K = 30
READ_LEN = 100
W = READ_LEN - K + 1
OFFSETS = tuple(sorted({0, W // 3, (2 * W) // 3, W - 1}))
TIER_KW = {
    "neighbor": dict(max_runs=4, max_dirty=0, neighbor_mode=True),
    "point": dict(max_runs=4, max_dirty=8),
    "runs": dict(max_runs=6, max_dirty=0, max_dirty_runs=2,
                 dirty_run_width=32),
}


def _search(fa: str, control_bed: str | None = None):
    return jsearch.run_search(
        fa, SearchConfig(kmer_size=K, hash_size=1 << 16, edit_distance=0,
                         window_size=100, control_bed=control_bed),
        verbose=False)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """test_anchored.py's world: two chromosomes, one with an N gap and a
    repeated segment (its k-mers are not in the dictionary); both
    packages' indexes over it, on the CPU."""
    rng = np.random.default_rng(77)
    d = tmp_path_factory.mktemp("tanch")
    rep = helpers.random_genome(rng, 1500)
    chr1 = (helpers.random_genome(rng, 15000) + rep + "N" * 40
            + helpers.random_genome(rng, 8000) + rep)
    chr2 = helpers.random_genome(rng, 6000)
    fa = str(d / "g.fa")
    helpers.write_fasta(fa, {"c1": chr1, "c2": chr2})
    jdic = _search(fa)
    tdic = tdict.Dictionary.from_qm(fa + ".qm")
    return {"fa": fa, "chr1": chr1, "chr2": chr2, "jdic": jdic, "tdic": tdic,
            "jindex": janch.AnchoredIndex.from_dictionary_and_fasta(jdic, fa),
            "tindex": tanch.AnchoredIndex.from_dictionary_and_fasta(
                tdic, fa, device="cpu")}


def _rows(reads) -> np.ndarray:
    blob = "".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)).encode()
    return janch.rows_from_flat_codes(
        jcount.make_packer("fasta-lines").feed(blob), READ_LEN)


def _mixed_reads(world, seed: int):
    """Clean, erroneous (1 %/bp), garbage, chimeric, mixed-strand reads,
    reads over the N gap and the repeat, and all-N reads."""
    rng = np.random.default_rng(seed)
    chr1, chr2 = world["chr1"], world["chr2"]
    reads = (helpers.simulate_reads(rng, chr1, 250, READ_LEN)
             + helpers.simulate_reads(rng, chr2, 80, READ_LEN))
    # reads over the N gap keep their Ns and get no substitutions
    reads = [r if "N" in r else helpers.mutate_reads(rng, [r], 0.01)[0]
             for r in reads]
    reads += [helpers.revcomp(r) for r in reads[:40]]
    reads += [helpers.random_genome(rng, READ_LEN) for _ in range(30)]
    reads += ["N" * READ_LEN] * 3
    gap = chr1.find("N")
    reads += [chr1[gap + o: gap + o + READ_LEN] for o in range(-80, 20, 7)]
    reads += [chr1[15000 + o: 15000 + o + READ_LEN]
              for o in range(-60, 1560, 37)]
    reads += [chr1[1000 + 13 * i: 1000 + 13 * i + 50]
              + chr2[500 + 11 * i: 500 + 11 * i + 50] for i in range(40)]
    return [r for r in reads if len(r) == READ_LEN]


def _packed(rows):
    fmt, pk, aux = trowpack.pack_batch(rows)
    return fmt, pk, aux, torch.from_numpy(pk), trowpack.aux_tensor(fmt, aux)


def _t64(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


# -- probes, packing, rank_at, windows -------------------------------------

def test_probe_packed_matches_jax(world):
    jix, tix = world["jindex"], world["tindex"]
    khi, klo = jcodec.split_u64(world["jdic"].kmers_in_order)
    qhi = np.concatenate([khi, khi[:300] ^ 1, [0, 0]]).astype(np.uint32)
    qlo = np.concatenate([klo, klo[:300], [0, 5]]).astype(np.uint32)
    want = [np.asarray(a) for a in jpacked.probe_packed(
        jix.rows, jnp.asarray(qhi), jnp.asarray(qlo), jix.n_buckets,
        jnp.uint32(12345))]
    got = tpacked.probe_packed(tix.rows, _t64(qhi), _t64(qlo), tix.n_buckets,
                               12345)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert want[0][: len(khi)].all() and not want[0][len(khi):].any()


@pytest.mark.parametrize("fmt", ["lens", "mask"])
def test_pack_batch_matches_jax(fmt):
    rng = np.random.default_rng(len(fmt))
    for L in (7, 100, 160, 161):
        rows = rng.integers(0, 4, (41, L)).astype(np.uint8)
        lens = rng.integers(0, L + 1, 41)
        rows[np.arange(L)[None, :] >= lens[:, None]] = jcodec.SEP
        if fmt == "mask":
            rows[rng.random(rows.shape) < 0.02] = jcodec.SEP
            rows[0, L // 2] = jcodec.SEP
            rows[0, : L // 2] = 1
        want = jrowpack.pack_batch(rows)
        got = trowpack.pack_batch(rows)
        assert got[0] == want[0] == fmt
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        back = trowpack.unpack_batch(fmt, torch.from_numpy(got[1]),
                                     trowpack.aux_tensor(fmt, got[2]),
                                     read_len=L).numpy()
        jback = np.asarray(jrowpack.unpack_batch(
            fmt, jnp.asarray(want[1]), jnp.asarray(want[2]), read_len=L))
        np.testing.assert_array_equal(back, jback)
        np.testing.assert_array_equal(back, rows)


def test_rank_at_and_fetch_window_match_jax(world):
    jix, tix = world["jindex"], world["tindex"]
    G = tix.genome_tiles.numel()
    rng = np.random.default_rng(4)
    q = np.concatenate([rng.integers(0, G, 500), [0, 1, 31, 32, 63, 64,
                                                  G - 1]])
    want = np.asarray(janch.rank_at(jix.dblock, jnp.asarray(q, jnp.int32)))
    got = tkanch.rank_at(tix.dblock, torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), want)
    start = np.concatenate([rng.integers(-300, G + 300, 400),
                            [-1, -64, -65, 0, G - 100, G - 99, G - 1, G,
                             G + 63, G + 64, G + 1000]])
    for width in (100, 160):
        want = np.asarray(janch.fetch_genome_window(
            jix.genome_tiles, jnp.asarray(start, jnp.int32), width))
        got = tkanch.fetch_genome_window(tix.genome_tiles,
                                         torch.from_numpy(start), width)
        np.testing.assert_array_equal(got.numpy(), want)


# -- the anchored read pass (K3's plain version) ---------------------------

@pytest.mark.parametrize("branch,n_rate", [("neighbor", 0.0),
                                           ("neighbor", 0.003),
                                           ("point", 0.003),
                                           ("runs", 0.003)])
def test_anchored_count_matches_jax(world, branch, n_rate):
    """diff words and spill codes of one batch, in the lens format
    (n_rate 0) or the mask format (N bases scattered)."""
    jix, tix = world["jindex"], world["tindex"]
    rows = _rows(_mixed_reads(world, 6))
    rng = np.random.default_rng(7)
    rows = np.where(rng.random(rows.shape) < n_rate, jcodec.SEP,
                    rows).astype(np.uint8)
    fmt, pk, aux, pk_t, aux_t = _packed(rows)
    assert fmt == ("lens" if n_rate == 0 else "mask")
    kw = dict(k=K, read_len=READ_LEN, anchor_offsets=OFFSETS,
              **TIER_KW[branch])
    jdiff, jcode = janch.anchored_count_batch_packed(
        jnp.asarray(pk), jnp.asarray(aux), jix.rows, jix.genome_tiles,
        jix.dblock, jnp.zeros(jix.n_kmers + 2, jnp.uint32), None, fmt=fmt,
        n_buckets=jix.n_buckets, **kw)
    diff = torch.zeros(tix.n_kmers + 2, dtype=torch.int64)
    code = tkanch.anchored_count(pk_t, aux_t, tix.rows, tix.genome_tiles,
                                 tix.dblock, diff, fmt=fmt,
                                 n_buckets=tix.n_buckets, **kw)
    jcode = np.asarray(jcode)
    np.testing.assert_array_equal(code.numpy(), jcode)
    np.testing.assert_array_equal(diff.numpy().astype(np.uint32),
                                  np.asarray(jdiff))
    # every code occurs, and counted reads add ranges
    assert set(np.unique(jcode)) == {0, 1, 2}
    assert (diff.numpy() != 0).sum() > 100


def _planted_long_reads(rng, src: str, width: int) -> list[str]:
    """Reads of width + 100 bases of src with one to three substitutions
    at bases 1,000-1,060, across the first tile boundary (1,024) of the
    kernel's walk over rows wider than 1,024; every other one reverse
    complemented (so its errors sit near its end)."""
    reads = []
    for j in range(8):
        s = int(rng.integers(0, len(src) - width - 100))
        r = list(src[s:s + width + 100])
        for p in rng.choice(np.arange(1000, 1061), 1 + j % 3, replace=False):
            r[p] = "ACGT"[("ACGT".index(r[p]) + 1 + j % 3) % 4]
        r = "".join(r)
        reads.append(r if j % 2 == 0 else helpers.revcomp(r))
    return reads


def _rows_of_width(world, width: int, seed: int) -> np.ndarray:
    """Rows of `width` from the world's chromosomes. 64: reads of 64 at
    1 %/bp, reverse complements, garbage, reads over the N gap and the
    repeat. 1024: 10 kb reads at 0.3 %/bp (one reverse complemented)
    cut into k-1-overlap segments, as the count cuts long reads. Wider
    (2048, 3000): four 9 kb reads clean and four at 0.1 %/bp, the
    planted reads of _planted_long_reads and a read over the N gap and
    the repeat, cut into segments; at widths that are no multiple of 32
    an N is planted at bases 1,000-1,060 of every fourth planted read
    (the mask format)."""
    rng = np.random.default_rng(seed)
    chr1, chr2 = world["chr1"], world["chr2"]
    if width > 1024:
        src = chr1[:15000]
        reads = (helpers.simulate_reads(rng, src, 4, 9000)
                 + helpers.mutate_reads(
                     rng, helpers.simulate_reads(rng, src, 4, 9000), 0.001))
        reads.append(helpers.revcomp(reads[4]))
        planted = _planted_long_reads(rng, src, width)
        if width % 32:
            for j in range(3, len(planted), 4):
                p = int(rng.integers(1000, 1061))
                planted[j] = planted[j][:p] + "N" + planted[j][p + 1:]
        gap = chr1.find("N")
        reads += planted + [chr1[gap - width: gap + 1600]]
    elif width == 1024:
        reads = helpers.mutate_reads(
            rng, helpers.simulate_reads(rng, chr1, 4, 10000)
            + helpers.simulate_reads(rng, chr2, 1, 5000), 0.003)
        reads.append(helpers.revcomp(reads[0]))
    else:
        reads = helpers.mutate_reads(
            rng, helpers.simulate_reads(rng, chr1, 200, width)
            + helpers.simulate_reads(rng, chr2, 60, width), 0.01)
        reads += [helpers.revcomp(r) for r in reads[:30]]
        reads += [helpers.random_genome(rng, width) for _ in range(20)]
        gap = chr1.find("N")
        reads += [chr1[gap + o: gap + o + width] for o in range(-60, 20, 9)]
        reads += [chr1[15000 + o: 15000 + o + width]
                  for o in range(-40, 1560, 41)]
    stream = np.concatenate([np.append(jcodec.encode_bases(r.encode()),
                                       jcodec.SEP) for r in reads])
    return janch.rows_from_flat_codes(stream.astype(np.uint8), width,
                                      segment_k=K)


def _wide_match_jax(world, rows, width, branch):
    """K3's plain version against the JAX function on rows of `width`
    (anchors spread over the row's windows), diff words and spill codes
    exactly; returns (codes, diff)."""
    jix, tix = world["jindex"], world["tindex"]
    fmt, pk, aux, pk_t, aux_t = _packed(rows)
    w = width - K + 1
    kw = dict(k=K, read_len=width,
              anchor_offsets=tuple(sorted({0, w // 3, (2 * w) // 3, w - 1})),
              **TIER_KW[branch])
    jdiff, jcode = janch.anchored_count_batch_packed(
        jnp.asarray(pk), jnp.asarray(aux), jix.rows, jix.genome_tiles,
        jix.dblock, jnp.zeros(jix.n_kmers + 2, jnp.uint32), None, fmt=fmt,
        n_buckets=jix.n_buckets, **kw)
    diff = torch.zeros(tix.n_kmers + 2, dtype=torch.int64)
    code = tkanch.anchored_count(pk_t, aux_t, tix.rows, tix.genome_tiles,
                                 tix.dblock, diff, fmt=fmt,
                                 n_buckets=tix.n_buckets, **kw)
    jcode = np.asarray(jcode)
    np.testing.assert_array_equal(code.numpy(), jcode)
    np.testing.assert_array_equal(diff.numpy().astype(np.uint32),
                                  np.asarray(jdiff))
    return jcode, diff.numpy()


@pytest.mark.parametrize("width", [64, 1024, 2048, 3000])
@pytest.mark.parametrize("branch", ["neighbor", "runs", "point"])
def test_anchored_count_widths_match_jax(world, width, branch):
    """K3's plain version at the row widths its layout branches on (2
    and 32 lanes a read; a block of a warp a tile of 1,024 bases, at a
    width that is a multiple of 32 and one that is not), in tier 1 (with
    the neighbor bits or point probes) and tier 2."""
    jcode, diff = _wide_match_jax(world, _rows_of_width(world, width, width),
                                  width, branch)
    # point probes spill most reads (a substitution dirties k windows)
    assert (jcode == 0).sum() > 0
    assert (diff != 0).sum() > (4 if branch == "point" else 50)


def _tile_edge_reads(rng, src: str, width: int) -> list[str]:
    """Reads of `width` bases of src (every other one reverse
    complemented) with one to three substitutions within 40 bases of each
    tile boundary of K3's block past the first (bases 2,048, 3,072, ...);
    and two error-free reads, each one clean run over all of its
    tiles."""
    reads = []
    for j in range(12):
        s = int(rng.integers(0, len(src) - width))
        r = src[s:s + width]
        r = list(r if j % 2 == 0 else helpers.revcomp(r))
        for b in range(2048, width, 1024):
            for p in rng.choice(np.arange(b - 40, min(b + 40, width)),
                                1 + j % 3, replace=False):
                r[p] = "ACGT"[("ACGT".index(r[p]) + 1 + j % 3) % 4]
        reads.append("".join(r))
    for s in (200, 6000):
        reads.append(src[s:s + width])
    return reads


@pytest.mark.parametrize("with_n", [False, True])
@pytest.mark.parametrize("branch", ["neighbor", "point", "runs"])
def test_anchored_count_tile_edges_match_jax(world, branch, with_n):
    """K3's plain version on rows of 3,000 whose substitutions (with_n:
    and N bases, the mask format) sit across the second tile boundary
    (base 2,048) of the block that takes rows wider than 1,024, and on
    reads that are one clean run over all three tiles."""
    width = 3000
    reads = _tile_edge_reads(np.random.default_rng(3), world["chr1"][:15000],
                             width)
    stream = np.concatenate([np.append(jcodec.encode_bases(r.encode()),
                                       jcodec.SEP) for r in reads])
    rows = janch.rows_from_flat_codes(stream.astype(np.uint8), width,
                                      segment_k=K)
    assert rows.shape == (len(reads), width)
    if with_n:                          # an N by base 2,048, every other row
        rows[1:-2:2, 2047:2050] = jcodec.SEP
    jcode, diff = _wide_match_jax(world, rows, width, branch)
    # the clean reads add their runs; the planted ones spill or count
    assert (jcode[-2:] == 0).all() and (jcode[:-2] == 1).any()
    assert (diff != 0).sum() >= 4


def test_anchor_probes_wide_blocks_match_jax(world):
    """K3a's plain version on rows of 2,048 under a two-block split: each
    block's found / pos are the JAX function's per-block anchor probes
    (probe_packed_block on the block's rows, found only where the window
    is valid); their sum holds one hit an anchor, and K3 on the blocks
    with it adds, over the blocks, the one-device diff and codes."""
    jix, tix = world["jindex"], world["tindex"]
    L = 2048
    rows = _rows_of_width(world, L, 7 * L)
    fmt, pk, aux, pk_t, aux_t = _packed(rows)
    R, w = len(rows), L - K + 1
    offs = tuple(sorted({0, w // 3, (2 * w) // 3, w - 1}))
    chi_f, clo_f, valid_f = jcodec.sliding_kmers(jnp.asarray(rows.reshape(-1)),
                                                 K)
    pad = R * L - chi_f.shape[0]
    chi, clo, valid = (np.pad(np.asarray(a), (0, pad)).reshape(R, L)[:, :w]
                       for a in (chi_f, clo_f, valid_f))
    bb = tix.n_buckets // 2
    kw = dict(fmt=fmt, k=K, read_len=L, n_buckets=tix.n_buckets,
              anchor_offsets=offs)
    found = pos = 0
    for j in range(2):
        f, p = tkanch.anchor_probes(pk_t, aux_t, tix.rows[j * bb:(j + 1) * bb],
                                    blk_lo=j * bb, block_buckets=bb, **kw)
        for i, a in enumerate(offs):
            jf, _, jp = jpacked.probe_packed_block(
                jix.rows[j * bb:(j + 1) * bb], jnp.asarray(chi[:, a]),
                jnp.asarray(clo[:, a]), jix.n_buckets, bb,
                jnp.uint32(j * bb), jnp.uint32(0))
            want_f = np.asarray(jf) & valid[:, a]
            np.testing.assert_array_equal(f[i].numpy(), want_f)
            np.testing.assert_array_equal(
                p[i].numpy(), np.where(want_f, np.asarray(jp), 0))
        found, pos = found + f.long(), pos + p
    assert int(found.max()) <= 1 and int(found.sum()) > R
    tier = TIER_KW["runs"]
    one = torch.zeros(tix.n_kmers + 2, dtype=torch.int64)
    want_code = tkanch.anchored_count(pk_t, aux_t, tix.rows, tix.genome_tiles,
                                      tix.dblock, one, **kw, **tier)
    total = torch.zeros_like(one)
    for j in range(2):
        d = torch.zeros_like(one)
        code = tkanch.anchored_count(
            pk_t, aux_t, tix.rows[j * bb:(j + 1) * bb], tix.genome_tiles,
            tix.dblock, d, anchors=(found.to(torch.uint8), pos),
            blk_lo=j * bb, block_buckets=bb, ranges=j == 0, **kw, **tier)
        np.testing.assert_array_equal(code.numpy(), want_code.numpy())
        total = (total + d) & 0xFFFFFFFF
    np.testing.assert_array_equal(total.numpy(), one.numpy())
    assert (want_code.numpy() == 0).sum() > 0


@pytest.mark.parametrize("read_len,ok", [(2048, True), (65535, True),
                                         (65536, False)])
def test_wrapper_checks_take_rows_up_to_u16(read_len, ok):
    """K3's and K3a's option checks (what their wrappers run on the card)
    take rows up to 65,535 bases and refuse wider ones, naming the
    reason: the lens format's u16 lengths, which wrap a full row of
    65,536 to 0 (the JAX package's rowpack.row_suffix_lens too)."""
    last = read_len - K
    checks = [
        lambda: tkanch.check_anchored_count(
            fmt="lens", k=K, read_len=read_len, n_rows=3,
            anchor_offsets=(0, last // 2, last), n_tiles=8, dblock_rows=8,
            n_diff=10, n_buckets=64),
        lambda: tkanch.check_anchor_probes(
            fmt="mask", k=K, read_len=read_len, n_rows=3,
            anchor_offsets=(0, last), n_buckets=64, blk_lo=32,
            block_buckets=32, bitmap_words=1024)]
    for check in checks:
        if ok:
            check()
        else:
            with pytest.raises(ValueError, match="65535.*u16"):
                check()
    if not ok:
        full = np.zeros((1, read_len), np.uint8)
        assert int(jrowpack.row_suffix_lens(full)[0]) == 0
        assert int(jrowpack.row_suffix_lens(full[:, :-1])[0]) == 65535


def test_exact_count_rows_mono_matches_jax(world):
    """K2r's plain version: slot depth and the set of unresolved lanes,
    on a crowded mono table (load 2: a side table and full buckets)."""
    khi, klo = jcodec.split_u64(world["jdic"].kmers_in_order)
    jt = jmono.MonoTable.build(khi, klo, load=2.0)
    tt = tmono.MonoTable.build(khi, klo, load=2.0)
    assert jt.side is not None
    for n_rate in (0.0, 0.01):
        rows = _rows(_mixed_reads(world, 8))
        rows = np.where(np.random.default_rng(9).random(rows.shape) < n_rate,
                        jcodec.SEP, rows).astype(np.uint8)
        fmt, pk, aux, pk_t, aux_t = _packed(rows)
        jdepth, jub = janch.exact_count_rows_mono_packed(
            jnp.asarray(pk), jnp.asarray(aux), jnp.asarray(jt.rows),
            jnp.zeros(jt.n_slots + 1, jnp.uint32), fmt=fmt, k=K,
            n_buckets=jt.n_buckets, read_len=READ_LEN)
        depth = torch.zeros(tt.n_slots + 1, dtype=torch.int64)
        words = count_mono_rows(pk_t, aux_t, _t64(tt.rows), depth, fmt=fmt,
                                k=K, n_buckets=tt.n_buckets,
                                read_len=READ_LEN)
        n_lanes = len(rows) * W
        want = np.flatnonzero(np.unpackbits(np.asarray(jub))[:n_lanes])
        got = np.flatnonzero(np.unpackbits(
            words.numpy().astype(np.uint32).view(np.uint8),
            bitorder="little")[:n_lanes])
        np.testing.assert_array_equal(got, want)
        assert len(want) > 0
        np.testing.assert_array_equal(depth.numpy()[:-1],
                                      np.asarray(jdepth)[:-1])


def _rows_at(fmt: str, L: int, k: int) -> tuple[np.ndarray, tuple]:
    """Rows of width L drawn from a seeded random genome at 1 %/bp
    (reverse complemented in turn) plus random rows, in the lens format
    (suffix SEP padding at random lengths) or the mask format (SEP bases
    anywhere); and both packages' mono tables of the genome's unique
    k-mers at load 2 (full buckets and a side table)."""
    rng = np.random.default_rng(10 * L + k)
    g = rng.integers(0, 4, 4000).astype(np.uint8)
    canon, valid = jcodec.sliding_kmers_np(g, k)
    uniq, cnt = np.unique(canon[valid & (canon != 0)], return_counts=True)
    khi, klo = jcodec.split_u64(uniq[cnt == 1])
    tables = (jmono.MonoTable.build(khi, klo, load=2.0),
              tmono.MonoTable.build(khi, klo, load=2.0))
    starts = rng.integers(0, len(g) - L, 120)
    rows = g[starts[:, None] + np.arange(L)[None, :]]
    rows = np.where(rng.random(rows.shape) < 0.01, (rows + 1) % 4, rows)
    rows[::2] = (rows[::2, ::-1] + 2) % 4
    rows = np.concatenate([rows, rng.integers(0, 4, (9, L))]).astype(np.uint8)
    if fmt == "lens":
        cut = rng.integers(k - 1, L + 1, len(rows))
        cut[::3] = L
        rows[np.arange(L)[None, :] >= cut[:, None]] = jcodec.SEP
    else:
        rows[rng.random(rows.shape) < 0.01] = jcodec.SEP
    return rows, tables


@pytest.mark.parametrize("k", [15, 31, 32])
@pytest.mark.parametrize("L", [64, 150, 160])
@pytest.mark.parametrize("fmt", ["lens", "mask"])
def test_exact_count_rows_mono_shapes_match_jax(fmt, L, k):
    """K2r's plain version at the row widths and k its window map
    branches on (a 38-B pitch at L = 150, k = 32 filling the code):
    slot depth and the unresolved lanes, exactly."""
    rows, (jt, tt) = _rows_at(fmt, L, k)
    assert jt.side is not None
    fmt_got, pk, aux, pk_t, aux_t = _packed(rows)
    assert fmt_got == fmt
    jdepth, jub = janch.exact_count_rows_mono_packed(
        jnp.asarray(pk), jnp.asarray(aux), jnp.asarray(jt.rows),
        jnp.zeros(jt.n_slots + 1, jnp.uint32), fmt=fmt, k=k,
        n_buckets=jt.n_buckets, read_len=L)
    depth = torch.zeros(tt.n_slots + 1, dtype=torch.int64)
    words = count_mono_rows_plain(pk_t, aux_t, _t64(tt.rows), depth, fmt=fmt,
                                  k=k, n_buckets=tt.n_buckets, read_len=L)
    n_lanes = len(rows) * (L - k + 1)
    want = np.unpackbits(np.asarray(jub))[:n_lanes]
    got = np.unpackbits(words.numpy().astype(np.uint32).view(np.uint8),
                        bitorder="little")
    np.testing.assert_array_equal(got[:n_lanes], want)
    assert not got[n_lanes:].any() and want.any()
    want_depth = np.asarray(jdepth)[:-1]
    np.testing.assert_array_equal(depth.numpy()[:-1].astype(np.uint32),
                                  want_depth)
    assert want_depth.sum() > 0


# -- the neighbor bitmap and the .qai --------------------------------------

def test_neighbor_bits_builders_match_jax():
    """Host builder and the plain K4 sweep (chunked, across seams) against
    the JAX host builder, on a genome with planted one-substitution
    pairs so that the bitmap has hits."""
    rng = np.random.default_rng(9)
    genome = helpers.random_genome(rng, 3000)
    muts = []
    for at in (100, 900, 2000):
        blk = genome[at: at + 60]
        muts.append(blk[:31] + ("A" if blk[31] != "A" else "C") + blk[32:])
    genome = genome + "N" + "".join(muts) + "NN" + helpers.random_genome(rng, 50)
    codes = jcodec.encode_bases(genome.encode())
    canon, valid = jcodec.sliding_kmers_np(codes, K)
    valid &= canon != 0
    uniq, counts = np.unique(canon[valid], return_counts=True)
    kmers = uniq[counts == 1]
    khi, klo = jcodec.split_u64(kmers)
    rank = np.arange(len(kmers), dtype=np.uint32)
    jt = jpacked.PackedTable.build(khi, klo, rank)
    tt = tpacked.PackedTable.build(khi, klo, rank)
    np.testing.assert_array_equal(tt.rows, jt.rows)
    want = janch.build_neighbor_bits(codes, jt.rows, jt.n_buckets, K)
    assert want.any()
    np.testing.assert_array_equal(
        tanch.build_neighbor_bits(codes, tt.rows, tt.n_buckets, K), want)
    for chunk in (1 << 23, 500, 4 * K):
        np.testing.assert_array_equal(tanch.build_neighbor_bits_device(
            codes, _t64(tt.rows), tt.n_buckets, K, chunk=chunk), want)


def test_qai_bytes_and_cross_load(world, tmp_path):
    fa, jdic, tdic = world["fa"], world["jdic"], world["tdic"]
    jq, tq = str(tmp_path / "jax.qai"), str(tmp_path / "port.qai")
    janch.AnchoredIndex.from_dictionary_and_fasta(jdic, fa, cache_path=jq)
    tanch.AnchoredIndex.from_dictionary_and_fasta(tdic, fa, cache_path=tq,
                                                  device="cpu")
    with open(jq, "rb") as f, open(tq, "rb") as g:
        jbytes, tbytes = f.read(), g.read()
    assert tbytes == jbytes and len(jbytes) > 40
    # the K4 sweep (device_build) writes the same bytes
    tq2 = str(tmp_path / "port_sweep.qai")
    tanch.AnchoredIndex.from_dictionary_and_fasta(
        tdic, fa, cache_path=tq2, device_build=True, device="cpu")
    with open(tq2, "rb") as f:
        assert f.read() == jbytes
    # each package loads the other's
    got = tanch.AnchoredIndex.load(jq, tdic, device="cpu")
    want = janch.AnchoredIndex.load(tq, jdic)
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
    np.testing.assert_array_equal(got.genome_tiles.numpy(),
                                  np.asarray(want.genome_tiles))
    np.testing.assert_array_equal(got.dblock.numpy(), np.asarray(want.dblock))
    assert (got.genome_len, got.n_kmers, got.has_neighbor_bits) == \
        (want.genome_len, want.n_kmers, want.has_neighbor_bits)
    assert tformats.read_qai(tq)[5] == tdic.fingerprint
    # a stale artifact is refused
    k_, G_, tiles_, pos_, nb_, fp_ = jformats.read_qai(jq)
    tformats.write_qai(tq, k_, G_, tiles_, pos_[:-5], nb_, fp_)
    with pytest.raises(ValueError, match="stale"):
        tanch.AnchoredIndex.load(tq, tdic, device="cpu")


# -- the counter and the pipeline --------------------------------------------

def _counters(world, neighbor: bool, **kw):
    if neighbor:
        jix, tix = world["jindex"], world["tindex"]
    else:
        jix = janch.AnchoredIndex.from_dictionary_and_fasta(
            world["jdic"], world["fa"], neighbor_bits=False)
        tix = tanch.AnchoredIndex.from_dictionary_and_fasta(
            world["tdic"], world["fa"], neighbor_bits=False, device="cpu")
    return (janch.AnchoredDepthCounter(jix, K, READ_LEN, batch_reads=128,
                                       **kw),
            tanch.AnchoredDepthCounter(tix, K, READ_LEN, batch_reads=128,
                                       device="cpu", **kw))


@pytest.mark.parametrize("neighbor", [True, False])
def test_counter_matches_jax(world, neighbor):
    rows = _rows(_mixed_reads(world, 10))
    jc, tc = _counters(world, neighbor, spill_lag=2, put_depth=1)
    for part in np.array_split(rows, 5):
        jc.feed_reads(part)
        tc.feed_reads(part)
    want = jc.finish()
    got = tc.finish()
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0
    assert (tc.n_reads, tc.n_spilled, tc.n_spilled2) == \
        (jc.n_reads, jc.n_spilled, jc.n_spilled2)
    assert tc.n_spilled > tc.n_spilled2 > 0


def test_counter_resumes_from_jax_snapshot(world):
    rows = _rows(_mixed_reads(world, 11))
    cut = len(rows) * 3 // 5
    jfull, _ = _counters(world, True)
    jfull.feed_reads(rows)
    want = jfull.finish()
    jhalf, tc = _counters(world, True)
    jhalf.feed_reads(rows[:cut])
    arrays, meta = jhalf.snapshot()
    tc.restore(arrays, meta)
    tc.feed_reads(rows[cut:])
    np.testing.assert_array_equal(tc.finish(), want)
    assert (tc.n_spilled, tc.n_spilled2) == (jfull.n_spilled,
                                            jfull.n_spilled2)
    # a snapshot whose plain-count accumulator is not zero: depth is
    # cumsum(diff) + exact_acc, so moving counts between them is neutral
    acc = np.random.default_rng(3).integers(
        0, 1 << 32, len(arrays["diff"]), dtype=np.uint64).astype(np.uint32)
    moved = dict(arrays, exact_acc=acc,
                 diff=np.asarray(arrays["diff"], np.uint32)
                 - np.diff(acc, prepend=np.uint32(0)))
    _, tc3 = _counters(world, True)
    tc3.restore(moved, meta)
    tc3.feed_reads(rows[cut:])
    np.testing.assert_array_equal(tc3.finish(), want)
    # the port's own snapshot carries the JAX keys
    _, tc2 = _counters(world, True)
    tc2.feed_reads(rows[:cut])
    tarrays, tmeta = tc2.snapshot()
    assert set(tarrays) == set(arrays) and set(tmeta) == set(meta)
    for name in ("pending", "spill", "spill2", "side_counts"):
        np.testing.assert_array_equal(tarrays[name], arrays[name])
    np.testing.assert_array_equal(tarrays["diff"], arrays["diff"])


@pytest.mark.parametrize("lengths", [(100, 150), (120, 2000)])
def test_run_count_anchored_matches_jax(tmp_path, lengths):
    """run_count(mode="anchored") writes the JAX package's .bin and .txt,
    byte for byte, with long reads cut into segments."""
    from quickmer2_tpu.pipelines.count import run_count as jrun
    rng = np.random.default_rng(sum(lengths))
    chrom = helpers.random_genome(rng, 30000)
    outs = {}
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        d.mkdir()
        fa = str(d / "g.fa")
        helpers.write_fasta(fa, {"c1": chrom, "c2": chrom[:3000][::-1]})
        # a control bed gives the .qgc, hence the .txt; its last row
        # names another chromosome (the reference's stuck-last-row quirk)
        with open(d / "ctrl.bed", "w") as f:
            f.write(f"c1\t0\t{len(chrom)}\nc2\t0\t3000\nc9\t0\t100\n")
        _search(fa, str(d / "ctrl.bed"))
        outs[pkg] = (fa, str(d))
    reads = []
    for n, L in zip((400, 8), lengths):
        reads += helpers.simulate_reads(rng, chrom, n, L)
    reads = helpers.mutate_reads(rng, reads, 0.003)
    for pkg, (fa, d) in outs.items():
        helpers.write_fastq(d + "/r.fq", reads)
        kw = dict(batch_bases=1 << 16, verbose=False, mode="anchored",
                  ref_fasta=fa)
        if pkg == "jax":
            stats = jrun(fa + ".qm", d + "/r.fq", d + "/s", **kw)
        else:
            stats = tcount.run_count(fa + ".qm", d + "/r.fq", d + "/s",
                                     device="cpu", **kw)
        outs[pkg] = (d, stats)
    for ext in (".bin", ".txt"):
        with open(outs["jax"][0] + "/s" + ext, "rb") as f:
            want = f.read()
        with open(outs["port"][0] + "/s" + ext, "rb") as f:
            assert f.read() == want, ext
    js, ts = outs["jax"][1], outs["port"][1]
    for key in ("mode", "n_reads", "n_spilled", "n_spilled2", "read_len"):
        assert ts[key] == js[key], key
    if max(lengths) > 1024:
        assert ts["n_long_reads"] == js["n_long_reads"] == 8
        assert ts["n_segments"] == js["n_segments"]
    assert formats_nonzero(outs["port"][0] + "/s.bin")


def test_run_count_anchored_read_len_2048_matches_jax(tmp_path):
    """run_count(mode="anchored", read_len=2048) writes the JAX
    package's .bin and .txt, byte for byte, with long reads cut into
    segments of 2,048 (rows the card walks in tiles of 1,024), and the
    same n_long_reads and n_segments."""
    from quickmer2_tpu.pipelines.count import run_count as jrun
    rng = np.random.default_rng(2048)
    chrom = helpers.random_genome(rng, 30000)
    reads = helpers.mutate_reads(
        rng, helpers.simulate_reads(rng, chrom, 24, 5000)
        + helpers.simulate_reads(rng, chrom, 100, 150), 0.001)
    reads += _planted_long_reads(rng, chrom, 2048)
    outs = {}
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        d.mkdir()
        fa = str(d / "g.fa")
        helpers.write_fasta(fa, {"c1": chrom})
        with open(d / "ctrl.bed", "w") as f:
            f.write(f"c1\t0\t{len(chrom)}\nc9\t0\t100\n")
        _search(fa, str(d / "ctrl.bed"))
        helpers.write_fastq(str(d / "r.fq"), reads)
        kw = dict(batch_bases=1 << 16, verbose=False, mode="anchored",
                  ref_fasta=fa, read_len=2048)
        if pkg == "jax":
            stats = jrun(fa + ".qm", str(d / "r.fq"), str(d / "s"), **kw)
        else:
            stats = tcount.run_count(fa + ".qm", str(d / "r.fq"),
                                     str(d / "s"), device="cpu", **kw)
        outs[pkg] = (str(d), stats)
    for ext in (".bin", ".txt"):
        with open(outs["jax"][0] + "/s" + ext, "rb") as f:
            want = f.read()
        with open(outs["port"][0] + "/s" + ext, "rb") as f:
            assert f.read() == want, ext
    js, ts = outs["jax"][1], outs["port"][1]
    for key in ("mode", "n_reads", "n_spilled", "n_spilled2", "read_len",
                "n_long_reads", "n_segments"):
        assert ts[key] == js[key], key
    assert ts["read_len"] == 2048 and ts["n_long_reads"] == 32
    assert formats_nonzero(outs["port"][0] + "/s.bin")


def formats_nonzero(path: str) -> bool:
    return tformats.read_u16(path).sum() > 0


def test_rows_and_streamer_match_jax():
    rng = np.random.default_rng(12)
    read_len, k = 96, 30
    parts = []
    for L in (10, 96, 97, 163, 500, 1003, 40):
        parts += [rng.integers(0, 4, L).astype(np.uint8),
                  np.array([jcodec.SEP], np.uint8)]
    stream = np.concatenate(parts)
    for seg in (None, k):
        js, ts = {}, {}
        want = janch.rows_from_flat_codes(stream, read_len, True, seg, js)
        got = tanch.rows_from_flat_codes(stream, read_len, True, seg, ts)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert ts == js
        jrs, trs = janch.RowStreamer(read_len, seg), \
            tanch.RowStreamer(read_len, seg)
        cuts = np.sort(rng.integers(0, len(stream), 6))
        for a, b in zip([0, *cuts], [*cuts, len(stream)]):
            np.testing.assert_array_equal(trs.feed(stream[a:b]),
                                          jrs.feed(stream[a:b]))
        np.testing.assert_array_equal(trs.finish(), jrs.finish())
        np.testing.assert_array_equal(trs.take_overflow(),
                                      jrs.take_overflow())
        assert trs.stats == jrs.stats
    assert tcount._autodetect_read_len(stream) == \
        jcount._autodetect_read_len(stream)


def test_estimate_hbm_bytes_matches_jax():
    for n, g, ds in [(20000, 20000, 1), (11_000_000, 12_000_000, 1),
                     (11_000_000, 12_000_000, 4)]:
        assert tanch.AnchoredIndex.estimate_hbm_bytes(n, g, ds) == \
            janch.AnchoredIndex.estimate_hbm_bytes(n, g, ds)


def test_cli_anchored_matches_jax(tmp_path):
    """`count --mode anchored` of both CLIs on the same files."""
    import subprocess
    import sys
    from quickmer2_tpu.cli import main as jax_main
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rng = np.random.default_rng(13)
    chrom = helpers.random_genome(rng, 20000)
    reads = helpers.mutate_reads(
        rng, helpers.simulate_reads(rng, chrom, 500, 150), 0.005)
    outs = {}
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        d.mkdir()
        helpers.write_fasta(str(d / "g.fa"), {"c1": chrom})
        _search(str(d / "g.fa"))
        helpers.write_fastq(str(d / "r.fq"), reads)
        args = ["count", "--mode", "anchored", "--batch-bases", "65536",
                "g.fa", "r.fq", "s"]
        if pkg == "port":
            subprocess.run([sys.executable, "-m", "quickmer2_tpu_torch", *args,
                            "--device", "cpu"], cwd=str(d), check=True,
                           capture_output=True,
                           env=dict(os.environ, PYTHONPATH=root))
        else:
            cwd = os.getcwd()
            os.chdir(d)
            try:
                assert jax_main(args) == 0
            finally:
                os.chdir(cwd)
        outs[pkg] = str(d)
    for name in ("s.bin", "g.fa.qai"):
        with open(os.path.join(outs["jax"], name), "rb") as f:
            want = f.read()
        with open(os.path.join(outs["port"], name), "rb") as f:
            assert f.read() == want, name
