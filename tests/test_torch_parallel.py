"""The port's multi-device layer against the JAX package on the CPU (the
JAX side on its 8-device virtual CPU mesh, the port on copies of the CPU
device): the block probe, the packed exact recount (K12's plain
version), the flat ShardedDepthCounter (K8b), the ShardedAnchoredCounter
(K3a and K3 on bucket blocks), AnchoredDepthCounter(mono_spill=False),
run_count with data_devices / dict_devices, the sharded emit scanner,
snapshots restored across the packages, and the multichip dry run.
Integer outputs throughout, so the tolerance is exact equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from quickmer2_tpu.config import SearchConfig
from quickmer2_tpu.ops import anchored as janch
from quickmer2_tpu.ops import codec as jcodec
from quickmer2_tpu.ops import packed_table as jpacked
from quickmer2_tpu.parallel import anchored_parallel as janpar
from quickmer2_tpu.parallel import count_parallel as jcpar
from quickmer2_tpu.parallel import emit_parallel as jemit
from quickmer2_tpu.parallel.mesh import make_mesh as jmesh
from quickmer2_tpu.pipelines import count as jcount
from quickmer2_tpu.pipelines import search as jsearch
from quickmer2_tpu_torch import dictionary as tdict
from quickmer2_tpu_torch.kernels import anchored as tkanch
from quickmer2_tpu_torch.kernels import count_mono as tkmono
from quickmer2_tpu_torch.ops import anchored as tanch
from quickmer2_tpu_torch.ops import packed_table as tpacked
from quickmer2_tpu_torch.ops import rowpack as trowpack
from quickmer2_tpu_torch.parallel import anchored_parallel as tanpar
from quickmer2_tpu_torch.parallel import count_parallel as tcpar
from quickmer2_tpu_torch.parallel import emit_parallel as temit
from quickmer2_tpu_torch.parallel.mesh import make_mesh as tmesh
from quickmer2_tpu_torch.pipelines import count as tcount
from tests import helpers
from tests.torch_threads import few_threads  # noqa: F401

K = 30
READ_LEN = 100


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A genome with an N gap and a repeated segment, both packages'
    dictionaries and anchored indexes, and mixed reads (clean, 1 %/bp
    errors, garbage, over the gap and the repeat) as rows and codes."""
    rng = np.random.default_rng(91)
    d = tmp_path_factory.mktemp("tpar")
    rep = helpers.random_genome(rng, 1200)
    chr1 = (helpers.random_genome(rng, 12000) + rep + "N" * 30
            + helpers.random_genome(rng, 6000) + rep)
    chr2 = helpers.random_genome(rng, 5000)
    fa = str(d / "g.fa")
    helpers.write_fasta(fa, {"c1": chr1, "c2": chr2})
    jdic = jsearch.run_search(fa, SearchConfig(
        kmer_size=K, hash_size=1 << 16, edit_distance=0, window_size=100),
        verbose=False)
    tdic = tdict.Dictionary.from_qm(fa + ".qm")
    reads = (helpers.simulate_reads(rng, chr1, 500, READ_LEN)
             + helpers.simulate_reads(rng, chr2, 150, READ_LEN))
    reads = [r if "N" in r else helpers.mutate_reads(rng, [r], 0.01)[0]
             for r in reads]
    reads += [helpers.random_genome(rng, READ_LEN) for _ in range(40)]
    gap = chr1.find("N")
    reads += [chr1[gap + o: gap + o + READ_LEN] for o in range(-80, 20, 9)]
    reads += [chr1[12000 + o: 12000 + o + READ_LEN]
              for o in range(-60, 1200, 53)]
    reads = [r for r in reads if len(r) == READ_LEN]
    blob = "".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)).encode()
    codes = jcount.make_packer("fasta-lines").feed(blob)
    return {"fa": fa, "chr1": chr1, "jdic": jdic, "tdic": tdic,
            "codes": codes,
            "rows": janch.rows_from_flat_codes(codes, READ_LEN),
            "jindex": janch.AnchoredIndex.from_dictionary_and_fasta(jdic, fa),
            "tindex": tanch.AnchoredIndex.from_dictionary_and_fasta(
                tdic, fa, device="cpu")}


def _t64(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_make_mesh():
    m = tmesh(2, 2, device="cpu")
    assert m.shape == {"data": 2, "dict": 2}
    assert m.distinct() == [torch.device("cpu")]
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        tmesh(2, 2, devices=["cpu", "cpu"])


@pytest.mark.parametrize("ds", [1, 2, 4])
def test_probe_packed_block_matches_jax(world, ds):
    jix, tix = world["jindex"], world["tindex"]
    khi, klo = jcodec.split_u64(world["jdic"].kmers_in_order)
    qhi = np.concatenate([khi, khi[:200] ^ 1, [0, 0]]).astype(np.uint32)
    qlo = np.concatenate([klo, klo[:200], [0, 7]]).astype(np.uint32)
    bb = tix.n_buckets // ds
    found = np.zeros(len(qhi), np.int64)
    for j in range(ds):
        want = [np.asarray(a) for a in jpacked.probe_packed_block(
            jix.rows[j * bb:(j + 1) * bb], jnp.asarray(qhi), jnp.asarray(qlo),
            jix.n_buckets, bb, j * bb, jnp.uint32(99))]
        got = tpacked.probe_packed_block(
            tix.rows[j * bb:(j + 1) * bb], _t64(qhi), _t64(qlo),
            tix.n_buckets, bb, j * bb, 99)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
        found += want[0]
    # each key is found on exactly one block
    np.testing.assert_array_equal(found[: len(khi)], 1)
    assert not found[len(khi):].any()


def _jax_exact_blocked(jix, reads, ds):
    """JAX's exact_count_rows under a dict axis of ds virtual devices:
    the per-block partials u32[ds, n + 2]."""
    mesh = jmesh(1, ds)
    bb = jix.n_buckets // ds
    rows = jax.device_put(np.asarray(jix.rows).reshape(ds, bb, -1),
                          NamedSharding(mesh, P("dict", None, None)))

    def local(rows, depth):
        return janch.exact_count_rows(
            jnp.asarray(reads), jnp.ones(len(reads), bool), rows[0],
            depth[0], k=K, n_buckets=jix.n_buckets, dict_axis="dict",
            block_buckets=bb)[None]
    step = jax.jit(jax.shard_map(local, mesh=mesh,
                                 in_specs=(P("dict", None, None),
                                           P("dict", None)),
                                 out_specs=P("dict", None)))
    depth = np.zeros((ds, jix.n_kmers + 2), np.uint32)
    return np.asarray(step(rows, jax.device_put(
        depth, NamedSharding(mesh, P("dict", None)))))


@pytest.mark.parametrize("ds", [1, 2, 4])
@pytest.mark.parametrize("fmt", ["lens", "mask"])
def test_exact_count_rows_matches_jax(world, ds, fmt):
    """K12's plain version, on the whole table (ds = 1) and block by
    block, against JAX's exact_count_rows (its per-block partials under a
    dict axis); the trash word, which K12 does not write, is left out."""
    jix, tix = world["jindex"], world["tindex"]
    reads = world["rows"][:300].copy()
    if fmt == "mask":
        reads[::7, 40] = jcodec.SEP
    n = jix.n_kmers
    if ds == 1:
        want = np.asarray(janch.exact_count_rows(
            jnp.asarray(reads), jnp.ones(len(reads), bool), jix.rows,
            jnp.zeros(n + 2, jnp.uint32), k=K, n_buckets=jix.n_buckets))[None]
    else:
        want = _jax_exact_blocked(jix, reads, ds)
    f, pk, aux = trowpack.pack_batch(reads)
    assert f == fmt
    bb = tix.n_buckets // ds
    for j in range(ds):
        acc = torch.zeros(n + 2, dtype=torch.int64)
        tkmono.count_packed_rows(
            torch.from_numpy(pk), trowpack.aux_tensor(fmt, aux),
            tix.rows[j * bb:(j + 1) * bb], acc, fmt=fmt, k=K,
            n_buckets=tix.n_buckets, read_len=READ_LEN, blk_lo=j * bb,
            block_buckets=bb)
        np.testing.assert_array_equal(acc.numpy()[:-1], want[j, :-1])
        assert acc[-1] == 0


def _segments(kmers: np.ndarray, k: int) -> np.ndarray:
    """Codes of each k-mer (MSB-first 2-bit) followed by a separator."""
    shifts = 2 * np.arange(k - 1, -1, -1, dtype=np.uint64)
    bases = ((kmers[:, None] >> shifts[None, :]) & np.uint64(3)).astype(
        np.uint8)
    sep = np.full((len(kmers), 1), jcodec.SEP, np.uint8)
    return np.concatenate([bases, sep], 1).reshape(-1)


@pytest.mark.parametrize("case,ds", [("reads", 1), ("reads", 2),
                                     ("reads", 4), ("one_block", 2)])
def test_block_step_plain_matches_jax_local_step(world, case, ds):
    """K8b's plain version on each bucket block, translated to rank
    space, equals the JAX sharded step's partial depth[0, j] on one data
    shard. "one_block": the shard is the dictionary's keys whose both
    candidate buckets lie in block 1, each as a k-base segment: block 0
    gets no local window (all trash) and every valid window is local to
    block 1 (each a hit)."""
    from quickmer2_tpu.ops.hash import djb_pair as jdjb
    from quickmer2_tpu_torch.kernels import count_flat as tkflat
    from quickmer2_tpu_torch.kernels.block_probe import (
        block_displaced_filter)
    jtable = jpacked.PackedTable.from_dictionary(world["jdic"])
    ttable = tpacked.PackedTable.from_dictionary(world["tdic"])
    np.testing.assert_array_equal(ttable.rows, jtable.rows)
    B, n = ttable.n_buckets, ttable.n_kmers
    bb = B // ds
    if case == "reads":
        codes = world["codes"][:20_000]
    else:
        km = world["jdic"].kmers_in_order
        khi, klo = jcodec.split_u64(km)
        h1, h2 = jpacked.bucket_hashes(np.asarray(jdjb(khi, klo)), B)
        codes = _segments(km[(h1 >= bb) & (h2 >= bb)][:500], K)
    mesh = jmesh(1, ds)
    step = jcpar.make_sharded_count_step(mesh, K, B, bb, n)
    want = np.asarray(step(
        jax.device_put(codes[None], NamedSharding(mesh, P("data", None))),
        jax.device_put(np.zeros((1, 1), np.uint8),
                       NamedSharding(mesh, P("data", None))),
        jax.device_put(jtable.rows.reshape(ds, bb, -1),
                       NamedSharding(mesh, P("dict", None, None))),
        jax.device_put(np.zeros((1, ds, n + 1), np.uint32),
                       NamedSharding(mesh, P("data", "dict", None)))))
    pk, bits = trowpack.pack_rows(codes[None])
    pk, bits = torch.from_numpy(pk[0]), torch.from_numpy(bits[0])
    n_win = len(codes) - K + 1
    for j in range(ds):
        rows = _t64(ttable.rows[j * bb:(j + 1) * bb])
        d = torch.zeros(2 * bb + 1, dtype=torch.int64)
        disp = block_displaced_filter(rows, B, j * bb)
        tkflat.count_packed_block_step(pk, bits, rows, disp, d, k=K,
                                       n_buckets=B, blk_lo=j * bb,
                                       block_buckets=bb, n_bases=len(codes))
        got = tkflat.block_slot_depth_to_rank(
            d, tkflat.packed_block_entries(rows), n).numpy()
        np.testing.assert_array_equal(got, want[0, j])
        if case == "one_block":
            trash = n_win if j == 0 else n_win - 500
            assert got[n] == trash and got[:n].sum() == n_win - trash
    assert want[0, :, :n].sum() > 0


@pytest.mark.parametrize("n_parts,bb", [(512, 1 << 13), (256, 1 << 7),
                                        (48, 1 << 13)])
def test_block_launch_rejects_bad_slice_counts(n_parts, bb):
    """K8b takes a power-of-two slice count P up to MAX_PARTS (256) and
    up to the block's buckets; any other P raises before a launch,
    whatever the tensors' device."""
    from quickmer2_tpu_torch.kernels import count_flat as tkflat
    assert tkflat.MAX_PARTS == 256
    n_bases = 4096
    pk = torch.zeros(n_bases // 4, dtype=torch.uint8)
    bits = torch.zeros(n_bases // 8, dtype=torch.uint8)
    rows = torch.zeros((bb, 8), dtype=torch.int32)
    disp = torch.zeros(1024, dtype=torch.int32)
    depth = torch.zeros(2 * bb + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="bad slice count"):
        tkflat.count_packed_block_launch(
            pk, bits, rows, disp, depth, k=K, n_buckets=4 * bb, blk_lo=bb,
            block_buckets=bb, n_bases=n_bases, n_parts=n_parts)


@pytest.mark.parametrize("ds", [1, 2])
def test_displaced_filter_holds_every_key_at_h2(world, ds):
    """block_displaced_filter has a bit for every key of the block that
    sits in its h2 bucket (no false negatives), and those keys exist."""
    from quickmer2_tpu_torch.kernels import block_probe as tkprobe
    from quickmer2_tpu_torch.ops.hash import djb_pair
    table = tpacked.PackedTable.from_dictionary(world["tdic"])
    B = table.n_buckets
    bb = B // ds
    n_moved = 0
    for j in range(ds):
        rows = _t64(table.rows[j * bb:(j + 1) * bb])
        disp = tkprobe.block_displaced_filter(rows, B, j * bb)
        e = rows.reshape(-1, 4)
        h = djb_pair(e[:, 0], e[:, 1])
        at = torch.arange(e.shape[0]) // 2 + j * bb
        moved = ((e[:, 0] | e[:, 1]) != 0) & ((h & (B - 1)) != at)
        assert tkprobe.maybe_displaced(h[moved], disp).all()
        n_moved += int(moved.sum())
    assert n_moved > 0


@pytest.fixture(scope="module")
def flat_truth(world):
    c = tcount.DepthCounter(world["tdic"], batch_bases=1 << 14, device="cpu")
    c.feed_codes(world["codes"])
    return c.finish()


@pytest.mark.parametrize("dp,ds", [(2, 1), (1, 2), (2, 2), (4, 2)])
def test_sharded_depth_counter_matches_jax(world, flat_truth, dp, ds):
    """Depth, and the snapshot's rank-space partials depth[dp, ds, n + 1]
    (trash lanes included), equal the JAX counter's; a snapshot of either
    package resumes in the other to the same depth."""
    codes = world["codes"]
    half = len(codes) // 2
    jc = jcpar.ShardedDepthCounter(world["jdic"], jmesh(dp, ds),
                                   batch_bases=1 << 14)
    tc = tcpar.ShardedDepthCounter(world["tdic"], tmesh(dp, ds, device="cpu"),
                                   batch_bases=1 << 14)
    for c in (jc, tc):
        c.feed_codes(codes[:half])
    js, ts = jc.snapshot(), tc.snapshot()
    np.testing.assert_array_equal(ts["depth"], js["depth"])
    np.testing.assert_array_equal(ts["residual"], js["residual"])
    assert ts["windows"] == js["windows"]
    for c in (jc, tc):
        c.feed_codes(codes[half:])
    np.testing.assert_array_equal(tc.finish(), jc.finish())
    np.testing.assert_array_equal(jc.finish(), flat_truth)
    # across the packages
    for snap, cls, dic, mesh in (
            (js, tcpar.ShardedDepthCounter, world["tdic"],
             tmesh(dp, ds, device="cpu")),
            (ts, jcpar.ShardedDepthCounter, world["jdic"], jmesh(dp, ds))):
        c = cls(dic, mesh, batch_bases=1 << 14)
        c.restore(snap)
        c.feed_codes(codes[half:])
        np.testing.assert_array_equal(c.finish(), flat_truth)
    with pytest.raises(ValueError, match="same data_devices"):
        tcpar.ShardedDepthCounter(world["tdic"], tmesh(1, 1, device="cpu"),
                                  batch_bases=1 << 14).restore(js)


@pytest.fixture(scope="module")
def anchored_truth(world):
    c = tanch.AnchoredDepthCounter(world["tindex"], K, READ_LEN,
                                   batch_reads=128, device="cpu")
    c.feed_reads(world["rows"])
    depth = c.finish()
    return depth, c.n_spilled, c.n_spilled2


@pytest.mark.parametrize("dp,ds", [(2, 1), (1, 2), (2, 2)])
def test_sharded_anchored_matches_jax(world, flat_truth, anchored_truth,
                                      dp, ds):
    """The sharded anchored counter's depth equals the JAX sharded
    counter's, the one-device port's and the flat count; its spill codes
    are intact (the one-device counter's n_spilled and n_spilled2: the
    JAX dict axis folds code 2 into 1, which changes its routing, not
    its depth)."""
    rows = world["rows"]
    jc = janpar.ShardedAnchoredCounter(world["jindex"], K, READ_LEN,
                                       jmesh(dp, ds), batch_reads=128)
    jc.feed_reads(rows)
    want = jc.finish()
    tc = tanpar.ShardedAnchoredCounter(world["tindex"], K, READ_LEN,
                                       tmesh(dp, ds, device="cpu"),
                                       batch_reads=128)
    tc.feed_reads(rows)
    got = tc.finish()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, anchored_truth[0])
    np.testing.assert_array_equal(got, flat_truth)
    assert (tc.n_spilled, tc.n_spilled2) == anchored_truth[1:]
    assert tc.n_spilled > 0 and tc.n_spilled2 > 0
    assert tc.n_spilled == jc.n_spilled


def test_sharded_anchored_snapshot_crosses_packages(world, flat_truth):
    """A (2, 2) sharded anchored snapshot taken mid-stream resumes in the
    other package to the same depth; its diff partials are the JAX
    counter's (the exact partials differ only in the trash word)."""
    rows = world["rows"]
    half = len(rows) // 2
    jc = janpar.ShardedAnchoredCounter(world["jindex"], K, READ_LEN,
                                       jmesh(2, 2), batch_reads=128)
    tc = tanpar.ShardedAnchoredCounter(world["tindex"], K, READ_LEN,
                                       tmesh(2, 2, device="cpu"),
                                       batch_reads=128)
    jc.feed_reads(rows[:half])
    tc.feed_reads(rows[:half])
    (ja, jm), (ta, tm) = jc.snapshot(), tc.snapshot()
    assert ta["diff"].shape == ja["diff"].shape == (2, 2,
                                                    world["jindex"].n_kmers + 2)
    assert tm["mono_spill"] is False and jm["mono_spill"] is False
    np.testing.assert_array_equal(ta["exact_acc"][..., :-1],
                                  ja["exact_acc"][..., :-1])
    tj = tanpar.ShardedAnchoredCounter(world["tindex"], K, READ_LEN,
                                       tmesh(2, 2, device="cpu"),
                                       batch_reads=128)
    tj.restore(ja, jm)
    tj.feed_reads(rows[half:])
    np.testing.assert_array_equal(tj.finish(), flat_truth)
    jt = janpar.ShardedAnchoredCounter(world["jindex"], K, READ_LEN,
                                       jmesh(2, 2), batch_reads=128)
    jt.restore(ta, tm)
    jt.feed_reads(rows[half:])
    np.testing.assert_array_equal(jt.finish(), flat_truth)
    with pytest.raises(ValueError, match="same mesh"):
        tanpar.ShardedAnchoredCounter(world["tindex"], K, READ_LEN,
                                      tmesh(2, 1, device="cpu"),
                                      batch_reads=128).restore(ja, jm)


def test_dict_sharded_index_keeps_rows_off_device(world, anchored_truth):
    """An index built with place_rows off holds its packed rows on the
    host only; the (1, 2) counter places one block a device from them,
    to the one-device depth and spill codes."""
    ix = tanch.AnchoredIndex.from_dictionary_and_fasta(
        world["tdic"], world["fa"], place_rows=False, device="cpu")
    assert ix.rows is None
    tc = tanpar.ShardedAnchoredCounter(ix, K, READ_LEN,
                                       tmesh(1, 2, device="cpu"),
                                       batch_reads=128)
    assert {tuple(b.shape) for b in tc._rows.values()} == {
        (ix.n_buckets // 2, tpacked.ROW_WIDTH)}
    tc.feed_reads(world["rows"])
    np.testing.assert_array_equal(tc.finish(), anchored_truth[0])
    assert (tc.n_spilled, tc.n_spilled2) == anchored_truth[1:]


def test_mono_spill_off_matches_jax(world, flat_truth):
    """AnchoredDepthCounter(mono_spill=False) recounts spills through the
    packed table (K12): depth and exact_acc equal the JAX counter's, and
    a mid-stream snapshot resumes across the packages in both
    directions; a snapshot with the other mono_spill is refused."""
    rows = world["rows"]
    half = len(rows) // 2
    kw = dict(batch_reads=128, mono_spill=False)
    jc = janch.AnchoredDepthCounter(world["jindex"], K, READ_LEN, **kw)
    tc = tanch.AnchoredDepthCounter(world["tindex"], K, READ_LEN,
                                    device="cpu", **kw)
    for c in (jc, tc):
        c.feed_reads(rows[:half])
    (ja, jm), (ta, tm) = jc.snapshot(), tc.snapshot()
    np.testing.assert_array_equal(ta["diff"][:-1], ja["diff"][:-1])
    np.testing.assert_array_equal(ta["exact_acc"][:-1], ja["exact_acc"][:-1])
    assert "exact_slot" not in ta and tm["mono_spill"] is False
    for c in (jc, tc):
        c.feed_reads(rows[half:])
    np.testing.assert_array_equal(tc.finish(), jc.finish())
    np.testing.assert_array_equal(jc.finish(), flat_truth)
    assert (tc.n_spilled, tc.n_spilled2) == (jc.n_spilled, jc.n_spilled2)
    tj = tanch.AnchoredDepthCounter(world["tindex"], K, READ_LEN,
                                    device="cpu", **kw)
    tj.restore(ja, jm)
    tj.feed_reads(rows[half:])
    np.testing.assert_array_equal(tj.finish(), flat_truth)
    jt = janch.AnchoredDepthCounter(world["jindex"], K, READ_LEN, **kw)
    jt.restore(ta, tm)
    jt.feed_reads(rows[half:])
    np.testing.assert_array_equal(jt.finish(), flat_truth)
    mono = tanch.AnchoredDepthCounter(world["tindex"], K, READ_LEN,
                                      batch_reads=128, device="cpu")
    with pytest.raises(ValueError, match="mono_spill"):
        mono.restore(ja, jm)


@pytest.mark.parametrize("ds", [1, 2])
def test_anchor_probes_sum_to_one_device_vote(world, ds):
    """K3a's plain version: the blocks' found / pos summed equal the
    unsharded probe of the valid anchor windows, and K3 on the blocks
    with those sums adds, over the blocks, the one-device diff."""
    tix = world["tindex"]
    rows = world["rows"][:256]
    fmt, pk, aux = trowpack.pack_batch(rows)
    pk, aux = torch.from_numpy(pk), trowpack.aux_tensor(fmt, aux)
    W = READ_LEN - K + 1
    kw = dict(fmt=fmt, k=K, read_len=READ_LEN, n_buckets=tix.n_buckets,
              anchor_offsets=tuple(sorted({0, W // 3, 2 * W // 3, W - 1})))
    tier = dict(max_runs=6, max_dirty=0, max_dirty_runs=2,
                dirty_run_width=32)
    one = torch.zeros(tix.n_kmers + 2, dtype=torch.int64)
    want_code = tkanch.anchored_count(pk, aux, tix.rows, tix.genome_tiles,
                                      tix.dblock, one, **kw, **tier)
    bb = tix.n_buckets // ds
    found = pos = 0
    for j in range(ds):
        f, p = tkanch.anchor_probes(pk, aux, tix.rows[j * bb:(j + 1) * bb],
                                    blk_lo=j * bb, block_buckets=bb, **kw)
        found, pos = found + f.long(), pos + p
    assert int(found.max()) <= 1
    total = torch.zeros_like(one)
    for j in range(ds):
        d = torch.zeros_like(one)
        code = tkanch.anchored_count(
            pk, aux, tix.rows[j * bb:(j + 1) * bb], tix.genome_tiles,
            tix.dblock, d, anchors=(found.to(torch.uint8), pos),
            blk_lo=j * bb, block_buckets=bb, ranges=j == 0, **kw, **tier)
        np.testing.assert_array_equal(code.numpy(), want_code.numpy())
        total = (total + d) & 0xFFFFFFFF
    np.testing.assert_array_equal(total.numpy(), one.numpy())


def _run_count_pair(world, tmp_path, mode, **opts):
    reads_fq = str(tmp_path / "r.fq")
    rng = np.random.default_rng(5)
    helpers.write_fastq(reads_fq, helpers.mutate_reads(
        rng, helpers.simulate_reads(rng, world["chr1"][:12000], 400,
                                    READ_LEN), 0.005))
    kw = dict(verbose=False, mode=mode, batch_bases=1 << 14,
              ref_fasta=world["fa"] if mode == "anchored" else None)
    jcount.run_count(world["fa"] + ".qm", reads_fq, str(tmp_path / "jax"),
                     **kw, **opts)
    tcount.run_count(world["fa"] + ".qm", reads_fq, str(tmp_path / "port"),
                     device="cpu", **kw, **opts)
    tcount.run_count(world["fa"] + ".qm", reads_fq, str(tmp_path / "one"),
                     device="cpu", **kw)
    with open(str(tmp_path / "jax.bin"), "rb") as f:
        want = f.read()
    for out in ("port", "one"):
        with open(str(tmp_path / out) + ".bin", "rb") as f:
            assert f.read() == want, out


@pytest.mark.parametrize("mode", ["flat", "anchored"])
def test_run_count_data_devices_matches_jax(world, tmp_path, mode):
    _run_count_pair(world, tmp_path, mode, data_devices=4)


@pytest.mark.parametrize("mode", ["flat", "anchored"])
def test_run_count_dict_devices_matches_jax(world, tmp_path, mode):
    _run_count_pair(world, tmp_path, mode, dict_devices=4)


def test_scanner_data_devices_matches_jax(world):
    """DeviceMembershipScanner(data_devices=2): each chunk halo-split over
    two devices, K10 a shard; the mask equals the JAX sharded scanner's
    and the one-device scanner's, at chunks that split mid-window."""
    kmers = world["jdic"].kmers_in_order
    khi, klo = jcodec.split_u64(kmers)
    rank = np.arange(len(kmers), dtype=np.uint32)
    jtab = jpacked.PackedTable.build(khi, klo, rank)
    ttab = tpacked.PackedTable.build(khi, klo, rank)
    g = jcodec.encode_bases(np.frombuffer(world["chr1"].encode(), np.uint8))
    want = jemit.DeviceMembershipScanner(jtab, K, data_devices=2,
                                         chunk=1 << 13).scan(g)
    for chunk in (1 << 13, 5000):
        got = temit.DeviceMembershipScanner(ttab, K, data_devices=2,
                                            chunk=chunk, device="cpu").scan(g)
        np.testing.assert_array_equal(got, want)
    assert want.sum() > 0


@pytest.mark.parametrize("n,shape", [(4, (2, 2)), (8, (2, 4))])
def test_dryrun_multichip(n, shape):
    """n devices factored as the JAX dry run factors them; each count
    equals the one-device count."""
    from quickmer2_tpu_torch.entry import dryrun_multichip
    out = dryrun_multichip(n, device="cpu")
    assert (out["data"], out["dict"]) == shape
    assert out["depth_sum"] == out["anchored_depth_sum"] > 0
