"""The host side of K5's counting sort and K12's packed exact recount
against the JAX package and the plain versions on the CPU.

bucket_runs (K5's counting sort) runs on the CPU as its plain version,
bucket_runs_plain, a sort; it is held against the lanes of the padded
layouts that JAX's _part_chunk_join_bits scatters, at widths 1 to 24,
caps 1 to 255, no entry, no entering entry and a skewed key set. The
kernel's plan of coarse bins (runs_plan) is held against its rule, and a
skewed set's largest bin outgrows the place pass's stage. K12's wrapper
checks, the bitmap of displaced keys on an anchored index with keys
planted to be displaced, and K12's plain version with that bitmap
against JAX's exact_count_rows_packed in both row formats. Integer
outputs throughout, so the tolerance is exact equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from quickmer2_tpu.ops import anchored as janch
from quickmer2_tpu.ops import hamming_join as jhj
from quickmer2_tpu.parallel.mesh import make_mesh as jmesh
from quickmer2_tpu_torch.device import to_numpy_u32
from quickmer2_tpu_torch.kernels import block_probe as tkprobe
from quickmer2_tpu_torch.kernels import count_mono as tkmono
from quickmer2_tpu_torch.kernels import hamming_join as tkhj
from quickmer2_tpu_torch.ops import anchored as tanch
from quickmer2_tpu_torch.ops import codec as tcodec
from quickmer2_tpu_torch.ops import rowpack as trowpack
from quickmer2_tpu_torch.ops.hash import djb_pair_np
from tests.torch_threads import few_threads  # noqa: F401


def _i64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _entries(case: str, n: int, width: int, seed: int):
    """(hi, lo, keys) of n entries whose part key is bits [0, width) of
    lo: uniform keys, or ("skewed") three quarters of them crowded into
    the first 200 keys."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 1 << width, n, dtype=np.int64)
    if case == "skewed":
        key[: 3 * n // 4] = rng.integers(0, min(200, 1 << width), 3 * n // 4)
    lo = ((rng.integers(0, 1 << 32, n, dtype=np.int64)
           & ~((1 << width) - 1)) | key).astype(np.uint32)
    hi = rng.integers(0, 1 << 32, n, dtype=np.int64).astype(np.uint32)
    return hi, lo, key.astype(np.uint32)


@pytest.mark.parametrize("case,n,width,cap", [
    ("uniform", 3000, 1, 64), ("uniform", 20000, 20, 240),
    ("uniform", 50000, 24, 255), ("uniform", 20000, 20, 1),
    ("empty", 0, 20, 64), ("all_out", 5000, 12, 255),
    ("skewed", 40000, 20, 255)])
@pytest.mark.parametrize("tags", [False, True])
def test_bucket_runs_put_each_entry_at_its_jax_lane(case, n, width, cap,
                                                    tags):
    """bucket_runs on the CPU (its plain version, the one the kernel is
    held against on the card) lays out, in lane order, the live lanes of
    the padded layout that JAX's _part_chunk_join_bits scatters (lane key
    * cap + slot of every entry whose slot is below the cap, the key by
    JAX's _part_key_device), on either side: the runs hold those entries
    and no other, and the offsets count them by key."""
    hi, lo, _ = _entries(case, n, width, seed=width + cap)
    keys = np.asarray(jhj._part_key_device(jnp.asarray(hi), jnp.asarray(lo),
                                           lo_bit=0, width=width))
    slot = (np.full(n, 255, np.uint8) if case == "all_out"
            else jhj._slots_u8(keys))
    fwd = np.random.default_rng(n).random(n) < 0.5
    out = tkhj.bucket_runs(_i64(hi), _i64(lo), torch.from_numpy(slot),
                           lo_bit=0, width=width, cap=cap,
                           fwd=torch.from_numpy(fwd) if tags else None)
    live = np.flatnonzero(slot < cap)
    lanes = keys[live].astype(np.int64) * cap + slot[live]
    order = live[np.argsort(lanes)]
    m = len(order)
    off = to_numpy_u32(out[-1]).astype(np.int64)
    np.testing.assert_array_equal(off, np.concatenate([[0], np.cumsum(
        np.bincount(keys[live], minlength=1 << width))]))
    np.testing.assert_array_equal(to_numpy_u32(out[0])[:m],
                                  np.stack([hi[order], lo[order]], 1))
    if tags:
        np.testing.assert_array_equal(
            to_numpy_u32(out[1])[:m],
            order.astype(np.uint32) | (fwd[order].astype(np.uint32) << 31))
    assert (m > 0) == (case not in ("empty", "all_out"))


@pytest.mark.parametrize("n,width,tags,keys,want", [
    (0, 20, True, None, (13, 16384)), (4096, 20, True, None, (13, 16384)),
    (1_685_535, 20, True, None, (12, 16384)),
    (11_950_546, 20, False, None, (10, 24576)),
    (11_950_546, 24, False, None, (13, 24576)),
    (100, 1, False, None, (1, 24576)), (1 << 31, 3, True, None, (0, 16384)),
    (40000, 20, True, "uniform", (13, 16384)),
    (40000, 20, True, "skewed", (13, 16384)),
    (40000, 20, False, "skewed", (13, 24576))])
def test_runs_plan(n, width, tags, keys, want):
    """The coarse bins: the least power of two whose mean bin is at most
    half the stage and whose bins hold at most 8192 keys, at most 2048
    bins and a key a bin (the smoke's query tile takes 256 bins, its
    word chunk 1024). On a key set, its largest bin by the plain runs'
    offsets fits the stage where the keys are uniform and outgrows it
    where three quarters crowd into 200 keys (the place pass then stores
    that bin straight)."""
    assert tkhj.runs_plan(n, width, tags) == want
    if keys is None:
        return
    hi, lo, key = _entries(keys, n, width, seed=n)
    off = tkhj.bucket_runs_plain(_i64(hi), _i64(lo),
                                 torch.from_numpy(jhj._slots_u8(key)),
                                 lo_bit=0, width=width, cap=255)[-1]
    shift, stage = want
    largest = int(np.diff(to_numpy_u32(off)[:: 1 << shift].astype(
        np.int64)).max())
    assert (largest > stage) == (keys == "skewed")


@pytest.mark.parametrize("k,part,cpad,cpad_q", [
    (15, 0, 8, 4), (16, 2, 64, 32), (30, 1, 240, 240)])
def test_bucket_runs_hold_the_part_chunk_join_bits_layouts(k, part, cpad,
                                                           cpad_q):
    """Each side's runs from the passes hold, bucket by bucket and in lane
    order, the live lanes of the padded layout that JAX's
    _part_chunk_join_bits scatters (lane key * cpad + slot of every entry
    whose slot is below the pad; the query lanes with their index and
    strand): the same entries, none dropped or added."""
    rng = np.random.default_rng(k + part)
    s, t = jhj.part_ranges(k)[part]
    width = 2 * (t - s)
    n = 30000
    codes = rng.integers(0, 1 << (2 * k - 1), n, dtype=np.int64)
    codes[: n // 3] = codes[0] ^ (codes[: n // 3] & 0x3)  # crowded buckets
    hi, lo = tcodec.split_u64(codes.astype(np.uint64))
    keys = np.asarray(jhj._part_key_device(jnp.asarray(hi), jnp.asarray(lo),
                                           lo_bit=2 * s, width=width))
    slot = jhj._slots_u8(keys)
    fwd = rng.random(n) < 0.5
    for pad, f in ((cpad, None), (cpad_q, fwd)):
        hole = (1 << width) * pad
        lanes = np.where(slot < pad, keys.astype(np.int64) * pad + slot, hole)
        # JAX's scatter of the padded layout, as _part_chunk_join_bits
        dh = np.asarray(jnp.zeros(hole + 1, jnp.uint32).at[lanes].set(hi))
        dl = np.asarray(jnp.zeros(hole + 1, jnp.uint32).at[lanes].set(lo))
        qidx = np.asarray(jnp.full(hole + 1, n, jnp.int32).at[lanes].set(
            jnp.arange(n, dtype=jnp.int32)))
        out = tkhj.bucket_runs(_i64(hi), _i64(lo), torch.from_numpy(slot),
                               lo_bit=2 * s, width=width, cap=pad,
                               fwd=None if f is None else torch.from_numpy(f))
        off = to_numpy_u32(out[-1]).astype(np.int64)
        run_codes = to_numpy_u32(out[0])
        live = qidx[:hole] != n
        bucket, lane = np.divmod(np.flatnonzero(live), pad)
        at = off[bucket] + lane
        assert off[-1] == live.sum()
        np.testing.assert_array_equal(np.diff(off), np.bincount(
            bucket, minlength=1 << width))
        np.testing.assert_array_equal(run_codes[at, 0], dh[:hole][live])
        np.testing.assert_array_equal(run_codes[at, 1], dl[:hole][live])
        if f is not None:
            ix = qidx[:hole][live]
            np.testing.assert_array_equal(
                to_numpy_u32(out[1])[at],
                ix | (f[ix].astype(np.uint32) << 31))


@pytest.mark.parametrize("case", ["no bitmap", "bitmap of 3 words",
                                  "block past the table"])
def test_count_packed_rows_rejects_a_bad_call(case):
    """K12's wrapper takes the block's bitmap of displaced keys (a power
    of two of words) and a block inside the table; anything else raises
    before a launch, whatever the tensors' device."""
    R, L, bb = 4, 40, 1 << 10
    f, pk, aux = trowpack.pack_batch(np.zeros((R, L), np.uint8))
    rows = torch.zeros((bb, 8), dtype=torch.int32)
    acc = torch.zeros(100, dtype=torch.int32)
    bitmap = {"no bitmap": None, "bitmap of 3 words": torch.zeros(
        3, dtype=torch.int32)}.get(case, torch.zeros(1024, dtype=torch.int32))
    with pytest.raises(ValueError, match={"no bitmap": "bitmap is required",
                                          "bitmap of 3 words": "bad bitmap",
                                          }.get(case, "bad fmt")):
        tkmono.count_packed_rows(
            torch.from_numpy(pk).to("meta"),
            trowpack.aux_tensor(f, aux).to("meta"), rows.to("meta"),
            acc.to("meta"), fmt=f, k=K, n_buckets=4 * bb, read_len=L,
            blk_lo=4 * bb if case == "block past the table" else bb,
            block_buckets=bb, displaced=None if bitmap is None
            else bitmap.to("meta"))


K = 21
READ_LEN = 100


@pytest.fixture(scope="module")
def planted():
    """An anchored index (no neighbor bits) over unique random canonical
    k-mers, 150 of them planted three to a bucket so that at least one of
    each three sits in its h2 bucket; the k-mers laid out one a SEP-ended
    segment; and read rows of concatenated k-mers (planted ones among
    them) with errors, with no separator (lens) or with some (mask)."""
    rng = np.random.default_rng(2121)
    top = (1 << (2 * K)) - 1
    base = rng.integers(1, top, 3000, dtype=np.int64).astype(np.uint64)
    n_final = len(base) + 150
    B = 1 << int(np.ceil(np.log2(n_final)))
    cand = rng.integers(1, top, 400_000, dtype=np.int64).astype(np.uint64)
    cand = np.minimum(cand, jhj._rc_np(cand, K))
    hi, lo = tcodec.split_u64(cand)
    h1 = djb_pair_np(hi, lo) & np.uint32(B - 1)
    pick = []
    for b in rng.choice(B, 50, replace=False):
        pick += list(cand[h1 == b][:3])
    kmers = np.unique(np.minimum(base, jhj._rc_np(base, K)))
    kmers = np.concatenate([kmers, np.setdiff1d(np.array(pick, np.uint64),
                                                kmers)])
    kmers = kmers[rng.permutation(len(kmers))]
    assert 1 << int(np.ceil(np.log2(len(kmers)))) == B
    shifts = 2 * np.arange(K - 1, -1, -1, dtype=np.uint64)
    bases = ((kmers[:, None] >> shifts) & np.uint64(3)).astype(np.uint8)
    seg = np.concatenate([bases, np.full((len(kmers), 1), tcodec.SEP,
                                         np.uint8)], 1)
    genome = seg.reshape(-1)
    end_pos = (np.arange(len(kmers)) * (K + 1) + K - 1).astype(np.uint32)
    index = tanch.AnchoredIndex.build(genome, end_pos, kmers, K,
                                      neighbor_bits=False, device="cpu")
    order = np.concatenate([
        rng.choice(len(kmers), 1500),
        np.flatnonzero(np.isin(kmers, np.array(pick, np.uint64)))])
    stream = bases[rng.permutation(order)].reshape(-1)
    n_rows = len(stream) // READ_LEN
    rows = stream[: n_rows * READ_LEN].reshape(n_rows, READ_LEN).copy()
    err = rng.random(rows.shape) < 0.01
    rows[err] = (rows[err] + 1) % 4
    masked = rows.copy()
    masked[::5, 37] = tcodec.SEP
    return {"index": index, "B": B, "rows": {"lens": rows, "mask": masked},
            "kmers": kmers, "bases": bases}


@pytest.mark.parametrize("ds", [1, 2])
def test_displaced_filter_holds_planted_keys_of_an_anchored_index(planted,
                                                                  ds):
    """block_displaced_filter over each bucket block of the anchored
    index has a bit for every key that sits in its h2 bucket (no false
    negative), and the planted buckets put dozens there."""
    index, B = planted["index"], planted["B"]
    assert index.n_buckets == B
    bb = B // ds
    rows = index.rows
    n_moved = 0
    for j in range(ds):
        blk = rows[j * bb:(j + 1) * bb]
        disp = tkprobe.block_displaced_filter(blk, B, j * bb)
        e = to_numpy_u32(blk).reshape(-1, 4)
        h = djb_pair_np(e[:, 0], e[:, 1])
        at = np.arange(len(e)) // 2 + j * bb
        moved = ((e[:, 0] | e[:, 1]) != 0) & ((h & np.uint32(B - 1)) != at)
        assert tkprobe.maybe_displaced(_i64(h[moved]), disp).all()
        n_moved += int(moved.sum())
    assert n_moved >= 50


def _jax_exact(jrows, pk, aux, fmt, n_buckets, n_kmers, ds):
    """JAX's exact recount of packed rows: exact_count_rows_packed on the
    whole table (ds = 1), or exact_count_rows under a dict axis of ds
    virtual devices (its per-block partials)."""
    depth = jnp.zeros(n_kmers + 2, jnp.uint32)
    if ds == 1:
        return np.asarray(janch.exact_count_rows_packed(
            jnp.asarray(pk), jnp.asarray(aux), jnp.asarray(jrows), depth,
            fmt=fmt, k=K, n_buckets=n_buckets, read_len=READ_LEN))[None]
    from quickmer2_tpu.ops import rowpack as jrowpack
    reads = jrowpack.unpack_batch(fmt, jnp.asarray(pk), jnp.asarray(aux),
                                  read_len=READ_LEN)
    mesh = jmesh(1, ds)
    bb = n_buckets // ds
    sharded = jax.device_put(np.asarray(jrows).reshape(ds, bb, -1),
                             NamedSharding(mesh, P("dict", None, None)))

    def local(rows, acc):
        return janch.exact_count_rows(
            reads, jnp.ones(reads.shape[0], bool), rows[0], acc[0], k=K,
            n_buckets=n_buckets, dict_axis="dict", block_buckets=bb)[None]
    step = jax.jit(jax.shard_map(local, mesh=mesh,
                                 in_specs=(P("dict", None, None),
                                           P("dict", None)),
                                 out_specs=P("dict", None)))
    acc = np.zeros((ds, n_kmers + 2), np.uint32)
    return np.asarray(step(sharded, jax.device_put(
        acc, NamedSharding(mesh, P("dict", None)))))


@pytest.mark.parametrize("ds", [1, 2])
@pytest.mark.parametrize("fmt", ["lens", "mask"])
def test_exact_rows_packed_with_the_bitmap_matches_jax(planted, fmt, ds):
    """K12's plain version with each block's bitmap of displaced keys
    (as the counters pass it) against JAX's exact_count_rows_packed on
    the same table, block by block, in both row formats; the planted
    displaced keys are counted, and the bitmap changes no count."""
    index, B = planted["index"], planted["B"]
    f, pk, aux = trowpack.pack_batch(planted["rows"][fmt])
    assert f == fmt
    n = index.n_kmers
    want = _jax_exact(to_numpy_u32(index.rows), pk, aux, fmt, B, n, ds)
    bb = B // ds
    total = np.zeros(n + 2, np.int64)
    for j in range(ds):
        blk = dict(fmt=fmt, k=K, n_buckets=B, read_len=READ_LEN,
                   blk_lo=j * bb, block_buckets=bb)
        rows = index.rows[j * bb:(j + 1) * bb]
        disp = tkprobe.block_displaced_filter(rows, B, j * bb)
        acc, plain = (torch.zeros(n + 2, dtype=torch.int64) for _ in "ab")
        tkmono.count_packed_rows(torch.from_numpy(pk),
                                 trowpack.aux_tensor(fmt, aux), rows, acc,
                                 displaced=disp, **blk)
        tkmono.count_packed_rows(torch.from_numpy(pk),
                                 trowpack.aux_tensor(fmt, aux), rows, plain,
                                 **blk)
        np.testing.assert_array_equal(acc.numpy()[:-1], want[j, :-1])
        np.testing.assert_array_equal(acc.numpy(), plain.numpy())
        total += acc.numpy()
    # the keys that sit in their h2 bucket were counted
    e = to_numpy_u32(index.rows).reshape(-1, 4)
    h = djb_pair_np(e[:, 0], e[:, 1])
    moved = (((e[:, 0] | e[:, 1]) != 0)
             & ((h & np.uint32(B - 1)) != np.arange(len(e)) // 2))
    assert total[e[moved, 2]].sum() > 0


def _anchor_rows(planted, rng):
    """Read rows of READ_LEN whose anchor windows (offsets 0, K, 2K, 3K)
    are whole k-mers: the keys that sit at h2, other keys, codes absent
    from the table whose h1 bucket is full (a miss behind a full h1)
    and random codes; a lens and a mask copy (a separator in one anchor
    window of every fifth row). Returns (rows by format, offsets)."""
    index, B = planted["index"], planted["B"]
    e = to_numpy_u32(index.rows).reshape(-1, 4)
    key = (e[:, 0].astype(np.uint64) << np.uint64(32)) | e[:, 1]
    h = djb_pair_np(e[:, 0], e[:, 1])
    at_h2 = key[(key != 0) & ((h & np.uint32(B - 1))
                              != np.arange(len(e)) // 2)]
    full = (e.reshape(B, 8)[:, :4].any(1) & e.reshape(B, 8)[:, 4:].any(1))
    top = (1 << (2 * K)) - 1
    cand = rng.integers(1, top, 200_000, dtype=np.int64).astype(np.uint64)
    cand = np.minimum(cand, jhj._rc_np(cand, K))
    ch = djb_pair_np(*tcodec.split_u64(cand))
    behind = cand[full[ch & np.uint32(B - 1)] & ~np.isin(cand, key)][:300]
    pool = np.concatenate([np.repeat(at_h2, 4), behind,
                           rng.choice(planted["kmers"], 600), cand[-100:]])
    n_rows = len(pool) // 4
    anchors = rng.permutation(pool)[:4 * n_rows].reshape(n_rows, 4)
    shifts = 2 * np.arange(K - 1, -1, -1, dtype=np.uint64)
    rows = rng.integers(0, 4, (n_rows, READ_LEN)).astype(np.uint8)
    for i in range(4):
        rows[:, i * K:(i + 1) * K] = ((anchors[:, i, None] >> shifts)
                                      & np.uint64(3)).astype(np.uint8)
    masked = rows.copy()
    masked[::5, K + 3] = tcodec.SEP
    return {"lens": rows, "mask": masked}, (0, K, 2 * K, 3 * K)


@pytest.mark.parametrize("ds", [2, 4])
@pytest.mark.parametrize("fmt", ["lens", "mask"])
def test_anchor_probes_with_the_bitmap_match_the_ungated_probe(planted, fmt,
                                                               ds):
    """K3a's plain version with each block's bitmap of displaced keys (as
    the sharded counter passes it), block by block, against JAX's
    probe_packed_block of both candidate rows with no gate on the anchor
    windows: equal found and pos, found summed over the blocks at most
    1, every anchor on a key found once (the planted keys at h2 among
    them), no miss behind a full h1 found."""
    from quickmer2_tpu.ops import packed_table as jpacked
    from quickmer2_tpu_torch.kernels import anchored as tkanch
    index, B = planted["index"], planted["B"]
    rows, offs = _anchor_rows(planted, np.random.default_rng(ds))
    f, pk, aux = trowpack.pack_batch(rows[fmt])
    assert f == fmt
    pk, aux_t = torch.from_numpy(pk), trowpack.aux_tensor(fmt, aux)
    windows = np.stack([rows[fmt][:, a:a + K] for a in offs])
    valid = (windows != tcodec.SEP).all(2)
    shifts = 2 * np.arange(K - 1, -1, -1, dtype=np.uint64)
    code = (np.where(valid[..., None], windows, 0).astype(np.uint64)
            << shifts).sum(2, dtype=np.uint64)
    code = np.minimum(code, jhj._rc_np(code, K))
    qhi, qlo = tcodec.split_u64(code.reshape(-1))
    jrows = jnp.asarray(to_numpy_u32(index.rows))
    bb = B // ds
    total = np.zeros(code.shape, np.int64)
    for j in range(ds):
        blk = dict(fmt=fmt, k=K, read_len=READ_LEN, n_buckets=B,
                   anchor_offsets=offs, blk_lo=j * bb, block_buckets=bb)
        rows_j = index.rows[j * bb:(j + 1) * bb]
        disp = tkprobe.block_displaced_filter(rows_j, B, j * bb)
        found, pos = tkanch.anchor_probes_plain(pk, aux_t, rows_j,
                                                displaced=disp, **blk)
        jf, _, jp = jpacked.probe_packed_block(
            jrows[j * bb:(j + 1) * bb], jnp.asarray(qhi), jnp.asarray(qlo),
            B, bb, j * bb, 0)
        jf = np.asarray(jf).reshape(code.shape) & valid
        np.testing.assert_array_equal(found.numpy(), jf)
        np.testing.assert_array_equal(
            to_numpy_u32(pos), np.where(jf, np.asarray(jp).reshape(
                code.shape), 0))
        again = tkanch.anchor_probes(pk, aux_t, rows_j, displaced=disp, **blk)
        assert torch.equal(again[0], found) and torch.equal(again[1], pos)
        total += found.numpy()
    assert total.max() == 1
    e = to_numpy_u32(index.rows).reshape(-1, 4)
    key = (e[:, 0].astype(np.uint64) << np.uint64(32)) | e[:, 1]
    h = djb_pair_np(e[:, 0], e[:, 1])
    at_h2 = key[(key != 0) & ((h & np.uint32(B - 1))
                              != np.arange(len(e)) // 2)]
    np.testing.assert_array_equal(total, np.isin(code, key) & valid)
    assert (np.isin(code, at_h2) & valid).sum() >= 100
