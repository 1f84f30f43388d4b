"""State carried across packages: the port's mono DepthCounter resumes
from the JAX DepthCounter's snapshot() dict as it is (numpy arrays:
slot-space depth, residual codes, windows, layout, side counts), and
its own snapshot matches the JAX one on the same stream."""

import numpy as np
import pytest

from quickmer2_tpu import dictionary as jdict
from quickmer2_tpu.ops import codec as jcodec
from quickmer2_tpu.ops import monotable as jmono
from quickmer2_tpu.pipelines import count as jcount
from quickmer2_tpu_torch import dictionary as tdict
from quickmer2_tpu_torch.ops import monotable as tmono
from quickmer2_tpu_torch.pipelines import count as tcount


def _world(k: int, seed: int):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, 30000).astype(np.uint8)
    canon, valid = jcodec.sliding_kmers_np(g, k)
    km = canon[valid & (canon != 0)]
    _, first = np.unique(km, return_index=True)
    kmers = km[np.sort(first)]
    starts = rng.integers(0, len(g) - 120, 1200)
    reads = g[starts[:, None] + np.arange(120)].copy()
    reads[rng.random(reads.shape) < 0.003] = jcodec.SEP
    codes = np.concatenate(
        [reads, np.full((len(reads), 1), jcodec.SEP, np.uint8)], 1).reshape(-1)
    return kmers, codes


def _counters(kmers, k, batch, load):
    hi, lo = jcodec.split_u64(kmers)
    jd = jdict.Dictionary.from_kmers_in_order(kmers, 1 << 17, k)
    td = tdict.Dictionary.from_kmers_in_order(kmers, 1 << 17, k)
    jc = jcount.DepthCounter(
        jd, batch_bases=batch, packed_table=jmono.MonoTable.build(hi, lo, load=load))
    tc = tcount.DepthCounter(
        td, batch_bases=batch, device="cpu",
        packed_table=tmono.MonoTable.build(hi, lo, load=load))
    return jd, jc, tc


@pytest.mark.parametrize("k,load,cut", [(30, 0.5, 0.5), (31, 3.0, 0.37),
                                        (25, 3.0, 0.81)])
def test_port_resumes_from_jax_snapshot(k, load, cut):
    kmers, codes = _world(k, k)
    batch = 1 << 13
    _, jfull, tc = _counters(kmers, k, batch, load)
    jfull.feed_codes(codes)
    want = jfull.finish()

    _, jhalf, _ = _counters(kmers, k, batch, load)
    m = int(len(codes) * cut)
    jhalf.feed_codes(codes[:m])
    snap = jhalf.snapshot()
    tc.restore(snap)
    tc.feed_codes(codes[m:])
    np.testing.assert_array_equal(tc.finish(), want)


def test_port_snapshot_matches_jax_snapshot():
    k = 30
    kmers, codes = _world(k, 99)
    _, jc, tc = _counters(kmers, k, 1 << 13, 3.0)
    m = len(codes) // 3
    jc.feed_codes(codes[:m])
    tc.feed_codes(codes[:m])
    js, ts = jc.snapshot(), tc.snapshot()
    assert set(ts) == set(js)
    # the trash lane (last) is not part of the contract
    np.testing.assert_array_equal(ts["depth"][:-1], np.asarray(js["depth"])[:-1])
    np.testing.assert_array_equal(ts["residual"], js["residual"])
    np.testing.assert_array_equal(ts["side_counts"], js["side_counts"])
    assert (ts["windows"], ts["layout"]) == (js["windows"], js["layout"])


def test_restore_rejects_other_layout():
    kmers, _ = _world(30, 5)
    _, jc, tc = _counters(kmers, 30, 1 << 13, 0.5)
    snap = jc.snapshot()
    with pytest.raises(ValueError, match="layout"):
        tc.restore(dict(snap, layout="packed"))
    with pytest.raises(ValueError, match="depth length"):
        tc.restore(dict(snap, depth=snap["depth"][:-1]))
