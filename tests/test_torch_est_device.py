"""est's device window sums in the port against the JAX package: K11's
plain version (kernels.est_windows) against JAX corrected_window_sums,
and run_est(device_sums=True) against JAX run_est(device=True) and the
host path.

Tolerances: the window sums are float32 in both packages but summed in
different orders (JAX: a scatter-add, one term after another; the port:
32 strided lane sums and a fixed tree). The port's sums are held within
rtol 1e-6 of a float64 truth (they come within ~1.6e-7), and within
rtol 1e-6 plus JAX's own distance from that truth of JAX's sums (JAX's
sequential float32 sum errs by up to ~1.8e-6 over 1000 terms). CN agrees
within 1e-4 (absolute), the bound of JAX's own device test."""

import os

import numpy as np
import pytest
import torch

from quickmer2_tpu.io import formats as jformats
from quickmer2_tpu.ops.est_device import corrected_window_sums
from quickmer2_tpu.pipelines.est import run_est as jax_run_est
from quickmer2_tpu_torch.kernels.est_windows import (
    window_sums, window_sums_plain)
from quickmer2_tpu_torch.pipelines.est import run_est

RTOL = 1e-6


def _inputs(rng, n, w):
    """u16 depth and .qgc entries (GC bin, some control flags), f32
    factors and window k-mer ranges of w k-mers with gaps between
    chromosomes, a short window and an empty one."""
    gc = np.clip(rng.normal(200, 40, n), 0, 400).astype(np.uint16)
    qgc = gc | np.where(rng.random(n) < 0.1, 0x8000, 0).astype(np.uint16)
    depth = rng.poisson(25.0 * (0.6 + gc / 400.0)).astype(np.uint16)
    factors = np.linspace(0.4, 2.8, 401).astype(np.float32)
    starts = list(range(0, n // 2 - w, w)) + list(range(n // 2 + 37,
                                                         n - w, w))
    ks = np.array(starts, np.int64)
    ke = ks + w
    ke[3] = ks[3] + 17            # a short window (a chromosome's end)
    ke[5] = ks[5]                 # an empty one
    return depth, qgc, factors, ks, ke


def _truth(depth, qgc, factors, ks, ke):
    prod = (factors[qgc & 0x1FF].astype(np.float64)
            * depth.astype(np.float64))
    return np.array([prod[a:b].sum() for a, b in zip(ks, ke)])


@pytest.mark.parametrize("w", [100, 1000])
def test_window_sums_plain_matches_jax(w):
    import jax.numpy as jnp
    rng = np.random.default_rng(w)
    depth, qgc, factors, ks, ke = _inputs(rng, 300_000, w)
    want = np.asarray(corrected_window_sums(
        jnp.asarray(depth.astype(np.uint32)),
        jnp.asarray((qgc & 0x1FF).astype(np.int32)), jnp.asarray(factors),
        jnp.asarray(ks.astype(np.int32)), jnp.asarray(ke.astype(np.int32))))

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a).view(dtype))
    args = (t(depth, np.int16), t(qgc, np.int16), t(factors, np.float32),
            t(ks.astype(np.int32), np.int32), t(ke.astype(np.int32),
                                                np.int32))
    got = window_sums_plain(*args).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    truth = _truth(depth, qgc, factors, ks, ke)
    np.testing.assert_allclose(got, truth, rtol=RTOL)
    live = truth > 0
    jax_err = np.max(np.abs(want[live] - truth[live]) / truth[live])
    np.testing.assert_allclose(got, want, rtol=RTOL + jax_err)
    assert got[5] == 0.0
    # the wrapper takes the plain version for a CPU tensor, the same bits
    assert torch.equal(window_sums(*args), torch.from_numpy(got))


def test_window_sums_plain_order():
    """The plain version's order, spelled out: lane l sums k-mers
    kstart + l, + 32, ... in turn, then the tree 16, 8, 4, 2, 1; bins
    past the last factor take the last one (JAX's clamped gather)."""
    rng = np.random.default_rng(3)
    n = 5000
    depth = rng.integers(0, 60000, n).astype(np.uint16)
    qgc = rng.integers(0, 1 << 16, n).astype(np.uint16)   # bins up to 511
    factors = rng.random(401).astype(np.float32) * 3
    ks = np.array([0, 100, 1234, 4000], np.int32)
    ke = np.array([100, 1234, 1300, 5000], np.int32)
    got = window_sums_plain(
        torch.from_numpy(depth.view(np.int16)),
        torch.from_numpy(qgc.view(np.int16)), torch.from_numpy(factors),
        torch.from_numpy(ks), torch.from_numpy(ke)).numpy()
    fac = factors[np.minimum(qgc & 0x1FF, 400)]
    prod = fac * depth.astype(np.float32)
    for wi, (a, b) in enumerate(zip(ks, ke)):
        lanes = np.zeros(32, np.float32)
        for i in range(a, b):
            lanes[(i - a) % 32] += prod[i]
        off = 16
        while off:
            lanes[:off] = lanes[:off] + lanes[off:2 * off]
            off //= 2
        assert got[wi] == lanes[0], wi


def _est_files(d, rng):
    """A .qgc / .bed pair (two chromosomes, windows of 500 k-mers, k-mers
    in no window between them) and a sample's .bin."""
    depth, qgc, _, ks, ke = _inputs(rng, 120_000, 500)
    ke[3] = ks[3] + 500
    ke[5] = ks[5] + 500
    prefix = os.path.join(d, "g.fa")
    jformats.write_u16(prefix + ".qgc", qgc)
    rows = [("c1" if a < 60_000 else "c2", 10 * a, 10 * b, a, b)
            for a, b in zip(ks, ke)]
    jformats.write_windows_bed(prefix + ".bed", rows)
    jformats.write_u16(os.path.join(d, "smp.bin"), depth)
    return prefix, os.path.join(d, "smp")


def test_run_est_device_sums_matches_jax(tmp_path):
    """run_est(device_sums=True, device="cpu") against JAX
    run_est(device=True) and both host paths: the first three columns
    identical, CN within 1e-4."""
    d = str(tmp_path)
    prefix, smp = _est_files(d, np.random.default_rng(9))
    outs = {}
    jax_run_est(prefix, smp, os.path.join(d, "jd.bed"), verbose=False,
                device=True)
    jax_run_est(prefix, smp, os.path.join(d, "jh.bed"), verbose=False)
    run_est(prefix, smp, os.path.join(d, "pd.bed"), verbose=False,
            device="cpu", device_sums=True)
    run_est(prefix, smp, os.path.join(d, "ph.bed"), verbose=False,
            device="cpu")
    for name in ("jd", "jh", "pd", "ph"):
        with open(os.path.join(d, name + ".bed")) as f:
            outs[name] = [ln.split("\t") for ln in f.read().splitlines()]
    assert len(outs["pd"]) > 200
    with open(os.path.join(d, "ph.bed"), "rb") as a, \
            open(os.path.join(d, "jh.bed"), "rb") as b:
        assert a.read() == b.read()
    for ref in ("jd", "jh", "ph"):
        assert [r[:3] for r in outs[ref]] == [r[:3] for r in outs["pd"]]
        cn = np.array([float(r[3]) for r in outs["pd"]])
        want = np.array([float(r[3]) for r in outs[ref]])
        np.testing.assert_allclose(cn, want, rtol=0, atol=1e-4)
