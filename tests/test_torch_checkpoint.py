"""Count checkpoint/resume across the two packages: a count interrupted
mid-stream by one package resumes in the other from its checkpoint file
and writes the uninterrupted .bin, byte for byte; flat with each table
layout and anchored, from a file and from stdin, and with the JAX
package's overflow counter (ovf_* arrays) live, in either mode. A layout
mismatch is refused; the anchored count falls back to flat under a device-memory
limit."""

import builtins
import io
import os
import sys

import numpy as np
import pytest

from quickmer2_tpu.config import SearchConfig
from quickmer2_tpu.pipelines import count as jcount
from quickmer2_tpu.pipelines import search as search_pipe
from quickmer2_tpu_torch.io import formats
from quickmer2_tpu_torch.pipelines import count as tcount
from quickmer2_tpu_torch.utils import checkpoint
from tests import helpers
from tests.torch_threads import few_threads  # noqa: F401


class Bomb(Exception):
    pass


class LimitedFile:
    """Raises Bomb after n_reads read() calls: a count that dies. Counts
    the bytes it returns."""

    def __init__(self, f, n_reads):
        self._f = f
        self._left = n_reads
        self.n_bytes = 0

    def read(self, n):
        if self._left <= 0:
            raise Bomb()
        self._left -= 1
        data = self._f.read(n)
        self.n_bytes += len(data)
        return data

    def seek(self, n):
        return self._f.seek(n)

    def close(self):
        return self._f.close()


class LimitedStdin:
    def __init__(self, data, n_reads):
        self.buffer = LimitedFile(io.BytesIO(data), n_reads)


def _run(package: str, qm, sample, out, **kw):
    if package == "jax":
        kw.pop("device", None)
        return jcount.run_count(qm, sample, out, **kw)
    return tcount.run_count(qm, sample, out, device="cpu", **kw)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(5)
    d = str(tmp_path_factory.mktemp("tckpt"))
    chr1 = helpers.random_genome(rng, 20000)
    fa = os.path.join(d, "g.fa")
    helpers.write_fasta(fa, {"c1": chr1})
    search_pipe.run_search(fa, SearchConfig(kmer_size=30, hash_size=1 << 16,
                                            edit_distance=0, window_size=100),
                           verbose=False)
    # 100 bp reads (anchored rows) and a few 2000 bp reads (segmented),
    # 0.5 % errors so the anchored path spills
    reads = helpers.simulate_reads(np.random.default_rng(9), chr1, 2000, 100)
    reads += helpers.simulate_reads(np.random.default_rng(10), chr1, 10, 2000)
    reads = helpers.mutate_reads(np.random.default_rng(11), reads, 0.005)
    sample = os.path.join(d, "reads.fq")
    helpers.write_fastq(sample, reads)
    truth = os.path.join(d, "truth")
    tcount.run_count(fa + ".qm", sample, truth, batch_bases=1 << 15,
                     verbose=False, device="cpu")
    return {"dir": d, "fa": fa, "qm": fa + ".qm", "sample": sample,
            "truth": formats.read_u16(truth + ".bin")}


def _kw(world, ckpt, mode="flat", engine="mono"):
    return dict(batch_bases=1 << 13, chunk_bytes=50_000, verbose=False,
                mode=mode, ref_fasta=world["fa"], engine=engine,
                checkpoint_path=ckpt, checkpoint_every_bytes=100_000)


def _with_reader(world, n_reads, fn):
    """fn() with the sample opened through a LimitedFile of n_reads
    reads; returns the LimitedFiles made."""
    sample = world["sample"]
    real = builtins.open
    made = []

    def patched(path, *a, **k):
        f = real(path, *a, **k)
        if path != sample:
            return f
        made.append(LimitedFile(f, n_reads))
        return made[-1]

    builtins.open = patched
    try:
        fn()
    finally:
        builtins.open = real
    return made


def _interrupt(package, world, out, n_reads, **kw):
    """Run count until its reader raises after n_reads reads; a
    checkpoint must exist then."""
    def run():
        with pytest.raises(Bomb):
            _run(package, world["qm"], world["sample"], out, **kw)
    _with_reader(world, n_reads, run)
    assert os.path.exists(kw["checkpoint_path"]), "no checkpoint written"


_CASES = [("flat", "mono"), ("flat", "linear"), ("flat", "packed"),
          ("flat", "sortjoin"), ("anchored", "mono")]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("mode,engine", _CASES)
def test_resume_across_packages(world, tmp_path, mode, engine, writer,
                                reader):
    ckpt = str(tmp_path / "count.ckpt")
    kw = _kw(world, ckpt, mode, engine)
    _interrupt(writer, world, str(tmp_path / "part"), 5, **kw)
    offset = checkpoint.load(ckpt)[0]
    assert offset > 0
    made = _with_reader(world, 10 ** 9, lambda: _run(
        reader, world["qm"], world["sample"], str(tmp_path / "resumed"),
        **kw))
    # the resume reads on from the checkpoint's offset
    assert made[0].n_bytes == os.path.getsize(world["sample"]) - offset
    assert not os.path.exists(ckpt)      # removed on success
    np.testing.assert_array_equal(
        formats.read_u16(str(tmp_path / "resumed.bin")), world["truth"])


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"),
                                           ("port", "jax")])
def test_resume_from_stdin(world, tmp_path, monkeypatch, writer, reader):
    """A stdin count resumes by replaying the pipe and discarding the
    consumed prefix (_discard_exactly)."""
    data = open(world["sample"], "rb").read()
    ckpt = str(tmp_path / "count.ckpt")
    kw = _kw(world, ckpt)
    monkeypatch.setattr(sys, "stdin", LimitedStdin(data, 5))
    with pytest.raises(Bomb):
        _run(writer, world["qm"], "-", str(tmp_path / "part"), **kw)
    assert os.path.exists(ckpt)
    monkeypatch.setattr(sys, "stdin", LimitedStdin(data, 10 ** 9))
    _run(reader, world["qm"], "-", str(tmp_path / "resumed"), **kw)
    np.testing.assert_array_equal(
        formats.read_u16(str(tmp_path / "resumed.bin")), world["truth"])


def test_replayed_stdin_shorter_than_checkpoint_raises(world, tmp_path,
                                                       monkeypatch):
    data = open(world["sample"], "rb").read()
    ckpt = str(tmp_path / "count.ckpt")
    kw = _kw(world, ckpt)
    monkeypatch.setattr(sys, "stdin", LimitedStdin(data, 5))
    with pytest.raises(Bomb):
        _run("port", world["qm"], "-", str(tmp_path / "part"), **kw)
    monkeypatch.setattr(sys, "stdin", LimitedStdin(data[:1000], 10 ** 9))
    with pytest.raises(EOFError, match="shorter than the original"):
        _run("port", world["qm"], "-", str(tmp_path / "resumed"), **kw)


def test_resume_refuses_other_layout(world, tmp_path):
    ckpt = str(tmp_path / "count.ckpt")
    _interrupt("jax", world, str(tmp_path / "part"), 5,
               **_kw(world, ckpt, engine="mono"))
    with pytest.raises(ValueError, match="layout"):
        _run("port", world["qm"], world["sample"], str(tmp_path / "o"),
             **_kw(world, ckpt, engine="packed"))


def _resume_with_overflow_counter(world, tmp_path, mode):
    """A JAX checkpoint of `mode` whose overflow side-counter is live
    (ovf_* arrays; a JAX StreamCounter's, fed by hand) resumes in the
    port to the JAX package's depth, the counter's depth added at
    finish, and the port's snapshot carries the counter's arrays
    again."""
    import shutil
    from quickmer2_tpu.dictionary import Dictionary as JaxDictionary
    from quickmer2_tpu_torch.ops.anchored import AnchoredIndex
    ckpt = str(tmp_path / "count.ckpt")
    _interrupt("jax", world, str(tmp_path / "part"), 5,
               **_kw(world, ckpt, mode=mode))
    offset, arrays, meta = checkpoint.load(ckpt)
    jdic = JaxDictionary.from_qm(world["qm"])
    jsc = jcount.StreamCounter(jdic, batch_bases=1 << 13)
    jsc.overflow_counter = jcount.DepthCounter(jdic, batch_bases=1 << 13)
    with open(world["sample"], "rb") as f:
        jsc.overflow_counter.feed_codes(
            jcount.make_packer("fastq").feed(f.read(30_000)))
    ovf, ovf_meta = jsc.snapshot()
    ovf = {k: v for k, v in ovf.items() if k.startswith("ovf_")}
    assert set(ovf) == {"ovf_depth", "ovf_residual", "ovf_side_counts"}
    arrays.update(ovf)
    meta["state"]["ovf_windows"] = ovf_meta["ovf_windows"]
    checkpoint.save(ckpt, offset, arrays, meta)

    dic = tcount.Dictionary.from_qm(world["qm"])
    index = (AnchoredIndex.from_dictionary_and_fasta(dic, world["fa"],
                                                     device="cpu")
             if mode == "anchored" else None)
    sc = tcount.StreamCounter(dic, mode=mode, index=index,
                              batch_bases=1 << 13, device="cpu")
    sc.restore(arrays, meta["state"])
    again, again_meta = sc.snapshot()
    assert again_meta["ovf_windows"] == ovf_meta["ovf_windows"]
    for name, a in ovf.items():
        np.testing.assert_array_equal(again[name], a)
    bins = {}
    for package in ("jax", "port"):
        shutil.copy(ckpt, ckpt + "." + package)
        out = str(tmp_path / package)
        _run(package, world["qm"], world["sample"], out,
             **_kw(world, ckpt + "." + package, mode=mode))
        bins[package] = formats.read_u16(out + ".bin")
    np.testing.assert_array_equal(bins["port"], bins["jax"])
    assert (bins["port"] != world["truth"]).any()


def test_resume_refuses_overflow_counter(world, tmp_path):
    """Refused until the port restored it (the name is the refusal
    test's): a flat JAX checkpoint with a live overflow counter, which
    the JAX package restores in either mode, resumes in the port."""
    _resume_with_overflow_counter(world, tmp_path, "flat")


def test_resume_anchored_overflow_counter(world, tmp_path):
    """The shape the JAX package writes: its StreamCounter makes an
    overflow counter in anchored mode only (reads wider than the row
    width), so an anchored checkpoint with ovf_* arrays resumes in the
    port through the anchored finish."""
    _resume_with_overflow_counter(world, tmp_path, "anchored")


def test_checkpoint_format_is_the_jax_format(tmp_path):
    from quickmer2_tpu.utils import checkpoint as jckpt
    assert checkpoint.MAGIC == jckpt.MAGIC
    arrays = {"depth": np.arange(5, dtype=np.uint32),
              "residual": np.zeros(0, np.uint8)}
    meta = {"fmt": "fastq", "state": {"mode": "flat"}}
    for save, load in ((checkpoint.save, jckpt.load),
                       (jckpt.save, checkpoint.load)):
        path = str(tmp_path / "c")
        save(path, 123, arrays, meta)
        offset, got, got_meta = load(path)
        assert (offset, got_meta) == (123, meta)
        for name, a in arrays.items():
            np.testing.assert_array_equal(got[name], a)
            assert got[name].dtype == a.dtype


def test_hbm_limit_falls_back_to_flat(world, tmp_path):
    """Anchored structures over the limit: the count runs flat, as the
    JAX package's does, and says why."""
    stats = {}
    for package in ("jax", "port"):
        out = str(tmp_path / package)
        stats[package] = _run(package, world["qm"], world["sample"], out,
                              batch_bases=1 << 15, verbose=False,
                              mode="anchored", ref_fasta=world["fa"],
                              hbm_limit_bytes=1)
        np.testing.assert_array_equal(formats.read_u16(out + ".bin"),
                                      world["truth"])
    got, want = stats["port"]["fallback"], stats["jax"]["fallback"]
    assert got["reason"] == want["reason"] == "anchored-structures-exceed-hbm"
    assert stats["port"]["mode"] == "flat"
    assert got["estimate_bytes"]["total"] == want["estimate_bytes"]["total"]
