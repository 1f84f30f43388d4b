"""The port's multi-process count: two torch.distributed processes (gloo,
on the CPU) against a one-process count of the port and of the JAX
package, and a pair that dies after its first per-process checkpoint and
resumes. The processes meet through a file:// rendezvous under the test's
directory, so no port is picked and raced for."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from quickmer2_tpu.config import SearchConfig
from quickmer2_tpu.io import formats
from quickmer2_tpu.pipelines import search as search_pipe
from quickmer2_tpu.pipelines.count import run_count as jax_run_count
from tests import helpers
from tests.torch_threads import few_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


WORKER = r"""
import os, sys
from quickmer2_tpu_torch.parallel import distributed as dist
from quickmer2_tpu_torch.utils import checkpoint as ckpt

if {die!r}:
    # die right after the first checkpoint lands: the bytes counted after
    # it are lost and must be counted again on resume
    real_save = ckpt.save
    def dying_save(*a, **kw):
        real_save(*a, **kw)
        os._exit(17)
    ckpt.save = dying_save

dist.initialize("file://" + {rdv!r}, 2, int(sys.argv[1]), backend="gloo",
                device="cpu")
stats = dist.run_count_distributed({qm!r}, {sample!r}, {out!r},
                                   batch_bases=1 << 16, verbose=False,
                                   mode={mode!r}, ref_fasta={ref!r},
                                   checkpoint_path={ckpt!r},
                                   checkpoint_every_bytes=30000,
                                   chunk_bytes=20000, device="cpu")
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "quickmer2_tpu" or m.startswith("quickmer2_tpu."))
print("DONE", stats["process"], stats["shard"], "LEAKED", bad)
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(44)
    d = tmp_path_factory.mktemp("tdist")
    chr1 = helpers.random_genome(rng, 20000)
    fa = str(d / "g.fa")
    helpers.write_fasta(fa, {"c1": chr1})
    search_pipe.run_search(fa, SearchConfig(kmer_size=30, hash_size=1 << 16,
                                            edit_distance=0, window_size=100),
                           verbose=False)
    srng = np.random.default_rng(6)
    reads = helpers.simulate_reads(srng, chr1, 2000, 100)
    reads += helpers.simulate_reads(srng, chr1, 8, 2000)   # segmented rows
    reads = helpers.mutate_reads(srng, reads, 0.004)       # spill paths
    sample = str(d / "reads.fq")
    helpers.write_fastq(sample, reads)
    jax_run_count(fa + ".qm", sample, str(d / "jax"), batch_bases=1 << 16,
                  verbose=False)
    return {"d": str(d), "fa": fa, "sample": sample,
            "truth": formats.read_u16(str(d / "jax.bin"))}


def _pair(tmp_path, world, mode, tag, die=False, ckpt=None):
    """Two gloo processes; returns their exit codes and outputs."""
    script = WORKER.format(
        die=die, rdv=str(tmp_path / f"rdv_{tag}"), qm=world["fa"] + ".qm",
        sample=world["sample"], out=str(tmp_path / "multi"), mode=mode,
        ref=world["fa"] if mode == "anchored" else None, ckpt=ckpt)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "2"
    procs = [subprocess.Popen([sys.executable, "-c", script, str(i)],
                              cwd=str(tmp_path), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out.decode(), err.decode()[-2000:]))
    return outs


@pytest.mark.parametrize("mode", ["flat", "anchored"])
def test_two_process_count_matches_single(tmp_path, world, mode):
    """Two processes, each a record-aligned shard, merged by the gloo
    all-reduce: the .bin of process 0 is the one-process count's (the
    JAX package's and the port's), and neither imports jax."""
    from quickmer2_tpu_torch.pipelines.count import run_count
    run_count(world["fa"] + ".qm", world["sample"], str(tmp_path / "one"),
              batch_bases=1 << 16, verbose=False, mode=mode,
              ref_fasta=world["fa"] if mode == "anchored" else None,
              device="cpu")
    np.testing.assert_array_equal(
        formats.read_u16(str(tmp_path / "one.bin")), world["truth"])
    outs = _pair(tmp_path, world, mode, mode)
    for rc, out, err in outs:
        assert rc == 0, err
        assert "LEAKED []" in out, out
    shards = [eval(o.split("DONE")[1].split("LEAKED")[0].split(" ", 2)[2])
              for _, o, _ in outs]
    assert shards[0][0] == 0 and shards[0][0] + shards[0][1] == shards[1][0]
    np.testing.assert_array_equal(
        formats.read_u16(str(tmp_path / "multi.bin")), world["truth"])


def test_two_process_checkpoint_resume(tmp_path, world):
    """Both processes die after their first checkpoint; a rerun resumes
    each from its own <path>.p<rank> and the merged .bin is the
    uninterrupted count's; the checkpoints go on success."""
    ckpt = str(tmp_path / "dist.ckpt")
    for rc, _, err in _pair(tmp_path, world, "flat", "die", die=True,
                            ckpt=ckpt):
        assert rc == 17, err
    assert os.path.exists(ckpt + ".p0") and os.path.exists(ckpt + ".p1")
    assert not os.path.exists(str(tmp_path / "multi.bin"))
    for rc, _, err in _pair(tmp_path, world, "flat", "resume", ckpt=ckpt):
        assert rc == 0, err
    np.testing.assert_array_equal(
        formats.read_u16(str(tmp_path / "multi.bin")), world["truth"])
    assert not os.path.exists(ckpt + ".p0")
    assert not os.path.exists(ckpt + ".p1")


def test_shard_check_refuses_another_split(tmp_path, world):
    """A per-process checkpoint of another shard (another process count)
    is refused; one process alone runs without a process group."""
    from quickmer2_tpu_torch.parallel import distributed as dist
    from quickmer2_tpu_torch.utils import checkpoint
    lo, length = dist.byte_shard(world["sample"], 0, 2)
    assert lo == 0 and 0 < length < os.path.getsize(world["sample"])
    ckpt = str(tmp_path / "c")
    checkpoint.save(ckpt + ".p0", 10, {}, meta={"shard": [lo, length]})
    with pytest.raises(ValueError, match="same process count"):
        dist.run_count_distributed(world["fa"] + ".qm", world["sample"],
                                   str(tmp_path / "o"), verbose=False,
                                   checkpoint_path=ckpt, device="cpu")
    dist.run_count_distributed(world["fa"] + ".qm", world["sample"],
                               str(tmp_path / "o"), batch_bases=1 << 16,
                               verbose=False, device="cpu")
    np.testing.assert_array_equal(formats.read_u16(str(tmp_path / "o.bin")),
                                  world["truth"])
