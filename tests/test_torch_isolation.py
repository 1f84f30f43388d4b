"""The port stands alone: it imports neither jax nor the JAX package
(a flat and an anchored count, a sort-join count, a checkpointed count,
a cohort, flat and anchored counts sharded over a 2 x 2 mesh, a
one-process run_count_distributed, a search whose slow queries take the
packed-table path and an anchored index whose bitmap the Hamming join
builds, a search with the device emit on one device and sharded over
two, sparse, index and an est with device window sums, on the CPU, in a
fresh interpreter), and its entry points run on the card unless asked
for the CPU — on a box without a card they raise instead of falling
back. The multi-device CLI options run and write the JAX CLI's bytes;
--profile is still refused."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from tests.torch_threads import few_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_COUNT_ON_CPU = r"""
import sys
import numpy as np
from quickmer2_tpu_torch.dictionary import Dictionary
from quickmer2_tpu_torch.ops import codec
from quickmer2_tpu_torch.pipelines.count import run_count
from quickmer2_tpu_torch.io import formats

rng = np.random.default_rng(0)
g = rng.integers(0, 4, 5000).astype(np.uint8)
canon, valid = codec.sliding_kmers_np(g, 25)
kmers = canon[valid & (canon != 0)]          # rank order = genome order
assert len(np.unique(kmers)) == len(kmers)
lut = np.frombuffer(b"ACTG", np.uint8)
with open("g.fa", "w") as f:
    f.write(">c1\n" + lut[g].tobytes().decode() + "\n")
Dictionary.from_kmers_in_order(kmers, 1 << 14, 25).to_qm("g.fa.qm")
with open("r.fa", "w") as f:
    for s in rng.integers(0, 4900, 200):
        f.write(">r\n" + lut[g[s:s + 100]].tobytes().decode() + "\n")
stats = run_count("g.fa.qm", "r.fa", "flat", batch_bases=1 << 13,
                  verbose=False, device="cpu")
assert formats.read_u16("flat.bin").sum() > 0, stats
stats = run_count("g.fa.qm", "r.fa", "anch", batch_bases=1 << 13,
                  verbose=False, mode="anchored", device="cpu")
assert stats["mode"] == "anchored", stats
with open("flat.bin", "rb") as a, open("anch.bin", "rb") as b:
    assert a.read() == b.read()
run_count("g.fa.qm", "r.fa", "sj", batch_bases=1 << 13, verbose=False,
          engine="sortjoin", device="cpu")
run_count("g.fa.qm", "r.fa", "ck", batch_bases=1 << 13, verbose=False,
          checkpoint_path="ck.ckpt", checkpoint_every_bytes=4096,
          device="cpu")
from quickmer2_tpu_torch.pipelines.cohort import run_cohort
run_cohort("g.fa.qm", [("r.fa", "co")], batch_bases=1 << 13, verbose=False,
           device="cpu")
# the sharded counters (a 2 x 2 mesh of CPU copies) and one process of
# the distributed count (no process group: world size 1)
for mode in ("flat", "anchored"):
    run_count("g.fa.qm", "r.fa", "sh_" + mode, batch_bases=1 << 13,
              verbose=False, mode=mode, data_devices=2, dict_devices=2,
              device="cpu")
from quickmer2_tpu_torch.parallel.distributed import run_count_distributed
st = run_count_distributed("g.fa.qm", "r.fa", "dist", batch_bases=1 << 13,
                           verbose=False, device="cpu")
assert st["process"] == 0, st
for out in ("sj", "ck", "co", "sh_flat", "sh_anchored", "dist"):
    with open("flat.bin", "rb") as a, open(out + ".bin", "rb") as b:
        assert a.read() == b.read(), out

from quickmer2_tpu_torch.config import SearchConfig
from quickmer2_tpu_torch.ops import anchored
from quickmer2_tpu_torch.pipelines import search
# 100 windows ending in one motif overflow a join bucket: slow queries
crowd = np.concatenate([np.concatenate([rng.integers(0, 4, 20), g[:10]])
                        for _ in range(100)]).astype(np.uint8)
with open("s.fa", "w") as f:
    f.write(">s1\n" + lut[np.concatenate([g, crowd])].tobytes().decode()
            + "\n")
st = {}
search.PACKED_SLOW_PATH_DEVICES = ("cuda", "cpu")
search.run_search("s.fa", SearchConfig(kmer_size=15, hash_size=1 << 14,
                                       edit_distance=2, window_size=50),
                  verbose=False, stats=st, device="cpu")
assert st["filter"]["n_slow"] > 0 and st["phases"]["slow_table_s"] > 0, st
pos = np.arange(len(kmers), dtype=np.uint32) + 24
tiles = []
for join_on, device_build in ((("cpu",), True), ((), False)):
    anchored.JOIN_BITS_DEVICES = join_on   # the join, then the host builder
    tiles.append(anchored.AnchoredIndex.build(
        g, pos, kmers, 25, device_build=device_build,
        device="cpu").genome_tiles.numpy())
assert (tiles[0] == tiles[1]).all()

# the device emit, sparse, index, est with device window sums
search.run_search("g.fa", SearchConfig(kmer_size=25, hash_size=1 << 14,
                                       edit_distance=1, window_size=50),
                  verbose=False, out_prefix="em", device="cpu",
                  emit_devices=1)
with open("g.fa.qm", "rb") as a, open("em.qm", "rb") as b:
    assert a.read() != b.read()         # the filter removed some k-mers
search.run_search("g.fa", SearchConfig(kmer_size=25, hash_size=1 << 14,
                                       edit_distance=1, window_size=50),
                  verbose=False, out_prefix="em2", device="cpu",
                  emit_devices=2)
for ext in (".qm", ".bed"):
    with open("em" + ext, "rb") as a, open("em2" + ext, "rb") as b:
        assert a.read() == b.read(), ext
from quickmer2_tpu_torch.pipelines.est import run_est
from quickmer2_tpu_torch.pipelines.index import run_index
from quickmer2_tpu_torch.pipelines.sparse import run_sparse
import shutil
shutil.copy("em.qm", "g.fa.qm")
shutil.copy("em.bed", "g.fa.bed")
run_sparse("g.fa", 20, window_size=50, verbose=False, device="cpu")
with open("k.bed", "w") as f:
    f.write("c1\t0\t25\t" + lut[g[:25]].tobytes().decode() + "\n")
run_index("k.bed", "k.qm", hash_size=1 << 10, verbose=False, device="cpu")
import numpy as np
from quickmer2_tpu_torch.io import formats
n = formats.read_windows_bed("g.fa.bed")[1][-1, 3] + 10
formats.write_u16("g.fa.qgc", (100 + np.arange(n) % 200) | 0x8000)
formats.write_u16("d.bin", np.full(n, 25, np.uint16))
res = run_est("g.fa", "d", "d.CN.bed", verbose=False, device="cpu",
              device_sums=True)
assert res["n_windows"] > 0, res
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "quickmer2_tpu"
             or m.startswith("quickmer2_tpu."))
print("LEAKED", bad)
assert not bad, bad
"""


def test_port_never_imports_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", _COUNT_ON_CPU],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card refusal is moot")


def _entry(name, tmp_path):
    from quickmer2_tpu_torch.config import SearchConfig
    from quickmer2_tpu_torch.dictionary import Dictionary
    from quickmer2_tpu_torch.pipelines import count, est, search
    d = str(tmp_path)
    if name == "run_search":
        return lambda: search.run_search(os.path.join(d, "g.fa"),
                                         SearchConfig())
    if name == "run_count":
        return lambda: count.run_count(os.path.join(d, "g.qm"),
                                       os.path.join(d, "r.fa"),
                                       os.path.join(d, "o"))
    if name == "run_count_anchored":
        return lambda: count.run_count(os.path.join(d, "g.qm"),
                                       os.path.join(d, "r.fa"),
                                       os.path.join(d, "o"), mode="anchored")
    if name == "run_est":
        return lambda: est.run_est(os.path.join(d, "g"), os.path.join(d, "o"),
                                   os.path.join(d, "cn.bed"))
    if name == "run_sparse":
        from quickmer2_tpu_torch.pipelines.sparse import run_sparse
        return lambda: run_sparse(os.path.join(d, "g.fa"), 100)
    if name == "run_index":
        from quickmer2_tpu_torch.pipelines.index import run_index
        return lambda: run_index(os.path.join(d, "k.bed"),
                                 os.path.join(d, "k.qm"))
    if name == "DeviceMembershipScanner":
        from quickmer2_tpu_torch.ops.packed_table import PackedTable
        from quickmer2_tpu_torch.parallel.emit_parallel import (
            DeviceMembershipScanner)
        tab = PackedTable.build(np.zeros(1, np.uint32),
                                np.ones(1, np.uint32),
                                rank=np.zeros(1, np.uint32))
        return lambda: DeviceMembershipScanner(tab, 15)
    if name == "run_cohort":
        from quickmer2_tpu_torch.pipelines.cohort import run_cohort
        return lambda: run_cohort(os.path.join(d, "g.qm"),
                                  [(os.path.join(d, "r.fa"),
                                    os.path.join(d, "o"))])
    dic = Dictionary.from_kmers_in_order(np.arange(1, 50, dtype=np.uint64),
                                         1 << 8, 15)
    if name == "DepthCounter":
        return lambda: count.DepthCounter(dic)
    if name == "ShardedDepthCounter":
        from quickmer2_tpu_torch.parallel.count_parallel import (
            ShardedDepthCounter)
        from quickmer2_tpu_torch.parallel.mesh import make_mesh
        return lambda: ShardedDepthCounter(dic, make_mesh(2, 1))
    if name == "run_count_distributed":
        from quickmer2_tpu_torch.parallel.distributed import (
            run_count_distributed)
        return lambda: run_count_distributed(os.path.join(d, "g.qm"),
                                             os.path.join(d, "r.fa"),
                                             os.path.join(d, "o"))
    from quickmer2_tpu_torch.ops import anchored
    genome = np.random.default_rng(1).integers(0, 4, 200).astype(np.uint8)
    if name == "AnchoredIndex":
        return lambda: anchored.AnchoredIndex.build(
            genome, np.arange(49, dtype=np.uint32) + 14, dic.kmers_in_order,
            15, neighbor_bits=False)
    index = anchored.AnchoredIndex.build(
        genome, np.arange(49, dtype=np.uint32) + 14, dic.kmers_in_order, 15,
        neighbor_bits=False, device="cpu")
    if name == "ShardedAnchoredCounter":
        from quickmer2_tpu_torch.parallel.anchored_parallel import (
            ShardedAnchoredCounter)
        from quickmer2_tpu_torch.parallel.mesh import make_mesh
        return lambda: ShardedAnchoredCounter(index, 15, 100,
                                              make_mesh(2, 1))
    return lambda: anchored.AnchoredDepthCounter(index, 15, 100)


@pytest.mark.parametrize("name", ["run_search", "run_count",
                                  "run_count_anchored", "run_est",
                                  "run_cohort", "DepthCounter",
                                  "AnchoredIndex", "AnchoredDepthCounter",
                                  "run_sparse", "run_index",
                                  "DeviceMembershipScanner",
                                  "ShardedDepthCounter",
                                  "ShardedAnchoredCounter",
                                  "run_count_distributed"])
def test_default_device_refuses_cpu_fallback(tmp_path, name):
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry(name, tmp_path)()


def test_cli_default_device_refuses_cpu_fallback(tmp_path):
    _no_card()
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-m", "quickmer2_tpu_torch", "est",
                          "g.fa", "smp", "cn.bed"], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


@pytest.mark.parametrize("args", [
    ["search", "--emit-devices", "2", "g.fa"],
    ["count", "--data-devices", "2", "g.fa", "r.fq", "o"],
    ["count", "--dict-devices", "2", "g.fa", "r.fq", "o"],
    ["count", "--profile", "d", "g.fa", "r.fq", "o"],
    ["search", "--profile", "d", "g.fa"],
    ["cohort", "--data-devices", "2", "g.fa", "r.fq:o"]])
def test_cli_rejects_unported(args, capsys, tmp_path):
    """--profile is still refused; the multi-device options, refused
    before the multi-device layer was ported, run on a small genome
    (--device cpu) and write the JAX CLI's bytes."""
    from quickmer2_tpu_torch.cli import main
    if "--profile" not in args:
        from tests.test_torch_cli import multi_device_cli_pair
        multi_device_cli_pair(args, tmp_path)
        return
    with pytest.raises(SystemExit) as exc:
        main(args + ["--device", "cpu"])
    assert exc.value.code != 0
    assert "not yet ported" in capsys.readouterr().err


def test_cli_search_quirk_editdist_matches_jax(tmp_path):
    """`search --quirk-editdist` runs the quirk-compat filter and writes
    the JAX package's .qm and .bed."""
    from quickmer2_tpu.cli import main as jax_main
    from quickmer2_tpu_torch.cli import main
    from tests import helpers
    rng = np.random.default_rng(3)
    seq = helpers.random_genome(rng, 1500)
    noisy = "".join("ACGT"[rng.integers(0, 4)] if rng.random() < 0.03 else c
                    for c in seq)
    fa = str(tmp_path / "g.fa")
    helpers.write_fasta(fa, {"c1": seq + noisy})
    args = ["search", "-k", "30", "-s", "16K", "-d", "2", "-w", "50",
            "--quirk-editdist"]
    jax_main(args + ["--out-prefix", str(tmp_path / "jax"), fa])
    main(args + ["--out-prefix", str(tmp_path / "port"), "--device", "cpu",
                 fa])
    for ext in (".qm", ".bed"):
        with open(str(tmp_path / "jax") + ext, "rb") as a, \
                open(str(tmp_path / "port") + ext, "rb") as b:
            assert a.read() == b.read(), ext
