"""`--profile` against the JAX package's: the JAX CLI's xprof trace
(`plugins/profile/<ts>/<host>.trace.json.gz`) and the port's
torch.profiler trace (`<dir>/*.pt.trace.json`, --device cpu) name the
same pipeline regions in the same order, none overlapping the next, and
the four runs (each package with and without --profile) write the same
bytes. `trace(None, ...)` writes nothing; `trace(dir, "cuda")` without a
card raises, as every entry point does."""

import glob
import gzip
import json
import os
import shutil

import numpy as np
import pytest
import torch

from quickmer2_tpu.cli import main as jax_main
from quickmer2_tpu.config import SearchConfig as JaxSearchConfig
from quickmer2_tpu.pipelines import search as jsearch
from quickmer2_tpu_torch.cli import main
from quickmer2_tpu_torch.utils.profiling import annotate, trace
from tests import helpers
from tests.torch_threads import few_threads  # noqa: F401

SEARCH = ["search", "-k", "25", "-s", "16K", "-d", "1", "-w", "50", "-c",
          "ctrl.bed"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A small genome with a repeat and a segment copied with one
    substitution (the edit filter removes the k-mers over it), its
    reads, a control bed, and the JAX search's dictionary with its .qgc
    (so a count writes .txt too)."""
    rng = np.random.default_rng(31)
    d = tmp_path_factory.mktemp("prof")
    rep = helpers.random_genome(rng, 400)
    seg = helpers.random_genome(rng, 300)
    sub = "C" if seg[150] != "C" else "G"
    g = (helpers.random_genome(rng, 3000) + rep
         + helpers.random_genome(rng, 2500) + rep + seg
         + helpers.random_genome(rng, 500) + seg[:150] + sub + seg[151:])
    helpers.write_fasta(str(d / "g.fa"), {"c1": g})
    helpers.write_fastq(str(d / "r.fq"), helpers.mutate_reads(
        rng, helpers.simulate_reads(rng, g, 300, 100), 0.005))
    with open(str(d / "ctrl.bed"), "w") as f:
        f.write("c1\t0\t2500\nc9\t0\t10\n")
    jsearch.run_search(str(d / "g.fa"), JaxSearchConfig(
        kmer_size=25, hash_size=1 << 14, edit_distance=1,
        edit_depth_threshold=1, window_size=50,
        control_bed=str(d / "ctrl.bed")), verbose=False)
    return d


def _regions(events):
    """(name, start, end) of the pipeline regions, in time order."""
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X"
                   and e.get("name", "").startswith(("search.", "count.")))
    return [(n, a, b) for a, b, n in spans]


def _jax_regions(prof):
    [path] = glob.glob(os.path.join(prof, "plugins", "profile", "*",
                                    "*.trace.json.gz"))
    with gzip.open(path) as f:
        return _regions(json.load(f)["traceEvents"])


def _port_regions(prof):
    [path] = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return _regions([e for e in events if e.get("cat") == "user_annotation"])


@pytest.mark.parametrize("args,regions", [
    (SEARCH[:1] + ["-e", "1"] + SEARCH[1:] + ["g.fa"],
     ("search.tabulate", "search.filter", "search.emit")),
    (SEARCH[:1] + ["-e", "0"] + SEARCH[1:] + ["g.fa"],
     ("search.tabulate", "search.emit")),
    (["count", "--batch-bases", "4096", "g.fa", "r.fq", "o"],
     ("count.stream", "count.finish"))],
    ids=["search", "search-e0", "count"])
def test_profile_regions_and_bytes_match_jax(inputs, tmp_path, args,
                                             regions):
    runs = {}
    for package, run in (("jax", jax_main), ("port", main)):
        for profiled in (False, True):
            d = tmp_path / f"{package}{int(profiled)}"
            shutil.copytree(str(inputs), str(d))
            before = set(os.listdir(d))
            argv = [str(d / a) if a in ("g.fa", "r.fq", "o", "ctrl.bed")
                    else a for a in args]
            if profiled:
                argv = argv[:1] + ["--profile", str(d / "prof")] + argv[1:]
            if package == "port":
                argv = argv[:1] + ["--device", "cpu"] + argv[1:]
            if args[0] == "search":
                argv = argv[:1] + ["--out-prefix", str(d / "out")] + argv[1:]
            assert run(argv) == 0
            made = sorted(set(os.listdir(d)) - before - {"prof"})
            runs[package, profiled] = (d, made)
    want = (["out.bed", "out.qgc", "out.qm"] if args[0] == "search"
            else ["o.bin", "o.txt"])
    for d, made in runs.values():
        assert made == want
        for name in made:
            with open(runs["jax", False][0] / name, "rb") as a, \
                    open(d / name, "rb") as b:
                assert a.read() == b.read(), (d, name)
    got = {"jax": _jax_regions(str(runs["jax", True][0] / "prof")),
           "port": _port_regions(str(runs["port", True][0] / "prof"))}
    for package, spans in got.items():
        assert tuple(n for n, _, _ in spans) == regions, (package, spans)
        for (_, _, end), (_, start, _) in zip(spans, spans[1:]):
            assert end <= start, (package, spans)


def test_trace_none_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with trace(None, "cpu"):
        with annotate("count.stream"):
            torch.ones(4).sum()
    assert os.listdir(tmp_path) == []


def test_trace_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card refusal is moot")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with trace(str(tmp_path / "prof"), "cuda"):
            pass
    assert not os.path.exists(tmp_path / "prof")
