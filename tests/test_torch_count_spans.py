"""The flat counter's phases (utils.profiling.Phases) on the CPU, with the
kernels' plain versions: each a `counter.*` profiler range inside its
parent, timed in StreamCounter.stats as phase_<name>_s beside the counts
n_batches, n_recount_lanes and n_side_hits; the depth the same with the
profiler on and off; the anchored counter's phases under their old keys.
"""

import json
import sys
import threading
import types

import numpy as np
import pytest
import torch

from quickmer2_tpu_torch.dictionary import Dictionary
from quickmer2_tpu_torch.ops import codec
from quickmer2_tpu_torch.ops.anchored import AnchoredIndex
from quickmer2_tpu_torch.ops.monotable import MonoTable
from quickmer2_tpu_torch.pipelines import count as tcount
from quickmer2_tpu_torch.utils import profiling
from quickmer2_tpu_torch.utils.profiling import Phases
from tests import helpers
from tests.torch_threads import few_threads  # noqa: F401

K = 25
BATCH = 1 << 13

# each span's parent, where it always has one (PERF.md §3); concat,
# pack_put, dispatch and drain also run inside finish_tail at finish
PARENT = {"pack": "pack_put", "put": "pack_put", "mask_wait": "drain",
          "mask_scan": "drain", "recount": "drain"}
TAIL = ("concat", "pack_put", "pack", "put", "dispatch", "drain",
        "mask_wait", "mask_scan", "recount")
FLAT = ("concat", "pack_put", "pack", "put", "dispatch", "finish_tail")
SPANS = {"mono": FLAT + ("drain", "mask_wait", "mask_scan", "recount",
                         "depth_fetch", "depth_rank"),
         "packed": FLAT + ("depth_fetch",),
         "linear": FLAT + ("depth_fetch",),
         "sortjoin": FLAT}
COUNTS = {"mono": ("batches", "recount_lanes", "side_hits")}
# the anchored counter's keys before its phases moved onto Phases
ANCHORED = ("pack_put", "put_wait", "dispatch_1", "drain", "finish_sync")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A random genome (as a FASTA too), its dictionary, a mono table at
    load 2.0 (full buckets: a side table and unresolved lanes), and a
    FASTQ stream of 150 bp reads at 1 %/bp, half reverse-complemented,
    as the packer's code stream."""
    rng = np.random.default_rng(2026)
    d = tmp_path_factory.mktemp("spans")
    g = helpers.random_genome(rng, 20000)
    fa = str(d / "g.fa")
    helpers.write_fasta(fa, {"c1": g})
    genome = tcount.make_packer("fasta-lines").feed(f">c1\n{g}\n".encode())
    canon, valid = codec.sliding_kmers_np(genome, K)
    km = canon[valid]
    _, first = np.unique(km, return_index=True)
    dic = Dictionary.from_kmers_in_order(km[np.sort(first)], 1 << 16, K)
    reads = helpers.mutate_reads(rng, helpers.simulate_reads(rng, g, 500, 150),
                                 0.01)
    fq = "".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n" for i, r in
                 enumerate(reads)).encode()
    codes = tcount.make_packer("fastq").feed(fq)
    return {"fa": fa, "dic": dic, "codes": codes,
            "mono": MonoTable.from_dictionary(dic, load=2.0)}


def _count(world, layout, profiled=False, tmp_path=None, mode="flat"):
    """(StreamCounter, depth, the trace's user annotations or None):
    the world's stream fed in uneven chunks, then finish()."""
    kw = dict(batch_bases=BATCH, device="cpu", engine=layout)
    if mode == "anchored":
        kw["index"] = AnchoredIndex.from_dictionary_and_fasta(
            world["dic"], world["fa"], device="cpu")
    elif layout == "mono":
        kw["packed_table"] = world["mono"]
    sc = tcount.StreamCounter(world["dic"], mode=mode, **kw)
    codes = world["codes"]
    cuts = np.sort(np.random.default_rng(5).integers(0, len(codes), 9))
    prof = (torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
        if profiled else None)
    if prof is not None:
        prof.__enter__()
    for part in np.split(codes, cuts):
        sc.feed_codes(part)
    depth = sc.finish()
    if prof is None:
        return sc, depth, None
    prof.__exit__(None, None, None)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    notes = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == "user_annotation"]
    return sc, depth, notes


def _inside(child, parents) -> bool:
    s, t, _ = child
    return any(a <= s and t <= b for a, b, _ in parents)


@pytest.mark.parametrize("layout", sorted(SPANS))
def test_spans_nest_once_a_batch(world, tmp_path, monkeypatch, layout):
    """Every span of the layout is in the trace as `counter.<name>`, each
    child inside its parent and, inside finish_tail, only the batch's
    phases; pack_put and dispatch (and mono's drain, one batch behind
    and the last at finish) occur once a batch, and the batches are the
    count steps run (the plain K2 counts no launches, so its calls)."""
    steps = []
    step = tcount.count_mono_step

    def counted(*a, **kw):
        steps.append(1)
        return step(*a, **kw)
    monkeypatch.setattr(tcount, "count_mono_step", counted)
    sc, _, notes = _count(world, layout, True, tmp_path)
    by = {}
    for s, t, n in notes:
        if n.startswith("counter."):
            by.setdefault(n[len("counter."):], []).append((s, t, n))
    assert set(by) == set(SPANS[layout])
    n_batches = sc.stats["n_batches"]
    assert n_batches > 3
    once = ("pack_put", "dispatch") + (("drain",) if layout == "mono" else ())
    for name in once:
        assert len(by[name]) == n_batches, name
    assert len(steps) == (n_batches if layout == "mono" else 0)
    for name, parent in PARENT.items():
        for span in by.get(name, []):
            assert _inside(span, by[parent]), span
    tail = by["finish_tail"]
    assert len(tail) == 1
    for name, spans in by.items():
        if name != "finish_tail" and any(_inside(s, tail) for s in spans):
            assert name in TAIL, name


def test_side_hits_are_the_side_keys_windows(world):
    """n_side_hits equals the stream's valid windows whose canonical
    k-mer is a side-table key, counted here with the host codec and a
    set; n_recount_lanes is at least that."""
    sc, depth, _ = _count(world, "mono")
    mono = world["mono"]
    assert mono.side_rank is not None and len(mono.side_rank)
    side = set(world["dic"].kmers_in_order[mono.side_rank].tolist())
    canon, valid = codec.sliding_kmers_np(world["codes"], K)
    want = sum(1 for c in canon[valid].tolist() if c in side)
    st = sc.stats
    assert want > 0
    assert st["n_side_hits"] == want
    assert st["n_recount_lanes"] >= want
    assert st["total_windows"] > st["n_recount_lanes"]


@pytest.mark.parametrize("layout", sorted(SPANS))
def test_depth_same_with_profiler_on(world, tmp_path, layout):
    _, off, _ = _count(world, layout)
    _, on, _ = _count(world, layout, True, tmp_path)
    assert off.dtype == on.dtype and off.tobytes() == on.tobytes()
    assert off.sum() > 0


@pytest.mark.parametrize("layout", sorted(SPANS))
def test_stats_carry_spans_and_counts(world, layout):
    """phase_<name>_s for every span, n_<name> for every count; the
    children's seconds add up to no more than their parent's."""
    sc, _, _ = _count(world, layout)
    st = sc.stats
    assert {k for k in st if k.startswith("phase_")} == {
        f"phase_{n}_s" for n in SPANS[layout]}
    assert {k for k in st if k.startswith("n_")} == {
        f"n_{n}" for n in COUNTS.get(layout, ("batches",))}
    sec = sc.counter.phases.seconds
    for parent in set(PARENT.values()) & set(sec):
        kids = [n for n, p in PARENT.items() if p == parent]
        assert sum(sec[n] for n in kids) <= sec[parent]
        assert all(sec[n] <= sec[parent] for n in kids)
    assert st["total_windows"] == st["n_batches"] * (BATCH - K + 1)


def test_anchored_keeps_its_phase_keys(world, tmp_path):
    """One anchored count: its phases under their keys as before, those
    of the thread that runs the profiler as `anchored.*` ranges in the
    trace (pack_put runs on the transfer thread, which torch.profiler
    does not follow), and no `counter.*` range."""
    sc, depth, notes = _count(world, "mono", True, tmp_path, mode="anchored")
    st = sc.stats
    assert {f"phase_{n}_s" for n in ANCHORED} <= set(st)
    names = {n for _, _, n in notes}
    assert {f"anchored.{n}" for n in ANCHORED if n != "pack_put"} <= names
    assert not any(n.startswith("counter.") for n in names)
    assert depth.sum() > 0


def test_phases_sum_across_threads(monkeypatch):
    """Phases and counts from several threads at once lose no update:
    each thread's clock reads one second later at every call, so every
    phase lasts exactly one second."""
    clock = threading.local()

    def perf_counter():
        clock.t = getattr(clock, "t", 0.0) + 1.0
        return clock.t

    monkeypatch.setattr(profiling, "time",
                        types.SimpleNamespace(perf_counter=perf_counter))
    ph = Phases("t.")
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(500):
                with ph("a"):
                    ph.add("n", 1)
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(before)
    assert ph.seconds["a"] == 4000.0 and ph.counts["n"] == 4000
    assert ph.stats() == {"phase_a_s": 4000.0, "n_n": 4000}
