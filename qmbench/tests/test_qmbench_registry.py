"""Every configuration, mix and metric named in BENCHMARK.json is a
file found by its name, and a new one is found without editing any."""

import json
import os

import pytest

from qmbench import run

from qmbench_tiny import QM, load_bench, metric_names

BENCH = load_bench()


@pytest.mark.parametrize("cfg", [c["name"] for c in BENCH["configs"]])
def test_configs_load(cfg):
    c = run.Registry().config(cfg)
    entry = next(e for e in BENCH["configs"] if e["name"] == cfg)
    assert entry["file"] == f"qmbench/configs/{cfg}.json"
    assert sorted(entry["reduced"]) == sorted(c["reduced"])
    assert entry["source"] == c["source"]
    for key in ("mode", "k", "batch_bases", "chunk_bytes", "genome_bases",
                "genome_seed", "dup_len", "dup_copies", "guarantees"):
        assert key in c, key


@pytest.mark.parametrize("mix", sorted({w["traffic"]
                                        for w in BENCH["workloads"]}))
def test_traffic_loads(mix):
    t = run.Registry().traffic(mix)
    for key in ("read_len", "n_reads", "sub_rate", "revcomp_share",
                "header", "qual"):
        assert key in t, key


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_files_agree_with_benchmark(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    run.check_metric(entry, run.Registry().metric(metric))
    for cell in entry.get("workloads", []):
        assert cell in {w["name"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("metric", sorted(metric_names()))
def test_every_metric_file_declares_itself(metric):
    """Each reader, those BENCHMARK.json does not name yet included,
    declares its unit, layer, source and the end-to-end metric it moves."""
    mod = run.Registry().metric(metric)
    assert mod.SOURCE in ("device_trace", "program_span", "program_counter")
    assert mod.MOVES in {m["name"] for m in BENCH["end_to_end"]}
    assert mod.UNIT and mod.LAYER and callable(mod.read)


def test_cells_name_known_files():
    names = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert w["config"] in names
        assert os.path.exists(os.path.join(QM, "traffic",
                                           w["traffic"] + ".json"))
        assert w["chips"] == 1


def test_new_files_are_found_by_name(tiny, run_tiny):
    """A new mix, configuration and metric, each a new file, make a new
    cell that runs, with no existing file edited."""
    bench, reg, _ = tiny
    with open(os.path.join(reg.root, "traffic", "tiny-il.json")) as f:
        mix = dict(json.load(f), read_len=100, n_reads=150)
    with open(os.path.join(reg.root, "traffic", "tiny-il100.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(reg.root, "metrics", "parse_s.py"), "w") as f:
        f.write('UNIT = "s"\nLAYER = "host parse"\nSOURCE = "program_span"\n'
                'MOVES = "count_kmers_per_s"\n\n\n'
                'def read(run):\n    return run.spans.get("parse")\n')
    new = json.loads(json.dumps(bench))
    new["workloads"].append({"name": "f100", "config": "tiny-flat",
                             "traffic": "tiny-il100", "chips": 1,
                             "why": "new"})
    new["per_layer"].append({"name": "parse_s", "unit": "s",
                             "better": "lower", "source": "program_span",
                             "layer": "host parse",
                             "moves": "count_kmers_per_s",
                             "workloads": ["f100"]})
    result, _ = run_tiny("f100", traced=True, bench=new)
    assert result["correct"]
    assert result["metrics"]["parse_s"]["value"] > 0
    result, _ = run_tiny("f", traced=True, bench=new)
    assert "parse_s" not in result["metrics"]


def test_a_metric_at_odds_with_its_file_is_refused(tiny):
    entry = dict(next(m for m in BENCH["per_layer"]
                      if m["name"] == "finish_s"), unit="ms")
    with pytest.raises(ValueError, match="unit"):
        run.check_metric(entry, run.Registry().metric("finish_s"))
