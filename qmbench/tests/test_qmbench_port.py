"""The reference against the port's StreamCounter on the CPU (the
kernels' plain versions), on short and long reads, through the harness."""

import json

import pytest


@pytest.mark.parametrize("cell", ["f", "g"])
def test_port_matches_reference(run_tiny, cell):
    result, checks = run_tiny(cell, seed=2**31 + 77)
    assert result["correct"], checks
    assert all(v == 0 for v, _ in checks.values())
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["metrics"]["count_kmers_per_s"]["value"] > 0


@pytest.mark.parametrize("cell", ["f", "g"])
def test_last_line_keys(run_tiny, cell):
    for traced in (False, True):
        result, _ = run_tiny(cell, traced=traced)
        line = json.loads(json.dumps(result))
        keys = ["correct", "attempted", "failed", "metrics", "device"]
        assert list(line)[:5] == keys
        assert list(line)[-1] == "checks"      # the numbers compared, last
        assert set(line) - set(keys) - {"checks"} == (
            {"breakdown"} if traced else set())
        for name, c in line["checks"].items():
            assert set(c) == {"value", "limit"}, name
        dev = line["device"]
        assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
        if traced:
            assert {"busy_s", "window_s"} <= set(dev)
            assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
            assert "setup_s" not in line["metrics"]
            assert "host_parse_pct" in line["metrics"]
        else:
            assert set(line["metrics"]) == {"count_kmers_per_s", "setup_s"}
