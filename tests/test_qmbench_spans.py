"""The benchmark's readers of the flat counter's phases and counts, on a
synthetic run, and the summary of a synthetic trace, which the
program's `counter.*` spans leave as it is without them."""

import pytest

from qmbench import run, trace

WINDOW_S = 20.0
START = {"total_windows": 1000, "phase_concat_s": 0.5, "phase_put_s": 0.25,
         "phase_drain_s": 1.0, "phase_mask_scan_s": 0.5,
         "n_recount_lanes": 10}
END = {"total_windows": 5000, "phase_concat_s": 1.5, "phase_put_s": 2.25,
       "phase_drain_s": 5.0, "phase_mask_scan_s": 2.0, "n_recount_lanes": 50,
       "phase_depth_fetch_s": 0.75, "phase_depth_rank_s": 4.5}
# a counter's stats before its phases were split: pack_put, dispatch and
# a drain that timed the mask's fetch and unpack alone
OLDER = ({"total_windows": 1000, "phase_pack_put_s": 0.5,
          "phase_dispatch_s": 0.25, "phase_drain_s": 0.125},
         {"total_windows": 5000, "phase_pack_put_s": 2.5,
          "phase_dispatch_s": 1.25, "phase_drain_s": 0.625})
# each reader's value on START -> END over WINDOW_S
WANT = {"batch_concat_pct": 100.0 * 1.0 / WINDOW_S,
        "h2d_put_pct": 100.0 * 2.0 / WINDOW_S,
        "mask_drain_pct": 100.0 * 4.0 / WINDOW_S,
        "recount_lane_pct": 100.0 * 40 / 4000,
        "depth_fetch_s": 0.75,
        "depth_rank_s": 4.5}


def _run(start, end):
    return run.Run(WINDOW_S, {}, start, end, None, {}, [])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_its_delta(name):
    mod = run.Registry().metric(name)
    assert mod.read(_run(START, END)) == pytest.approx(WANT[name])
    # a program without the phase (the parent's) gives no value
    assert mod.read(_run({"total_windows": 1000},
                         {"total_windows": 5000})) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_silent_on_older_stats(name):
    """A counter's stats from before the split (its phase_drain_s the
    narrow one) give none of the readers a value."""
    assert run.Registry().metric(name).read(_run(*OLDER)) is None


def _ev(cat, name, ts, dur):
    """A trace event at ts for dur, both in seconds (the trace's µs)."""
    return {"cat": cat, "name": name, "ts": ts * 1e6, "dur": dur * 1e6,
            "ph": "X"}


def _events():
    """A window of 100 s: a parse span, a feed span and a finish span;
    kernels at 10-20 and 60-65 and a copy at 90-92, so idle gaps at
    0-10, 20-60, 65-90 and 92-100."""
    return [_ev("user_annotation", "qmbench.window", 0, 100),
            _ev("user_annotation", "qmbench.parse", 0, 10),
            _ev("user_annotation", "qmbench.feed", 10, 60),
            _ev("user_annotation", "qmbench.finish", 70, 30),
            _ev("kernel", "void count_mono_probe_kernel<8>(int)", 10, 10),
            _ev("kernel", "count_mono_hist_kernel", 60, 5),
            _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 90, 2)]


def _counter_spans():
    """The program's spans: a drain with a recount inside (20-55, 25-50),
    a pack beside it (55-60), a finish's depth fetch (70-88) and rank
    (92-100), and an anchored span over the whole window."""
    return [_ev("user_annotation", "counter.drain", 20, 35),
            _ev("user_annotation", "counter.recount", 25, 25),
            _ev("user_annotation", "counter.pack", 55, 5),
            _ev("user_annotation", "counter.depth_fetch", 70, 18),
            _ev("user_annotation", "counter.depth_rank", 92, 8),
            _ev("user_annotation", "anchored.drain", 0, 100)]


@pytest.mark.parametrize("spans", [[], _counter_spans(), [
    _ev("user_annotation", "counter.drain", 15, 50),
    _ev("user_annotation", "counter.mask_scan", 20, 40)]],
    ids=["none", "phases", "nested"])
def test_summary_unmoved_by_counter_spans(spans):
    """The program's spans inside the benchmark's change nothing that
    the summary reads: every value, the gaps' names included, is the
    one without them."""
    got = trace.summarize(_events() + spans)
    assert got == trace.summarize(_events())
    assert {round(s): n for n, s in got["idle_gaps"]} == {
        40: "feed +20.000s", 25: "finish +65.000s",
        10: "parse +0.000s", 8: "finish +92.000s"}
