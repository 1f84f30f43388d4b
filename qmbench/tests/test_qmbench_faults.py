"""The comparison that decides `correct` fails the control and each fault
a one-card count can have: the harness runs with the timed path broken
underneath (the look for a card skipped: the CPU's plain kernels)."""

import pytest
import torch

from qmbench import control, program, reference, traffic


def skip_second_feed(monkeypatch):
    """A step that returns its state unchanged: the window's first
    feed_codes call does nothing."""
    real = program.Count.feed_codes
    calls = {"n": 0}

    def feed(self, codes):
        calls["n"] += 1
        if calls["n"] != 2:
            real(self, codes)
    monkeypatch.setattr(program.Count, "feed_codes", feed)


def half_of_each_batch(monkeypatch):
    """Half of the batch left out: each chunk's codes cut in half."""
    real = program.Count.feed_codes
    monkeypatch.setattr(program.Count, "feed_codes",
                        lambda self, codes: real(self, codes[:len(codes) // 2]))


def one_answer_off(monkeypatch):
    """An answer altered where it is produced: one depth off by one."""
    real = program.Count.finish

    def finish(self):
        depth = real(self).copy()
        depth[len(depth) // 2] += 1
        return depth
    monkeypatch.setattr(program.Count, "finish", finish)


def forward_only_reference(monkeypatch):
    """The control: the reference in the program's place, its canonical
    guarantee broken (each window on its forward strand alone)."""
    made = {}
    make_pool, init = traffic.make_pool, program.Count.__init__
    feed = program.Count.feed_bytes

    def keep_pool(*args, **kw):
        made["pool"] = make_pool(*args, **kw)
        return made["pool"]

    def new_init(self, cfg, ref_world, device, spans, log=print):
        init(self, cfg, ref_world, device, spans, log)
        self._fed, self._keys, self._k = 0, ref_world.keys, int(cfg["k"])

    def new_feed(self, chunk):
        self._fed += len(chunk)
        return feed(self, chunk)

    def finish(self):
        self.counter.finish()
        return reference.count_stream(made["pool"].data, self._keys,
                                      self._k, [self._fed],
                                      torch.device("cpu"),
                                      forward_only=True)[0]
    monkeypatch.setattr(traffic, "make_pool", keep_pool)
    monkeypatch.setattr(program.Count, "__init__", new_init)
    monkeypatch.setattr(program.Count, "feed_bytes", new_feed)
    monkeypatch.setattr(program.Count, "finish", finish)


@pytest.mark.parametrize("fault", [skip_second_feed, half_of_each_batch,
                                   one_answer_off, forward_only_reference])
@pytest.mark.parametrize("cell", ["f", "g"])
def test_fault_is_not_correct(run_tiny, monkeypatch, fault, cell):
    fault(monkeypatch)
    result, checks = run_tiny(cell, seed=99)
    assert result["correct"] is False, checks
    assert checks["depth_mismatch"][0] > 0


def test_control_readings_separate(tiny):
    """control.py's readings at the tiny cell's size: the control and
    the dropped tail fail; u16 does not at this depth."""
    bench, reg, cache = tiny
    got = control.readings("f", 7, 30, torch.device("cpu"), bench=bench,
                           registry=reg, cache_dir=cache)
    assert got["forward_only"] > 0 and got["tail_dropped"] > 0
    assert got["u16"] == 0 and got["max_depth"] < 1 << 16
