"""The benchmark's arithmetic on synthetic intervals and counts."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from inrbench import readers, stats
from inrbench import trace as tr

H100 = {"mm_flops_per_s": 165e12, "other_flops_per_s": 67e12,
        "bytes_per_s": 3.35e12}


def test_union_of_intervals():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert stats.merged(iv) == [(0, 3), (5, 6)]


def test_least_time_and_work():
    per_row = {"mm_flops": 1577472, "other_flops": 14081, "bytes": 36,
               "bytes_per_call": 530436}
    w = stats.scale_work(per_row, 262144, 1)
    t = stats.least_time_s(w, H100)
    assert t == pytest.approx(262144 * (1577472 / 165e12 + 14081 / 67e12))
    # memory-bound work takes the bytes term
    assert stats.least_time_s({"mm_flops": 0, "other_flops": 0,
                               "bytes": 3.35e12}, H100) == pytest.approx(1)


class _Ev:
    def __init__(self, name, start, dur, dev):
        self._n, self._s, self._d, self._dev = name, start, dur, dev

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._n.startswith("bench.")


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def test_trace_reduction_on_synthetic_events():
    ms = 1_000_000
    spans = [("bench.request", 0, 60 * ms), ("bench.sync", 60 * ms,
                                                100 * ms),
             ("bench.window", 0, 100 * ms)]
    ev = [_Ev("k_region", 10 * ms, 30 * ms, True),
          _Ev("k_region", 35 * ms, 10 * ms, True),      # overlaps
          _Ev("Memcpy DtoD", 70 * ms, 5 * ms, True),
          _Ev("bench.sync", 0, 1, True),                 # a GPU annotation
          _Ev("k_outside", 150 * ms, 10 * ms, True)]     # after the window
    r = tr.read(_prof(ev), spans)
    assert r.window_s == pytest.approx(0.1)
    assert r.busy_s == pytest.approx(0.04)
    assert r.kernel_s == pytest.approx(0.04)
    assert r.copy_s == pytest.approx(0.005)
    assert r.idle_share == pytest.approx(0.6)
    assert r.device_ops[0] == ["k_region", pytest.approx(0.04)]
    # gaps 0-10 and 45-70 fall in the request (by their midpoints), 75-100
    # in the sync
    assert r.idle_gaps == [["bench.request", pytest.approx(0.025)],
                           ["bench.sync", pytest.approx(0.025)],
                           ["bench.request", pytest.approx(0.010)]]
    assert r.idle_by_span == {"bench.request": pytest.approx(0.035),
                              "bench.sync": pytest.approx(0.025)}
    assert r.n_device_ops == 3 and r.n_outside == 1
    assert tr.read(_prof(ev), spans[:2]) is None    # no window span


def test_readers_on_a_synthetic_run():
    t = tr.TraceReport(window_s=2.0, busy_s=1.5, kernel_s=1.2, copy_s=0.1)
    win = SimpleNamespace(rows=4000)
    ctx = SimpleNamespace(trace=t, least_s=0.03, window=win,
                          launches={"region": 8, "fused_chain": 2})
    assert readers.mfu(ctx) == pytest.approx(1.5)
    assert readers.kernel_roofline(ctx) == pytest.approx(2.5)
    assert readers.idle_share(ctx) == pytest.approx(25.0)
    assert readers.launches_per_krow(ctx) == pytest.approx(2.5)
    # nothing to read gives nothing, never 0
    none = SimpleNamespace(trace=None, least_s=None,
                           window=SimpleNamespace(rows=0),
                           launches={})
    for f in (readers.mfu, readers.kernel_roofline, readers.idle_share,
              readers.launches_per_krow):
        assert f(none) is None
