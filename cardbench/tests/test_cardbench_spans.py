"""The reductions of the port's spans and counters (``cardbench/spans.py``)
on planted records, counters and profiler events."""

import pytest

from cardbench import spans

NS = 1_000_000_000


def rec(name, t0, dur):
    return {"name": name, "t0": t0, "dur_s": dur}


def test_idle_by_span_takes_the_innermost_open_span():
    recs = [rec("ivf_pq::search", 10.0, 1.0),
            rec("strip_scan::plan", 10.2, 0.2)]
    gaps = [(int(9.0 * NS), int(9.5 * NS)),       # before the search
            (int(10.05 * NS), int(10.15 * NS)),   # in the search only
            (int(10.25 * NS), int(10.35 * NS)),   # in the plan too
            (int(10.9 * NS), int(10.9 * NS))]     # empty
    got = spans.idle_by_span(gaps, recs)
    assert got == pytest.approx({spans.OUTSIDE: 0.5, "ivf_pq::search": 0.1,
                                 "strip_scan::plan": 0.1})


class Ev:
    """A profiler event without an activity type (as on older torch)."""

    def __init__(self, name, device, start, dur):
        self._n, self._d, self._s, self._t = name, device, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._t


def test_device_copies_of_span_ranges_are_not_device_work():
    events = [Ev("cardbench.window", False, 0, 100),
              Ev("cardbench.window", True, 5, 90),
              Ev("ivf_pq::search", False, 10, 50),
              Ev("ivf_pq::search", True, 12, 40),
              Ev("strip_kernel_wg", True, 20, 10)]
    dev, window, ranges = spans.events_by_kind(events)
    assert dev == [(20, 30)] and window == (0, 100)
    assert ranges["ivf_pq::search"] == [(10, 60)]


def snapshot():
    timers = {name: {"count": 4, "total_s": 0.004, "device_total_s": 0.002}
              for names in spans.PHASES.values() for name in names}
    timers["ivf_pq::search"] = {"count": 2, "total_s": 0.02,
                                "device_total_s": 0.016}
    return {"timers": timers,
            "counters": {"strip_scan.k1.products_needed": 30,
                         "strip_scan.k1.products_computed": 120,
                         "strip_scan.slots.live": 48,
                         "strip_scan.slots.launched": 192}}


def test_reduce_spans_reads_per_name_device_totals():
    recs = [rec("ivf_pq::search", 1.0, 0.01),
            rec("ivf_pq::search", 2.0, 0.01)]
    dev = [(int(1.0 * NS), int(1.004 * NS)), (int(1.006 * NS),
                                              int(2.0 * NS))]
    out = spans.reduce_spans(snapshot(), recs, 8.0, dev,
                             (int(0.9 * NS), int(2.1 * NS)))
    assert out["prep_ms"] == pytest.approx(2.0)
    assert out["plan_ms"] == pytest.approx(2.0)
    assert out["class_ms"] == pytest.approx(1.0)
    assert out["merge_ms"] == pytest.approx(2.0)
    assert out["coverage"] == pytest.approx(7.0 / 8.0)
    assert out["search_host_ms"] == pytest.approx(10.0)
    assert out["search_device_ms"] == pytest.approx(8.0)
    assert out["k1_useful_share"] == pytest.approx(25.0)
    assert out["slot_share"] == pytest.approx(25.0)
    assert out["port_idle_ms"] == pytest.approx(1.0)   # 2 ms, 2 searches
    assert out["ring_complete"]


def test_a_ring_that_dropped_a_search_gives_no_idle_number():
    recs = [rec("ivf_pq::search", 1.0, 0.01)]
    dev = [(int(1.0 * NS), int(1.004 * NS))]
    out = spans.reduce_spans(snapshot(), recs, 8.0, dev,
                             (int(0.9 * NS), int(2.1 * NS)))
    assert "port_idle_ms" not in out and not out["ring_complete"]
    assert spans.port_idle_ms(recs, 2, dev, None) is None


def test_useful_share_is_none_where_k1_computed_nothing():
    assert spans.useful_share({}) is None
    assert spans.useful_share({"strip_scan.k1.products_needed": 0,
                               "strip_scan.k1.products_computed": 0}) is None


def test_clock_check_holds_each_record_to_its_range():
    ranges = {"ivf_pq::search": [(1 * NS, 2 * NS), (3 * NS, 4 * NS),
                                 (5 * NS, 6 * NS)]}
    recs = [rec("ivf_pq::search", 1.5, 0.49996),   # ends 40 us early
            rec("ivf_pq::search", 3.5, 0.49994),   # ends 60 us early
            rec("ivf_pq::search", 5.5, 0.6),       # ends past its range
            rec("refine::refine", 3.0, 1.0)]
    got = spans.clock_check(recs, ranges)
    assert got["records"] == 3 and got["inside"] == 2
    assert got["widest_end_gap_us"] == pytest.approx(60.0, abs=1.0)
    assert got["over_50us"] == 1
