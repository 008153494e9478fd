"""The metric arithmetic: the interval union, the gaps, the p95 over all
frames, the split of a frame's device ops by order, the rooflines' counts
from T, H, W and the covered pixels."""

import math

import pytest

from portbench import catalog, trace, work


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (10, 11)]
    assert trace.union(iv) == 3 + 1 + 1
    assert trace.union([]) == 0
    assert trace._gaps(iv, 0, 12) == [(3, 5), (6, 10), (11, 12)]


def test_p95_is_nearest_rank_over_all_frames():
    p95 = catalog.metric("frame_ms_p95").p95
    assert p95(list(range(1, 101))) == 95
    assert p95([5.0] * 19 + [100.0]) == 5.0
    assert p95([5.0] * 18 + [100.0, 100.0]) == 100.0
    assert p95([3.0]) == 3.0


def _frame(t0):
    names = ["elementwise", "elementwise", "void setup_kernel<true, false>",
             "sort", "Memset (Device)", "part_scan_kernel<2>",
             "split_walk_kernel", "split_finalize_kernel", "where"]
    return [(n, t0 + 10 * k, t0 + 10 * k + 4) for k, n in enumerate(names)]


def test_split_by_order():
    parts = trace.split(_frame(0), ("setup_kernel",),
                        ("part_scan_kernel", "split_walk_kernel",
                         "split_finalize_kernel"))
    assert [len(parts[k]) for k in ("geometry", "setup", "binning",
                                    "raster", "shade")] == [2, 1, 1, 4, 1]
    assert trace.split(_frame(0)[:4], ("setup_kernel",),
                       ("split_walk_kernel",)) is None


def test_reduce_assigns_device_ops_to_frames():
    events = [("portbench.frame", False, 100, 200),
              ("portbench.frame", False, 300, 400),
              ("portbench.frame", True, 101, 199),
              ("aten::sort", False, 150, 190), ("early", True, 50, 60),
              ("between frames", True, 250, 260)]
    events += [(n, True, s, e) for n, s, e in _frame(110)[:3]]
    events += [(n, True, s, e) for n, s, e in _frame(300)]
    t = trace.reduce(events)
    assert [len(f) for f in t.frames] == [3, 9]
    assert t.window == 200
    assert t.busy == 12 * 4
    assert t.device_ops["elementwise"] == 16
    assert sum(t.idle_gaps.values()) == pytest.approx(200 - 48)
    assert t.idle_gaps["aten::sort"] == pytest.approx(200 - 134)
    assert trace.segment_ms(t, ("setup_kernel",), ("split_walk",),
                            "raster") is None


def test_setup_work_counts_from_triangles_alone():
    b, ops = work.setup_work(1_001_112, False)
    assert b == 1_001_112 * (3 * 10 * 4 + 544)
    assert ops == 1_001_112 * 250
    bt, opst = work.setup_work(1_001_114, True)
    assert bt == 1_001_114 * (3 * 12 * 4 + 544)
    assert opst == 1_001_114 * 290
    peaks = catalog.peaks("NVIDIA H100 80GB HBM3")
    assert work.bound_ms(b, ops, peaks) == pytest.approx(
        1_001_112 * 664 / 3.35e12 * 1e3)


def test_raster_work_counts_kept_triangles_pixels_and_covered():
    b, ops = work.raster_work(500_000, 600_000, 1920 * 1080, 12, 8, True, 2)
    assert b == 500_000 * 352 + 1920 * 1080 * 12
    assert ops == 600_000 * (110 + 96 + 24 + 40 + 140)
    b, ops = work.raster_work(500_000, 600_000, 1920 * 1080, 48, 10, False,
                              2)
    assert b == 500_000 * 352 + 1920 * 1080 * 48
    assert ops == 600_000 * (110 + 120)


def test_roofline_reader_is_a_share_of_the_measured_time():
    class R:
        peaks = {"memory_bytes_per_s": 1e12, "f32_ops_per_s": 1e12}
        work = dict(triangles=1000, textured=False)
        yardstick = work
        metric = staticmethod(catalog.metric)
        trace = object()

        @staticmethod
        def trace_segment(first, last, seg):
            return 0.01 if seg == "setup" else None

    R.yardstick = work
    got = catalog.metric("setup_roofline").read(R)
    assert got == pytest.approx(100 * (1000 * 664 / 1e12 * 1e3) / 0.01)
    assert not math.isnan(got)
