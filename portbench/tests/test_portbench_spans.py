"""The span readings (portbench/spans.py): device ops credited to the span
that launched them by correlation id, the spans' device marks left out,
idle gaps and host syncs credited to spans or to no span; the host block
on the CPU; and every span reader reading nothing without spans."""

from types import SimpleNamespace

import pytest

from portbench import catalog, spans
from portbench.spans import NO_LAUNCH, OUTSIDE, Event

NEW = [f"{layer}.{kind}" for kind in ("host_ms", "launches")
       for layer in spans.LAYERS] + ["geometry.device_ms"]


def host(name, start, end, corr=0, mark=False, launch=False):
    return Event(name, False, mark, launch, start, end, corr)


def device(name, start, end, corr, mark=False):
    return Event(name, True, mark, False, start, end, corr)


def one_frame(t, c):
    """A frame at time t (us), correlation ids from c: the benchmark's
    span, the program's spans, launches and the device ops they launched,
    listed out of order."""
    span = [("portbench.frame", 0, 100), ("tr.geometry", 2, 8),
            ("tr.render", 10, 60), ("tr.setup", 12, 20),
            ("tr.binning", 20, 35), ("tr.raster", 35, 45),
            ("tr.raster", 36, 44)]
    calls = [(1, 3), (2, 11), (3, 13), (4, 21), (5, 23), (6, 37), (7, 62)]
    ops = [(6, "split_walk_kernel", 39, 50), (4, "setup_kernel", 22, 26),
           (1, "elementwise", 5, 9), (3, "radix sort", 15, 19),
           (2, "add", 12, 13), (5, "Memcpy DtoH (Device -> Pageable)", 26,
                                27), (7, "fill", 64, 66),
           (99, "launched where the trace lost it", 70, 71)]
    out = [host(n, t + s, t + e, mark=True) for n, s, e in span]
    out += [host("cudaLaunchKernel", t + s, t + s + 0.5, c + k, launch=True)
            for k, s in calls]
    out += [host("cudaEventSynchronize", t + 65, t + 99, c + 8, launch=True),
            host("aten::add", t + 11, t + 12, c + 6)]  # a torch op's own id
    out += [device(n, t + s, t + e, c + k) for k, n, s, e in ops]
    out.append(device("tr.raster", t + 36, t + 44, 0, mark=True))
    return out[::-1]


def test_credit_by_correlation_not_by_order():
    events = one_frame(0, 0) + one_frame(1000, 100) + [
        device("after the frames", 2000, 2001, 200),
        host("cudaLaunchKernel", 1990, 1991, 200, launch=True)]
    got = spans.credit(events)
    assert got.frames == 2 and got.ops == [8, 8]
    assert got.spans == {"tr.geometry", "tr.render", "tr.setup",
                         "tr.binning", "tr.raster"}
    assert got.launches == {
        "tr.geometry": 1, "tr.render": 1, "tr.setup": 1, "tr.binning": 2,
        "tr.raster": 1, OUTSIDE: 1, NO_LAUNCH: 1}
    assert got.device_ms == pytest.approx({
        "tr.geometry": 0.004, "tr.render": 0.001, "tr.setup": 0.004,
        "tr.binning": 0.005, "tr.raster": 0.011, OUTSIDE: 0.002,
        NO_LAUNCH: 0.001})
    # gaps [0, 5] [9, 12] [13, 15] [19, 22] [27, 39] [50, 64] [66, 70]
    # [71, 100], each credited at its midpoint
    assert got.idle_ms == pytest.approx({
        "tr.geometry": 0.005, "tr.render": 0.017, "tr.setup": 0.002,
        "tr.binning": 0.015, OUTSIDE: 0.033})
    assert got.syncs == {"tr.binning": 1, OUTSIDE: 1}
    blocks = spans.Blocks(got, {"tr.render": 0.25}, 2.0, 2.5)
    assert spans._from_json(spans._to_json(blocks)) == blocks


def test_credit_needs_the_frame_spans():
    with pytest.raises(ValueError, match="no frame span"):
        spans.credit([e for e in one_frame(0, 0)
                      if e.name != "portbench.frame"])


def test_the_blocks_rebuild_the_cell_on_the_cpu(monkeypatch):
    """The blocks as the process a traced run starts runs them, at a
    test's size on the CPU (the mesh cut, the frame small): the cell built
    again from its seed, the host block reading every layer's span; the
    profiled block is the card's alone."""
    cell = "sphere1m_deferred.orbit_1080p"
    w = catalog.workload(catalog.benchmark(), cell)
    cfg = catalog.config(w["config"])
    cfg["objects"][0]["mesh"][0].update(lat=20, lon=21)
    mix = dict(catalog.traffic(w["traffic"]), height=72, width=128,
               warm_frames=1, trace_frames=2)
    monkeypatch.setattr(catalog, "config", lambda name: cfg)
    monkeypatch.setattr(catalog, "traffic", lambda name: mix)
    got = spans.measure_cell(cell, 2 ** 31 + 77, 5, "cpu")
    assert got.credit is None
    assert set(got.host_ms) == set(spans.LAYERS.values())
    assert all(v >= 0 for v in got.host_ms.values())
    assert 0 < sum(got.host_ms.values()) < got.enqueue_ms


def reading(trace):
    return SimpleNamespace(trace=trace, attempted=5, enqueue_ms=[1.0],
                           metric=catalog.metric)


@pytest.mark.parametrize("name", NEW)
def test_a_span_reader_reads_nothing_without_spans(monkeypatch, name):
    """Untraced; traced but not a run of portbench/run.py; and a program
    without ``profiling.spans``, as the parent of the spans has."""
    from tpu_renderer_torch.utils import profiling

    read = catalog.metric(name).read
    assert read(reading(None)) is None
    assert read(reading(object())) is None
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.setattr(spans, "_command_line", lambda: pytest.fail(
        "the command line read for a program without spans"))
    assert read(reading(object())) is None
