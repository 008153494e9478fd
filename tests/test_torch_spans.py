"""The port's spans (``tpu_renderer_torch.utils.profiling``): off, a span
records nothing and never enters the profiler; on, each layer of a frame
records its span at its boundary, nested under the frame's ``tr.render``
(``tr.geometry`` beside it), ``self_ms`` takes each span's children out of
its time, a profiler's trace holds the spans, and a frame is the same with
spans on or off. CPU only, small scenes."""

from types import SimpleNamespace

import pytest
import torch

import tpu_renderer_torch as trt
from tpu_renderer_torch.geometry.transform import rotate_object, rotation_y
from tpu_renderer_torch.models.route_scenes import torch_scene
from tpu_renderer_torch.utils import profiling as prof
from torch_threads import one_torch_thread  # noqa: F401

LAYERS = {"tr.render", "tr.geometry", "tr.setup", "tr.binning",
          "tr.raster"}
ROUTES = [("base", LAYERS), ("gbuffer", LAYERS | {"tr.shade"})]


def frame(renderer, scene, tr, li, angle):
    """The benchmark's frame: every object rotated, then rendered."""
    rot = rotation_y(angle, device="cpu")
    sc = [(rotate_object(o, rot), c) for o, c in scene]
    return renderer.render(sc, tr, li)


def no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)


def test_spans_off_record_nothing_and_skip_the_profiler(monkeypatch):
    no_record_function(monkeypatch)
    assert prof.annotate("tr.a") is prof.annotate("tr.b")
    scene, tr, li, (h, w) = torch_scene("k6", "base", "cpu")
    renderer = trt.Renderer(h, w, device="cpu")
    with prof.spans() as records:
        pass
    frame(renderer, scene, tr, li, 0.1)
    assert records == []
    with prof.spans() as records:  # on, no profiler running: no entry
        frame(renderer, scene, tr, li, 0.1)
    assert records


def test_nesting_parents_and_self_ms(monkeypatch):
    """Hand-timed spans (a clock that counts 1 ms a reading): parents,
    render numbers, and each span's time less its children's."""
    ticks = iter(range(0, 100 * 10 ** 6, 10 ** 6))
    monkeypatch.setattr(prof, "time", SimpleNamespace(
        perf_counter_ns=lambda: next(ticks)))
    with prof.spans() as records:
        with prof.annotate("tr.geometry"):  # 0 .. 1
            pass
        for _ in range(2):
            with prof.annotate(prof.RENDER):  # 2 .. 9, 10 .. 17
                with prof.annotate("tr.setup"):  # 3 .. 4
                    pass
                with prof.annotate("tr.raster"):  # 5 .. 8
                    with prof.annotate("tr.raster"):  # 6 .. 7
                        pass
    assert [r[:3] for r in records] == [
        ("tr.geometry", None, None),
        ("tr.render", None, 0), ("tr.setup", 1, 0), ("tr.raster", 1, 0),
        ("tr.raster", 3, 0),
        ("tr.render", None, 1), ("tr.setup", 5, 1), ("tr.raster", 5, 1),
        ("tr.raster", 7, 1)]
    assert [(r[4] - r[3]) // 10 ** 6 for r in records] == [
        1, 7, 1, 3, 1, 7, 1, 3, 1]
    assert prof.self_ms(records) == {
        "tr.geometry": 1.0, "tr.render": 6.0, "tr.setup": 2.0,
        "tr.raster": 6.0}
    assert prof.annotate("tr.a") is prof.annotate("tr.b")  # off again


def test_spans_do_not_nest_and_close_on_an_error():
    with prof.spans() as records:
        with pytest.raises(RuntimeError, match="on already"):
            with prof.spans():
                pass
        with pytest.raises(ValueError):
            with prof.annotate(prof.RENDER):
                with prof.annotate("tr.setup"):
                    raise ValueError("a frame that raises")
        with prof.annotate("tr.geometry"):
            pass
    assert [(r[0], r[1]) for r in records] == [
        ("tr.render", None), ("tr.setup", 0), ("tr.geometry", None)]
    assert all(r[4] >= r[3] for r in records)


@pytest.mark.parametrize("variant, names", ROUTES)
def test_a_frame_records_the_layers_spans(variant, names):
    """The fused route (K7 -> K6) and the G-buffer route (K7 -> K8, the
    deferred shade): exactly the layers' span names, one ``tr.render``
    root a frame, every other span inside it but the ``rotate_object``
    calls' ``tr.geometry`` (the draw's resolve opens one inside)."""
    scene, tr, li, (h, w) = torch_scene("k6", variant, "cpu")
    renderer = trt.Renderer(h, w, device="cpu")
    with prof.spans() as records:
        for angle in (0.1, 0.2):
            frame(renderer, scene, tr, li, angle)
    assert {r[0] for r in records} == names
    roots = [r for r in records if r[1] is None]
    assert [(r[0], r[2]) for r in roots] == [
        ("tr.geometry", None), ("tr.render", 0),
        ("tr.geometry", None), ("tr.render", 1)]
    for name, parent, seq, start, end in records:
        if parent is None:
            continue
        top = parent
        while records[top][1] is not None:
            top = records[top][1]
        assert records[top][0] == "tr.render" and records[top][2] == seq
        assert records[parent][3] <= start <= end <= records[parent][4]
    assert set(prof.self_ms(records)) == names


def test_a_profiler_trace_holds_the_spans():
    from torch.profiler import ProfilerActivity, profile

    scene, tr, li, (h, w) = torch_scene("k6", "gbuffer", "cpu")
    renderer = trt.Renderer(h, w, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with prof.spans():
            frame(renderer, scene, tr, li, 0.1)
    names = {e.name for e in p.events()}
    assert LAYERS | {"tr.shade"} <= names


@pytest.mark.parametrize("variant", ["base", "gbuffer"])
def test_frames_are_the_same_with_spans_on(variant):
    scene, tr, li, (h, w) = torch_scene("k6", variant, "cpu")
    renderer = trt.Renderer(h, w, device="cpu")
    off = frame(renderer, scene, tr, li, 0.3)
    with prof.spans():
        on = frame(renderer, scene, tr, li, 0.3)
    assert torch.equal(on.color.view(torch.int32),
                       off.color.view(torch.int32))
    assert torch.equal(on.depth.view(torch.int32),
                       off.depth.view(torch.int32))


def test_a_multi_object_draw_sets_up_in_the_scene_span(monkeypatch):
    """A fused scene of several objects, 4096 triangles or more in all:
    ``tr.scene`` inside ``tr.render``, ``tr.setup`` inside it, and the
    grouped setup's launches made in ``tr.setup``. Under 4096 the chain
    runs in ``tr.scene`` and K7 in ``tr.setup`` after it; one object opens
    no ``tr.scene``."""
    from test_torch_scene_setup import mixed_scene
    from tpu_renderer_torch.models.scenes import to_torch_scene
    from tpu_renderer_torch.ops import setup as tsp

    scene, tr, li = to_torch_scene(*mixed_scene(0), device="cpu")
    renderer = trt.Renderer(96, 128, device="cpu")
    real, called_in = tsp.setup_scene_kernel, []

    def grouped(*args, **kw):
        called_in.append(prof._records[prof._stack[-1]][0])
        return real(*args, **kw)
    monkeypatch.setattr(tsp, "setup_scene_kernel", grouped)
    with prof.spans() as records:
        frame(renderer, scene, tr, li, 0.1)
    names = [r[0] for r in records]
    assert set(names) == LAYERS | {"tr.scene"}
    assert names.count("tr.scene") == 1 and names.count("tr.setup") == 1
    at = names.index("tr.scene")
    assert records[at][1] == names.index("tr.render")
    assert records[names.index("tr.setup")][1] == at
    assert called_in == ["tr.setup"]
    with prof.spans() as records:
        frame(renderer, scene[2:5], tr, li, 0.1)  # 1,584 triangles
    names = [r[0] for r in records]
    assert records[names.index("tr.setup")][1] == names.index("tr.render")
    assert "tr.scene" in names and called_in == ["tr.setup"]
    with prof.spans() as records:
        frame(renderer, scene[1:2], tr, li, 0.1)
    assert "tr.scene" not in {r[0] for r in records}
