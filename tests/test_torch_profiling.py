"""``tpu_renderer_torch.utils.profiling`` against the JAX package's
``tpu_renderer.utils.profiling``: FrameTimer's statistics on the same
samples, stage_breakdown's keys and route on the CPU (its times are the
CPU's here, only checked to be finite and non-negative), and trace /
annotate writing a trace.
"""

import ast
import math
import os

import pytest
import torch

import tpu_renderer_torch as trt
from tpu_renderer.utils import profiling as jprof
from tpu_renderer_torch.models.route_scenes import torch_scene
from tpu_renderer_torch.ops import gbuffer as tgb
from tpu_renderer_torch.ops import raster as trp
from tpu_renderer_torch.utils import profiling as prof
from torch_threads import one_torch_thread  # noqa: F401


def jax_stage_keys():
    """The keys of the dict JAX's stage_breakdown returns, read from its
    source (running it would compile five scans of the Pallas pipeline)."""
    with open(jprof.__file__) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "stage_breakdown")
    ret, = [n for n in fn.body if isinstance(n, ast.Return)]
    return [k.value for k in ret.value.keys]


def test_frame_timer_summary_equals_jax():
    """The same samples give JAX's summary; the window keeps the last
    max_samples; tick times a block and synchronises nothing on the
    CPU."""
    samples = [0.0125, 0.0031, 0.0207, 0.0099, 0.0164, 0.0042, 0.0118]
    t, jt = prof.FrameTimer(max_samples=5), jprof.FrameTimer(max_samples=5)
    for s in samples:
        t.record(s)
        jt.record(s)
    assert t.samples == jt.samples == samples[-5:]
    assert t.summary() == jt.summary()
    assert t.fps == jt.fps
    assert prof.FrameTimer().summary() == jprof.FrameTimer().summary()
    for _ in range(3):
        with t.tick(torch.ones(4)) as out:
            pass
        assert out["seconds"] >= 0.0
    assert len(t.samples) == 5 and t.summary()["frames"] == 5


@pytest.mark.parametrize("name, variant", [
    ("k4", "base"),      # sorted, fused (K7, K4)
    ("k6", "base"),      # mask, fused (K7, K6)
    ("k6", "gbuffer"),   # mask, G-buffer (K7, K8, the deferred shade)
])
def test_stage_breakdown_keys_and_route(name, variant):
    """JAX's keys in JAX's order; the strategy and tile height the port's
    route picks (raster_route, or gbuffer_route on the G-buffer path);
    finite, non-negative stage times that sum to total_ms; stream_ms 0."""
    scene, tr, li, (h, w) = torch_scene(name, variant, "cpu")
    (obj, cfg), = scene
    got = prof.stage_breakdown(obj, cfg, tr, li, h, w, frames=2,
                               device="cpu")
    assert list(got) == jax_stage_keys()
    fused = variant != "gbuffer"
    route = (trp.raster_route if fused else tgb.gbuffer_route)(
        obj.num_triangles, h, w)
    assert (got["strategy"], got["tile_h"], got["fused_shading"]) == (
        route.strategy, route.tile_h, fused)
    stages = [got[k] for k in ("setup_ms", "binning_ms", "stream_ms",
                               "raster_ms", "shade_ms")]
    assert all(math.isfinite(v) and v >= 0.0 for v in stages)
    assert got["stream_ms"] == 0.0 and (got["shade_ms"] > 0.0) == (not fused)
    assert got["total_ms"] == pytest.approx(sum(stages))


def test_stage_breakdown_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    scene, tr, li, (h, w) = torch_scene("k6", "base", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prof.stage_breakdown(*scene[0], tr, li, h, w, frames=1)


def test_trace_writes_a_file_and_annotate_names_a_span(tmp_path):
    scene, tr, li, (h, w) = torch_scene("k6", "base", "cpu")
    r = trt.Renderer(h, w, device="cpu")
    with prof.trace(str(tmp_path)):
        with prof.annotate("frame"):
            r.render(scene, tr, li)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        assert '"frame"' in f.read()
