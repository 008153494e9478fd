"""``tpu_renderer_torch.utils.profiling`` against the JAX package's
``tpu_renderer.utils.profiling``: FrameTimer's statistics on the same
samples, and trace / annotate writing a trace (the spans themselves:
tests/test_torch_spans.py).
"""

import os

import pytest
import torch

import tpu_renderer_torch as trt
from tpu_renderer.utils import profiling as jprof
from tpu_renderer_torch.models.route_scenes import torch_scene
from tpu_renderer_torch.utils import profiling as prof
from torch_threads import one_torch_thread  # noqa: F401


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
