"""Tracing and profiling utilities (PyTorch counterpart of
``tpu_renderer.utils.profiling``).

- FrameTimer: wall-clock frame statistics, waiting for the card at the end
  of each frame.
- stage_breakdown: the time of each stage of one object's frame, on the
  route the port takes.
- trace(): a torch.profiler trace of a block (host and card), written for
  TensorBoard's profiler plugin or chrome://tracing.
- annotate(): a named span inside a trace.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import List

import torch

from ..core.math import pack_argb
from ..core.types import resolve_device
from ..engine.renderer import _obj_fusable, object_specs
from ..geometry.transform import rotate_object, rotation_y
from ..ops.gbuffer import prepare_gbuffer
from ..ops.raster import mask_capacity, prepare_raster, setup_out
from ..ops.setup import setup_for_raster
from ..ops.shading import shade


def _tensors(result):
    """The tensors of a result: a tensor, or tuples, lists and dicts of
    them (a Framebuffer is a tuple)."""
    if isinstance(result, torch.Tensor):
        yield result
    elif isinstance(result, (tuple, list)):
        for r in result:
            yield from _tensors(r)
    elif isinstance(result, dict):
        for r in result.values():
            yield from _tensors(r)


def _synchronize(result) -> None:
    """Wait until the card has computed ``result``: synchronise the CUDA
    device of each of its tensors (all of that device's work); nothing for
    CPU tensors, which are ready when returned."""
    for device in {t.device for t in _tensors(result) if t.is_cuda}:
        torch.cuda.synchronize(device)


@dataclass
class FrameTimer:
    """Rolling frame statistics. ``tick`` around each frame render."""

    samples: List[float] = field(default_factory=list)
    max_samples: int = 240

    @contextlib.contextmanager
    def tick(self, result_to_block_on=None):
        """Time the block, then wait for ``result_to_block_on``: read when
        the block ends, so a list that the block fills with its frame
        works (``with t.tick(out): out.append(render(...))``)."""
        t0 = time.perf_counter()
        out = {}
        yield out
        if result_to_block_on is not None:
            _synchronize(result_to_block_on)
        dt = time.perf_counter() - t0
        self.record(dt)
        out["seconds"] = dt

    def record(self, seconds: float):
        self.samples.append(seconds)
        if len(self.samples) > self.max_samples:
            self.samples.pop(0)

    @property
    def fps(self) -> float:
        if not self.samples:
            return 0.0
        return len(self.samples) / sum(self.samples)

    def summary(self) -> dict:
        if not self.samples:
            return {"frames": 0}
        s = sorted(self.samples)
        n = len(s)
        return {
            "frames": n,
            "fps": self.fps,
            "ms_mean": 1e3 * sum(s) / n,
            "ms_p50": 1e3 * s[n // 2],
            "ms_p99": 1e3 * s[min(n - 1, int(n * 0.99))],
        }


def _stage_clock(device: torch.device):
    """``run(fn) -> (fn(), ms)``: ``fn`` alone between two synchronisations,
    timed by CUDA events on the card and by the host clock on the CPU."""
    if device.type != "cuda":
        def run(fn):
            t0 = time.perf_counter()
            out = fn()
            return out, (time.perf_counter() - t0) * 1e3
        return run

    def run(fn):
        stream = torch.cuda.current_stream(device)
        stream.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record(stream)
        out = fn()
        e1.record(stream)
        e1.synchronize()
        return out, e0.elapsed_time(e1)
    return run


def _setup(obj, cfg, transform, lights, height: int, width: int):
    """The setup stage as the engine runs it: setup_for_raster (K1 from
    4096 triangles, else the small-object chain), then ``setup_out`` (K7
    and the bboxes where the chain ran) -> (SetupOut, the mask capacity
    the engine gives the table)."""
    table, T = setup_out(setup_for_raster(obj, transform, lights, cfg,
                                          frame_height=height,
                                          frame_width=width), height, width)
    return table, mask_capacity(T)


def stage_breakdown(obj, cfg, transform, lights, height: int, width: int,
                    frames: int = 30, strategy: str = "auto",
                    device="cuda") -> dict:
    """Per-stage time (ms per frame) of one object's frame on the route
    the port takes, the JAX package's keys (utils/profiling.py:65).

    The stages: setup (``_setup``); binning (``prepare_raster`` on the
    fused route, ``prepare_gbuffer`` on the G-buffer one: the route from
    ``raster_route`` / ``gbuffer_route`` with ``strategy`` forced and the
    tile height picked, the bins); raster (the launch's kernel: raster and
    shade in one on the fused route, the G-buffer on the other); shade
    (the deferred shade and pack; 0 on the fused route). ``fused_shading``
    is the engine's choice (``_obj_fusable``: untextured, or textured
    within the fused limits). ``stream_ms`` is 0.0: the port has no
    ``_queue_stream`` gather, its kernels read the records in place.

    Each stage runs alone between two synchronisations, timed by CUDA
    events on the card (the host clock on the CPU), over ``frames``
    frames rotated about y from 0 to 0.7 rad after one untimed frame; each
    stage's ms is the mean over the frames and includes its own host
    enqueue, so the stages sum to more than a frame whose host work
    overlaps the card's. ``obj`` must lie on ``device``."""
    device = resolve_device(device)
    if obj.vertices.device.type != device.type:
        raise ValueError(f"object on {obj.vertices.device}, stages timed "
                         f"on {device}")
    fused = _obj_fusable(obj, cfg)
    objspecs, atlas = object_specs(obj, cfg) if fused else (None, None)
    clock = _stage_clock(device)
    total = {"setup": 0.0, "binning": 0.0, "raster": 0.0, "shade": 0.0}
    angles = [0.7 * i / max(frames - 1, 1) for i in range(frames)]
    for i, angle in enumerate([0.0] + angles):
        spun = rotate_object(obj, rotation_y(angle, device=device))
        ms = {}
        (table, capacity), ms["setup"] = clock(
            lambda: _setup(spun, cfg, transform, lights, height, width))
        if fused:
            launch, ms["binning"] = clock(lambda: prepare_raster(
                table, objspecs, transform, lights, height, width,
                capacity, strategy=strategy, atlas=atlas))
            _, ms["raster"] = clock(launch.run)
        else:
            launch, ms["binning"] = clock(lambda: prepare_gbuffer(
                table, height, width, capacity, strategy=strategy))
            (gid, gbuf), ms["raster"] = clock(launch.run)
            _, ms["shade"] = clock(lambda: pack_argb(shade(
                gid[:height, :width] >= 0, gbuf[:, :height, :width],
                transform, lights, cfg, obj.texture)[0]))
        if i:  # frame 0 warms up
            for k, v in ms.items():
                total[k] += v
    mean = {k: v / frames for k, v in total.items()}
    return {
        "strategy": launch.route.strategy,
        "tile_h": launch.route.tile_h,
        "fused_shading": fused,
        "setup_ms": mean["setup"],
        "binning_ms": mean["binning"],
        "stream_ms": 0.0,
        "raster_ms": mean["raster"],
        "shade_ms": mean["shade"],
        "total_ms": sum(mean.values()),
    }


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the block, the host's activity and
    the card's where there is one, written into ``logdir`` as a
    ``*.pt.trace.json`` (TensorBoard's profiler plugin, chrome://tracing)."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(logdir))):
        yield


def annotate(name: str):
    """Named span inside a trace: ``with annotate('raster'): ...``."""
    return torch.profiler.record_function(name)
