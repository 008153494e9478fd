"""Tracing and profiling utilities (PyTorch counterpart of
``tpu_renderer.utils.profiling``).

- FrameTimer: wall-clock frame statistics, waiting for the card at the end
  of each frame.
- annotate(): the program's span. Each layer of a frame runs inside one,
  at the function where its work starts: ``tr.render`` (the engine,
  ``Renderer.render``), ``tr.geometry`` (``rotate_object``), ``tr.setup``,
  ``tr.binning``, ``tr.raster`` and ``tr.shade`` (the deferred shade, pack
  and merge). Off, a span costs one flag test; ``spans()`` turns them on
  and hands back what they recorded, and ``self_ms`` reads it.
- trace(): a torch.profiler trace of a block (host and card), the spans
  in it, written for TensorBoard's profiler plugin or chrome://tracing.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import List

import torch

RENDER = "tr.render"  # the span whose calls number the frames (render_seq)
_OFF = contextlib.nullcontext()  # every span while spans are off
_records = None  # the list that spans() fills; None while spans are off
_stack: List[int] = []  # indices in _records of the open spans, innermost last
_renders = 0  # RENDER spans opened in this spans() block


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


class _Span:
    """One span while spans are on: its record, (name, parent, render_seq,
    start_ns, end_ns), is appended when it opens and completed when it
    closes; it also enters ``record_function(name)`` when a torch.profiler
    is running, so the profiler's trace holds it on its own clock."""

    __slots__ = ("name", "index", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _renders
        parent = _stack[-1] if _stack else None
        if self.name == RENDER:
            seq, _renders = _renders, _renders + 1
        else:
            seq = None if parent is None else _records[parent][2]
        self.annotation = None
        if torch.autograd.profiler._is_profiler_enabled:
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.index = len(_records)
        _stack.append(self.index)
        _records.append((self.name, parent, seq, time.perf_counter_ns(),
                         None))
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        name, parent, seq, start, _ = _records[self.index]
        _records[self.index] = (name, parent, seq, start, end)
        _stack.pop()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


def annotate(name: str):
    """The program's span: ``with annotate('tr.raster'): ...``. While spans
    are off (the default) it returns one shared no-op context and records
    nothing; inside ``spans()`` it records the block's host time."""
    if _records is None:
        return _OFF
    return _Span(name)


@contextlib.contextmanager
def spans():
    """Turns the spans on for the block: ``with spans() as records:``.
    Each span the block runs appends ``(name, parent, render_seq, start_ns,
    end_ns)`` to ``records``, in the order the spans open: ``parent`` the
    index of the enclosing span (None at the root), ``render_seq`` the
    number of the ``tr.render`` call it belongs to in this block (None
    outside one), the times from ``time.perf_counter_ns``. One thread, one
    stack; nothing is written to disk. Blocks do not nest."""
    global _records, _renders
    if _records is not None:
        raise RuntimeError("spans are on already")
    records: list = []
    _records, _renders = records, 0
    try:
        yield records
    finally:
        _records = None
        _stack.clear()


def self_ms(records) -> dict:
    """{span name: ms} over ``records`` (a ``spans()`` block's): each
    span's time less the part its child spans cover, summed by name, so
    the values add up to the root spans' time."""
    out: dict = {}
    for name, parent, _, start, end in records:
        ms = (end - start) / 1e6
        out[name] = out.get(name, 0.0) + ms
        if parent is not None:
            pname = records[parent][0]
            out[pname] = out.get(pname, 0.0) - ms
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the block, the host's activity and
    the card's where there is one, with the program's spans on, written
    into ``logdir`` as a ``*.pt.trace.json`` (TensorBoard's profiler
    plugin, chrome://tracing)."""
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
        with spans():
            yield
