"""Reads a ``torch.profiler`` trace of frames the benchmark marked with
its own spans: each frame's device operations in order, the union of the
device's busy intervals, the traced window, the device operations that
took most time and the idle gaps by what the host was doing."""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

SPAN = "portbench.frame"  # the benchmark's record_function span per frame
TOP = 10  # entries of each breakdown list


@dataclass
class Trace:
    """Times in microseconds, on the profiler's clock."""

    frames: list  # per frame: [(name, start, end)] device ops by start
    window: float  # the frames' spans, summed
    busy: float  # the union of each frame's device intervals, summed
    device_ops: dict = field(default_factory=dict)  # name -> us
    idle_gaps: dict = field(default_factory=dict)  # host op -> us


def union(intervals):
    """Total length covered by (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def _gaps(intervals, lo, hi):
    """The (start, end) gaps inside [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def _host_op_at(host, starts, t):
    """The innermost host op running at time t (latest start covering t),
    or 'python between ops' where the trace holds none."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 400, -1), -1):
        name, _, e = host[j]
        if e >= t:
            return name
    return "python between ops"


def reduce(events) -> Trace:
    """``events``: (name, is_device, start_us, end_us) of a profiler trace.
    A frame's device ops are those that start inside its span (it waits
    for its planes inside it); the traced window is the frames' spans
    together, so the benchmark's own work between frames, the profiler's
    warm-up and the span's own mark on the device's timeline are left
    out."""
    spans = sorted((s, e) for n, dev, s, e in events
                   if not dev and n == SPAN)
    if not spans:
        raise ValueError("the trace holds no frame span")
    starts = [s for s, _ in spans]
    frames = [[] for _ in spans]
    for n, dev, s, e in events:
        if not dev or n == SPAN:
            continue
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s <= spans[i][1]:
            frames[i].append((n, s, min(e, spans[i][1])))
    for f in frames:
        f.sort(key=lambda x: x[1])
    ops = {}
    for f in frames:
        for n, s, e in f:
            ops[n[:60]] = ops.get(n[:60], 0.0) + (e - s)
    host = sorted(((n, s, e) for n, dev, s, e in events
                   if not dev and n != SPAN), key=lambda x: x[1])
    hstarts = [s for _, s, _ in host]
    gaps = {}
    for (lo, hi), f in zip(spans, frames):
        for s, e in _gaps([(s, e) for _, s, e in f], lo, hi):
            name = _host_op_at(host, hstarts, 0.5 * (s + e))[:60]
            gaps[name] = gaps.get(name, 0.0) + (e - s)
    return Trace(frames=frames, window=sum(e - s for s, e in spans),
                 busy=sum(union((s, e) for _, s, e in f) for f in frames),
                 device_ops=ops, idle_gaps=gaps)


def profiler_events(prof):
    """(name, is_device, start_us, end_us) of every event of a finished
    ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    return [(e.name, e.device_type == DeviceType.CUDA, e.time_range.start,
             e.time_range.end) for e in prof.events()]


def top(d: dict, n: int = TOP):
    """[[name, seconds], ...] of the n largest entries, microseconds in."""
    return [[k, v / 1e6] for k, v in sorted(d.items(),
                                             key=lambda kv: -kv[1])[:n]]


def split(frame, first_names, last_names, leading=("Memset",)):
    """A frame's device ops cut by order into five segments: before the
    first op named by ``first_names`` (geometry), from it to the last such
    op (setup), up to the first op named by ``last_names`` (binning),
    from it to the last such (raster; the device memsets just before it,
    its own key fill, included) and after (shade). Returns None unless
    both name lists match an op, in that order."""
    def named(n, names):
        return any(k in n for k in names)

    fi = [i for i, (n, _, _) in enumerate(frame) if named(n, first_names)]
    li = [i for i, (n, _, _) in enumerate(frame) if named(n, last_names)]
    if not fi or not li or li[0] <= fi[-1]:
        return None
    r0 = li[0]
    while r0 - 1 > fi[-1] and named(frame[r0 - 1][0], leading):
        r0 -= 1
    return dict(geometry=frame[:fi[0]], setup=frame[fi[0]:fi[-1] + 1],
                binning=frame[fi[-1] + 1:r0], raster=frame[r0:li[-1] + 1],
                shade=frame[li[-1] + 1:])


def unsplit(trace: Trace, first_names, last_names):
    """The frames that ``split`` cannot cut: [(frame index, op names)]."""
    return [(i, [n[:48] for n, _, _ in f]) for i, f in enumerate(trace.frames)
            if split(f, first_names, last_names) is None]


def segment_ms(trace: Trace, first_names, last_names, segment):
    """Mean device ms a frame of one ``split`` segment (the union of its
    ops' intervals), or None when a frame does not split."""
    total = 0.0
    for f in trace.frames:
        parts = split(f, first_names, last_names)
        if parts is None:
            return None
        total += union((s, e) for _, s, e in parts[segment])
    return total / 1e3 / len(trace.frames)
