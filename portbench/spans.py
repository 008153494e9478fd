"""The program's spans in a traced run: where each layer's host time and
device work go, read from the spans the program opens at its layer
boundaries (``tpu_renderer_torch.utils.profiling``: ``tr.render``,
``tr.geometry``, ``tr.setup``, ``tr.binning``, ``tr.raster``,
``tr.shade``).

Two blocks on the traced frames' indices, after the run's own traced
block and its check, in a fresh process (``python -m portbench.spans``)
on the cell built again from the seed (the renderer keeps no state
between frames, so the frames are the same):

- (b) first, spans on and no profiler yet in the process: each span's
  host self time a frame (``profiling.self_ms``), in passes over the
  frames, each followed by one with spans off, what the spans cost;
- (a) profiled, spans on, each frame in the benchmark's ``portbench.frame``
  span: each device op is credited to the innermost ``tr.*`` span that
  holds the host call that launched it, matched through CUPTI's
  correlation id (never by order or kernel name); launches, device ms (the
  union of the ops' intervals), host syncs and the device's idle gaps a
  frame, by span.

The harness runs neither itself: the readers of the span metrics
(``metrics/*.host_ms``, ``*.launches``, ``geometry.device_ms``) start them
once a run, through ``blocks``, in a run of ``portbench/run.py`` with
``--trace 1``. Elsewhere, and on a program without ``profiling.spans``,
every reader returns None.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import re
import subprocess
import sys
import time
import traceback
from dataclasses import asdict, dataclass, field
from typing import NamedTuple

from . import catalog, harness
from . import trace as traces

PREFIX = "tr."  # the program's spans; no torch op or benchmark span
OUTSIDE = "outside the program"  # host time in no span of the program
NO_LAUNCH = "no launch found"  # device ops whose launch the trace lacks
LAYERS = {"engine": "tr.render", "geometry": "tr.geometry",
          "setup": "tr.setup", "binning": "tr.binning",
          "raster": "tr.raster", "shade": "tr.shade"}
# a CUDA API call on the host: cudaLaunchKernel, cuLaunchKernel, ...
LAUNCH_NAME = re.compile(r"cu(da)?[A-Z]")
SYNC = "Synchronize"  # in the name of the runtime's waits for the device
DTOH = "Memcpy DtoH"  # a device-to-host copy on the device's timeline
HOST_PASSES = 5  # block (b)'s passes over the traced frames, spans on
CHILD_SECONDS = 240  # most the span blocks may take (15-25 s on the card)
RUN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "run.py")


class Event(NamedTuple):
    """One event of a profiler trace, times in microseconds on the
    profiler's clock."""

    name: str
    device: bool  # on the device's timeline
    mark: bool  # a user annotation: a span's host event or its device mark
    launch: bool  # a CUDA API call on the host (cuda*, cu*)
    start: float
    end: float
    correlation: int  # CUPTI's: a device op's equals its launch's


@dataclass
class Credit:
    """Block (a)'s readings, each a mean a frame, keyed by span name,
    OUTSIDE or NO_LAUNCH."""

    frames: int
    ops: list  # device ops of each frame
    launches: dict = field(default_factory=dict)
    device_ms: dict = field(default_factory=dict)
    idle_ms: dict = field(default_factory=dict)
    syncs: dict = field(default_factory=dict)
    spans: set = field(default_factory=set)  # the span names that ran


def kineto_events(prof):
    """The Events of a finished ``torch.profiler.profile``, from its
    Kineto results. Spans and their device marks are known by their names
    (the program's prefix, the benchmark's frame span), as trace.py knows
    the frame span's; launches by the CUDA API's names."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns() / 1e3
        out.append(Event(
            name, e.device_type() == DeviceType.CUDA,
            name.startswith(PREFIX) or name == traces.SPAN,
            e.device_type() != DeviceType.CUDA
            and LAUNCH_NAME.match(name) is not None,
            start, start + e.duration_ns() / 1e3, int(e.correlation_id())))
    return out


def _innermost(spans, starts, t):
    """The innermost span of ``spans`` ([(start, end, name)] by start, as
    nested spans of one thread are) that holds time t, or OUTSIDE."""
    for j in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        s, e, name = spans[j]
        if e >= t:
            return name
    return OUTSIDE


def _add(d, k, v):
    d[k] = d.get(k, 0.0) + v


def credit(events, frame_span=traces.SPAN) -> Credit:
    """Credits each device op of the frames (the ``frame_span`` host
    spans) to the innermost program span that holds its launch, each idle
    gap of the device inside a frame to the span the host was in at the
    gap's midpoint, and each host sync (a runtime call that waits, or a
    device-to-host copy, by its launch) to the span it ran in. The spans'
    own device marks are no device ops. Means a frame."""
    frames = sorted((e.start, e.end) for e in events
                    if e.mark and not e.device and e.name == frame_span)
    if not frames:
        raise ValueError("the trace holds no frame span")
    fstarts = [s for s, _ in frames]

    def frame_of(t):
        i = bisect.bisect_right(fstarts, t) - 1
        return i if i >= 0 and t <= frames[i][1] else None

    spans = [[] for _ in frames]
    for e in events:
        if e.mark and not e.device and e.name.startswith(PREFIX):
            i = frame_of(e.start)
            if i is not None:
                spans[i].append((e.start, e.end, e.name))
    for s in spans:
        s.sort()
    starts = [[s for s, _, _ in sp] for sp in spans]

    def owner_at(i, t):
        return _innermost(spans[i], starts[i], t)

    launches = {e.correlation: e for e in events
                if e.launch and not e.device and e.correlation}
    ops = [[] for _ in frames]  # per frame: (owner, start, end)
    syncs: dict = {}
    for e in events:
        if e.device and not e.mark:
            at = launches.get(e.correlation)
            i = frame_of(at.start if at is not None else e.start)
            if i is None:
                continue
            owner = NO_LAUNCH if at is None else owner_at(i, at.start)
            ops[i].append((owner, e.start, e.end))
            if e.name.startswith(DTOH):
                _add(syncs, owner, 1)
        elif e.launch and not e.device and SYNC in e.name:
            i = frame_of(e.start)
            if i is not None:
                _add(syncs, owner_at(i, e.start), 1)
    n = len(frames)
    out = Credit(frames=n, ops=[len(f) for f in ops],
                 spans={name for s in spans for _, _, name in s})
    for i, ((lo, hi), f) in enumerate(zip(frames, ops)):
        by_owner: dict = {}
        for owner, s, e in f:
            _add(out.launches, owner, 1 / n)
            by_owner.setdefault(owner, []).append((s, min(e, hi)))
        for owner, iv in by_owner.items():
            _add(out.device_ms, owner, traces.union(iv) / 1e3 / n)
        for s, e in traces._gaps([(s, e) for _, s, e in f], lo, hi):
            _add(out.idle_ms, owner_at(i, 0.5 * (s + e)), (e - s) / 1e3 / n)
    out.syncs = {k: v / n for k, v in syncs.items()}
    return out


@dataclass
class Blocks:
    """What a run's span blocks read."""

    credit: Credit | None  # block (a); None off the card
    host_ms: dict  # block (b): self ms a frame by span
    enqueue_ms: float  # block (b): mean enqueue ms a frame, spans on
    enqueue_off_ms: float  # the same frames in passes between, spans off


def run_blocks(frame, first, n, dev, profiling, warm=harness.TRACE_WARM,
               passes=HOST_PASSES):
    """Blocks (b) and (a) on frames ``first`` .. ``first + warm + n - 1``
    (``frame(i)`` renders frame i and waits for it, returning (..., enqueue
    ms, ...) as the harness's frame does), each block's first ``warm``
    frames unmarked. Block (b) takes ``passes`` passes over the marked
    frames with spans on, each followed by one with spans off (the spans'
    cost), and runs first: the host's time after a profiler has run in a
    process is no longer the window's. Block (a) runs on the card
    alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    marked = range(first + warm, first + warm + n)
    for i in range(first, first + warm):
        frame(i)
    on, off, host = [], [], {}
    for _ in range(passes):
        with profiling.spans() as records:
            on += [frame(i)[2] for i in marked]
        for k, v in profiling.self_ms(records).items():
            _add(host, k, v / (passes * n))
        off += [frame(i)[2] for i in marked]
    got = None
    if dev.type == "cuda":
        with profiling.spans():
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for i in range(first, first + warm):
                    frame(i)
                for i in marked:
                    with record_function(traces.SPAN):
                        frame(i)
        got = credit(kineto_events(prof))
        torch.cuda.synchronize(dev)
    return Blocks(got, host, sum(on) / len(on), sum(off) / len(off))


def _profiling():
    """The program's profiling module if it has spans, else None."""
    from tpu_renderer_torch.utils import profiling

    return profiling if hasattr(profiling, "spans") else None


def _command_line():
    """The run's --workload and --seed when this process is
    ``portbench/run.py``, else None."""
    main = sys.modules.get("__main__")
    if os.path.abspath(getattr(main, "__file__", "") or "") != RUN:
        return None
    return harness.parse(sys.argv[1:])


def measure_cell(workload, seed, first, device="cuda"):
    """Builds the cell again from its seed on ``device`` and runs both
    blocks on the traced frames' indices from ``first`` (where the
    harness's traced block starts), after the cell's warm frames."""
    import torch

    import tpu_renderer_torch as trt
    from tpu_renderer_torch.geometry.transform import rotate_object

    from . import scene as scenes, traffic as traffics

    cell = catalog.workload(catalog.benchmark(), workload)
    cfg, mix = catalog.config(cell["config"]), catalog.traffic(cell["traffic"])
    dev = torch.device(device)
    height, width = mix["height"], mix["width"]
    scene, tr_d, li_d = scenes.build(cfg, height, width,
                                     harness.rng(seed, "scene"))
    orbit = traffics.Orbit(mix, harness.rng(seed, "orbit"))
    prog, tr, li = harness.device_scene(scene, tr_d, li_d, dev)
    rots = torch.as_tensor(orbit.matrices, device=dev)
    renderer = trt.Renderer(height, width, device=dev)
    clock = harness.Clock(dev)

    def frame(i):  # the harness's frame
        t0 = time.perf_counter()
        clock.start()
        rot = rots[orbit.index(i)]
        sc = [(rotate_object(o, rot), c) for o, c in prog]
        fb, stats = renderer.render(sc, tr, li, with_stats=True)
        t1 = time.perf_counter()
        return fb, stats, (t1 - t0) * 1e3, clock.stop()

    for i in range(-mix["warm_frames"], 0):
        frame(i)
    return run_blocks(frame, first, mix["trace_frames"], dev, _profiling())


def _measure(r):
    """Both blocks of a traced run of portbench/run.py, on the traced
    frames' indices (``r.attempted``), in a fresh process on the card: this
    one has run a profiler (the traced block) and the reference's pool.
    None where there is nothing to read."""
    if r.trace is None or _profiling() is None:
        return None
    args = _command_line()
    if args is None:
        return None
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "portbench.spans", "--workload",
         args.workload, "--seed", str(args.seed), "--first",
         str(r.attempted)], cwd=catalog.CHECKOUT, stdout=subprocess.PIPE,
        text=True, timeout=CHILD_SECONDS, check=True)
    got = _from_json(out.stdout.strip().splitlines()[-1])
    report(got, r, time.perf_counter() - t0)
    return got


def _to_json(got: Blocks) -> str:
    d = asdict(got)
    if got.credit is not None:
        d["credit"]["spans"] = sorted(got.credit.spans)
    return json.dumps(d)


def _from_json(line: str) -> Blocks:
    d = json.loads(line)
    c = d.pop("credit")
    if c is not None:
        c = Credit(**dict(c, spans=set(c["spans"])))
    return Blocks(credit=c, **d)


_done: dict = {}


def blocks(r):
    """The span blocks of the run whose reading is ``r``, run once however
    many readers ask; None where they read nothing. A block that raises
    is logged and reads nothing."""
    if id(r) not in _done:
        try:
            got = _measure(r)
        except Exception:  # the run's other metrics still print
            harness.log(f"# span blocks raised:\n{traceback.format_exc()}")
            got = None
        _done[id(r)] = (r, got)
    return _done[id(r)][1]


def _fmt(d, digits=4):
    return "{" + ", ".join(f"{k}: {round(v, digits)}" for k, v in sorted(
        d.items(), key=lambda kv: -kv[1])) + "}"


def report(got, r, seconds):
    """The blocks' stderr lines."""
    c = got.credit
    if c is not None:
        harness.log(
            f"# spans (a): {c.frames} frames, device ops a frame {c.ops}; "
            f"launches a frame by span {_fmt(c.launches)}, sum "
            f"{round(sum(c.launches.values()), 4)}")
        order = {}
        for layer in ("setup", "binning", "raster", "shade"):
            v = r.metric(f"{layer}.device_ms").read(r)
            if v is not None:
                order[layer] = round(v, 4)
        harness.log(f"# device ms a frame by span {_fmt(c.device_ms)}; "
                    f"by the traced block's order split {order}")
        harness.log(f"# idle by layer, ms a frame: {_fmt(c.idle_ms)}; "
                    f"host syncs a frame by span: {_fmt(c.syncs)}")
    window = sum(r.enqueue_ms) / len(r.enqueue_ms) if r.enqueue_ms else 0.0
    harness.log(
        f"# spans (b): host self ms a frame by span {_fmt(got.host_ms)}, "
        f"sum {round(sum(got.host_ms.values()), 4)}; enqueue ms a frame, "
        f"spans on {round(got.enqueue_ms, 4)}, the same frames off "
        f"{round(got.enqueue_off_ms, 4)}, the window's (off) "
        f"{round(window, 4)}; the blocks took {round(seconds, 3)} s")


def host_ms(r, layer):
    """Block (b): the layer's span's host self ms a frame, or None."""
    got = blocks(r)
    return None if got is None else got.host_ms.get(LAYERS[layer])


def credited(r, layer, reading):
    """Block (a)'s ``reading`` ('launches' or 'device_ms') a frame of the
    ops launched in the layer's span (its self part), or None where the
    span never ran or the run read nothing."""
    got = blocks(r)
    if got is None or got.credit is None:
        return None
    c, name = got.credit, LAYERS[layer]
    return getattr(c, reading).get(name, 0.0) if name in c.spans else None


def main(argv=None) -> int:
    """``python -m portbench.spans --workload <cell> --seed <n> --first
    <i>`` from the checkout's root: both blocks on the card in this fresh
    process, one JSON line out (``Blocks``)."""
    import torch

    p = argparse.ArgumentParser(prog="python -m portbench.spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--first", type=int, required=True)
    args = p.parse_args(argv)
    torch.set_num_threads(2)  # as harness.main
    got = measure_cell(args.workload, args.seed, args.first)
    print(_to_json(got), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
