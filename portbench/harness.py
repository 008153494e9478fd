"""One run of one cell: set-up, the measured window, the traced block, the
check against the plain reference, and the result line.

The window is a closed loop with one frame in flight, as a viewer that
presents each frame before it draws the next: frame i rotates every object
of the scene by its orbit matrix (``rotate_object``), renders it
(``Renderer.render(..., with_stats=True)``) and waits until its colour
and depth planes are ready. The benchmark times it with its own clock and
its own CUDA events, and reads its own spans from the profiler: the
program is handed inputs and nothing else.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from types import SimpleNamespace

import numpy as np

from . import catalog, scene as scenes, trace as traces, traffic as traffics
from . import work as yardstick
from .reference import frame as ref

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_renderer")
STREAMS = {"orbit": 0, "scene": 1, "sample": 2, "windows": 3}
WORKERS = 7  # most processes the reference renders its windows in
KEPT_ANGLES = 3  # traced frames whose kept triangles the roofline counts
FAILED_LOG = 3  # tracebacks of failed frames printed
TRACE_WARM = 2  # frames profiled before the first marked one


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def rng(seed: int, stream: str):
    """The generator of one use of the seed: any whole number, taken
    modulo 2**64."""
    return np.random.default_rng([int(seed) % 2 ** 64, STREAMS[stream]])


class Clock:
    """A frame's latency, its start to its planes being ready: CUDA events
    on the card (the device is idle when a frame starts, one frame being in
    flight, so the start event fires when the host starts), the host's
    clock elsewhere."""

    def __init__(self, device):
        import torch

        self.cuda = device.type == "cuda"
        if self.cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)

    def start(self):
        if self.cuda:
            self.a.record()
        else:
            self.t = time.perf_counter()

    def stop(self) -> float:
        """Waits for the frame; its latency in ms."""
        if self.cuda:
            self.b.record()
            self.b.synchronize()
            return self.a.elapsed_time(self.b)
        return (time.perf_counter() - self.t) * 1e3


class Reservoir:
    """A uniform sample of k frames of the window, drawn from the seed as
    they come (Algorithm R); holds their planes, no copy."""

    def __init__(self, k: int, gen):
        self.k, self.gen, self.seen, self.kept = k, gen, 0, {}

    def offer(self, i: int, planes):
        if self.seen < self.k:
            self.kept[self.seen] = (i, planes)
        else:
            j = int(self.gen.integers(self.seen + 1))
            if j < self.k:
                self.kept[j] = (i, planes)
        self.seen += 1

    def frames(self):
        return sorted(self.kept.values(), key=lambda x: x[0])


def power_line(index: int = 0) -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def device_scene(scene, tr_d, li_d, device):
    """The program's scene, transform and lights from the golden form,
    through its own constructors."""
    import tpu_renderer_torch as trt

    out = []
    for o, c in scene:
        obj = trt.make_object(o["p"], o["vertices"], o["colors"],
                              o["normals"], o["uvs"], c.get("texture"),
                              device=device)
        out.append((obj, trt.ObjectConfig(
            phong=c["phong"], textured=c.get("texture") is not None,
            uv_mode=c["uv_mode"], filter_mode=c["filter_mode"])))
    tr = trt.make_transform(tr_d["distance_above_target"],
                            tr_d["focal_length"], tr_d["meters_to_pixels"],
                            tr_d["screen_center"], device=device)
    li = trt.make_lights(li_d["ambient"], li_d["light_p"],
                         li_d["light_intensity"], device=device)
    return out, tr, li


def counters(route: dict):
    """The program's launch counters a configuration names
    ('module.wrapper', under tpu_renderer_torch.ops)."""
    import importlib

    out = {}
    for name in route:
        mod, attr = name.rsplit(".", 1)
        out[name] = getattr(importlib.import_module(
            f"tpu_renderer_torch.ops.{mod}"), attr)
    return out


def stop_tracker():
    """Ends the semaphore tracker process that a spawn pool starts, and
    waits for it, so that a run leaves no process behind it."""
    from multiprocessing import resource_tracker

    tracker = resource_tracker._resource_tracker
    if hasattr(tracker, "_stop"):
        tracker._stop()
    elif getattr(tracker, "_fd", None) is not None:
        os.close(tracker._fd)
        os.waitpid(tracker._pid, 0)
        tracker._fd = tracker._pid = None


def check_windows(sampled, scene, tr_d, li_d, orbit, height, width, mix,
                  seed, workers=WORKERS, lower=False):
    """Holds each sampled frame to the reference on windows drawn from the
    seed: ``sampled`` is [(frame index, (color u32, depth f32) NumPy)].
    Returns (differing px, compared px, px the reference covers).
    ``lower`` renders the reference's bfloat16 control instead of the
    float32 spec on the program's side (``sampled`` unused but for
    indices): the comparison it has to fail."""
    chk = mix["check"]
    size, gen = chk["window_px"], rng(seed, "windows")
    jobs, crops = [], []
    for i, planes in sampled:
        rot = orbit.matrices[orbit.index(i)]
        sc = [(ref.rotate(o, rot), c) for o, c in scene]
        projs = [ref.projected(o, tr_d) for o, _ in sc]
        rects = [(r0, c0, size, size) for r0, c0 in ref.place_windows(
            sc, tr_d, height, width, chk["windows"], size, gen, projs)]
        for rect, sub in zip(rects, ref.window_scenes(
                sc, tr_d, height, width, rects, projs)):
            r0, c0 = rect[:2]
            jobs.append((sub, tr_d, li_d, height, width, rect, False))
            if lower:
                jobs.append((sub, tr_d, li_d, height, width, rect, True))
            else:
                crops.append((planes[0][r0:r0 + size, c0:c0 + size],
                              planes[1][r0:r0 + size, c0:c0 + size]))
    n = max(1, min(len(jobs), workers, (os.cpu_count() or 2) - 1))
    with ProcessPoolExecutor(n, mp_context=get_context("spawn")) as pool:
        want = list(pool.map(ref.render_window, jobs))
    stop_tracker()
    if lower:
        crops, want = want[1::2], want[0::2]
    bad = sum(ref.differing(g, w) for g, w in zip(crops, want))
    covered = sum(int((w[1] > ref.spec.DEPTH_CLEAR).sum()) for w in want)
    return bad, len(want) * size * size, covered


def run_cell(bench, cell, seed, seconds, trace, device="cuda",
             t_start=None, config=None, mix=None, workers=WORKERS):
    """Runs the cell once; returns (result dict without its checks, checks
    dict). ``config`` and ``mix`` replace the files the cell names (the
    tests' small scenes); ``device`` 'cpu' runs the program's plain
    versions, for the tests alone."""
    import torch

    from tpu_renderer_torch.geometry.transform import rotate_object

    t_start = time.perf_counter() if t_start is None else t_start
    cfg = config or catalog.config(cell["config"])
    mix = mix or catalog.traffic(cell["traffic"])
    dev = torch.device(device)
    height, width = mix["height"], mix["width"]
    marks = [("imports", time.perf_counter())]
    scene, tr_d, li_d = scenes.build(cfg, height, width, rng(seed, "scene"))
    orbit = traffics.Orbit(mix, rng(seed, "orbit"))
    marks.append(("scene built", time.perf_counter()))
    prog, tr, li = device_scene(scene, tr_d, li_d, dev)
    rots = torch.as_tensor(orbit.matrices, device=dev)
    import tpu_renderer_torch as trt
    marks.append(("scene on the device", time.perf_counter()))

    renderer = trt.Renderer(height, width, device=dev)
    clock = Clock(dev)

    def frame(i):
        t0 = time.perf_counter()
        clock.start()
        rot = rots[orbit.index(i)]
        sc = [(rotate_object(o, rot), c) for o, c in prog]
        fb, stats = renderer.render(sc, tr, li, with_stats=True)
        t1 = time.perf_counter()
        return fb, stats, (t1 - t0) * 1e3, clock.stop()

    for i in range(-mix["warm_frames"], 0):
        frame(i)
        marks.append((f"warm frame {i}", time.perf_counter()))
    route = counters(cfg.get("route", {}))
    for wrapper in route.values():
        wrapper.launches = 0
    setup_s = time.perf_counter() - t_start
    log("# set-up, s from the start: " + ", ".join(
        f"{k} {t - t_start:.3f}" for k, t in marks))

    sampler = Reservoir(mix["check"]["frames"], rng(seed, "sample"))
    drops, lat, enq, failed, i, fb = [], [], [], 0, 0, None
    t0 = time.perf_counter()
    while True:
        try:
            fb, stats, e, ms = frame(i)
        except Exception:  # a frame that raises counts as failed
            failed += 1
            if failed <= FAILED_LOG:
                log(f"# frame {i} raised:\n{traceback.format_exc()}")
        else:
            drops.append(stats.get("bins_dropped", 0))
            enq.append(e)
            lat.append(ms)
            sampler.offer(i, (fb.color, fb.depth))
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    attempted = i
    if lat:
        q = np.percentile(lat, [0, 50, 90, 95, 99, 100])
        log(f"# window: {len(lat)} frames in {window_s:.3f} s; latency ms "
            f"min/p50/p90/p95/p99/max {np.round(q, 4).tolist()}; enqueue "
            f"ms p50 {np.median(enq):.4f}")
    per_frame = [int(d) for d in (torch.stack([torch.as_tensor(
        d, device=dev).reshape(()) for d in drops]).cpu() if drops else [])]
    failed += sum(1 for d in per_frame if d > 0)
    launches = {k: w.launches / max(1, len(lat)) for k, w in route.items()}
    cuda = dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    tr_data, covered = None, None
    if trace:
        tr_data, covered = traced_block(frame, i, mix["trace_frames"], dev,
                                        kept_offsets(mix["trace_frames"]))
    sampled = [(k, (p[0].contiguous().view(torch.int32).cpu().numpy().view(
        np.uint32), p[1].cpu().numpy())) for k, p in sampler.frames()]
    del sampler, fb, renderer, prog, rots
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    bad, compared, ref_cov = check_windows(
        sampled, scene, tr_d, li_d, orbit, height, width, mix, seed,
        workers)
    ref_s = time.perf_counter() - t_ref
    log(f"# reference: {len(sampled)} frames, {compared} px in windows, "
        f"{ref_cov} covered, {bad} differ; {ref_s:.3f} s")

    reading = SimpleNamespace(
        frames=len(lat), attempted=attempted, window_s=window_s,
        latencies_ms=lat, enqueue_ms=enq, setup_s=setup_s, trace=tr_data,
        work=scene_work(cfg, scene, tr_d, height, width, orbit, i, mix,
                        covered) if trace else None,
        peaks=catalog.peaks(torch.cuda.get_device_name(dev)) if cuda
        else None, metric=catalog.metric, yardstick=yardstick,
        trace_segment=lambda first, last, seg: traces.segment_ms(
            tr_data, first, last, seg))
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in catalog.metrics_of(bench, cell["name"], section):
        value = catalog.metric(m["name"]).read(reading) if lat else None
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": None, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if tr_data is not None:
        device_info["busy_s"] = tr_data.busy / 1e6
        device_info["window_s"] = tr_data.window / 1e6
        result["breakdown"] = {"device_ops": traces.top(tr_data.device_ops),
                               "idle_gaps": traces.top(tr_data.idle_gaps)}
    result["route"] = launches
    result["reference_s"] = ref_s
    checks = {
        "differing_px": {"value": bad, "max": 0},
        "dropped_entries": {"value": int(sum(per_frame)), "max": 0},
        "failed_frames": {"value": failed, "max": 0},
        "reference_covered_px": {"value": ref_cov, "min": 1},
    }
    result["correct"] = all(passes(c) for c in checks.values())
    return result, checks


def traced_block(frame, first, n, dev, kept):
    """``n`` frames from index ``first`` under torch.profiler, each in the
    benchmark's span, after TRACE_WARM profiled ones; returns (Trace,
    mean covered px of the marked frames at offsets ``kept``, counted
    outside their spans, no plane held)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    clear = torch.finfo(torch.float32).min
    covered = []
    with profile(activities=acts) as prof:
        for i in range(first, first + TRACE_WARM):
            frame(i)
        for j in range(n):
            with record_function(traces.SPAN):
                fb = frame(first + TRACE_WARM + j)[0]
            if j in kept:
                covered.append(int((fb.depth > clear).sum()))
            del fb
    t = traces.reduce(traces.profiler_events(prof))
    odd = traces.unsplit(t, catalog.metric("setup.device_ms").KERNELS,
                         catalog.metric("raster.device_ms").KERNELS)
    log(f"# trace: {len(t.frames)} frames, device ops a frame "
        f"{[len(f) for f in t.frames]}, {len(odd)} not cut into layers"
        + (f"; the first, frame {odd[0][0]}: {odd[0][1]}" if odd else ""))
    return t, float(np.mean(covered))


def kept_offsets(n):
    """The KEPT_ANGLES traced frames the roofline's counts are read on."""
    return [int(j) for j in np.linspace(0, n - 1, KEPT_ANGLES).round()]


def scene_work(cfg, scene, tr_d, height, width, orbit, first, mix,
               covered):
    """Scene quantities the rooflines count from: triangles, the kept ones
    (the spec's cull, bbox in the frame) and the covered px (the frame's
    own depth plane), each a mean over the KEPT_ANGLES traced frames, and
    the configuration's work terms."""
    kept = []
    for j in kept_offsets(mix["trace_frames"]):
        rot = orbit.matrices[orbit.index(first + TRACE_WARM + j)]
        k = 0
        for o, _ in scene:
            proj, vis = ref.projected(ref.rotate(o, rot), tr_d)
            k += int(ref.visible_in_frame(proj, vis, height, width).sum())
        kept.append(k)
    return dict(cfg.get("work", {}), triangles=scenes.triangles(scene),
                kept_triangles=float(np.mean(kept)), covered_px=covered,
                height=height, width=width,
                textured=any("texture" in c for _, c in scene),
                lights=len(cfg["lights"]["positions"]))


def passes(c: dict) -> bool:
    return (c["value"] <= c.get("max", math.inf)
            and c["value"] >= c.get("min", -math.inf))


def check_lines(checks: dict) -> list:
    out = []
    for k, c in checks.items():
        lim = (f"<= {c['max']}" if "max" in c else f">= {c['min']}")
        out.append(f"check {k} {c['value']} {lim} "
                   f"{'ok' if passes(c) else 'FAILED'}")
    return out


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start) -> int:
    args = parse(argv)
    bench = catalog.benchmark()
    cell = catalog.workload(bench, args.workload)
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        log(f"# {args.workload} needs {cell['chips']} CUDA device(s), found "
            f"{found}: no result")
        return 2
    torch.set_num_threads(2)
    result, checks = run_cell(bench, cell, args.seed, args.seconds,
                              args.trace, "cuda", t_start)
    from tpu_renderer_torch import _cuda

    log(f"# {args.workload} seed {args.seed} {args.seconds} s trace "
        f"{args.trace}; {power_line()}; torch {torch.__version__}, cuda "
        f"{torch.version.cuda}")
    log(f"# kernel library: cached {_cuda.build_info.get('cached')}, nvcc "
        f"{_cuda.build_info.get('seconds')} s")
    bad = loaded_forbidden()
    if bad:
        log(f"# the process loaded {bad}: no result")
        return 3
    for line in check_lines(checks):
        log(line)
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0
