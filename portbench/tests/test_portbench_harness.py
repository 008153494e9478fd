"""The harness end to end on the CPU, the look for a card skipped: a sound
run is correct, and every fault the cells can have, planted under the
timed path, turns ``correct`` false. Without a card the command fails and
prints no result."""

import glob
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import catalog, harness

BENCH = catalog.benchmark()
SEED = 2 ** 31 + 77


def small(cell):
    """The cell's configuration and mix at a CPU test's size."""
    w = catalog.workload(BENCH, cell)
    cfg = catalog.config(w["config"])
    for obj in cfg["objects"]:
        obj["mesh"][0].update(lat=20, lon=21)
        if obj.get("texture"):
            obj["texture"].update(height=64, width=64, cell=8)
    mix = dict(catalog.traffic(w["traffic"]), height=72, width=128,
               warm_frames=1, trace_frames=2)
    return w, cfg, mix


def run(cell, trace=0, seconds=0.3):
    w, cfg, mix = small(cell)
    return harness.run_cell(BENCH, w, SEED, seconds, trace, device="cpu",
                            config=cfg, mix=mix, workers=2)


CELLS = ["sphere1m_phong.orbit_1080p", "sphere1m_deferred.orbit_2160p"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result, checks = run(cell)
    assert result["correct"], checks
    assert checks["differing_px"]["value"] == 0
    assert checks["reference_covered_px"]["value"] > 0
    assert set(result["metrics"]) == {
        m["name"] for m in catalog.metrics_of(BENCH, cell, "end_to_end")}
    assert result["attempted"] >= 1 and result["failed"] == 0


def children():
    """Live child processes of this one, from /proc (Linux)."""
    out = []
    for stat in glob.glob("/proc/[0-9]*/stat"):
        try:
            with open(stat) as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == os.getpid() and fields[0] != "Z":
            out.append(stat)
    return out


def test_a_run_leaves_no_process_behind():
    before = children()
    result, _ = run(CELLS[0])
    assert result["correct"]
    assert children() == before


def test_traced_run_is_correct_and_reads_the_trace():
    result, checks = run(CELLS[0], trace=1)
    assert result["correct"], checks
    assert "host_enqueue_ms" in result["metrics"]
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def unrotated(monkeypatch):
    """A step that returns its state unchanged: the rotation."""
    from tpu_renderer_torch.geometry import transform

    monkeypatch.setattr(transform, "rotate_object", lambda obj, rot: obj)


def stale_frame(monkeypatch):
    """A step that returns its state unchanged: every frame the first."""
    import tpu_renderer_torch as trt

    real, first = trt.Renderer.render, {}

    def render(self, scene, transform, lights, with_stats=False):
        if "fb" not in first:
            first["fb"] = real(self, scene, transform, lights, True)
        return first["fb"]
    monkeypatch.setattr(trt.Renderer, "render", render)


def half_batch(monkeypatch):
    """Half of the batch left out: the second half of each object's
    triangles never drawn."""
    import tpu_renderer_torch as trt

    real = trt.Renderer.render

    def render(self, scene, transform, lights, with_stats=False):
        half = []
        for o, c in scene:
            t = o.vertices.shape[2] // 2
            half.append((o._replace(**{k: getattr(o, k)[..., :t] for k in (
                "vertices", "colors", "normals", "uvs")}), c))
        return real(self, half, transform, lights, with_stats)
    monkeypatch.setattr(trt.Renderer, "render", render)


def altered_answer(monkeypatch):
    """An answer altered where it is produced: one bit of every frame's
    blue channel flipped as the frame is returned."""
    import tpu_renderer_torch as trt

    real = trt.Renderer.render

    def render(self, scene, transform, lights, with_stats=False):
        fb, stats = real(self, scene, transform, lights, True)
        color = (fb.color.view(torch.int32) ^ 1).view(torch.uint32)
        return fb._replace(color=color), stats
    monkeypatch.setattr(trt.Renderer, "render", render)


@pytest.mark.parametrize("fault", [unrotated, stale_frame, half_batch,
                                   altered_answer])
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(monkeypatch, fault, cell):
    fault(monkeypatch)
    result, checks = run(cell)
    assert not result["correct"]
    assert checks["differing_px"]["value"] > 0


def test_drops_are_not_correct(monkeypatch):
    import tpu_renderer_torch as trt

    real = trt.Renderer.render

    def render(self, scene, transform, lights, with_stats=False):
        fb, stats = real(self, scene, transform, lights, True)
        return fb, dict(stats, bins_dropped=torch.tensor(3))
    monkeypatch.setattr(trt.Renderer, "render", render)
    result, checks = run(CELLS[0])
    assert not result["correct"]
    assert checks["dropped_entries"]["value"] > 0
    assert result["failed"] == result["attempted"]


def no_card_env():
    return dict(os.environ, CUDA_VISIBLE_DEVICES="")


def test_without_a_card_the_command_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=catalog.CHECKOUT, capture_output=True, text=True, timeout=300,
        env=no_card_env())
    assert out.returncode != 0
    assert not out.stdout.strip()
    assert "no result" in out.stderr


def test_the_benchmark_alone_fails_and_prints_no_result(tmp_path):
    shutil.copy(catalog.CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(catalog.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_imports_leave_out_jax_and_the_jax_package():
    """In a fresh process: the harness, every reader and generator and the
    program's modules a run loads hold no top-level name jax, jaxlib, flax
    or tpu_renderer; the reference alone holds no tpu_renderer_torch and
    no torch."""
    code = """
import sys
sys.path.insert(0, %r)
from portbench import catalog, harness
import tpu_renderer_torch, tpu_renderer_torch.engine.renderer
import tpu_renderer_torch.geometry.transform, tpu_renderer_torch.ops.gbuffer
import tpu_renderer_torch._cuda
bench = catalog.benchmark()
for s in ("end_to_end", "per_layer"):
    for m in bench[s]:
        catalog.metric(m["name"])
for c in bench["configs"]:
    for o in catalog.config(c["name"])["objects"]:
        for p in o["mesh"] + ([o["texture"]] if o.get("texture") else []):
            catalog.generator(p["kind"])
import torch.profiler
print(sorted({m.split(".")[0] for m in sys.modules}))
""" % str(catalog.CHECKOUT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not top & set(harness.FORBIDDEN)
    assert "tpu_renderer_torch" in top
    code = """
import sys
sys.path.insert(0, %r)
import portbench.reference.frame, portbench.reference.spec
print(sorted({m.split(".")[0] for m in sys.modules}))
""" % str(catalog.CHECKOUT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not top & (set(harness.FORBIDDEN) | {"tpu_renderer_torch",
                                                "torch"})


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
        cwd=catalog.CHECKOUT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_comparison(cell):
    """The bfloat16 reference in the program's place, on a run's windows
    at a test's size: differing pixels on every seed."""
    from portbench import scene as scenes
    from portbench import traffic as traffics

    _, cfg, mix = small(cell)
    h, w = mix["height"], mix["width"]
    for seed in (1, 2, 3):
        sg, tr, li = scenes.build(cfg, h, w, harness.rng(seed, "scene"))
        orbit = traffics.Orbit(mix, harness.rng(seed, "orbit"))
        sampled = [(i, None) for i in (4, 9)]
        bad, compared, covered = harness.check_windows(
            sampled, sg, tr, li, orbit, h, w, mix, seed, workers=2,
            lower=True)
        assert covered > 0 and bad > 0
