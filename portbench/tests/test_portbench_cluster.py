"""The sphere_cluster configuration and its cell: the scene it builds, the
ConstructSphere generator against the port's model, a run of the cell on
the CPU at a test's size (correct, and the bfloat16 control not), and the
readers of the ``tr.scene`` span (``scene.host_ms``, ``scene.launches``)."""

from types import SimpleNamespace

import numpy as np
import pytest

from portbench import catalog, harness, scene as scenes, spans
from portbench import traffic as traffics

BENCH = catalog.benchmark()
CELL = "sphere_cluster.orbit_1080p"
SEED = 2 ** 31 + 1021
READERS = ("scene.host_ms", "scene.launches")


def small():
    """The cell's configuration and mix at a test's size: the backdrop,
    every 17th sphere grid cut to 16 x 16, every 5th reference sphere,
    12,930 triangles (over 4096, so the scene-wide setup runs) on a 72 x
    128 frame."""
    w = catalog.workload(BENCH, CELL)
    cfg = catalog.config(w["config"])
    objs = cfg["objects"]
    cfg["objects"] = [objs[0]] + objs[1:121:17] + objs[121::5]
    for obj in cfg["objects"][1:9]:
        obj["mesh"][0].update(lat=16, lon=16)
    mix = dict(catalog.traffic(w["traffic"]), height=72, width=128,
               warm_frames=1, trace_frames=2)
    return w, cfg, mix


def test_the_config_builds_137_objects_of_1m_triangles():
    cfg = catalog.config("sphere_cluster")
    sg, _, _ = scenes.build(cfg, 1080, 1920, harness.rng(SEED, "scene"))
    assert len(sg) == 137
    assert scenes.triangles(sg) == cfg["triangles"] == 1_018_370
    kinds = [(c["phong"], "texture" in c) for _, c in sg]
    assert kinds == [(False, True)] + [(True, False)] * 120 + [
        (False, False)] * 16
    assert [len(o["vertices"]) // 3 for o, _ in sg[1:]] == (
        [8192] * 120 + [2208] * 16)
    assert sg[0][1]["filter_mode"] == "bilinear"
    assert sg[0][1]["texture"].shape == (64, 64)


def test_the_generator_at_scale_1_is_construct_sphere():
    from tpu_renderer_torch.models.sphere import construct_sphere

    got = catalog.generator("construct_sphere").build({"scale": 1.0}, None)
    want = construct_sphere()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k].view(np.uint32),
                                      want[k].view(np.uint32))
    fifth = catalog.generator("construct_sphere").build({"scale": 0.2}, None)
    np.testing.assert_array_equal(
        fifth["vertices"], (want["vertices"] * np.float32(0.2)))
    assert np.abs(fifth["vertices"]).max() == np.float32(0.1)


def test_a_small_run_is_correct():
    w, cfg, mix = small()
    sg, _, _ = scenes.build(cfg, 72, 128, harness.rng(SEED, "scene"))
    assert scenes.triangles(sg) == 12_930
    result, checks = harness.run_cell(BENCH, w, SEED, 0.3, 1, device="cpu",
                                      config=cfg, mix=mix, workers=2)
    assert result["correct"], checks
    assert checks["reference_covered_px"]["value"] > 0
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["route"]) == set(cfg["route"])


def test_the_control_fails_the_comparison():
    _, cfg, mix = small()
    h, w = mix["height"], mix["width"]
    for seed in (1, 2):
        sg, tr, li = scenes.build(cfg, h, w, harness.rng(seed, "scene"))
        orbit = traffics.Orbit(mix, harness.rng(seed, "orbit"))
        bad, _, covered = harness.check_windows(
            [(i, None) for i in (4, 9)], sg, tr, li, orbit, h, w, mix, seed,
            workers=2, lower=True)
        assert covered > 0 and bad > 0


def test_the_host_block_reads_the_scene_span(monkeypatch):
    """The span blocks on the CPU at a test's size: the host block holds
    ``tr.scene`` beside the layers' spans."""
    _, cfg, mix = small()
    monkeypatch.setattr(catalog, "config", lambda name: cfg)
    monkeypatch.setattr(catalog, "traffic", lambda name: mix)
    got = spans.measure_cell(CELL, SEED, 5, "cpu")
    assert set(got.host_ms) == set(spans.LAYERS.values()) - {"tr.shade"} | {
        "tr.scene"}
    assert got.host_ms["tr.scene"] > 0


@pytest.mark.parametrize("name", READERS)
def test_the_scene_readers(monkeypatch, name):
    """Each reads the span by its name from the blocks, and nothing where
    the blocks read nothing or the span never ran (as on the parent of
    the span)."""
    read = catalog.metric(name).read
    r = SimpleNamespace(trace=None)
    assert read(r) is None
    credit = spans.Credit(frames=2, ops=[9, 9],
                          launches={"tr.scene": 1.0, "tr.setup": 7.0},
                          spans={"tr.scene", "tr.setup"})
    want = {"scene.host_ms": 0.75, "scene.launches": 1.0}
    for got, value in (
            (spans.Blocks(credit, {"tr.scene": 0.75}, 5.0, 4.0), want[name]),
            (spans.Blocks(spans.Credit(frames=2, ops=[8, 8], spans={
                "tr.setup"}), {"tr.setup": 0.5}, 5.0, 4.0), None),
            (None, None)):
        monkeypatch.setattr(spans, "blocks", lambda r, got=got: got)
        assert read(r) == value
