"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import re

import pytest

from portbench import catalog

BENCH = catalog.benchmark()
LINE = re.compile(r"[^\n\t]{1,200}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_size():
    assert set(BENCH) == KEYS
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_have_the_contract_keys(section, keys):
    for e in BENCH[section]:
        assert set(e) - {"workloads"} == keys, e["name"]


def test_names_and_units():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[section]:
            assert catalog.NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert LINE.match(e[k]), (e["name"], k)
    for section in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[section]}) == len(
            BENCH[section])
    metrics = [e["name"] for s in ("end_to_end", "per_layer")
               for e in BENCH[s]]
    assert len(set(metrics)) == len(metrics)
    for w in BENCH["workloads"]:
        assert catalog.NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        if m["name"].endswith("roofline"):
            assert m["unit"] == "%"


def test_configs_found_by_name():
    import numpy as np

    from portbench import scene

    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = catalog.config(c["name"])
        sg, _, _ = scene.build(cfg, 1080, 1920, np.random.default_rng(0))
        assert scene.triangles(sg) == cfg["triangles"]
        assert cfg["name"] == c["name"]
        assert c["reduced"] == []
        for obj in cfg["objects"]:
            for part in obj["mesh"]:
                catalog.generator(part["kind"])
            if obj.get("texture"):
                catalog.generator(obj["texture"]["kind"])


def test_cells_found_by_name_and_report_enough():
    configs = {c["name"] for c in BENCH["configs"]}
    used = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs
        used.add(w["config"])
        mix = catalog.traffic(w["traffic"])
        assert mix["name"] == w["traffic"]
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        e2e = [m["name"] for m in catalog.metrics_of(
            BENCH, w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert catalog.metrics_of(BENCH, w["name"], "per_layer")
    assert used == configs
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_metric_readers_found_by_name():
    names = {w["name"] for w in BENCH["workloads"]}
    for section in ("end_to_end", "per_layer"):
        for m in BENCH[section]:
            assert callable(catalog.metric(m["name"]).read)
            assert set(m.get("workloads", [])) <= names


def test_a_new_cell_needs_only_files_and_an_entry(tmp_path, monkeypatch):
    """A traffic mix and a metric reader added as files are found by the
    names an entry gives, with no file of the harness changed."""
    here = tmp_path / "portbench"
    for d in ("configs", "traffic", "metrics", "generators"):
        (here / d).mkdir(parents=True)
    (here / "traffic" / "orbit_720p.json").write_text(json.dumps(
        dict(catalog.traffic("orbit_1080p"), name="orbit_720p",
             height=720, width=1280)))
    (here / "metrics" / "frames.count.py").write_text(
        "def read(r):\n    return r.frames\n")
    monkeypatch.setattr(catalog, "HERE", here)
    monkeypatch.setattr(catalog, "_modules", {})
    assert catalog.traffic("orbit_720p")["height"] == 720
    assert catalog.metric("frames.count").read(
        type("R", (), {"frames": 7})()) == 7
    with pytest.raises(ValueError):
        catalog.config("../BENCHMARK")
