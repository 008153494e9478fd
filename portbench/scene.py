"""Builds a configuration's scene on the host, in NumPy: the golden form
that both the program (through its own constructors) and the reference
are handed."""

from __future__ import annotations

import numpy as np

from . import catalog

F = np.float32
MESH_KEYS = ("vertices", "colors", "normals", "uvs")


def camera(cfg: dict, height: int, width: int) -> dict:
    """The configuration's camera for a height x width frame: its scale
    follows min(height, width), so a scene covers the same share of every
    frame, and it looks at the frame's centre."""
    cam = cfg["camera"]
    return dict(
        distance_above_target=float(cam["distance_above_target"]),
        focal_length=float(cam["focal_length"]),
        meters_to_pixels=float(cam["m2p_scale"] * min(height, width)),
        screen_center=(width / 2.0, height / 2.0),
    )


def lights(cfg: dict) -> dict:
    li = cfg["lights"]
    return dict(ambient=np.asarray(li["ambient"], F),
                light_p=np.asarray(li["positions"], F).reshape(-1, 3),
                light_intensity=np.asarray(li["intensities"], F).reshape(
                    -1, 4))


def build(cfg: dict, height: int, width: int, rng):
    """(scene, transform dict, lights dict): the scene a list of (object
    dict: p and the (V, C) f32 mesh arrays, config dict: phong, texture,
    uv_mode, filter_mode), each object's mesh the concatenation of its
    parts, each made by ``generators/<kind>.py``."""
    scene = []
    for obj in cfg["objects"]:
        parts = [catalog.generator(p["kind"]).build(p, rng)
                 for p in obj["mesh"]]
        mesh = {k: np.concatenate([m[k] for m in parts]).astype(F)
                for k in MESH_KEYS}
        oc = {"phong": bool(obj.get("phong", False)),
              "uv_mode": obj.get("uv_mode", "scalar"),
              "filter_mode": obj.get("filter_mode", "nearest")}
        if obj.get("texture"):
            tex = obj["texture"]
            oc["texture"] = catalog.generator(tex["kind"]).build(tex, rng)
        scene.append((dict(p=tuple(obj.get("p", (0.0, 0.0, 0.0))), **mesh),
                      oc))
    return scene, camera(cfg, height, width), lights(cfg)


def triangles(scene) -> int:
    return sum(len(o["vertices"]) // 3 for o, _ in scene)
