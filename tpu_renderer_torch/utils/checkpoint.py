"""Scene / framebuffer serialization (the renderer is stateless per frame,
so "checkpoint/resume" means saving and restoring scenes, camera and light
setups, and rendered frames).

PyTorch counterpart of ``tpu_renderer.utils.checkpoint``: plain .npz
files with the same keys and layouts, so each package reads the other's.
Loading puts the tensors on ``device``, the card unless the caller asks
for the CPU.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..core.types import (
    Framebuffer,
    LightData,
    ObjectConfig,
    ProjectiveTransform,
    classic_arrays,
    make_lights,
    make_object,
    make_transform,
    resolve_device,
)


def _u32(t: torch.Tensor) -> np.ndarray:
    """A u32 tensor (texture, colour) as a NumPy u32 array."""
    return t.view(torch.int32).cpu().numpy().view(np.uint32)


def save_scene(path, scene, transform: ProjectiveTransform,
               lights: LightData) -> None:
    """Save (scene, transform, lights) to an .npz file; scene is a list of
    (RenderObject, ObjectConfig). Vertices go in the classic (V, C)
    vertex-major form, a layout independent of the device's."""
    blobs, meta = {}, []
    for i, (obj, cfg) in enumerate(scene):
        classic = classic_arrays(obj)
        blobs[f"obj{i}_p"] = obj.p.cpu().numpy()
        for name in ("vertices", "colors", "normals", "uvs"):
            blobs[f"obj{i}_{name}"] = classic[name]
        if obj.texture is not None:
            blobs[f"obj{i}_texture"] = _u32(obj.texture)
        meta.append(dict(phong=cfg.phong, textured=cfg.textured,
                         uv_mode=cfg.uv_mode, filter_mode=cfg.filter_mode,
                         has_texture=obj.texture is not None))
    blobs["transform"] = np.array(
        [float(transform.distance_above_target),
         float(transform.focal_length), float(transform.meters_to_pixels),
         float(transform.screen_center[0]), float(transform.screen_center[1])],
        np.float32)
    blobs["ambient"] = lights.ambient.cpu().numpy()
    blobs["light_p"] = lights.light_p.cpu().numpy()
    blobs["light_intensity"] = lights.light_intensity.cpu().numpy()
    blobs["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **blobs)


def load_scene(path, device="cuda"):
    """Load a scene saved by either package's save_scene -> (scene,
    transform, lights) on ``device``."""
    device = resolve_device(device)
    data = np.load(path)
    meta = json.loads(bytes(data["meta"]).decode())
    scene = []
    for i, m in enumerate(meta):
        obj = make_object(
            data[f"obj{i}_p"], data[f"obj{i}_vertices"],
            data[f"obj{i}_colors"], data[f"obj{i}_normals"],
            data[f"obj{i}_uvs"],
            data[f"obj{i}_texture"] if m["has_texture"] else None,
            device=device)
        cfg = ObjectConfig(phong=m["phong"], textured=m["textured"],
                           uv_mode=m["uv_mode"],
                           filter_mode=m.get("filter_mode", "nearest"))
        scene.append((obj, cfg))
    t = data["transform"]
    transform = make_transform(float(t[0]), float(t[1]), float(t[2]),
                               (float(t[3]), float(t[4])), device=device)
    lights = make_lights(data["ambient"], data["light_p"],
                         data["light_intensity"], device=device)
    return scene, transform, lights


def save_framebuffer(path, fb: Framebuffer) -> None:
    np.savez_compressed(path, color=_u32(fb.color),
                        depth=fb.depth.cpu().numpy())


def load_framebuffer(path, device="cuda") -> Framebuffer:
    """A framebuffer saved by either package, on ``device``."""
    device = resolve_device(device)
    data = np.load(path)
    color = np.asarray(data["color"], np.uint32).view(np.int32)
    return Framebuffer(
        color=torch.from_numpy(color.copy()).to(device).view(torch.uint32),
        depth=torch.from_numpy(np.asarray(data["depth"], np.float32)).to(
            device))
