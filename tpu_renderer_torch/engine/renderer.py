"""Frame orchestration: the public ``Renderer`` API of the port.

PyTorch counterpart of ``tpu_renderer.engine.renderer``'s fused branch.
One object: the vertex stage writes its record table (the K1 kernel from
4096 triangles up, the small-object chain below), the sorted binning runs
as torch ops, and one raster kernel (K2, K3 or K4 by route) rasterizes,
shades and packs ARGB. Several objects render in ONE raster launch
(``prepare_scene``): their tables concatenate with global triangle
ids and the kernel picks each pixel's object from the winner's id. The
device of the scene's tensors picks the implementation: CUDA tensors
launch the kernels, CPU tensors run their plain versions. PyTorch runs
eagerly, so nothing is compiled per scene signature.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..core.types import (
    Framebuffer,
    LightData,
    ObjectConfig,
    ProjectiveTransform,
    RenderObject,
    make_framebuffer,
    resolve_device,
)
from ..geometry.vertex import setup_records
from ..ops.binning import triangle_bbox_rows
from ..ops.raster import (
    ObjSpec,
    RasterLaunch,
    finish_records,
    prepare_raster,
    run_shaded,
)
from ..ops.setup import FUSED_SETUP_MIN, SetupOut, setup_for_raster

_OBJ_PAD = 128  # each object's table pads its triangle axis to this


def _merge_into(framebuffer: Framebuffer | None, covered, z, packed):
    """The draw's outputs as a fresh frame (the raster outputs already
    carry the clear values on uncovered pixels), or merged over
    ``framebuffer`` with the strict '>' depth test."""
    if framebuffer is None:
        return Framebuffer(color=packed, depth=z)
    win = covered & (z > framebuffer.depth)
    color = torch.where(win, packed.view(torch.int32),
                        framebuffer.color.view(torch.int32))
    return Framebuffer(color=color.view(torch.uint32),
                       depth=torch.where(win, z, framebuffer.depth))


def _merge_stats(stats: dict | None, rstats: dict) -> None:
    """Accumulate one draw's raster stats: counters sum, budget utilization
    and the policy factor take the max over draws."""
    if stats is None:
        return
    if not stats:
        stats.update(rstats)
        return
    for key in ("bins_dropped", "bins_real_entries"):
        stats[key] = stats[key] + rstats[key]
    stats["bins_budget_utilization"] = torch.maximum(
        stats["bins_budget_utilization"], rstats["bins_budget_utilization"])
    stats["bins_budget_factor"] = max(stats["bins_budget_factor"],
                                      rstats["bins_budget_factor"])


def _scene_table(scene, transform: ProjectiveTransform, lights: LightData,
                 frame_height: int, frame_width: int):
    """(table, objspecs) of several untextured objects in ONE launch
    (renderer.py:229): their record tables concatenate into a scene-global
    table whose gid lanes carry the submission order, and the kernel shades
    each pixel by its winner's object (static gid ranges).

    One setup form for the whole scene: from FUSED_SETUP_MIN triangles in
    all, each object goes through setup_for_raster (K1 for large objects;
    small ones take setup_records -> pad to 128 -> K7 -> bboxes from the
    channel-major rows); below it, every object takes setup_records, padded
    to 128, and the concatenated table goes through one K7 in the raster
    stage. Pad rows are invalid records that never win; the next object's
    gids start after them (gid += T + pad)."""
    fused_setup = sum(o.num_triangles for o, _ in scene) >= FUSED_SETUP_MIN
    tables, bboxes, objspecs = [], [], []
    gid = true_t = 0
    for obj, cfg in scene:
        T = obj.num_triangles
        if fused_setup:
            out = setup_for_raster(obj, transform, lights, cfg, gid0=gid,
                                   frame_height=frame_height,
                                   frame_width=frame_width)
            if isinstance(out, SetupOut):
                rt, pad = out.recs, out.recs.shape[0] - T
                bboxes.append(out.bbox)
            else:  # small object below the kernel's own threshold
                pad = -T % _OBJ_PAD
                rt_cm = torch.nn.functional.pad(out, (0, pad))
                rt = finish_records(rt_cm)[:T + pad]
                bboxes.append(triangle_bbox_rows(rt_cm, frame_height,
                                                 frame_width))
        else:
            pad = -T % _OBJ_PAD
            rt = torch.nn.functional.pad(
                setup_records(obj, transform, lights, cfg, gid0=gid),
                (0, pad))
        tables.append(rt)
        objspecs.append(ObjSpec(gid, gid + T, cfg.phong))
        gid += T + pad
        true_t += T
    if fused_setup:
        table = SetupOut(torch.cat(tables),
                         [torch.cat(parts) for parts in zip(*bboxes)],
                         true_t)
    else:
        table = torch.cat(tables, dim=1)
    return table, tuple(objspecs)


def prepare_scene(scene: Sequence[Tuple[RenderObject, ObjectConfig]],
                  transform: ProjectiveTransform, lights: LightData,
                  height: int, width: int, frame_height: int | None = None,
                  frame_width: int | None = None) -> RasterLaunch:
    """The one raster launch that draws ``scene`` into a (height, width)
    rect of a (frame_height, frame_width) frame: its route, kernel and
    operands, with the setup already run (FillEdgeTable, SURVEY.md §1.1).
    One object takes setup_for_raster (K1 from 4096 triangles, else the
    channel-major table of setup_records); several untextured objects take
    one scene-global table (``_scene_table``)."""
    if any(cfg.textured for _, cfg in scene):
        raise NotImplementedError(
            "textured objects belong to the texturing slice of the port")
    frame_height = height if frame_height is None else frame_height
    frame_width = width if frame_width is None else frame_width
    if len(scene) == 1:
        (obj, cfg), = scene
        table = setup_for_raster(obj, transform, lights, cfg,
                                 frame_height=frame_height,
                                 frame_width=frame_width)
        objspecs = (ObjSpec(0, obj.num_triangles, cfg.phong),)
    else:
        table, objspecs = _scene_table(scene, transform, lights,
                                       frame_height, frame_width)
    return prepare_raster(table, objspecs, transform, lights, height, width,
                          frame_height, frame_width)


def _draw(framebuffer: Framebuffer | None, scene,
          transform: ProjectiveTransform, lights: LightData,
          frame_height: int | None, frame_width: int | None,
          stats: dict | None) -> Framebuffer:
    """Draw the scene in one raster launch (``prepare_scene``), as a fresh
    frame or merged over ``framebuffer``."""
    if framebuffer is None:
        if frame_height is None or frame_width is None:
            raise ValueError("a fresh frame (framebuffer=None) needs frame "
                             "dims")
        height, width = frame_height, frame_width
    else:
        height, width = framebuffer.height, framebuffer.width
    launch = prepare_scene(scene, transform, lights, height, width,
                           frame_height, frame_width)
    covered, z, packed, rstats = run_shaded(launch, height, width)
    _merge_stats(stats, rstats)
    return _merge_into(framebuffer, covered, z, packed)


def render_object(framebuffer: Framebuffer | None, obj: RenderObject,
                  transform: ProjectiveTransform, lights: LightData,
                  cfg: ObjectConfig, frame_height: int | None = None,
                  frame_width: int | None = None,
                  stats: dict | None = None) -> Framebuffer:
    """Draw one object (FillEdgeTable + DrawModel, SURVEY.md §1.1).

    ``framebuffer=None`` is a fresh zero-cleared frame of (frame_height,
    frame_width): the raster outputs already carry the clear values on
    uncovered pixels and are returned as they are. Otherwise the object
    merges over the framebuffer with the strict '>' depth test."""
    return _draw(framebuffer, [(obj, cfg)], transform, lights, frame_height,
                 frame_width, stats)


def _scene_batchable(scene) -> bool:
    """Whole-scene single-launch eligibility (renderer.py:213): every
    object untextured (textured objects raise until the texturing slice)."""
    return not any(cfg.textured for _, cfg in scene)


def render_scene(framebuffer: Framebuffer | None,
                 scene: Sequence[Tuple[RenderObject, ObjectConfig]],
                 transform: ProjectiveTransform, lights: LightData,
                 frame_height: int | None = None,
                 frame_width: int | None = None,
                 stats: dict | None = None) -> Framebuffer:
    """Draw a list of objects in submission order over one z-buffer
    (renderer.py:351): a scene of several untextured objects renders in one
    raster launch (prepare_scene), otherwise objects draw one after
    another; both give the same frame. ``framebuffer=None`` is a fresh
    (frame_height, frame_width) frame."""
    if framebuffer is None and (frame_height is None or frame_width is None):
        raise ValueError("render_scene(framebuffer=None) needs frame dims")
    if len(scene) > 1 and _scene_batchable(scene):
        return _draw(framebuffer, scene, transform, lights, frame_height,
                     frame_width, stats)
    if framebuffer is None and not scene:
        return make_framebuffer(frame_height, frame_width,
                                device=transform.focal_length.device)
    for obj, cfg in scene:
        framebuffer = render_object(framebuffer, obj, transform, lights,
                                    cfg, frame_height, frame_width, stats)
    return framebuffer


class Renderer:
    """Frame renderer for a fixed frame size on one device.

    ``device`` is where frames are rendered: 'cuda' (the default) launches
    the kernels and raises when no card is present, 'cpu' runs their plain
    versions. The scene's tensors must live there.
    """

    def __init__(self, height: int, width: int, device="cuda"):
        self.height = height
        self.width = width
        self.device = resolve_device(device)

    def render(self, scene: Sequence[Tuple[RenderObject, ObjectConfig]],
               transform: ProjectiveTransform, lights: LightData,
               with_stats: bool = False):
        """Render a fresh frame. with_stats=True also returns the binning
        stats ('bins_dropped' > 0 means entries past the static budget
        were dropped, counted, never silently)."""
        for obj, _ in scene:
            if obj.vertices.device.type != self.device.type:
                raise ValueError(
                    f"scene on {obj.vertices.device}, renderer on "
                    f"{self.device}")
        stats: dict = {}
        fb = render_scene(None, list(scene), transform, lights,
                          frame_height=self.height, frame_width=self.width,
                          stats=stats)
        return (fb, stats) if with_stats else fb
