"""Frame orchestration: the public ``Renderer`` API of the port.

PyTorch counterpart of ``tpu_renderer.engine.renderer``, both branches of
``render_object``:

- fused: the vertex stage writes the object's record table (the K1
  kernel from 4096 triangles up, the small-object chain below), the
  binning runs as torch ops (the mask strategy's per-tile lists up to 512
  triangles, the sorted streams above), and one raster kernel (K6, or K2,
  K3 or K4 by route) rasterizes, samples the texture (K5, 'scalar'
  addressing, nearest or bilinear, within the fused atlas limits), shades
  and packs ARGB. Several such objects render in ONE raster launch
  (``prepare_scene``): their records lie in one table with global
  triangle ids (from 4096 triangles in all, set up by K1's grouped form,
  one launch per kind of object), their textures stack into one atlas,
  and the kernel picks each pixel's object from the winner's id;
- G-buffer: a textured object the fused path cannot take (``uv_mode=
  'avx'``, a texture over the atlas limits) rasterizes into a G-buffer
  (``ops.gbuffer``: K8, or K9 with K10), then ``ops.shading.shade_merge``
  samples, shades and packs it and lays it over the frame with the strict
  '>' merge, one kernel on the card. A scene that holds such an object
  draws object by object.

``backend`` names the draw path: 'kernels' (the default, the JAX
package's 'pallas') is the two branches above; 'reference' (the JAX
package's default) is the pure-tensor oracle: ``setup_triangles`` ->
``ops.raster_reference.rasterize_reference`` -> ``shade`` -> pack ->
merge (``ops.shading.shade_merge_plain``), object by object, O(T * H *
W).

The device of the scene's tensors picks the implementation: CUDA tensors
launch the kernels, CPU tensors run their plain versions. PyTorch runs
eagerly, so nothing is compiled per scene signature.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

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
from ..geometry.transform import resolve_scene
from ..geometry.vertex import setup_records, setup_triangles
from ..ops.gbuffer import rasterize_gbuffer
from ..ops.raster import (
    ObjSpec,
    RasterLaunch,
    pack_texture_atlas,
    prepare_raster,
    run_shaded,
    texture_fits_fused,
)
from ..ops.raster_reference import rasterize_reference
from ..ops.setup import (
    FUSED_SETUP_MIN,
    object_rows,
    plan_scene_setup,
    setup_for_raster,
    setup_scene,
)
from ..ops.shading import merge_over, shade_merge, shade_merge_plain
from ..utils.profiling import annotate

BACKENDS = ("kernels", "reference")


def _merge_into(framebuffer: Framebuffer | None, covered, z, packed):
    """The draw's outputs as a fresh frame (the raster outputs already
    carry the clear values on uncovered pixels), or merged over
    ``framebuffer`` with the strict '>' depth test."""
    if framebuffer is None:
        return Framebuffer(color=packed, depth=z)
    return merge_over(framebuffer, covered, z, packed)


def _merge_stats(stats: dict | None, rstats: dict) -> None:
    """Accumulate one draw's raster stats (renderer.py:39): drops and real
    entries sum; budget utilization takes the max; 'bins_budget_factor'
    keeps the max policy factor over the draws and
    'bins_budget_factor_min' the min. Mask-strategy draws have no stream
    and add only their drops."""
    if stats is None:
        return
    stats["bins_dropped"] = (stats.get("bins_dropped", 0)
                             + rstats["bins_dropped"])
    if "bins_real_entries" not in rstats:  # mask strategy: no stream
        return
    stats["bins_real_entries"] = (stats.get("bins_real_entries", 0)
                                  + rstats["bins_real_entries"])
    util = rstats["bins_budget_utilization"]
    factor = rstats["bins_budget_factor"]
    if "bins_budget_utilization" not in stats:
        stats["bins_budget_utilization"] = util
        stats["bins_budget_factor"] = factor
        stats["bins_budget_factor_min"] = factor
    else:
        stats["bins_budget_utilization"] = torch.maximum(
            stats["bins_budget_utilization"], util)
        stats["bins_budget_factor"] = max(stats["bins_budget_factor"],
                                          factor)
        stats["bins_budget_factor_min"] = min(
            stats["bins_budget_factor_min"], factor)


def _obj_fusable(obj: RenderObject, cfg: ObjectConfig) -> bool:
    """Eligible for the fused path (renderer.py:201): untextured, or
    textured with 'scalar' addressing, nearest or bilinear filtering and a
    texture within the atlas limits."""
    if not cfg.textured:
        return True
    return (cfg.uv_mode == "scalar"
            and cfg.filter_mode in ("nearest", "bilinear")
            and obj.texture is not None
            and texture_fits_fused(*obj.texture.shape))


def _scene_batchable(scene) -> bool:
    """Whole-scene single-launch eligibility (renderer.py:213): every
    object fusable AND the scene atlas within the fused limits."""
    if not all(_obj_fusable(obj, cfg) for obj, cfg in scene):
        return False
    seen, ah, aw = set(), 0, 0
    for obj, cfg in scene:
        if cfg.textured and id(obj.texture) not in seen:
            seen.add(id(obj.texture))
            ah += int(obj.texture.shape[0])
            aw = max(aw, int(obj.texture.shape[1]))
    return texture_fits_fused(ah, aw)


def _tex_spec(slot_off: int, obj: RenderObject, cfg: ObjectConfig):
    """ObjSpec.tex of a textured object whose texture starts at atlas row
    ``slot_off``."""
    th, tw = int(obj.texture.shape[0]), int(obj.texture.shape[1])
    return (slot_off, th, tw) + (
        ("bilinear",) if cfg.filter_mode == "bilinear" else ())


def _scene_table(scene, transform: ProjectiveTransform, lights: LightData,
                 frame_height: int, frame_width: int):
    """(table, objspecs, atlas) of several objects in ONE launch
    (renderer.py:229): their record tables lie one after another in a
    scene-global table whose gid lanes carry the submission order, their
    textures (each distinct tensor once) stack into one atlas, and the
    kernel shades each pixel by its winner's object (static gid ranges).
    The assembly runs in the ``tr.scene`` span.

    One setup form for the whole scene: from FUSED_SETUP_MIN triangles in
    all, ``setup_scene`` sets up every object, small ones included, at its
    rows of one table (``plan_scene_setup``: K1's grouped form, one launch
    per kind of object); below it, every object takes setup_records, and
    the concatenated table goes through one K7 in the raster stage. Either
    way each object's rows are ``object_rows``: its pad rows are invalid
    records that never win, and the next object's gids start after them."""
    with annotate("tr.scene"):
        fused_setup = (sum(o.num_triangles for o, _ in scene)
                       >= FUSED_SETUP_MIN)
        if fused_setup:
            plan = plan_scene_setup(scene, lights.count)
            gids = plan.row0
        else:
            tables, gids, gid = [], [], 0
            for obj, cfg in scene:
                T = obj.num_triangles
                pad = object_rows(T) - T
                tables.append(torch.nn.functional.pad(
                    setup_records(obj, transform, lights, cfg, gid0=gid),
                    (0, pad)))
                gids.append(gid)
                gid += T + pad
        textures, tex_slot, slots = [], {}, []
        for obj, cfg in scene:
            slot = None
            if cfg.textured:
                slot = tex_slot.setdefault(id(obj.texture), len(textures))
                if slot == len(textures):
                    textures.append(obj.texture)
            slots.append(slot)
        atlas, offs = (pack_texture_atlas(textures) if textures
                       else (None, []))
        objspecs = tuple(
            ObjSpec(lo, lo + obj.num_triangles, cfg.phong,
                    None if slot is None else _tex_spec(offs[slot], obj, cfg))
            for (obj, cfg), lo, slot in zip(scene, gids, slots))
        if fused_setup:
            table = setup_scene(plan, transform, lights, frame_height,
                                frame_width)
        else:
            table = torch.cat(tables, dim=1)
        return table, objspecs, atlas


def object_specs(obj: RenderObject, cfg: ObjectConfig):
    """(objspecs, atlas) of one fusable object drawn alone: its gid range
    and Phong flag, and its texture as the whole atlas."""
    atlas, tex = None, None
    if cfg.textured:
        atlas, _ = pack_texture_atlas([obj.texture])
        tex = _tex_spec(0, obj, cfg)
    return (ObjSpec(0, obj.num_triangles, cfg.phong, tex),), atlas


def prepare_scene(scene: Sequence[Tuple[RenderObject, ObjectConfig]],
                  transform: ProjectiveTransform, lights: LightData,
                  height: int, width: int, frame_height: int | None = None,
                  frame_width: int | None = None, row0: int = 0,
                  col0: int = 0, capacity: int | None = None,
                  budget_override: float | None = None,
                  zcull: bool = False, strategy: str = "auto",
                  tile_h: int | None = None) -> RasterLaunch:
    """The one raster launch that draws ``scene`` into the (height, width)
    rect at origin (row0, col0) of a (frame_height, frame_width) frame: its
    route, kernel and operands, with the setup already run (FillEdgeTable,
    SURVEY.md §1.1). One object takes setup_for_raster (K1 from 4096
    triangles, else the channel-major table of setup_records) and its
    texture as the atlas; several objects take one scene-global table and
    atlas (``_scene_table``). Every object must be fusable
    (``_obj_fusable``); the others take the G-buffer path of
    ``render_object``. ``capacity``, ``budget_override``, ``zcull``,
    ``strategy`` and ``tile_h`` go to ``ops.raster.prepare_raster`` (zcull:
    K11 on 8-row tiles, nothing elsewhere; the route knobs, which the
    engine's draws leave to 'auto', force a route)."""
    assert all(_obj_fusable(obj, cfg) for obj, cfg in scene), (
        "prepare_scene is the fused launch; this scene holds an object "
        "for the G-buffer path")
    frame_height = height if frame_height is None else frame_height
    frame_width = width if frame_width is None else frame_width
    if len(scene) == 1:
        (obj, cfg), = scene
        table = setup_for_raster(obj, transform, lights, cfg,
                                 frame_height=frame_height,
                                 frame_width=frame_width)
        objspecs, atlas = object_specs(obj, cfg)
    else:
        table, objspecs, atlas = _scene_table(scene, transform, lights,
                                              frame_height, frame_width)
    return prepare_raster(table, objspecs, transform, lights, height, width,
                          capacity, frame_height, frame_width, row0, col0,
                          strategy, tile_h, atlas, budget_override, zcull)


def _local_rect(framebuffer: Framebuffer | None, frame_height, frame_width):
    """(height, width, frame_height, frame_width) of a draw: the
    framebuffer is the local rect of the frame (a fresh one, None, is the
    whole frame), and the frame's dims default to the rect's
    (renderer.py:103-124)."""
    if framebuffer is None:
        height, width = frame_height, frame_width
    else:
        height, width = framebuffer.height, framebuffer.width
    return (height, width, height if frame_height is None else frame_height,
            width if frame_width is None else frame_width)


def _draw(framebuffer: Framebuffer | None, scene,
          transform: ProjectiveTransform, lights: LightData,
          frame_height: int | None, frame_width: int | None, row0: int,
          col0: int, stats: dict | None, **knobs) -> Framebuffer:
    """Draw the scene in one raster launch (``prepare_scene``, which takes
    the ``knobs`` capacity, budget_override and zcull), as a fresh frame or
    merged over ``framebuffer``, the rect at (row0, col0)."""
    height, width, frame_height, frame_width = _local_rect(
        framebuffer, frame_height, frame_width)
    launch = prepare_scene(scene, transform, lights, height, width,
                           frame_height, frame_width, row0, col0, **knobs)
    covered, z, packed, rstats = run_shaded(launch, height, width)
    _merge_stats(stats, rstats)
    return _merge_into(framebuffer, covered, z, packed)


def _draw_deferred(framebuffer: Framebuffer | None, obj: RenderObject,
                   transform: ProjectiveTransform, lights: LightData,
                   cfg: ObjectConfig, frame_height: int | None,
                   frame_width: int | None, stats: dict | None,
                   backend: str = "kernels", capacity: int | None = None,
                   budget_override: float | None = None, row0: int = 0,
                   col0: int = 0) -> Framebuffer:
    """render_object's deferred branch (renderer.py:167-198): a G-buffer,
    then ``shade_merge``: shade, pack and the strict '>' merge of the
    covered pixels over ``framebuffer`` (a fresh zero-cleared frame when
    None: 'avx' narrows the coverage after shading, so the G-buffer cannot
    stand for the frame), the rect at (row0, col0) of the frame. The
    G-buffer comes from setup_for_raster + ``rasterize_gbuffer`` (K8, or K9
    with K10; with ``capacity`` and ``budget_override``; no zcull, as in
    the JAX package) and is shaded by the kernel on the card or, on the
    'reference' backend, from ``setup_triangles`` + ``rasterize_reference``
    and shaded by the plain chain (``shade_merge_plain``)."""
    height, width, frame_height, frame_width = _local_rect(
        framebuffer, frame_height, frame_width)
    if backend == "reference":
        covered, gbuf = rasterize_reference(
            setup_triangles(obj, transform, lights, cfg), height, width,
            frame_width, row0, col0)
    else:
        table = setup_for_raster(obj, transform, lights, cfg,
                                 frame_height=frame_height,
                                 frame_width=frame_width)
        covered, gbuf, rstats = rasterize_gbuffer(
            table, height, width, capacity, frame_height, frame_width, row0,
            col0, budget_override=budget_override)
        _merge_stats(stats, rstats)
    merge = shade_merge_plain if backend == "reference" else shade_merge
    with annotate("tr.shade"):
        return merge(covered, gbuf, transform, lights, cfg, obj.texture,
                     row0, col0, framebuffer)


def render_object(framebuffer: Framebuffer | None, obj: RenderObject,
                  transform: ProjectiveTransform, lights: LightData,
                  cfg: ObjectConfig, backend: str = "kernels",
                  frame_height: int | None = None,
                  frame_width: int | None = None, row0: int = 0,
                  col0: int = 0, capacity: int | None = None,
                  stats: dict | None = None,
                  budget_override: float | None = None,
                  zcull: bool = False) -> Framebuffer:
    """Draw one object (FillEdgeTable + DrawModel, SURVEY.md §1.1), with
    the JAX package's parameters in its order (renderer.py:84). On the
    'kernels' backend: the fused launch when the object is fusable, else
    the G-buffer path (``_draw_deferred``); on 'reference', the reference
    rasterizer and the deferred shade.

    ``framebuffer`` may be the local rect at origin (row0, col0) of a
    larger (frame_height, frame_width) frame, as a device of a sharded
    frame renders its tile (SURVEY.md §5.8). ``framebuffer=None`` is a
    fresh zero-cleared frame of (frame_height, frame_width): on the fused
    path the raster outputs already carry the clear values on uncovered
    pixels and are returned as they are. Otherwise the object merges over
    the framebuffer with the strict '>' depth test. ``capacity`` is the
    mask strategy's per-tile list length, ``budget_override`` the sorted
    strategy's budget factor (both in ``stats``' terms: drops are
    counted); ``zcull`` launches K11 on the fused 8-row routes and does
    nothing on K4, K6, the G-buffer path (renderer.py:182-185 never passes
    it there) and 'reference'."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend: {backend}")
    if framebuffer is None and (frame_height is None or frame_width is None):
        raise ValueError("a fresh frame (framebuffer=None) needs frame dims")
    if backend == "reference" or not _obj_fusable(obj, cfg):
        return _draw_deferred(framebuffer, obj, transform, lights, cfg,
                              frame_height, frame_width, stats, backend,
                              capacity, budget_override, row0, col0)
    return _draw(framebuffer, [(obj, cfg)], transform, lights, frame_height,
                 frame_width, row0, col0, stats, capacity=capacity,
                 budget_override=budget_override, zcull=zcull)


def render_scene(framebuffer: Framebuffer | None,
                 scene: Sequence[Tuple[RenderObject, ObjectConfig]],
                 transform: ProjectiveTransform, lights: LightData,
                 backend: str = "kernels", frame_height: int | None = None,
                 frame_width: int | None = None, row0: int = 0,
                 col0: int = 0, capacity: int | None = None,
                 stats: dict | None = None,
                 budget_override: float | None = None,
                 zcull: bool = False) -> Framebuffer:
    """Draw a list of objects in submission order over one z-buffer
    (renderer.py:351, same parameters in the same order): on the
    'kernels' backend a scene of several fusable objects whose atlas fits
    renders in one raster launch (prepare_scene), otherwise objects draw
    one after another (fused, G-buffer or reference each); both give the
    same frame. ``framebuffer=None`` is a fresh (frame_height,
    frame_width) frame; the origin and knobs are ``render_object``'s.
    The scene's pending rotations (``rotate_object``) are computed first,
    together (``geometry.transform.resolve_scene``)."""
    if framebuffer is None and (frame_height is None or frame_width is None):
        raise ValueError("render_scene(framebuffer=None) needs frame dims")
    scene = resolve_scene(scene)
    knobs = dict(capacity=capacity, budget_override=budget_override,
                 zcull=zcull)
    if backend == "kernels" and len(scene) > 1 and _scene_batchable(scene):
        return _draw(framebuffer, scene, transform, lights, frame_height,
                     frame_width, row0, col0, stats, **knobs)
    if framebuffer is None and not scene:
        return make_framebuffer(frame_height, frame_width,
                                device=transform.focal_length.device)
    for obj, cfg in scene:
        framebuffer = render_object(framebuffer, obj, transform, lights,
                                    cfg, backend, frame_height, frame_width,
                                    row0, col0, capacity, stats,
                                    budget_override, zcull)
    return framebuffer


class Renderer:
    """Frame renderer for a fixed frame size on one device.

    The JAX package's Renderer's parameters in its order (renderer.py:405),
    then ``device``: ``backend`` 'kernels' (the default here; the JAX
    package's 'pallas') or 'reference' (the JAX package's default; both
    give the same frame within the parity budgets, only the speed
    differs); ``clear_color``, the u32 ARGB the frame is cleared to (0
    renders straight into a fresh frame, anything else merges over a
    cleared one); ``capacity``, the mask strategy's per-tile list length;
    ``budget_factor``, the sorted strategy's entry budget in place of the
    policy's (set, or measured by ``calibrate``); ``zcull``, the occlusion
    skip (K11) on the fused 8-row routes, bit-exact, worth it on
    depth-complex scenes drawn front to back.

    ``device`` is where frames are rendered: 'cuda' (the default) launches
    the kernels and raises when no card is present, 'cpu' runs their plain
    versions. The scene's tensors must live there.
    """

    def __init__(self, height: int, width: int, backend: str = "kernels",
                 clear_color: int = 0, capacity: int | None = None,
                 budget_factor: float | None = None, zcull: bool = False,
                 device="cuda"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend: {backend}")
        self.height = height
        self.width = width
        self.device = resolve_device(device)
        self.backend = backend
        self.clear_color = clear_color
        self.capacity = capacity
        self.budget_factor = budget_factor
        self.zcull = zcull

    def render(self, scene: Sequence[Tuple[RenderObject, ObjectConfig]],
               transform: ProjectiveTransform, lights: LightData,
               with_stats: bool = False):
        """Render a frame. with_stats=True also returns the binning stats
        ('bins_dropped' > 0 means entries past the static budget or the
        list capacity were dropped, counted, never silently; the
        'reference' backend bins nothing and reports nothing)."""
        with annotate("tr.render"):
            for obj, _ in scene:
                if obj.device.type != self.device.type:
                    raise ValueError(
                        f"scene on {obj.device}, renderer on {self.device}")
            fb = (None if self.clear_color == 0 else make_framebuffer(
                self.height, self.width, self.clear_color,
                device=self.device))
            stats: dict = {}
            fb = render_scene(fb, list(scene), transform, lights,
                              self.backend, self.height, self.width,
                              capacity=self.capacity, stats=stats,
                              budget_override=self.budget_factor,
                              zcull=self.zcull)
            return (fb, stats) if with_stats else fb

    def calibrate(self, scene: Sequence[Tuple[RenderObject, ObjectConfig]],
                  transform: ProjectiveTransform, lights: LightData,
                  margin: float = 1.25) -> Optional[float]:
        """Tighten this renderer's entry budget from one representative
        frame (renderer.py:469): render ``scene`` at the current budget,
        take ``_suggest_budget_factor``'s suggestion, keep it only if a
        re-render at it drops nothing (else revert). Returns the applied
        factor, or None when nothing changed."""
        _, stats = self.render(scene, transform, lights, with_stats=True)
        suggestion = _suggest_budget_factor(stats, margin)
        if suggestion is None:
            return None
        prev = self.budget_factor
        self.budget_factor = suggestion
        _, stats2 = self.render(scene, transform, lights, with_stats=True)
        if int(stats2["bins_dropped"]) > 0:
            self.budget_factor = prev
            return None
        return suggestion


def _suggest_budget_factor(stats: dict, margin: float) -> Optional[float]:
    """max policy factor * max stream utilization * margin from one
    frame's stats (renderer.py:512), or None: no sorted draw, nothing
    used, or a suggestion at or above the smallest policy factor of the
    scene's draws (it would loosen some draw's budget)."""
    if "bins_budget_utilization" not in stats:
        return None
    util = float(stats["bins_budget_utilization"])
    used = float(stats["bins_budget_factor"])
    used_min = float(stats["bins_budget_factor_min"])
    if util <= 0.0:
        return None
    suggestion = used * util * margin
    if suggestion >= used_min:
        return None
    return suggestion


def calibrate_budget_factor(
        scene: Sequence[Tuple[RenderObject, ObjectConfig]],
        transform: ProjectiveTransform, lights: LightData,
        frame_height: int, frame_width: int,
        margin: float = 1.25) -> Optional[float]:
    """One frame's budget-factor suggestion for this scene family, or None
    (renderer.py:536): the 'kernels' backend at the policy budget,
    ``_suggest_budget_factor``. Unvalidated, as in the JAX package: apply
    it through ``budget_override`` (or prefer ``Renderer.calibrate``,
    which re-renders and reverts on drops). Renders on the scene's
    device."""
    stats: dict = {}
    render_scene(None, list(scene), transform, lights,
                 frame_height=frame_height, frame_width=frame_width,
                 stats=stats)
    return _suggest_budget_factor(stats, margin)
