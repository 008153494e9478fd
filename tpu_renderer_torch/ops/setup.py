"""Vertex/setup stage: triangle soup -> packed record table + binning bboxes.

PyTorch counterpart of ``tpu_renderer.ops.setup_pallas``. It holds kernel
K1, the port of the Pallas ``_setup_kernel`` (setup_pallas.py:174):
FillEdgeTable (projekt.cpp:3882-4121) per triangle -- projection, backface
cull, Gouraud bake, per-edge y-range / x / z / color / normal left values
and gradients, and for textured objects the u/z, v/z and 1/z fields with
the white Gouraud base -- written straight into

- the row-major (Tp, 128) f32 record table (gid at lane 84, then zeros),
- the (8, Tp) f32 bbox rows (valid, ylo, yhi, xlo, xhi, 3 zero rows).

``setup_kernel`` launches the CUDA kernel (``csrc/setup.cu``) on CUDA
tensors and runs ``setup_plain``, the same f32 math in the same op order
on (3, Tp) rows, on CPU tensors.

A scene of several objects is set up in one table (``setup_scene``):
``plan_scene_setup`` lays the objects out at their gid offsets and, on the
card, uploads a table of their planes and offsets; ``setup_scene_kernel``
then runs K1's grouped form, one launch per <PHONG, TEXTURED> kind
present, small objects included, and ``setup_scene_plain`` loops over
``setup_plain`` into the same table.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _cuda
from ..core.types import (
    LightData,
    ObjectConfig,
    ProjectiveTransform,
    RenderObject,
)
from ..geometry.vertex import (
    EDGE_STRIDE,
    GID_LANE,
    F_X0,
    F_XG,
    F_YMAX,
    F_YMIN,
    REC_LANES,
    scene_setup_params,
    setup_fields,
    setup_params,
    setup_records,
)
from ..utils.profiling import annotate
from .binning import _bbox_core

F32 = torch.float32

SETUP_BLK = 1024  # triangles per block of the padded table
# Below this triangle count the vertex stage runs the small-object chain
# (geometry.vertex.setup_records, torch ops) instead of the K1 kernel, as
# the JAX package runs its XLA chain there.
FUSED_SETUP_MIN = 4096
# The small-object chain pads each object's table to this many rows.
OBJ_PAD = 128
SETUP_THREADS = 128  # K1's block: the grouped launch's unit of rows


class SetupOut:
    """Setup products the raster stage consumes.

    recs: (Tp, REC_LANES) row-major packed records
    bbox: (tri_valid, ylo, yhi, xlo, xhi), rows (Tp,)
    num_triangles: the true (unpadded) T, which policy decisions use."""

    def __init__(self, recs, bbox, num_triangles: int):
        self.recs = recs
        self.bbox = tuple(bbox)
        self.num_triangles = int(num_triangles)


def _setup_blk(T: int) -> int:
    """Padding block of the record table (setup_pallas.py:105): Tp is T
    rounded up to it, so tables compare by shape with the JAX package's."""
    if T >= 16384:
        return SETUP_BLK
    if T >= 1024:
        return 512
    return 128


def setup_for_raster(obj: RenderObject, transform: ProjectiveTransform,
                     lights: LightData, cfg: ObjectConfig, gid0: int = 0,
                     frame_height: int | None = None,
                     frame_width: int | None = None):
    """Vertex stage for the raster path (setup_pallas.py:116): the K1
    kernel from FUSED_SETUP_MIN triangles up (a SetupOut), the small-object
    chain below it (the channel-major (85, T) table of setup_records)."""
    T = obj.num_triangles
    with annotate("tr.setup"):
        if T < FUSED_SETUP_MIN or frame_height is None:
            return setup_records(obj, transform, lights, cfg, gid0)
        recs, bbox = setup_records_fused(
            obj, transform, lights, cfg, gid0, frame_height, frame_width,
            _setup_blk(T),
        )
        return SetupOut(recs, bbox, T)


def setup_records_fused(obj: RenderObject, transform: ProjectiveTransform,
                        lights: LightData, cfg: ObjectConfig, gid0: int = 0,
                        frame_height: int | None = None,
                        frame_width: int | None = None,
                        blk: int = SETUP_BLK):
    """Vertex stage -> (recs (Tp, 128) row-major, bbox 5-tuple).

    Tp pads T to a ``blk`` multiple; padded rows are invalid records (all
    zero inputs fail the backface test) and bbox-invalid."""
    if frame_height is None or frame_width is None:
        raise ValueError("setup_records_fused needs the global frame dims")
    T = obj.num_triangles
    tp = object_rows(max(T, 1), blk)
    params = setup_params(obj.p, transform, lights)
    recs, bbox = setup_kernel(
        params, obj.vertices, obj.colors, obj.normals,
        n_lights=lights.count, phong=cfg.phong, gid0=int(gid0),
        frame_height=frame_height, frame_width=frame_width, tp=tp,
        uvs=obj.uvs if cfg.textured else None,
    )
    return recs, (bbox[0] > 0.5, bbox[1], bbox[2], bbox[3], bbox[4])


def setup_kernel(params, verts, cols, nrms, *, n_lights: int, phong: bool,
                 gid0: int, frame_height: int, frame_width: int, tp: int,
                 uvs=None):
    """K1: (recs (tp, 128) f32, bbox (8, tp) f32); ``uvs`` (2, 3, T) for a
    textured object, None for an untextured one.

    CUDA tensors launch ``tr_setup`` (csrc/setup.cu) and count the launch
    in ``setup_kernel.launches``; CPU tensors run ``setup_plain``."""
    T = verts.shape[2]
    kw = dict(n_lights=n_lights, phong=phong, gid0=gid0,
              frame_height=frame_height, frame_width=frame_width, tp=tp,
              uvs=uvs)
    if verts.device.type == "cpu":
        return setup_plain(params, verts, cols, nrms, **kw)
    if verts.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not {verts.device}")
    inputs = [("params", params, (12 + 7 * n_lights,)),
              ("verts", verts, (3, 3, T)), ("cols", cols, (4, 3, T)),
              ("nrms", nrms, (3, 3, T))]
    if uvs is not None:
        inputs.append(("uvs", uvs, (2, 3, T)))
    for name, t, shape in inputs:
        _cuda.check_tensor(name, t, verts.device, F32, shape)
    if not T <= tp < 2 ** 24:
        raise ValueError(f"bad padded length {tp} for {T} triangles")
    recs = torch.empty((tp, REC_LANES), dtype=F32, device=verts.device)
    bbox = torch.empty((8, tp), dtype=F32, device=verts.device)
    _cuda.launch(
        "tr_setup", verts.device,
        params.data_ptr(), n_lights, int(bool(phong)),
        verts.data_ptr(), cols.data_ptr(), nrms.data_ptr(),
        None if uvs is None else uvs.data_ptr(), T, tp,
        int(gid0), int(frame_height), int(frame_width),
        recs.data_ptr(), bbox.data_ptr(),
    )
    setup_kernel.launches += 1
    return recs, bbox


setup_kernel.launches = 0
_cuda.declare("tr_setup", [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p])


def setup_plain(params, verts, cols, nrms, *, n_lights: int, phong: bool,
                gid0: int, frame_height: int, frame_width: int, tp: int,
                uvs=None):
    """Plain-PyTorch K1: the _setup_kernel math (setup_pallas.py:196-383),
    which is geometry.vertex.setup_fields on the (3, Tp) rows padded with
    zeros (invalid records), packed row-major with the bbox rows. Runs on
    any device."""
    T = verts.shape[2]

    def padt(a):
        return torch.nn.functional.pad(a, (0, tp - T))

    fields, keep = setup_fields(params, padt(verts), padt(cols), padt(nrms),
                                n_lights, phong,
                                None if uvs is None else padt(uvs))
    rec = fields.permute(1, 0, 2).reshape(3 * EDGE_STRIDE, tp)
    gid_row = (torch.arange(tp, dtype=torch.int32, device=verts.device)
               + gid0).to(F32)[None]
    pad = rec.new_zeros((REC_LANES - GID_LANE - 1, tp))
    recs = torch.cat([rec, gid_row, pad]).t().contiguous()

    tri_valid, ylo, yhi, xlo, xhi = _bbox_core(
        [keep[e] for e in range(3)],
        *[[fields[f, e] for e in range(3)]
          for f in (F_YMIN, F_YMAX, F_X0, F_XG)],
        frame_height, frame_width,
    )
    bbox = torch.cat([
        torch.stack([tri_valid.to(F32), ylo, yhi, xlo, xhi]),
        rec.new_zeros((3, tp)),
    ])
    return recs, bbox


def object_rows(T: int, blk: int | None = None) -> int:
    """An object's rows in a record table: its T triangles rounded up to a
    multiple of ``blk``, by default the pad its own setup gives it, K1's
    (``_setup_blk``) from FUSED_SETUP_MIN triangles, the small-object
    chain's (OBJ_PAD) below, so always a multiple of SETUP_THREADS. The
    one-object table, the small objects' concatenated table and the
    grouped table all lay their rows out by it."""
    if blk is None:
        blk = _setup_blk(T) if T >= FUSED_SETUP_MIN else OBJ_PAD
    return -(-T // blk) * blk


class ScenePlan(NamedTuple):
    """A scene's objects laid out in one record table.

    objects: per object in submission order, (p, verts, cols, nrms, uvs or
    None, phong); row0: its first row, which is its first gid; rows: its
    rows (``object_rows``); kinds: per <PHONG, TEXTURED> kind present,
    (phong, textured, first entry of ``table``, entries, blocks); table:
    on the card, the (n, SCENE_FIELDS) int64 rows of csrc/setup.cu's
    SetupObject, grouped by kind, else None."""

    objects: tuple
    row0: tuple
    rows: tuple
    kinds: tuple
    table: torch.Tensor | None

    @property
    def total(self) -> int:
        return self.row0[-1] + self.rows[-1]

    @property
    def num_triangles(self) -> int:
        return sum(int(o[1].shape[2]) for o in self.objects)


SCENE_FIELDS = 9  # int64 fields of csrc/setup.cu's SetupObject
KINDS = ((True, False), (True, True), (False, False), (False, True))


def plan_scene_setup(scene, n_lights: int) -> ScenePlan:
    """The ScenePlan of ``scene`` ([(RenderObject, ObjectConfig)]): each
    object's rows follow the last's. On the card it checks every plane and
    uploads the table from pinned memory, with no wait for the device."""
    objects, row0, rows, at = [], [], [], 0
    for obj, cfg in scene:
        n = object_rows(obj.num_triangles)
        objects.append((obj.p, obj.vertices, obj.colors, obj.normals,
                        obj.uvs if cfg.textured else None, bool(cfg.phong)))
        row0.append(at)
        rows.append(n)
        at += n
    dev = objects[0][1].device
    entries, kinds = [], []
    for phong, textured in KINDS:
        first, blocks = len(entries), 0
        for i, (_, v, c, nr, uv, ph) in enumerate(objects):
            if (ph, uv is not None) != (phong, textured):
                continue
            entries.append((v, c, nr, uv, i, blocks))
            blocks += rows[i] // SETUP_THREADS
        if blocks:
            kinds.append((phong, textured, first, len(entries) - first,
                          blocks))
    table = None
    if dev.type == "cuda":
        stride = 12 + 7 * n_lights
        flat = []
        for v, c, nr, uv, i, block0 in entries:
            T = int(v.shape[2])
            planes = [("verts", v, 3), ("cols", c, 4), ("nrms", nr, 3)]
            if uv is not None:
                planes.append(("uvs", uv, 2))
            for name, t, ch in planes:
                _cuda.check_tensor(name, t, dev, F32, (ch, 3, T))
            flat.append((v.data_ptr(), c.data_ptr(), nr.data_ptr(),
                         0 if uv is None else uv.data_ptr(), T, rows[i],
                         row0[i], i * stride, block0))
        table = torch.tensor(flat, dtype=torch.int64,
                             pin_memory=True).to(dev, non_blocking=True)
    return ScenePlan(tuple(objects), tuple(row0), tuple(rows), tuple(kinds),
                     table)


def setup_scene(plan: ScenePlan, transform: ProjectiveTransform,
                lights: LightData, frame_height: int,
                frame_width: int) -> SetupOut:
    """The scene's record table and bbox rows as one SetupOut: every
    object's ``setup_params`` in one batched op, then
    ``setup_scene_kernel``. Row g is gid g; an object's pad rows are
    invalid records."""
    with annotate("tr.setup"):
        params = scene_setup_params(torch.stack([o[0] for o in plan.objects]),
                                    transform, lights)
        recs, bbox = setup_scene_kernel(
            params, plan, n_lights=lights.count, frame_height=frame_height,
            frame_width=frame_width)
        return SetupOut(recs, (bbox[0] > 0.5, bbox[1], bbox[2], bbox[3],
                               bbox[4]), plan.num_triangles)


def setup_scene_kernel(params, plan: ScenePlan, *, n_lights: int,
                       frame_height: int, frame_width: int):
    """Grouped K1: (recs (total, 128) f32, bbox (8, total) f32) of every
    object of ``plan`` at its rows, ``params`` its (n, 12 + 7 * n_lights)
    ``scene_setup_params``.

    CUDA tensors launch ``tr_setup_grouped`` (csrc/setup.cu
    ``setup_kernel_grouped``) once per kind of ``plan.kinds`` and count
    the launches in ``setup_scene_kernel.launches``; CPU tensors run
    ``setup_scene_plain``."""
    kw = dict(n_lights=n_lights, frame_height=frame_height,
              frame_width=frame_width)
    dev = params.device
    if dev.type == "cpu":
        return setup_scene_plain(params, plan, **kw)
    if dev.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not {dev}")
    total = plan.total
    _cuda.check_tensor("params", params, dev, F32,
                       (len(plan.rows), 12 + 7 * n_lights))
    if plan.table is None or plan.table.device != dev:
        raise ValueError("the plan's table is not on the params' card")
    if not total < 2 ** 24:
        raise ValueError(f"{total} rows: the f32 gid lane is exact to 2^24")
    recs = torch.empty((total, REC_LANES), dtype=F32, device=dev)
    bbox = torch.empty((8, total), dtype=F32, device=dev)
    base = plan.table.data_ptr()
    for phong, textured, first, count, blocks in plan.kinds:
        _cuda.launch(
            "tr_setup_grouped", dev, base + first * SCENE_FIELDS * 8, count,
            blocks, params.data_ptr(), n_lights, int(phong), int(textured),
            total, int(frame_height), int(frame_width), recs.data_ptr(),
            bbox.data_ptr())
        setup_scene_kernel.launches += 1
    return recs, bbox


setup_scene_kernel.launches = 0
_cuda.declare("tr_setup_grouped", [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])


def setup_scene_plain(params, plan: ScenePlan, *, n_lights: int,
                      frame_height: int, frame_width: int):
    """Plain grouped K1: ``setup_plain`` of each object, with its row of
    ``params``, its first row as gid0 and its rows as tp, into one
    table."""
    recs = params.new_empty((plan.total, REC_LANES))
    bbox = params.new_empty((8, plan.total))
    for i, ((_, verts, cols, nrms, uvs, phong), r0, n) in enumerate(
            zip(plan.objects, plan.row0, plan.rows)):
        recs[r0:r0 + n], bbox[:, r0:r0 + n] = setup_plain(
            params[i], verts, cols, nrms, n_lights=n_lights, phong=phong,
            gid0=r0, frame_height=frame_height, frame_width=frame_width,
            tp=n, uvs=uvs)
    return recs, bbox
