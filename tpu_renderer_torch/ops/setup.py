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
"""

from __future__ import annotations

import ctypes

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
    tp = -(-max(T, 1) // blk) * blk
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
