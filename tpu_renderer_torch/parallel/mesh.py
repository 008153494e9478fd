"""Sharded rendering over a ``torch.distributed`` DeviceMesh.

PyTorch counterpart of ``tpu_renderer.parallel.mesh`` (SURVEY.md §5.8).
Each function takes a ``torch.distributed.device_mesh.DeviceMesh`` where
the JAX package takes a ``jax.sharding.Mesh``, with the same dim names:

- **Tile parallelism** ('ty', 'tx'): the frame is cut into per-rank
  sub-rects, the scene is replicated; no collective at all, since every
  pixel has one owner.
- **Geometry parallelism** ('tr', or 'host' on a two-level mesh): each
  object's triangle soup is cut into contiguous shards; each rank draws
  its shard of every object into a local (z, color, object-key) buffer,
  then ONE all-gather over the axis and a fold in ascending shard order
  keep the reference's depth rule (larger z wins, the earlier object on
  equal z, the earlier triangle on equal z within one object).
- **Object parallelism** ('obj'): whole objects are dealt out to ranks,
  folded the same way by their submission keys.

The functions run SPMD: every rank of the mesh calls them with the same
scene. ``jax.lax.axis_index(name)`` is ``mesh.get_local_rank(name)``,
and each collective goes to ``mesh.get_group(name)``. Where the JAX
function returns an array sharded over ('ty', 'tx'), a rank returns its
own (lh, lw) sub-rect as a ``Framebuffer`` (``gather_framebuffer``
assembles the frame); where JAX returns it replicated (no tile axis),
every rank returns the whole frame.

The mesh's ranks must lie in rank order along every dim (a mesh built
from ``torch.arange(n).reshape(shape)``), so that a dim's group rank is
the rank's coordinate on that dim and the folds run in shard order.

Collectives move int32 tensors only: a ``Framebuffer``'s color is int32
storage viewed as uint32 (``core.types.make_framebuffer``), which gloo
refuses and NCCL has no use for, and z travels as its int32 bits in the
same tensor as the color and the key, one collective for the three
planes. The functions take whatever process groups the mesh has: NCCL
with one rank a card, the collectives on the cards, or gloo (ranks
sharing a card, or on the CPU); ``entry.run_ranks`` picks between them.
The folds run on the ranks' devices in a fixed order, so both give the
same bits.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.math import pack_argb
from ..core.types import (
    DEPTH_CLEAR,
    Framebuffer,
    LightData,
    ObjectConfig,
    ProjectiveTransform,
    RenderObject,
    make_framebuffer,
)
from ..engine.renderer import BACKENDS, render_object, render_scene
from ..geometry.vertex import setup_triangles
from ..ops.gbuffer import rasterize_gbuffer
from ..ops.raster_reference import rasterize_reference
from ..ops.setup import setup_for_raster
from ..ops.shading import shade

I32 = torch.int32

# Winner-key plane sentinel: no object has written this pixel. Any real
# object index compares smaller, so the fold leaves untouched pixels to
# the clear color.
_NO_WINNER = 2 ** 31 - 1


def _size(mesh, name: str) -> int:
    """The mesh's extent along ``name``; 1 where the mesh has no such dim."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def _coord(mesh, name: str) -> int:
    """This rank's coordinate along ``name`` (jax.lax.axis_index); 0 where
    the mesh has no such dim."""
    return mesh.get_local_rank(name) if name in (mesh.mesh_dim_names or ()) \
        else 0


def _all_gather(t: torch.Tensor, mesh, name: str) -> torch.Tensor:
    """Every rank's ``t`` along dim ``name``, in coordinate order, stacked:
    (size along ``name``, *t.shape). NCCL gathers into the one buffer;
    gloo into views of it, one a rank (the list form gloo takes)."""
    group = mesh.get_group(name)
    t = t.contiguous()
    out = t.new_empty((_size(mesh, name), *t.shape))
    if dist.get_backend(group) == dist.Backend.NCCL:
        dist.all_gather_into_tensor(out, t, group=group)
    else:
        dist.all_gather(list(out.unbind(0)), t, group=group)
    return out


def _local_rect(mesh, height: int, width: int):
    """(lh, lw, row0, col0) of this rank's sub-rect of the frame."""
    ny, nx = _size(mesh, "ty"), _size(mesh, "tx")
    if height % ny or width % nx:
        raise ValueError(f"a {height}x{width} frame does not split into "
                         f"{ny}x{nx} tiles")
    lh, lw = height // ny, width // nx
    return lh, lw, _coord(mesh, "ty") * lh, _coord(mesh, "tx") * lw


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend: {backend}")


def _pad_triangle_axis(obj: RenderObject, pad_t: int) -> RenderObject:
    """Append ``pad_t`` degenerate (all-zero => backface-culled) triangles
    along the minor triangle axis of every (C, 3, T) soup tensor."""
    if pad_t == 0:
        return obj

    def pad(a):
        return F.pad(a, (0, pad_t))

    return obj._replace(vertices=pad(obj.vertices), colors=pad(obj.colors),
                        normals=pad(obj.normals), uvs=pad(obj.uvs))


def pad_scene_triangles(scene, multiple: int):
    """Pad each object's triangle soup to a multiple (degenerate triangles:
    all-zero vertices are backface-culled) so the soup splits evenly over
    the 'tr' axis."""
    return [(_pad_triangle_axis(obj, (-obj.num_triangles) % multiple), cfg)
            for obj, cfg in scene]


def _triangle_shard(obj: RenderObject, shard: int, n: int) -> RenderObject:
    """Shard ``shard`` of ``n`` of a padded soup: the contiguous triangle
    range [shard * Ts, (shard + 1) * Ts)."""
    ts = obj.num_triangles // n

    def cut(a):
        return a[:, :, shard * ts:(shard + 1) * ts].contiguous()

    return obj._replace(vertices=cut(obj.vertices), colors=cut(obj.colors),
                        normals=cut(obj.normals), uvs=cut(obj.uvs))


def _clear_planes(lh: int, lw: int, clear_color: int, device):
    """(color int32, depth, key) of an untouched (lh, lw) rect."""
    fb = make_framebuffer(lh, lw, clear_color, device=device)
    key = torch.full((lh, lw), _NO_WINNER, dtype=I32, device=device)
    return fb.color.view(I32), fb.depth, key


def _fold_shards(color, depth, key, mesh, axis: str,
                 clear_color: int) -> Framebuffer:
    """ONE all-gather of (z, color, key) over ``axis`` and the fold in
    ascending shard order (mesh.py:240-253): greater z wins, equal z goes
    to the smaller object key, and equal z and key (one object split
    across shards) to the earlier shard, which holds the earlier
    triangles."""
    planes = torch.stack([depth.view(I32), color, key])
    out_c, out_z, out_k = _clear_planes(*depth.shape, clear_color,
                                        depth.device)
    for shard in _all_gather(planes, mesh, axis):
        z_s, c_s, k_s = shard[0].view(torch.float32), shard[1], shard[2]
        win = (z_s > out_z) | ((z_s == out_z) & (k_s < out_k))
        out_z = torch.where(win, z_s, out_z)
        out_c = torch.where(win, c_s, out_c)
        out_k = torch.where(win, k_s, out_k)
    return Framebuffer(color=out_c.view(torch.uint32), depth=out_z)


def render_scene_tiled(
    scene: Sequence[Tuple[RenderObject, ObjectConfig]],
    transform: ProjectiveTransform,
    lights: LightData,
    height: int,
    width: int,
    mesh,
    backend: str = "kernels",
    clear_color: int = 0,
) -> Framebuffer:
    """Frame sharded over mesh dims ('ty', 'tx'); scene replicated.

    Each rank renders its (height / ny, width / nx) sub-rect of the frame
    with ``render_scene`` at its origin (row0, col0) and returns it; no
    collective is needed (``gather_framebuffer`` assembles the frame).
    The route (mask or sorted, tile height, row packing) is decided on the
    rect's own size, and every route gives the same pixels."""
    _check_backend(backend)
    lh, lw, row0, col0 = _local_rect(mesh, height, width)
    fb = make_framebuffer(lh, lw, clear_color,
                          device=transform.focal_length.device)
    # render_scene batches the whole scene into ONE raster launch per rank
    # when every object is fused-path-eligible (engine.renderer).
    return render_scene(fb, list(scene), transform, lights, backend,
                        frame_height=height, frame_width=width, row0=row0,
                        col0=col0)


def _gbuffer_draw(obj: RenderObject, cfg: ObjectConfig,
                  transform: ProjectiveTransform, lights: LightData,
                  backend: str, lh: int, lw: int, height: int, width: int,
                  row0: int, col0: int):
    """(covered, z, packed color) of one object shard over the rect: the
    G-buffer (setup_for_raster -> rasterize_gbuffer: K1 or the
    small-object chain + K7, then K8 or K9 + K10; 'reference':
    setup_triangles -> rasterize_reference), then ``shade`` and
    ``pack_argb``."""
    if backend == "kernels":
        table = setup_for_raster(obj, transform, lights, cfg,
                                 frame_height=height, frame_width=width)
        covered, gbuf, _ = rasterize_gbuffer(table, lh, lw, None, height,
                                             width, row0, col0)
    else:
        edges = setup_triangles(obj, transform, lights, cfg)
        covered, gbuf = rasterize_reference(edges, lh, lw, width, row0,
                                            col0)
    rgba, covered = shade(covered, gbuf, transform, lights, cfg,
                          obj.texture, row0, col0)
    return covered, gbuf[0], pack_argb(rgba).view(I32)


def render_scene_geometry_sharded(
    scene: Sequence[Tuple[RenderObject, ObjectConfig]],
    transform: ProjectiveTransform,
    lights: LightData,
    height: int,
    width: int,
    mesh,
    backend: str = "kernels",
    clear_color: int = 0,
    tr_axis: str = "tr",
) -> Framebuffer:
    """Triangles sharded over 'tr' (optionally x tiles over 'ty'/'tx').

    Each rank draws its contiguous triangle shard of EVERY object through
    the G-buffer path and ``shade`` into a local (z, color, object-key)
    accumulator (strict '>' in submission order, the single-device rule),
    then shards combine with ONE all-gather over ``tr_axis`` per frame,
    whatever the object count (``_fold_shards``). With tile dims a rank
    returns its sub-rect, without them the whole frame.

    ``tr_axis`` renames the geometry axis: render_scene_2level passes
    'host'."""
    _check_backend(backend)
    n_tr = _size(mesh, tr_axis)
    shard = _coord(mesh, tr_axis)
    lh, lw, row0, col0 = _local_rect(mesh, height, width)
    color, depth, okey = _clear_planes(lh, lw, clear_color,
                                       transform.focal_length.device)
    for i, (obj, cfg) in enumerate(pad_scene_triangles(scene, n_tr)):
        covered, gz, packed = _gbuffer_draw(
            _triangle_shard(obj, shard, n_tr), cfg, transform, lights,
            backend, lh, lw, height, width, row0, col0)
        z = torch.where(covered, gz, DEPTH_CLEAR)
        # Local merge in submission order: strict > keeps the earlier
        # object on ties (first writer), exactly the single-device rule.
        win = z > depth
        depth = torch.where(win, z, depth)
        color = torch.where(win, packed, color)
        okey = torch.where(win, i, okey)
    return _fold_shards(color, depth, okey, mesh, tr_axis, clear_color)


def render_scene_2level(
    scene: Sequence[Tuple[RenderObject, ObjectConfig]],
    transform: ProjectiveTransform,
    lights: LightData,
    height: int,
    width: int,
    mesh,
    backend: str = "kernels",
    clear_color: int = 0,
) -> Framebuffer:
    """Two-level mesh: geometry over the outer 'host' dim, frame tiles over
    'ty'/'tx' within each host (mesh.py:267). Build the mesh with hosts
    outermost, e.g. ``DeviceMesh("cuda", torch.arange(n).reshape(n_hosts,
    -1), mesh_dim_names=("host", "ty"))``: the tile dims need no
    collective, and the frame's one collective, the (z, color, key)
    all-gather of ``render_scene_geometry_sharded`` over each rank's local
    rect, crosses hosts."""
    return render_scene_geometry_sharded(
        scene, transform, lights, height, width, mesh, backend,
        clear_color, tr_axis="host")


def _object_groups(scene):
    """[(cfg, [(submission index, obj), ...])]: the scene grouped by draw
    path, (ObjectConfig, texture shape), in first-appearance order
    (mesh.py:335-348)."""
    index: dict = {}
    groups: list = []
    for i, (obj, cfg) in enumerate(scene):
        if cfg.textured and obj.texture is None:
            raise ValueError(f"object {i} is textured and has no texture")
        tex_shape = (None if obj.texture is None
                     else tuple(obj.texture.shape))
        gk = (cfg, tex_shape)
        if gk not in index:
            index[gk] = len(groups)
            groups.append((cfg, []))
        groups[index[gk]][1].append((i, obj))
    return groups


def render_scene_object_sharded(
    scene: Sequence[Tuple[RenderObject, ObjectConfig]],
    transform: ProjectiveTransform,
    lights: LightData,
    height: int,
    width: int,
    mesh,
    backend: str = "kernels",
    clear_color: int = 0,
) -> Framebuffer:
    """Whole objects sharded over 'obj' (optionally x tiles over 'ty'/'tx').

    Objects group by (ObjectConfig, texture shape), as in the JAX package.
    There each group is padded to a common triangle count and an object
    count that is a multiple of the 'obj' size and stacked, because
    shard_map wants uniform arrays; shard s draws slots [s * K, (s + 1) *
    K) of each group, K = ceil(members / n_obj). Here rank s takes the
    same slice of each group's member list and draws those objects as
    they are, skipping the padding slots (they draw no pixel) and the
    triangle padding (it changes no pixel), so every submission key, and
    so every pixel, is the JAX package's.

    A per-pixel key plane carries the winning object's submission index:
    the local merge and the cross-shard fold resolve equal depths to the
    smaller key whatever the group-major draw order; ONE all-gather of
    (z, color, key) over 'obj' per frame."""
    _check_backend(backend)
    n_obj = _size(mesh, "obj")
    shard = _coord(mesh, "obj")
    lh, lw, row0, col0 = _local_rect(mesh, height, width)
    dev = transform.focal_length.device
    color, depth, okey = _clear_planes(lh, lw, clear_color, dev)
    clear = make_framebuffer(lh, lw, clear_color, device=dev)
    for cfg, members in _object_groups(scene):
        n_local = -(-len(members) // n_obj)
        for key, obj in members[shard * n_local:(shard + 1) * n_local]:
            fb = render_object(clear, obj, transform, lights, cfg, backend,
                               frame_height=height, frame_width=width,
                               row0=row0, col0=col0)
            covered = fb.depth > DEPTH_CLEAR
            # Key-aware merge: groups draw out of submission order
            # locally, so equal depths resolve by key, not draw order.
            win = (fb.depth > depth) | (
                covered & (fb.depth == depth) & (key < okey))
            depth = torch.where(win, fb.depth, depth)
            color = torch.where(win, fb.color.view(I32), color)
            okey = torch.where(win, key, okey)
    return _fold_shards(color, depth, okey, mesh, "obj", clear_color)


def gather_framebuffer(fb: Framebuffer, mesh) -> Framebuffer:
    """All-gather a tile-sharded framebuffer into the whole frame on every
    rank: rows over 'ty', then columns over 'tx', where the mesh has
    them (one collective of the color and depth planes per dim)."""
    planes = torch.stack([fb.color.view(I32), fb.depth.view(I32)])
    for axis, dim in (("ty", 1), ("tx", 2)):
        if axis in (mesh.mesh_dim_names or ()):
            # (n, 2, h, w) -> (2, h, w) with the n ranks' rects side by
            # side along ``dim``.
            parts = _all_gather(planes, mesh, axis).movedim(0, dim)
            shape = list(planes.shape)
            shape[dim] *= parts.shape[dim]
            planes = parts.reshape(shape)
    return Framebuffer(color=planes[0].view(torch.uint32),
                       depth=planes[1].view(torch.float32))



def device_mesh(shape, names, device_type: str = "cuda"):
    """A DeviceMesh of ``prod(shape)`` ranks in rank order along every dim
    (the order the folds need), over the default process group, which the
    caller has initialised, with a subgroup a dim of that group's backend.
    The mesh is built from ranks, not from devices: each rank's device is
    the one it set before calling. With one rank a card (NCCL) rank r is
    on cuda:r; where ranks share cards (gloo) several ranks have one
    device, e.g. cuda:0 for every rank on a one-card host."""
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= s
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))
