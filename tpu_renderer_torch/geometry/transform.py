"""Model transforms for animated scenes (PyTorch counterpart of
``tpu_renderer.geometry.transform``, elementwise form only): rotations and
the object's position.

``rotate_object`` defers the rotation: it checks its operands and returns
a ``RotatedObject``, which computes its planes at their first read. The
engine's draw resolves every pending object of its scene together
(``resolve_scene``): two or more on one card in one launch of K13's
grouped form (``rotate_kernel_grouped``, csrc/transform.cu), a lone one
in K13 (``rotate_kernel``); any other read resolves that object alone.
On the CPU each resolves through ``rotate_plain``, the same f32 products
and sums as torch ops.

The rotation matrices follow the entry points' device rule: a tensor
angle keeps its device; a Python number goes to ``device``, the card
unless the caller asks for the CPU (``core.types.resolve_device``)."""

from __future__ import annotations

import array
import ctypes

import torch

from .. import _cuda
from ..core.math import scalar
from ..core.types import RenderObject, resolve_device
from ..utils.profiling import annotate

F32 = torch.float32


def _cos_sin(angle, device):
    """(cos, sin, 1, 0) of ``angle`` as 0-d f32 tensors on its device (a
    tensor angle) or on ``resolve_device(device)``."""
    if not isinstance(angle, torch.Tensor):
        angle = scalar(angle, resolve_device(device))
    a = angle.to(F32)
    return torch.cos(a), torch.sin(a), torch.ones_like(a), torch.zeros_like(a)


def rotation_y(angle, device="cuda") -> torch.Tensor:
    """3x3 rotation about +y, computed in f32."""
    c, s, one, zero = _cos_sin(angle, device)
    return torch.stack([
        torch.stack([c, zero, s]),
        torch.stack([zero, one, zero]),
        torch.stack([-s, zero, c]),
    ])


def rotation_x(angle, device="cuda") -> torch.Tensor:
    """3x3 rotation about +x, computed in f32."""
    c, s, one, zero = _cos_sin(angle, device)
    return torch.stack([
        torch.stack([one, zero, zero]),
        torch.stack([zero, c, -s]),
        torch.stack([zero, s, c]),
    ])


def rotation_z(angle, device="cuda") -> torch.Tensor:
    """3x3 rotation about +z, computed in f32."""
    c, s, one, zero = _cos_sin(angle, device)
    return torch.stack([
        torch.stack([c, -s, zero]),
        torch.stack([s, c, zero]),
        torch.stack([zero, zero, one]),
    ])


def rotate_plain(rot: torch.Tensor, vertices: torch.Tensor,
                 normals: torch.Tensor):
    """(vertices, normals) rotated by ``rot`` as torch ops, on any device:
    out_i = (rot[i,0]*x + rot[i,1]*y) + rot[i,2]*z on the channel planes."""

    def rot3(arr):
        return torch.stack([
            rot[i, 0] * arr[0] + rot[i, 1] * arr[1] + rot[i, 2] * arr[2]
            for i in range(3)
        ])

    return rot3(vertices), rot3(normals)


def rotate_kernel(rot: torch.Tensor, vertices: torch.Tensor,
                  normals: torch.Tensor):
    """K13: ``rotate_plain``'s planes, bit-equal. CUDA tensors launch
    ``tr_rotate`` (csrc/transform.cu), vertices and normals in one launch,
    counted in ``rotate_kernel.launches``; CPU tensors run
    ``rotate_plain``. ``rot`` is taken as f32 on the planes' device, as
    the plain version's products take it."""
    dev = vertices.device
    if dev.type == "cpu":
        return rotate_plain(rot, vertices, normals)
    if dev.type != "cuda":
        raise ValueError(f"K13 runs on CUDA or CPU tensors, not {dev}")
    T = vertices.shape[2]
    rot = rot.to(device=dev, dtype=F32).contiguous()
    _cuda.check_tensor("rot", rot, dev, F32, (3, 3))
    _cuda.check_tensor("vertices", vertices, dev, F32, (3, 3, T))
    _cuda.check_tensor("normals", normals, dev, F32, (3, 3, T))
    v_out, n_out = torch.empty_like(vertices), torch.empty_like(normals)
    if T:
        _cuda.launch("tr_rotate", dev, rot.data_ptr(), vertices.data_ptr(),
                     normals.data_ptr(), 3 * T, v_out.data_ptr(),
                     n_out.data_ptr())
        rotate_kernel.launches += 1
    return v_out, n_out


rotate_kernel.launches = 0
_cuda.declare("tr_rotate", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])


# Elements of a component plane that a block of the grouped form covers
# (csrc/transform.cu kGroupBlock: 256 threads, 4 elements each).
GROUP_BLOCK = 1024
ROTATE_FIELDS = 6  # int64 fields of csrc/transform.cu's RotateObject


def group_table(items):
    """(rows, sizes, floats, blocks) of a grouped launch over ``items``
    ((rot, vertices, normals) each): per object of T > 0 triangles, in
    order, the six int64 fields of its RotateObject row (its matrix's and
    planes' pointers, its 3 T elements a plane, the offset of its 18 T
    output floats, its first block: its ceil(3 T / GROUP_BLOCK) blocks a
    plane follow the last object's), flat; each object's T; the output's
    floats; the launch's blocks."""
    rows, sizes, at, blocks = [], [], 0, 0
    for rot, v, n in items:
        T = v.shape[2]
        sizes.append(T)
        if T:
            rows += (rot.data_ptr(), v.data_ptr(), n.data_ptr(), 3 * T, at,
                     blocks)
            blocks += (3 * T + GROUP_BLOCK - 1) // GROUP_BLOCK
        at += 18 * T
    return rows, sizes, at, blocks


def rotate_kernel_grouped(items):
    """K13's grouped form: ``[(vertices, normals)]``, each (rot, vertices,
    normals) of ``items`` as ``rotate_kernel`` gives it, bit-equal.

    CUDA tensors, all on one card, launch ``tr_rotate_grouped`` once
    (counted in ``rotate_kernel_grouped.launches``) over a device table of
    the objects' rows (``group_table``), uploaded from pinned memory with
    no wait for the device; the outputs are contiguous (3, 3, T) views of
    one allocation. CPU tensors run ``rotate_plain`` on each. The operands
    must be what ``rotate_kernel`` takes, f32 and contiguous on the card:
    ``rotate_object`` checks them at its call."""
    dev = items[0][1].device
    if dev.type == "cpu":
        return [rotate_plain(*item) for item in items]
    rows, sizes, floats, blocks = group_table(items)
    out = torch.empty(floats, dtype=F32, device=dev)
    if blocks:
        # array -> frombuffer: under half the time of torch.tensor on a list
        table = torch.frombuffer(array.array("q", rows), dtype=torch.int64)
        table = table.pin_memory().to(dev, non_blocking=True)
        _cuda.launch("tr_rotate_grouped", dev, table.data_ptr(),
                     len(rows) // ROTATE_FIELDS, blocks, out.data_ptr())
        rotate_kernel_grouped.launches += 1
    return _plane_views(out, sizes)


rotate_kernel_grouped.launches = 0
_cuda.declare("tr_rotate_grouped", [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p])


def _plane_views(out, sizes):
    """[(vertices, normals)]: each object's (3, 3, T) planes in ``out`` at
    its ``group_table`` offset. A run of objects of one size is cut by one
    view and one unbind, which make its views in one call."""
    runs = []  # [T, objects]
    for T in sizes:
        if runs and runs[-1][0] == T:
            runs[-1][1] += 1
        else:
            runs.append([T, 1])
    pieces = out.split([18 * T * k for T, k in runs])
    planes = []
    for piece, (T, k) in zip(pieces, runs):
        planes += piece.view(2 * k, 3, 3, T).unbind(0)
    return list(zip(planes[0::2], planes[1::2]))


class RotatedObject(RenderObject):
    """``rotate_object``'s result: ``rest`` turned by ``rot``, its planes
    computed at their first read and kept.

    Reading ``vertices`` or ``normals``, indexing, unpacking, ``_replace``
    (and so ``translate_object`` and the mesh's shard and pad), pickling
    or comparing resolves it alone, with ``rotate_kernel``; the engine's
    draw resolves a scene's pending objects together (``resolve_scene``).
    No read sees the rest pose: the tuple holds None in their place.
    ``p``, ``colors``, ``uvs`` and ``texture`` are the rest pose's, and
    ``num_triangles`` and ``device`` are read from it without resolving.
    The resolve raises if ``rot`` or a rest plane was changed in place
    after the call (``versions``, their ``_version`` then): the rotation
    of the call can no longer be had."""

    def __new__(cls, rest: RenderObject, rot: torch.Tensor, versions):
        self = tuple.__new__(cls, (rest[0], None, rest[2], None, rest[4],
                                   rest[5]))
        self._rest, self._rot, self._versions, self._out = (
            rest, rot, versions, None)
        return self

    @property
    def vertices(self) -> torch.Tensor:
        return self.resolve().vertices

    @property
    def normals(self) -> torch.Tensor:
        return self.resolve().normals

    @property
    def num_triangles(self) -> int:
        return self._rest.num_triangles

    @property
    def device(self) -> torch.device:
        return self._rest.device

    def _operands(self):
        """(rot, rest vertices, rest normals), after the version check."""
        rot, (_, v, _, n, _, _) = self._rot, self._rest
        if (rot._version, v._version, n._version) != self._versions:
            raise RuntimeError(
                "rotate_object's matrix or planes were changed in place "
                "before the rotation was computed")
        return rot, v, n

    def _set(self, vertices, normals) -> None:
        p, _, colors, _, uvs, texture = self._rest
        self._out = tuple.__new__(RenderObject, (p, vertices, colors,
                                                 normals, uvs, texture))

    def resolve(self) -> RenderObject:
        """The rotated object as a plain RenderObject, computed alone
        (``rotate_kernel``, counted in ``rotate_object.alone``) if it is
        still pending."""
        if self._out is None:
            with annotate("tr.geometry"):
                self._set(*rotate_kernel(*self._operands()))
                rotate_object.alone += 1
        return self._out

    def __getitem__(self, i):
        return self.resolve()[i]

    def __iter__(self):
        return iter(self.resolve())

    def __contains__(self, x):
        return x in self.resolve()

    def __eq__(self, other):
        return self.resolve() == other

    def __ne__(self, other):
        return self.resolve() != other

    def __hash__(self):
        return hash(self.resolve())

    def __reduce__(self):
        return RenderObject, tuple(self.resolve())

    def __repr__(self):
        return repr(self.resolve())

    def _replace(self, **fields) -> RenderObject:
        return self.resolve()._replace(**fields)


def rotate_object(obj: RenderObject, rot: torch.Tensor) -> RenderObject:
    """Rotate vertices and normals by a 3x3 matrix (colors/uvs unchanged):
    out_i = (rot[i,0]*x + rot[i,1]*y) + rot[i,2]*z on the channel planes.

    Deferred: checks ``rot`` (f32 (3, 3) on the planes' device, converted
    only when it is not) and, on the card, the planes, then returns a
    ``RotatedObject`` that launches nothing until it is read or drawn. An
    object still pending is resolved first. Inference tensors keep no
    version, so an object with one is rotated now, alone."""
    with annotate("tr.geometry"):
        if isinstance(obj, RotatedObject):
            obj = obj.resolve()
        _, v, _, n, _, _ = obj
        dev = v.device
        if not (isinstance(rot, torch.Tensor) and rot.device == dev
                and rot.dtype is F32 and rot.shape == (3, 3)
                and rot.is_contiguous()):
            rot = torch.as_tensor(rot).to(device=dev, dtype=F32).contiguous()
            _cuda.check_tensor("rot", rot, dev, F32, (3, 3))
        if dev.type == "cuda":
            shape = (3, 3, v.shape[2])
            _cuda.check_tensor("vertices", v, dev, F32, shape)
            _cuda.check_tensor("normals", n, dev, F32, shape)
        elif dev.type != "cpu":
            raise ValueError(f"K13 runs on CUDA or CPU tensors, not {dev}")
        try:
            versions = rot._version, v._version, n._version
        except RuntimeError:  # an inference tensor: no version to check
            v, n = rotate_kernel(rot, v, n)
            return obj._replace(vertices=v, normals=n)
        return RotatedObject(obj, rot, versions)


rotate_object.alone = 0  # objects resolved alone (RotatedObject.resolve)
rotate_object.grouped = 0  # objects resolved in a group (resolve_scene)


def resolve_scene(scene):
    """``scene`` ([(RenderObject, cfg)]) with every ``RotatedObject`` in it
    resolved, as plain RenderObjects, in the ``tr.geometry`` span: the
    pending ones on one device together when there are two or more
    (``rotate_kernel_grouped``: one launch on a card; counted in
    ``rotate_object.grouped``), a lone one alone. The engine's draw calls
    it first."""
    with annotate("tr.geometry"):
        groups: dict = {}
        for obj, _ in scene:
            if type(obj) is RotatedObject and obj._out is None:
                groups.setdefault(obj.device, {})[id(obj)] = obj
        for group in groups.values():
            if len(group) > 1:
                objs = list(group.values())
                outs = rotate_kernel_grouped([o._operands() for o in objs])
                for o, (vertices, normals) in zip(objs, outs):
                    o._set(vertices, normals)
                rotate_object.grouped += len(objs)
        return [(obj._out or obj.resolve() if type(obj) is RotatedObject
                 else obj, cfg) for obj, cfg in scene]


def translate_object(obj: RenderObject, p) -> RenderObject:
    """Set the object's camera-space position (the reference's Object->P):
    ``p`` as a (3,) f32 tensor on the object's device."""
    return obj._replace(p=torch.as_tensor(
        p, dtype=F32, device=obj.vertices.device).reshape(3))
