"""Deferred rotation (``geometry.transform.rotate_object`` ->
``RotatedObject``) and K13's grouped form (``rotate_kernel_grouped``,
csrc/transform.cu ``rotate_kernel_grouped``).

``rotate_object`` launches nothing: every read of its result resolves it
alone, bit-equal to the eager ``rotate_plain``, and the engine's draw
resolves a scene's pending objects together. On the CPU the group runs
``rotate_plain`` on each object, so these tests hold everything but the
launch: each kind of read, the reads that must not resolve, the group's
counters, frames equal to eagerly rotated ones, in-place changes caught
before the resolve, rotations composed, and a NumPy model of the grouped
kernel's block -> (object, element) map on ragged scenes. The tests
marked ``cuda`` (skipped without a card) hold the grouped launch bit-equal
to K13 an object, NaN, infinities and -0 planted, on ragged scenes and on
the benchmark's 137-object ``sphere_cluster`` sizes, count its launches,
and keep a view of its output past the rest of its frame.

The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_rotate_group.py
"""

import pickle

import numpy as np
import pytest
import torch

import tpu_renderer_torch as trt
from tpu_renderer_torch.core.types import RenderObject
from tpu_renderer_torch.engine import renderer as tre
from tpu_renderer_torch.geometry import transform as ttf
from tpu_renderer_torch.models.scenes import to_torch_scene
from torch_threads import one_torch_thread  # noqa: F401

# Threads a block and elements a thread of the grouped form
# (csrc/transform.cu kRotateThreads, kGroupElems).
THREADS, ELEMS = 256, 4
SIZES = (1, 5, 85, 86, 4096, 30001)


def planes(T, seed, device="cpu"):
    """(rot (3, 3), vertices, normals (3, 3, T)) f32 from ``seed``, with a
    signed zero, NaN and infinities planted where T allows."""
    g = torch.Generator().manual_seed(seed)
    rot = torch.randn((3, 3), generator=g)
    v = torch.randn((3, 3, T), generator=g) * 3
    n = torch.randn((3, 3, T), generator=g)
    if T >= 5:
        v[0, 0, 0], v[1, 1, 1], v[2, 2, 2] = -0.0, float("nan"), float("inf")
        n[0, 1, 3], n[2, 0, 4] = float("-inf"), -0.0
    return rot.to(device), v.to(device), n.to(device)


def soup_object(T, seed, device="cpu"):
    """A RenderObject of T triangles with ``planes``' vertices and
    normals, seeded colours and uvs, at a seeded position."""
    _, v, n = planes(T, seed, device)
    g = torch.Generator().manual_seed(seed + 1)
    return RenderObject(
        p=torch.randn((3,), generator=g).to(device), vertices=v,
        colors=torch.rand((4, 3, T), generator=g).to(device), normals=n,
        uvs=torch.rand((2, 3, T), generator=g).to(device))


def bits(t):
    return t.contiguous().view(torch.int32)


def assert_rotated(got, obj, rot):
    """``got``'s planes are ``rotate_plain``'s bit for bit, and its other
    fields are ``obj``'s own tensors."""
    want_v, want_n = ttf.rotate_plain(rot, obj.vertices, obj.normals)
    assert type(got) is RenderObject
    assert torch.equal(bits(got.vertices), bits(want_v))
    assert torch.equal(bits(got.normals), bits(want_n))
    for name in ("p", "colors", "uvs", "texture"):
        assert getattr(got, name) is getattr(obj, name)


def counts():
    return ttf.rotate_object.alone, ttf.rotate_object.grouped


def unpacked(obj):
    p, vertices, colors, normals, uvs, texture = obj
    return RenderObject(p, vertices, colors, normals, uvs, texture)


# Each read of a pending object, as a function of it.
READS = {
    "vertices": lambda o: o._rest._replace(vertices=o.vertices,
                                           normals=o.normals),
    "normals": lambda o: (o.normals, o)[1].resolve(),
    "index": lambda o: RenderObject(*[o[i] for i in range(6)]),
    "slice": lambda o: RenderObject(*o[0:6]),
    "unpack": lambda o: unpacked(o),
    "tuple": lambda o: RenderObject(*tuple(o)),
    "replace": lambda o: o._replace(),
    "asdict": lambda o: RenderObject(**o._asdict()),
    "translate": lambda o: ttf.translate_object(o, o.p)._replace(p=o.p),
    "pickle": lambda o: pickle.loads(pickle.dumps(o)),
    "resolve_scene": lambda o: ttf.resolve_scene([(o, None)])[0][0],
}


@pytest.mark.parametrize("read", sorted(READS))
def test_every_read_of_a_pending_object_is_the_eager_rotation(read):
    obj = soup_object(37, 5)
    rot = ttf.rotation_y(0.7, device="cpu")
    pending = ttf.rotate_object(obj, rot)
    assert isinstance(pending, ttf.RotatedObject) and pending._out is None
    alone, grouped = counts()
    got = READS[read](pending)
    if read == "pickle":  # a copy: the original is resolved for it
        assert torch.equal(bits(got.vertices), bits(pending.vertices))
        got = pending.resolve()
    assert_rotated(RenderObject(*got), obj, rot)
    assert counts() == (alone + 1, grouped)
    assert pending.resolve() is pending.resolve()  # computed once
    assert counts() == (alone + 1, grouped)


def test_no_read_sees_the_rest_pose_and_the_fields_stay_the_rests():
    obj = soup_object(12, 3)
    pending = ttf.rotate_object(obj, ttf.rotation_y(0.4, device="cpu"))
    assert tuple.__getitem__(pending, 1) is None  # nothing to fall back on
    assert tuple.__getitem__(pending, 3) is None
    for name in ("p", "colors", "uvs", "texture"):
        assert getattr(pending, name) is getattr(obj, name)
    assert pending._out is None
    assert len(pending) == 6
    assert not torch.equal(pending[1], obj.vertices)
    assert repr(pending) == repr(pending.resolve())


def test_num_triangles_and_the_device_do_not_resolve(monkeypatch):
    """Neither the fields nor the engine's device check resolve: the
    scene reaches ``resolve_scene`` with every object still pending."""
    scene = [(soup_object(T, T), trt.ObjectConfig()) for T in (7, 19)]
    rot = ttf.rotation_y(0.2, device="cpu")
    spun = [(ttf.rotate_object(o, rot), c) for o, c in scene]
    alone, grouped = counts()
    assert [o.num_triangles for o, _ in spun] == [7, 19]
    assert all(o.device == torch.device("cpu") for o, _ in spun)
    assert counts() == (alone, grouped)
    seen = []
    real = tre.resolve_scene

    def entry(sc):
        seen.append([o._out is None for o, _ in sc])
        return real(sc)
    monkeypatch.setattr(tre, "resolve_scene", entry)
    tr, li = scene_camera()
    trt.Renderer(32, 48, device="cpu").render(spun, tr, li)
    assert seen == [[True, True]]
    assert counts() == (alone, grouped + 2)


def scene_camera():
    from tpu_renderer_torch.models import scenes as ts
    tr_d, li_d = ts.baseline_camera_lights(32, 48)
    _, tr, li = to_torch_scene([], tr_d, li_d, device="cpu")
    return tr, li


def mixed(seed):
    """The scene-setup tests' six-object scene (every kind of the grouped
    setup, K1-sized and chain-sized objects, a textured backdrop) on the
    CPU, and its frame size."""
    from test_torch_scene_setup import H, W, mixed_scene

    return to_torch_scene(*mixed_scene(seed), device="cpu"), (H, W)


@pytest.mark.parametrize("seed", [0, 1])
def test_a_draw_resolves_the_scene_as_one_group(seed):
    """``Renderer.render`` resolves all six pending objects in one group
    and none alone, and the frame is the one drawn from objects rotated
    eagerly, bit for bit."""
    (scene, tr, li), (h, w) = mixed(seed)
    rot = ttf.rotation_y(0.3 + seed, device="cpu")
    eager = [(o._replace(vertices=v, normals=n), c) for (o, c), (v, n) in zip(
        scene, [ttf.rotate_plain(rot, o.vertices, o.normals)
                for o, _ in scene])]
    renderer = trt.Renderer(h, w, device="cpu")
    want = renderer.render(eager, tr, li)
    spun = [(ttf.rotate_object(o, rot), c) for o, c in scene]
    alone, grouped = counts()
    got, stats = renderer.render(spun, tr, li, with_stats=True)
    assert counts() == (alone, grouped + len(scene))
    assert int(stats["bins_dropped"]) == 0
    assert torch.equal(got.color.view(torch.int32),
                       want.color.view(torch.int32))
    assert torch.equal(bits(got.depth), bits(want.depth))
    for (o, _), (e, _) in zip(spun, eager):
        assert o._out is not None
        assert torch.equal(bits(o.vertices), bits(e.vertices))
    again = renderer.render(spun, tr, li)  # resolved: nothing to do
    assert counts() == (alone, grouped + len(scene))
    assert torch.equal(bits(again.depth), bits(want.depth))


def test_a_lone_pending_object_resolves_alone_and_twins_once():
    """One pending object in a scene takes the one-object path; the same
    pending object drawn twice is resolved once, in a group with the
    others."""
    rot = ttf.rotation_y(0.9, device="cpu")
    a, b = (ttf.rotate_object(soup_object(T, T), rot) for T in (9, 11))
    plain = soup_object(13, 13)
    alone, grouped = counts()
    out = ttf.resolve_scene([(a, 0), (plain, 1)])
    assert counts() == (alone + 1, grouped)
    assert out[1][0] is plain and out[0][0] is a.resolve()
    c = ttf.rotate_object(soup_object(15, 15), rot)
    out = ttf.resolve_scene([(b, 0), (c, 1), (b, 2), (a, 3)])
    assert counts() == (alone + 1, grouped + 2)
    assert out[0][0] is out[2][0] is b.resolve()
    assert [cfg for _, cfg in out] == [0, 1, 2, 3]


CHANGES = {
    "rot": lambda o, rot: rot.mul_(1.0),
    "vertices": lambda o, rot: o.vertices.add_(0.0),
    "normals": lambda o, rot: o.normals[0].zero_(),
}


@pytest.mark.parametrize("what", sorted(CHANGES))
@pytest.mark.parametrize("how", ["alone", "group"])
def test_a_change_in_place_before_the_resolve_raises(what, how):
    obj = soup_object(21, 4)
    rot = ttf.rotation_y(0.5, device="cpu")
    pending = ttf.rotate_object(obj, rot)
    other = ttf.rotate_object(soup_object(8, 8), rot.clone())
    CHANGES[what](obj, rot)
    with pytest.raises(RuntimeError, match="changed in place"):
        if how == "alone":
            pending.vertices
        else:
            ttf.resolve_scene([(other, 0), (pending, 1)])
    assert pending._out is None
    if how == "group":
        assert other._out is None  # nothing of the group was computed


def test_a_change_after_the_resolve_is_the_callers():
    obj = soup_object(6, 2)
    rot = ttf.rotation_y(0.5, device="cpu")
    pending = ttf.rotate_object(obj, rot)
    v = pending.vertices.clone()
    rot.mul_(2.0)
    assert torch.equal(bits(pending.vertices), bits(v))


def test_rotating_twice_is_two_eager_rotations():
    obj = soup_object(40, 6)
    r1 = ttf.rotation_y(0.3, device="cpu")
    r2 = ttf.rotation_x(-1.1, device="cpu")
    inner = ttf.rotate_object(obj, r1)
    alone, _ = counts()
    twice = ttf.rotate_object(inner, r2)
    assert counts()[0] == alone + 1 and inner._out is not None
    assert twice._out is None and twice._rest is inner.resolve()
    v1, n1 = ttf.rotate_plain(r1, obj.vertices, obj.normals)
    v2, n2 = ttf.rotate_plain(r2, v1, n1)
    assert torch.equal(bits(twice.vertices), bits(v2))
    assert torch.equal(bits(twice.normals), bits(n2))


def test_the_call_checks_and_converts_the_matrix():
    obj = soup_object(10, 1)
    with pytest.raises(ValueError, match="shape"):
        ttf.rotate_object(obj, torch.eye(4))
    rot = ttf.rotation_z(0.25, device="cpu")
    stack = torch.stack([rot.t(), rot])
    for r in (rot.double(), rot.t().contiguous().t(), stack[1],
              rot.numpy()):
        got = ttf.rotate_object(obj, r)
        assert got._rot.dtype is torch.float32 and got._rot.is_contiguous()
        assert_rotated(got.resolve(), obj, rot)
    assert ttf.rotate_object(obj, rot)._rot is rot  # converted only if not


def test_inference_tensors_rotate_at_the_call():
    with torch.inference_mode():
        obj = soup_object(14, 9)
        rot = ttf.rotation_y(0.6, device="cpu")
    got = ttf.rotate_object(obj, rot)
    assert type(got) is RenderObject
    assert_rotated(got, obj, rot)


def test_the_grouped_form_on_the_cpu_is_rotate_plain():
    items = [planes(T, 50 + T) for T in SIZES]
    before = ttf.rotate_kernel_grouped.launches
    got = ttf.rotate_kernel_grouped(items)
    assert ttf.rotate_kernel_grouped.launches == before
    for (rot, v, n), (gv, gn) in zip(items, got):
        wv, wn = ttf.rotate_plain(rot, v, n)
        assert torch.equal(bits(gv), bits(wv))
        assert torch.equal(bits(gn), bits(wn))


def block_map(items):
    """The grouped kernel's writes over ``items``' table, modelled in
    NumPy: for every block, plane (blockIdx.y), thread and element, the
    row its block finds in ``group_table``'s rows (the last whose first
    block is at or before its own) and the output index and input (object,
    plane, component, element) it writes. Returns (output indices, their
    sources, the output's floats)."""
    rows, _, floats, blocks = ttf.group_table(items)
    table = np.asarray(rows, dtype=np.int64).reshape(-1, ttf.ROTATE_FIELDS)
    index = {v.data_ptr(): i for i, (_, v, _) in enumerate(items)}
    firsts = table[:, 5]
    out_idx, src = [], []
    lanes = np.arange(THREADS)
    for block in range(blocks):
        found = int((firsts <= block).sum())  # __syncthreads_count
        _, vptr, _, n, off, b0 = (int(f) for f in table[found - 1])
        obj = index[vptr]
        k0 = (block - b0) * THREADS * ELEMS + lanes
        for y in (0, 1):
            for e in range(ELEMS):
                k = k0 + e * THREADS
                k = k[k < n]
                for i in range(3):
                    out_idx.append(off + y * 3 * n + i * n + k)
                    src.append(np.stack([np.full_like(k, obj),
                                         np.full_like(k, y),
                                         np.full_like(k, i), k], 1))
    return np.concatenate(out_idx), np.concatenate(src), floats


@pytest.mark.parametrize("order", range(4))
def test_the_block_map_writes_every_element_once(order):
    """Ragged scenes of the sizes around K13's and the grouped form's
    blocks (85 / 86 triangles: 255 / 258 elements; 341 / 342: 1,023 /
    1,026), an empty object in some: every output float is written once,
    by the thread reading that object's plane, component and element, at
    the place the object's (3, 3, T) view reads it."""
    gen = np.random.default_rng(order)
    sizes = list(SIZES) + [341, 342] + ([0] if order % 2 else [])
    sizes = [int(s) for s in gen.permutation(sizes)]
    if order == 3:
        sizes = sizes + sizes[::-1]
    assert THREADS * ELEMS == ttf.GROUP_BLOCK
    items = [planes(T, j) for j, T in enumerate(sizes)]
    out_idx, src, floats = block_map(items)
    assert floats == 18 * sum(sizes) and len(out_idx) == floats
    hits = np.bincount(out_idx, minlength=floats)
    assert hits.min() == 1 and hits.max() == 1
    views = ttf._plane_views(torch.empty(floats), sizes)
    base = np.array([[vv.storage_offset() for vv in pair] for pair in views])
    obj, y, i, k = src.T
    T = np.asarray(sizes)[obj]
    assert np.array_equal(out_idx, base[obj, y] + 3 * T * i + k)
    assert (k < 3 * T).all()
    for (vv, nn), T in zip(views, sizes):
        assert vv.shape == nn.shape == (3, 3, T)
        assert vv.is_contiguous() and nn.is_contiguous()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def ragged(seed, device, sizes=SIZES):
    """The seed's order of ``sizes``, each object with its own matrix and
    planted specials."""
    gen = np.random.default_rng(seed)
    return [planes(int(T), 1000 * seed + j, device)
            for j, T in enumerate(gen.permutation(list(sizes) + [341, 342]))]


def cluster_sizes():
    """The triangle counts of the benchmark's sphere_cluster, in its
    order: the backdrop quad, 120 sphere grids, 16 reference spheres."""
    return [2] + [8192] * 120 + [2208] * 16


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["ragged0", "ragged1", "ragged2",
                                   "cluster"])
def test_grouped_equals_k13_an_object_on_the_card(cuda, scene):
    if scene == "cluster":
        items = [planes(T, 7 + j, cuda)
                 for j, T in enumerate(cluster_sizes())]
    else:
        items = ragged(int(scene[-1]), cuda)
    before = (ttf.rotate_kernel_grouped.launches, ttf.rotate_kernel.launches)
    got = ttf.rotate_kernel_grouped(items)
    assert (ttf.rotate_kernel_grouped.launches,
            ttf.rotate_kernel.launches) == (before[0] + 1, before[1])
    base = got[0][0].untyped_storage().data_ptr()
    for (rot, v, n), (gv, gn) in zip(items, got):
        assert gv.is_contiguous() and gn.is_contiguous()
        assert gv.shape == v.shape and gn.shape == n.shape
        assert gv.untyped_storage().data_ptr() == base  # one allocation
        wv, wn = ttf.rotate_kernel(rot, v, n)
        assert torch.equal(bits(gv), bits(wv))
        assert torch.equal(bits(gn), bits(wn))


@pytest.mark.cuda
def test_a_scene_costs_one_grouped_launch_and_a_lone_object_one_k13(cuda):
    objs = [soup_object(T, T, cuda) for T in (300, 5000, 77)]
    rot = ttf.rotation_y(0.4, device=cuda)
    spun = [(ttf.rotate_object(o, rot), c) for c, o in enumerate(objs)]
    before = (ttf.rotate_kernel_grouped.launches, ttf.rotate_kernel.launches)
    assert (ttf.rotate_kernel_grouped.launches,
            ttf.rotate_kernel.launches) == before  # the calls launch nothing
    out = ttf.resolve_scene(spun)
    assert (ttf.rotate_kernel_grouped.launches,
            ttf.rotate_kernel.launches) == (before[0] + 1, before[1])
    for (got, _), o in zip(out, objs):
        assert_rotated(got, o, rot)
    lone = ttf.rotate_object(objs[0], rot)
    ttf.resolve_scene([(lone, 0), (out[1][0], 1)])
    assert (ttf.rotate_kernel_grouped.launches,
            ttf.rotate_kernel.launches) == (before[0] + 1, before[1] + 1)
    assert_rotated(lone.resolve(), objs[0], rot)


@pytest.mark.cuda
def test_a_view_of_the_group_outlives_its_frame(cuda):
    """One object's planes kept after the rest of the group and the
    scene are dropped and the allocator has handed their memory out again:
    still the rotation, bit for bit."""
    items = ragged(3, cuda)
    want = [ttf.rotate_plain(*it) for it in items]
    got = ttf.rotate_kernel_grouped(items)
    kept = got[2]
    del got
    for _ in range(3):
        junk = [torch.full((18 * int(v.shape[2]),), float("nan"),
                           device=cuda) for _, v, _ in items]
        ttf.rotate_kernel_grouped(items[::-1])
    del junk
    torch.cuda.synchronize()
    assert torch.equal(bits(kept[0]), bits(want[2][0]))
    assert torch.equal(bits(kept[1]), bits(want[2][1]))


@pytest.mark.cuda
def test_a_drawn_cluster_equals_the_eager_rotation_on_the_card(cuda):
    """The benchmark's 137-object frame drawn from pending objects (one
    grouped launch, none alone) equals the one drawn from objects rotated
    by K13 an object."""
    from test_torch_scene_setup import cluster

    spun, tr, li, mix = cluster(cuda)
    h, w = mix["height"], mix["width"]
    eager = [(o.resolve(), c) for o, c in cluster(cuda)[0]]
    renderer = trt.Renderer(h, w, device=cuda)
    want = renderer.render(eager, tr, li)
    alone, grouped = counts()
    launches = ttf.rotate_kernel_grouped.launches
    got = renderer.render(spun, tr, li)
    assert counts() == (alone, grouped + 137)
    assert ttf.rotate_kernel_grouped.launches == launches + 1
    assert torch.equal(got.color.view(torch.int32),
                       want.color.view(torch.int32))
    assert torch.equal(bits(got.depth), bits(want.depth))
