"""Seeded scenes at the edges of every kernel route: the boundary sweep.

Each family builds golden-form scenes (``(obj_dict, cfg_dict)`` lists,
cameras from ``scenes.baseline_camera_lights`` of the frame) from a seed,
each at one side of a routing threshold or a kernel's edge, with the
forms it is run through and what each form is built to produce: the
route, the C entry it launches, and stats such as a chosen tile's stream
count or the side list's length. ``to_torch_scene`` (the port),
``to_jax_scene`` (the JAX package) and ``golden.cpu_reference.render``
take them as they are.

Families (``FAMILIES``):

- thresholds: T at 511 / 512 / 513 (the mask strategy against the sorted
  one), 4095 / 4096 / 4097 (the small-object setup chain and K7 against
  K1), and frames solved so that T * 256 > H * W (8-row tiles) and
  T * 12 >= H * W (row packing) flip;
- part_edges: one tile's stream (one strip's under row packing) holding
  k * P - 1, k * P and k * P + 1 entries, P the entries of a part, k in
  1, 2, 5, beside an empty tile column, filled tiles, and tiles that only
  a large triangle on the side list touches;
- ties: duplicated triangles (equal records but the gid), coplanar pairs
  at one depth, and fans sharing edges, ordered so that each pair falls
  in different parts of a stream; and the same triangles as two objects,
  Gouraud then Phong, a tie on every covered pixel;
- side_list: 2047, 2048 and 2049 large triangles against the side list's
  2048 slots, the one past them counted as dropped;
- ragged: frames off the tile grid, sub-rects at an origin off it, and
  every tile height a route takes (8, 16, 24, 32, 40, 64);
- budgets: an entry budget or a mask list capacity small enough to drop
  entries;
- textures: textures 511, 512 and 513 texels on a side (the fused
  kernels' K5 against the G-buffer path), nearest and bilinear, 'scalar'
  and 'avx', one atlas of two textures at 511 and 512 rows, and K1's
  textured fields;
- zcull: sphere stacks, innermost layer first and last, on both of K11's
  routes (one stream and row packing).

Routes here are what the scenes are built to take, from the thresholds
below (copies of ``ops.raster`` and ``ops.setup``'s, which
tests/test_torch_sweep_scenes.py holds equal to them and holds every
scene's route, counts and records to): NumPy and this package's models
only, no torch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from . import primitives as tp
from . import scenes as ts

F = np.float32

AUTO_SORTED_THRESHOLD = 512  # ops.raster: 'auto' is sorted above this T
FUSED_SETUP_MIN = 4096  # ops.setup: K1 from this T up
TILE8_PX_PER_TRI = 256  # ops.raster: 8-row tiles when T * 256 > H * W
PACK_ROWS_MAX_PX_PER_TRI = 12  # ops.raster: packing when T * 12 >= H * W
PART_ENTRIES = 32  # ops.raster.RASTER_PART_ENTRIES
LARGE_CAPACITY = 2048  # ops.raster: side-list slots
MAX_FUSED_TEX_DIM = 512  # ops.raster: the fused atlas's longest side
TILE_W = 128
OBJ_PAD = 128  # ops.setup: small objects of a launch pad to this

FAMILIES = ("thresholds", "part_edges", "ties", "side_list", "ragged",
            "budgets", "textures", "zcull", "bands")
SEEDS = (0, 1)  # the card's sweep


class Form(NamedTuple):
    """One way a scene is drawn: ``path`` 'fused' (one raster launch of
    the scene, ``engine.renderer.prepare_scene``) or 'gbuffer' (its one
    object into a G-buffer, ``ops.gbuffer.prepare_gbuffer``), the route
    knobs (``strategy``, ``tile_h``, ``zcull``), the route it takes
    (strategy, tile_h, rows), the C entry of its raster launch, and
    ``claims``: stats of the binning it is built to produce ('stream':
    (index into the bins' starts / counts, entries), 'n_large',
    'dropped'; 'dropped_min': at least that many dropped)."""

    path: str
    strategy: str
    tile_h: int | None
    zcull: bool
    route: tuple
    entry: str
    claims: dict


class SweepScene(NamedTuple):
    """A scene of the sweep: ``sg`` drawn into the (h, w) rect ``hw`` at
    ``origin`` (row0, col0) of a ``frame`` (frame_height, frame_width),
    with the mask list ``capacity`` and the sorted ``budget_override``
    (None: the defaults) on every form and on the whole frame
    (``render_scene``, with ``zcull``). ``setup``: the setup launches of
    a fused form, {C entry: launches}. ``dups``: (gid, gid) pairs whose
    records are equal but for the gid; ``ties``: pairs that tie in depth
    wherever both cover a pixel, in different parts of their stream."""

    family: str
    name: str
    seed: int
    sg: list
    hw: tuple
    frame: tuple
    origin: tuple = (0, 0)
    capacity: int | None = None
    budget_override: float | None = None
    zcull: bool = False
    setup: dict = {}
    forms: tuple = ()
    dups: tuple = ()
    ties: tuple = ()

    def camera(self):
        """(transform_dict, lights_dict) of the frame."""
        return ts.baseline_camera_lights(*self.frame)

    @property
    def exact(self) -> bool:
        """No form drops an entry: the frame is the golden's."""
        return not any(f.claims.get("dropped", 0) or
                       f.claims.get("dropped_min", 0) for f in self.forms)

    @property
    def triangles(self) -> int:
        return sum(len(o["vertices"]) // 3 for o, _ in self.sg)


# ---------------------------------------------------------------------------
# Routes
# ---------------------------------------------------------------------------


def _counts(sg):
    return [len(o["vertices"]) // 3 for o, _ in sg]


def t_policy(sg, path="fused") -> int:
    """The T a draw's route is decided on: one object's T; several
    objects' sum from FUSED_SETUP_MIN up, else the sum of their tables
    padded to OBJ_PAD each."""
    counts = _counts(sg)
    if path == "gbuffer" or len(counts) == 1:
        return counts[0]
    if sum(counts) >= FUSED_SETUP_MIN:
        return sum(counts)
    return sum(-(-t // OBJ_PAD) * OBJ_PAD for t in counts)


def route(t, frame, strategy="auto", tile_h=None, path="fused"):
    """(strategy, tile_h, rows) of a T-triangle draw on ``frame``."""
    px = frame[0] * frame[1]
    if strategy == "auto":
        strategy = "sorted" if t > AUTO_SORTED_THRESHOLD else "mask"
    if tile_h is None:
        tile_h = 8 if t * TILE8_PX_PER_TRI > px else 16
    packed = (path == "fused" and strategy == "sorted" and tile_h <= 8
              and t * PACK_ROWS_MAX_PX_PER_TRI >= px)
    return strategy, tile_h, 2 if packed else 1


def entry(rt, path, zcull=False) -> str:
    """The C entry a route's raster launch calls."""
    strategy, tile_h, rows = rt
    if path == "gbuffer":
        return "tr_gbuffer_mask" if strategy == "mask" else "tr_gbuffer_queue"
    if strategy == "mask":
        return "tr_raster_mask"
    if tile_h == 8:
        name = "tr_raster" if rows == 2 else "tr_raster_rows1"
        return name + "_zcull" if zcull else name
    return {16: "tr_raster_narrow", 32: "tr_raster_narrow32"}.get(
        tile_h, "tr_raster_narrow_any")


def setup_launches(sg) -> dict:
    """{C entry: launches} of a fused draw's setup: K7 (``tr_records``)
    once for a draw below FUSED_SETUP_MIN triangles; above it, K1
    (``tr_setup``) once for one object, K1's grouped form
    (``tr_setup_grouped``) once per <phong, textured> kind of several."""
    counts = _counts(sg)
    if sum(counts) < FUSED_SETUP_MIN:
        return {"tr_records": 1}
    if len(counts) == 1:
        return {"tr_setup": 1}
    return {"tr_setup_grouped": len({
        (bool(c.get("phong", False)), c.get("texture") is not None)
        for _, c in sg})}


def form(sg, frame, path="fused", strategy="auto", tile_h=None,
         zcull=False, **claims) -> Form:
    rt = route(t_policy(sg, path), frame, strategy, tile_h, path)
    return Form(path, strategy, tile_h, zcull, rt,
                entry(rt, path, zcull and path == "fused"), claims)


def stream_index(rt, frame_w, row, col_tile) -> int:
    """Index into a sorted route's starts / counts of the stream that
    holds the rows from ``row`` in tile column ``col_tile`` of a frame
    drawn whole: ``rows * tile + strip``."""
    _, tile_h, rows = rt
    tile = (row // tile_h) * -(-frame_w // TILE_W) + col_tile
    return rows * tile + (row % tile_h) // (tile_h // rows)


# ---------------------------------------------------------------------------
# Triangles placed in pixels
# ---------------------------------------------------------------------------


def world(px, z, tr_d):
    """World vertices (..., 3) whose projection through ``tr_d`` lands at
    the pixel coordinates ``px`` (..., 2) (x, y) at camera z ``z``."""
    dat = F(tr_d["distance_above_target"])
    m2p = F(tr_d["meters_to_pixels"]) * F(tr_d["focal_length"])
    cx, cy = (F(c) for c in tr_d["screen_center"])
    px, z = np.asarray(px, F), np.asarray(z, F)
    dz = dat - z
    return np.stack([(px[..., 0] - cx) * dz / m2p,
                     (px[..., 1] - cy) * dz / m2p, z], -1).astype(F)


def triangles(px, z, tr_d, back=None):
    """(n, 3, 3) world triangles of pixel corners ``px`` (n, 3, 2) at
    camera z ``z`` (n, 3), wound to face the camera (the reference's cull
    keeps a negative screen cross product), or away from it where the
    bool mask ``back`` (n,) is set, as the far side of a mesh is."""
    px, z = np.array(px, F), np.array(z, F)
    e1, e2 = px[:, 1] - px[:, 0], px[:, 2] - px[:, 0]
    flip = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0] > 0
    if back is not None:
        flip ^= np.asarray(back, bool)
    px[flip, 1], px[flip, 2] = px[flip, 2].copy(), px[flip, 1].copy()
    z[flip, 1], z[flip, 2] = z[flip, 2].copy(), z[flip, 1].copy()
    return world(px, z, tr_d)


def small_px(rng, n, rows, cols, size):
    """(n, 3, 2) pixel corners of triangles about ``size`` px across,
    every corner in rows [rows[0], rows[1]] and cols [cols[0], cols[1]],
    none thinner than 1.5 px^2 of doubled area or 1.2 rows tall (so that
    some edge spans a row)."""
    out = np.zeros((0, 3, 2), F)
    while len(out) < n:
        m = 2 * (n - len(out)) + 16
        c = np.stack([rng.uniform(cols[0], cols[1], m),
                      rng.uniform(rows[0], rows[1], m)], -1)
        p = c[:, None] + rng.uniform(-size, size, (m, 3, 2))
        p[..., 0] = np.clip(p[..., 0], cols[0], cols[1])
        p[..., 1] = np.clip(p[..., 1], rows[0], rows[1])
        e1, e2 = p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
        ok = (np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]) >= 1.5) & (
            np.ptp(p[..., 1], axis=1) >= 1.2)
        out = np.concatenate([out, p[ok].astype(F)])
    return out[:n]


def depths(rng, n):
    """(n, 3) camera z of n triangles' corners, in [-0.3, 0.3]."""
    return rng.uniform(-0.3, 0.3, (n, 3)).astype(F)


def mesh(rng, verts):
    """A mesh dict of (n, 3, 3) world triangles with random vertex colours
    (alpha 1), unit normals and uvs in [0, 1]."""
    n = len(verts)
    col = np.concatenate([rng.uniform(0.05, 1.0, (n, 3, 3)),
                          np.ones((n, 3, 1))], -1).astype(F)
    nrm = rng.normal(size=(n, 3, 3)).astype(F)
    nrm = (nrm / np.sqrt((nrm * nrm).sum(-1, keepdims=True))).astype(F)
    return dict(vertices=np.asarray(verts, F).reshape(-1, 3),
                colors=col.reshape(-1, 4), normals=nrm.reshape(-1, 3),
                uvs=rng.uniform(0.0, 1.0, (n * 3, 2)).astype(F))


def obj(m, p=(0.0, 0.0, 0.0)):
    return dict(p=tuple(float(v) for v in p), **m)


def halves(rng, n):
    """A random half of n triangles, to wind away from the camera: a
    mesh's far side, which the route's budget counts in T but which bins
    nothing."""
    return rng.permutation(n) < n // 2


def soup(rng, n, frame, size, phong=True):
    """One object of ``n`` random triangles about ``size`` px across over
    the whole frame, at random depths, half of them facing away."""
    tr_d = ts.baseline_camera_lights(*frame)[0]
    px = small_px(rng, n, (0.0, frame[0] - 1.0), (0.0, frame[1] - 1.0),
                  size)
    return obj(mesh(rng, triangles(px, depths(rng, n), tr_d,
                                   halves(rng, n)))), {"phong": phong}


def merged(*parts):
    """Concatenate (n_i, 3, 3) triangle arrays in order."""
    return np.concatenate([np.asarray(p, F).reshape(-1, 3, 3)
                           for p in parts])


def texture(rng, th, tw):
    """A (th, tw) u32 ARGB texture of random texels."""
    return rng.integers(0, 2 ** 32, (th, tw), dtype=np.uint64).astype(
        np.uint32)


def scene(family, name, seed, sg, frame, forms, **kw) -> SweepScene:
    hw = kw.pop("hw", frame)
    return SweepScene(family, name, seed, sg, tuple(hw), tuple(frame),
                      setup=setup_launches(sg), forms=tuple(forms), **kw)


# ---------------------------------------------------------------------------
# Families
# ---------------------------------------------------------------------------


# (T, frame): T across 512 and 4096, frames across T * 256 and T * 12.
THRESHOLD_CASES = (
    (511, (96, 128)), (512, (96, 128)), (513, (96, 128)),
    (513, (54, 114)),  # 513 * 12 = 54 * 114: row packing
    (513, (256, 513)),  # 513 * 256 = 256 * 513: 16-row tiles
    (512, (512, 256)),  # 512 * 256 = 512 * 256: the mask route at 16 rows
    (4095, (128, 384)),  # 4095 * 12 < 128 * 384: one stream, K7
    (4096, (128, 384)),  # 4096 * 12 = 128 * 384: row packing, K1
    (4097, (128, 384)),
    (4096, (1024, 1024)),  # 4096 * 256 = 1024 * 1024: 16-row tiles
    (4097, (1024, 1024)),  # 8-row tiles, one stream
)


def thresholds(seed, cases=THRESHOLD_CASES):
    rng = np.random.default_rng([1, seed])
    out = []
    for t, frame in cases:
        # about as many px covered as the frame holds, so the route's
        # entry budget (fit to meshes) keeps every entry
        size = min(9.0, 0.8 * np.sqrt(frame[0] * frame[1] / t))
        sg = [soup(rng, t, frame, size=float(rng.uniform(0.7, 1.0) * size),
                   phong=bool(rng.integers(2)))]
        forms = [form(sg, frame), form(sg, frame, "gbuffer")]
        if route(t, frame)[:2] == ("sorted", 8):
            forms.append(form(sg, frame, zcull=True))
        out.append(scene("thresholds", f"T{t}@{frame[0]}x{frame[1]}", seed,
                         sg, frame, forms))
    return out


PART_COUNTS = tuple(k * PART_ENTRIES + d for k in (1, 2, 5)
                    for d in (-1, 0, 1))
WIDE_HEIGHTS = (8, 16, 24, 32, 40)  # forced sorted heights of part_edges


def _part_wide(rng, seed, n):
    """256x1280 (ten tile columns): n triangles in rows [r, r + 4) of tile
    column ``cx``, fillers in rows [0, 32) and [240, 256) of every column
    but ``cx`` and an empty one, and one large triangle over rows [72,
    232) of seven columns away from ``cx``: on the side list at every
    forced height but 64, and alone on the tiles it covers."""
    frame = (256, 1280)
    tr_d = ts.baseline_camera_lights(*frame)[0]
    cx = int(rng.choice([0, 1, 2, 7, 8, 9]))
    empty = int(rng.choice([c for c in range(1, 9) if abs(c - cx) > 1]))
    r = int(rng.choice([0, 8, 16, 24]))
    x0 = cx * TILE_W + float(rng.uniform(2, 40))
    chosen = small_px(rng, n, (r + 0.3, r + 3.3), (x0, x0 + 60), 7.0)
    fill = []
    for c in range(10):
        if c in (cx, empty):
            continue
        for rows in ((0.3, 31.6), (240.3, 255.6)):
            k = int(rng.integers(2, 9))
            fill.append(small_px(rng, k, rows, (c * TILE_W + 1.0,
                                                c * TILE_W + 126.0), 6.0))
    fill = np.concatenate(fill)
    lo = 3 if cx < 3 else 0
    big = np.array([[[lo * TILE_W + 10.0, 72.3],
                     [(lo + 7) * TILE_W - 10.0, 72.3],
                     [lo * TILE_W + 300.0, 231.6]]], F)
    px = np.concatenate([chosen, fill, big])
    sg = [(obj(mesh(rng, triangles(px, depths(rng, len(px)), tr_d))),
           {"phong": bool(rng.integers(2))})]
    forms = []
    for th in WIDE_HEIGHTS:
        for path in ("fused", "gbuffer"):
            if path == "gbuffer" and th == 40:
                continue
            rt = route(t_policy(sg), frame, "sorted", th, path)
            claims = dict(stream=(stream_index(rt, frame[1], r, cx), n),
                          n_large=1, dropped=0)
            forms.append(form(sg, frame, path, "sorted", th, **claims))
            if th == 8 and path == "fused":
                forms.append(form(sg, frame, path, "sorted", th, True,
                                  **claims))
    return scene("part_edges", f"wide n{n}", seed, sg, frame, forms)


def _part_dense(rng, seed, n):
    """32x256: n triangles in rows [8, 12) of tile column 0, fillers in
    column 1 and in rows [16, 32) of column 0, 700 triangles in all (700 *
    12 >= 32 * 256: the sorted route packs two 4-row strips)."""
    frame, total = (32, 256), 700
    tr_d = ts.baseline_camera_lights(*frame)[0]
    chosen = small_px(rng, n, (8.3, 11.3), (2.0, 126.0), 7.0)
    k = total - n
    fill = np.concatenate([
        small_px(rng, k - k // 3, (0.3, frame[0] - 0.4), (129.0, 254.0), 6.0),
        small_px(rng, k // 3, (16.3, frame[0] - 0.4), (1.0, 126.0), 6.0)])
    px = np.concatenate([chosen, fill])
    back = np.concatenate([np.zeros(n, bool), halves(rng, k)])
    sg = [(obj(mesh(rng, triangles(px, depths(rng, len(px)), tr_d, back))),
           {"phong": bool(rng.integers(2))})]
    forms = []
    for path, zc in (("fused", False), ("fused", True), ("gbuffer", False)):
        rt = route(t_policy(sg, path), frame, path=path)
        forms.append(form(sg, frame, path, zcull=zc, stream=(
            stream_index(rt, frame[1], 8, 0), n), n_large=0, dropped=0))
    return scene("part_edges", f"dense n{n}", seed, sg, frame, forms)


def part_edges(seed):
    rng = np.random.default_rng([2, seed])
    return ([_part_wide(rng, seed, n) for n in PART_COUNTS]
            + [_part_dense(rng, seed, n) for n in PART_COUNTS])


def _fan(center, radius, k, phase):
    a = phase + 2 * np.pi * np.arange(k + 1) / k
    rim = np.stack([center[0] + radius * np.cos(a),
                    center[1] + radius * np.sin(a)], -1)
    return np.stack([np.broadcast_to(np.asarray(center, F), (k, 2)),
                     rim[:-1], rim[1:]], 1).astype(F)


def _tie_mesh(rng, tr_d, rows, cols, base, fan_rows, fan_cols):
    """Triangles of one object: ``base`` random ones (over 200: half
    facing away), 16 at one depth each, 24 copies of base triangles and the 16 coplanar partners of the
    one-depth ones, all inside the rect (rows, cols), then two 8-triangle
    fans in the rect (fan_rows, fan_cols), one at one depth, one on a
    slanted plane. Each pair's gids lie at least 40 apart and nothing
    else of the object reaches the first rect, so no part of 32 entries
    of its stream holds both. Returns (mesh, dups, ties): the copies'
    (gid, gid) pairs, and every pair that ties in depth (the copies and
    the coplanar pairs)."""
    px_b = small_px(rng, base, rows, cols, 8.0)
    px_a = small_px(rng, 16, (rows[0] + 0.9, rows[1] - 0.9),
                    (cols[0] + 3, cols[1] - 3), 9.0)
    z_a = np.repeat(rng.uniform(-0.3, 0.3, (16, 1)), 3, 1).astype(F)
    shift = np.stack([rng.uniform(-3, 3, 16), rng.uniform(-0.8, 0.8, 16)],
                     -1)[:, None]
    px_p = (px_a[:, ::-1] + shift).astype(F)
    back = halves(rng, base) if base > 200 else np.zeros(base, bool)
    src = rng.choice(np.flatnonzero(~back[:base - 40]), 24, replace=False)
    first = merged(triangles(px_b, depths(rng, base), tr_d, back),
                   triangles(px_a, z_a, tr_d))
    cy, cx = (fan_rows[0] + fan_rows[1]) / 2, (fan_cols[0] + fan_cols[1]) / 2
    radius = min(10.0, (fan_rows[1] - fan_rows[0]) / 2 - 0.5)
    fan1 = _fan((cx - 25, cy), radius, 8, float(rng.uniform(0, 1)))
    fan2 = _fan((cx + 25, cy), radius, 8, float(rng.uniform(0, 1)))
    a, b = rng.uniform(-0.004, 0.004, 2)
    z_f2 = (0.1 + a * (fan2[..., 0] - cx) + b * (fan2[..., 1] - cy)).astype(F)
    tris = merged(first, first[src], triangles(px_p, z_a, tr_d),
                  triangles(fan1, np.full((8, 3), rng.uniform(-0.2, 0.2), F),
                            tr_d), triangles(fan2, z_f2, tr_d))
    m = mesh(rng, tris)
    n0 = base + 16
    for k in m:  # the copies carry their originals' attributes too
        per = m[k].reshape(len(tris), 3, -1)
        per[n0:n0 + 24] = per[src]
        m[k] = per.reshape(-1, m[k].shape[-1])
    dups = tuple((int(s), n0 + i) for i, s in enumerate(src))
    coplanar = tuple((base + i, n0 + 24 + i) for i in range(16))
    return m, dups, dups + coplanar


def ties(seed):
    rng = np.random.default_rng([3, seed])
    frame = (96, 256)
    tr_d = ts.baseline_camera_lights(*frame)[0]
    m, dups, pairs = _tie_mesh(rng, tr_d, (16.3, 23.6), (8.0, 120.0), 100,
                               (40.3, 79.6), (136.0, 250.0))
    sg = [(obj(m), {"phong": bool(rng.integers(2))})]
    forms = [form(sg, frame), form(sg, frame, strategy="sorted", tile_h=8),
             form(sg, frame, strategy="sorted", tile_h=8, zcull=True),
             form(sg, frame, strategy="sorted", tile_h=16),
             form(sg, frame, strategy="sorted", tile_h=32),
             form(sg, frame, strategy="sorted", tile_h=24),
             form(sg, frame, "gbuffer", "sorted", 8),
             form(sg, frame, "gbuffer", "sorted", 16),
             form(sg, frame, "gbuffer", "mask", 8)]
    out = [scene("ties", "one object", seed, sg, frame, forms, dups=dups,
                 ties=pairs)]
    twins = [(obj(m), {}), (obj(m), {"phong": True})]
    out.append(scene("ties", "twins", seed, twins, frame, [
        form(twins, frame),
        form(twins, frame, strategy="sorted", tile_h=8),
        form(twins, frame, strategy="sorted", tile_h=16),
        form(twins, frame, strategy="sorted", tile_h=24)], dups=dups,
        ties=pairs))
    # T * 12 >= 32 * 128: the sorted route packs two 4-row strips; the
    # pairs all lie in the strip of rows [8, 12)
    dense = (32, 128)
    tr_d = ts.baseline_camera_lights(*dense)[0]
    m, dups, pairs = _tie_mesh(rng, tr_d, (8.3, 11.6), (8.0, 120.0), 270,
                               (12.4, 31.6), (8.0, 120.0))
    sg = [(obj(m), {"phong": bool(rng.integers(2))})]
    out.append(scene("ties", "dense", seed, sg, dense, [
        form(sg, dense, strategy="sorted", tile_h=8),
        form(sg, dense, strategy="sorted", tile_h=8, zcull=True),
        form(sg, dense, "gbuffer", "sorted", 8)], dups=dups, ties=pairs))
    return out


def slivers(rng, n, frame, span, tr_d):
    """``n`` thin triangles, each reaching down ``span`` rows or more of
    the frame from near its top: 1-3 px at the top, a 2-5 px base."""
    h, w = frame
    y0 = rng.uniform(1.3, h - span - 1.3, n)
    y1 = rng.uniform(y0 + span, h - 0.4)
    x = rng.uniform(3.0, w - 8.0, n)
    px = np.stack([np.stack([x, y0], -1),
                   np.stack([x + rng.uniform(1, 3, n), y0], -1),
                   np.stack([x + rng.uniform(-2, 2, n), y1], -1)], 1)
    return triangles(px, depths(rng, n), tr_d)


# frame, rows of a sliver: more tiles than the expansion (one stream: 8)
# or more 4-row strips of a parity than 2 (row packing)
SIDE_LAYOUTS = {"rows1": ((128, 384), 80.0), "rows2": ((64, 384), 30.0)}


def side_list(seed, counts=(2047, 2048, 2049), fillers=40,
              layouts=("rows1", "rows2")):
    rng = np.random.default_rng([4, seed])
    out = []
    for lay in layouts:
        frame, span = SIDE_LAYOUTS[lay]
        tr_d = ts.baseline_camera_lights(*frame)[0]
        for n in counts:
            tris = merged(slivers(rng, n, frame, span, tr_d), triangles(
                small_px(rng, fillers, (0.3, frame[0] - 0.4),
                         (0.0, frame[1] - 1.0), 5.0),
                depths(rng, fillers), tr_d))
            sg = [(obj(mesh(rng, tris)), {"phong": bool(rng.integers(2))})]
            claims = dict(n_large=min(n, LARGE_CAPACITY),
                          dropped=max(0, n - LARGE_CAPACITY))
            forms = [form(sg, frame, **claims),
                     form(sg, frame, zcull=True, **claims)]
            if lay == "rows1":
                forms.append(form(sg, frame, "gbuffer", **claims))
            out.append(scene("side_list", f"{lay} n{n}", seed, sg, frame,
                             forms))
    return out


RAGGED_HEIGHTS = (8, 16, 24, 32, 40, 64)


def ragged(seed):
    """Frames off the tile grid (neither side a multiple of 8 or 128),
    sub-rects at an origin off it, every forced tile height: a dense
    scene (row packing, K1 where it reaches 4,096 triangles), then a
    sparse one."""
    rng = np.random.default_rng([5, seed])
    out = []
    for i in range(2):
        while True:
            frame = (int(rng.integers(60, 260)), int(rng.integers(90, 420)))
            if frame[0] % 8 and frame[1] % TILE_W:
                break
        row0 = int(rng.integers(1, frame[0] // 3))
        col0 = int(rng.integers(1, frame[1] // 3))
        row0 += row0 % 8 == 0
        col0 += col0 % TILE_W == 0
        hw = (frame[0] - row0 - int(rng.integers(0, 9)),
              frame[1] - col0 - int(rng.integers(0, 40)))
        tr_d = ts.baseline_camera_lights(*frame)[0]
        lat, lon = (int(v) for v in rng.integers(8, 24, 2))
        ball = tp.construct_sphere_grid(lat, lon, float(rng.uniform(.3, .6)))
        n = int(rng.integers(100, 600)) if i % 2 else int(
            frame[0] * frame[1] // 10)
        loose = mesh(rng, triangles(small_px(
            rng, n, (0.3, frame[0] - 0.4), (0.0, frame[1] - 1.0), 3.0),
            depths(rng, n), tr_d, halves(rng, n)))
        sg = [(obj(tp.merge_meshes(ts.rotate_y(ball, float(rng.uniform(0, 6))),
                                   loose), rng.uniform(-0.2, 0.2, 3)),
               {"phong": bool(rng.integers(2))})]
        forms = [form(sg, frame)]
        for th in RAGGED_HEIGHTS:
            forms.append(form(sg, frame, strategy="sorted", tile_h=th))
            forms.append(form(sg, frame, "gbuffer", "sorted", th))
            if th in (8, 24, 64):
                forms.append(form(sg, frame, strategy="mask", tile_h=th))
        forms += [form(sg, frame, strategy="sorted", tile_h=8, zcull=True),
                  form(sg, frame, "gbuffer", "mask", 16)]
        out.append(scene("ragged", f"{frame[0]}x{frame[1]} rect {hw} at "
                         f"({row0}, {col0})", seed, sg, frame, forms,
                         hw=hw, origin=(row0, col0)))
    return out


def budgets(seed):
    """A sorted draw under a budget factor of 0.02-0.08 (one stream and
    row packing), a mask draw with a list capacity of 8 or 16."""
    rng = np.random.default_rng([6, seed])
    out = []
    for frame, t in (((128, 256), int(rng.integers(700, 2600))),
                     ((48, 128), int(rng.integers(520, 900)))):
        sg = [soup(rng, t, frame, size=float(rng.uniform(4, 10)))]
        bo = float(rng.uniform(0.02, 0.08))
        forms = [form(sg, frame, dropped_min=1),
                 form(sg, frame, "gbuffer", dropped_min=1),
                 form(sg, frame, zcull=True, dropped_min=1)]
        if route(t, frame)[2] == 1:
            forms += [form(sg, frame, strategy="sorted", tile_h=16,
                           dropped_min=1),
                      form(sg, frame, strategy="sorted", tile_h=24,
                           dropped_min=1)]
        out.append(scene("budgets", f"sorted T{t} budget {bo:.4f}", seed, sg,
                         frame, forms, budget_override=bo))
    frame = (128, 128)
    t = int(rng.integers(200, 500))
    sg = [soup(rng, t, frame, size=float(rng.uniform(4, 10)))]
    cap = int(rng.choice([8, 16]))
    out.append(scene("budgets", f"mask T{t} capacity {cap}", seed, sg, frame,
                     [form(sg, frame, dropped_min=1),
                      form(sg, frame, "gbuffer", dropped_min=1),
                      form(sg, frame, strategy="mask", tile_h=24,
                           dropped_min=1)], capacity=cap))
    return out


def _textured_ball(rng, tex, filter_mode, uv_mode, lat=None, lon=None):
    lat = lat or int(rng.integers(6, 20))
    lon = lon or int(rng.integers(6, 20))
    m = ts.rotate_y(tp.construct_sphere_grid(lat, lon), float(rng.uniform(0, 6)))
    return obj(m, rng.uniform(-0.2, 0.2, 3)), {
        "phong": bool(rng.integers(2)), "texture": tex,
        "filter_mode": filter_mode, "uv_mode": uv_mode}


def textures(seed, dims=(511, 512, 513)):
    """Single textured objects with a texture ``dim`` texels on one side
    (on the rows for odd seeds, the columns for even ones), each filter
    and addressing; an atlas of two textures stacking to 511 and 512 rows
    in one launch; K1's textured fields (construct_sphere_grid(46, 45),
    4,140 triangles)."""
    rng = np.random.default_rng([7, seed])
    frame = (160, 192)
    out = []
    for dim in dims:
        shape = (dim, 8) if seed % 2 else (8, dim)
        for filt in ("nearest", "bilinear"):
            for uv in ("scalar", "avx"):
                sg = [_textured_ball(rng, texture(rng, *shape), filt, uv)]
                fused = uv == "scalar" and dim <= MAX_FUSED_TEX_DIM
                if fused:
                    forms = [form(sg, frame),
                             form(sg, frame, strategy="sorted", tile_h=16),
                             form(sg, frame, strategy="mask", tile_h=8)]
                else:
                    forms = [form(sg, frame, "gbuffer"),
                             form(sg, frame, "gbuffer", "sorted", 16),
                             form(sg, frame, "gbuffer", "mask", 8)]
                out.append(scene("textures", f"{shape} {filt} {uv}", seed,
                                 sg, frame, forms))
    for rows in (511, 512):
        sg = [_textured_ball(rng, texture(rng, 256, 8), "nearest", "scalar"),
              _textured_ball(rng, texture(rng, rows - 256, 8), "bilinear",
                             "scalar")]
        out.append(scene("textures", f"atlas {rows} rows", seed, sg, frame, [
            form(sg, frame), form(sg, frame, strategy="sorted", tile_h=8)]))
    sg = [_textured_ball(rng, texture(rng, 64, 256), "bilinear", "scalar",
                         46, 45)]
    out.append(scene("textures", "K1 textured", seed, sg, frame,
                     [form(sg, frame), form(sg, frame, zcull=True)]))
    return out


# rows of K11's route -> (frame side, lat/lon range, layer range); T * 256
# > side^2 for 8-row tiles, T * 12 against side^2 for the rows
ZCULL_LAYOUTS = {1: (640, (20, 30), (3, 6)), 2: (640, (44, 48), (9, 10))}


def zcull(seed):
    rng = np.random.default_rng([8, seed])
    out = []
    for r in (1, 2):
        side, ll, layers = ZCULL_LAYOUTS[r]
        lat, lon = (int(v) for v in rng.integers(*ll, 2))
        n = int(rng.integers(*layers, endpoint=True))
        for inner_first in (True, False):
            sg = ts.stack_scene_golden(lat, lon, n, side, side,
                                       inner_first)[0]
            frame = (side, side)
            out.append(scene("zcull", f"rows {r} {n}x({lat}, {lon}) "
                             f"{'innermost' if inner_first else 'outermost'}"
                             " first", seed, sg, frame,
                             [form(sg, frame, zcull=True, skips=True),
                              form(sg, frame)], zcull=True))
    return out


BAND = 8  # the band form's rows a band (csrc/raster.cu)
BAND_HEIGHTS = (24, 40, 48, 56, 64)  # sorted heights the band form runs
# A vertex row's offset from a band boundary 8k: the records round it half
# away from zero, to 8k - 1 (below -0.5), 8k, or 8k + 1 (above +0.5).
EDGE_OFFSETS = (-0.501, -0.499, -0.001, 0.0, 0.001, 0.499, 0.501)


def _band_px(rng, y_top, y_bot, x, width):
    """(3, 2) pixel corners: a triangle with its top corner at row
    ``y_top`` and a ``width`` px base at row ``y_bot`` (or the reverse)."""
    return np.array([[x, y_top], [x + width, y_bot], [x - width, y_bot]], F)


def bands(seed, heights=BAND_HEIGHTS, rows=320):
    """Scenes at the band walk's edges (the sorted route at heights
    without a form of their own): a frame of ``rows`` rows and 128-column
    tile columns, laid out left to right:

    - columns 0-1: at every band boundary 8k of the frame, triangles
      ending just above it and starting just below it, their corners at
      8k + EDGE_OFFSETS (records at 8k - 1, 8k, 8k + 1: the half-open
      row rule on both sides of the boundary);
    - one column per height H of ``heights``: 18 triangles in the first
      8 rows and 18 in the last 8 rows of every H-row tile, nothing in
      between, in alternating order, so each of the tile's two parts
      reaches its first and last band only;
    - a column of exact depth ties: 64 small triangles in the band of rows
      [8 * (rows // 16), + 8) (inside one tile at every height) and 24
      copies right after them, each copy 40 or more stream entries from
      its original (another part), and 40 triangles all covering one
      pixel, 8 of them copies of one;
    - a last column of tall slivers crossing tile boundaries and the
      frame's top and bottom edges (entries that reach into a tile from
      above or below) and zero-height triangles (three corners rounding to
      one row);
    - one-column slivers on columns 0 and 127 of the first and the last
      tile column, and a triangle wider than a tile in each of them (spans
      of all 128 columns);
    - one large triangle over the whole frame but its corners: on the
      side list among the small ones where its bbox covers more tiles than
      the route's expansion (32), its spans all 128 columns wide.
    Forms: the fused sorted route (K4's band form) and the G-buffer one
    (K9 + K10's) at every height, each claiming no drop and, where the
    frame's tiles make it certain, the side list's length."""
    rng = np.random.default_rng([9, seed])
    cols = 4 + len(heights)
    frame = (rows, cols * TILE_W)
    tr_d = ts.baseline_camera_lights(*frame)[0]
    tris = []

    def add(px, z=None):
        px = np.asarray(px, F).reshape(-1, 3, 2)
        tris.append(triangles(px, depths(rng, len(px)) if z is None else z,
                              tr_d))

    # Columns 0-1: both sides of every band boundary.
    for k in range(1, rows // BAND):
        y = float(k * BAND)
        for d in EDGE_OFFSETS:
            xa, xb = rng.uniform(8.0, 2 * TILE_W - 8.0, 2)
            add([_band_px(rng, y - float(rng.uniform(2, 6)), y + d, xa,
                          float(rng.uniform(1.5, 4))),
                 _band_px(rng, y + 2 * float(rng.uniform(1, 3)), y + d, xb,
                          float(rng.uniform(1.5, 4)))])
    # One column per height: the first and last band of each tile.
    for i, th in enumerate(heights):
        x0 = (2 + i) * TILE_W
        for t0 in range(0, rows - th + 1, th):
            a, b = (small_px(rng, 18, (r0 + 0.3, r0 + BAND - 0.7),
                             (x0 + 2.0, x0 + TILE_W - 3.0), 6.0)
                    for r0 in (t0, t0 + th - BAND))
            add(np.stack([a, b], 1))  # alternating: both in every part
    # Exact depth ties in other parts; one pixel under many fragments.
    x0 = (2 + len(heights)) * TILE_W
    yt = float(BAND * (rows // 16))
    base = small_px(rng, 64, (yt + 0.3, yt + 6.6),
                    (x0 + 2.0, x0 + TILE_W - 3.0), 7.0)
    zb = depths(rng, 64)
    src = np.sort(rng.choice(64, 24, replace=False))
    add(np.concatenate([base, base[src]]), np.concatenate([zb, zb[src]]))
    cy, cx = 105.5, x0 + 64.5
    a = rng.uniform(0, 2 * np.pi, 32)
    fan = np.stack([np.stack([cx + 6 * np.cos(a), cy + 6 * np.sin(a)], -1),
                    np.stack([cx + 6 * np.cos(a + 2.2),
                              cy + 6 * np.sin(a + 2.2)], -1),
                    np.stack([cx + 6 * np.cos(a + 4.2),
                              cy + 6 * np.sin(a + 4.2)], -1)], 1)
    zf = depths(rng, 32)
    add(np.concatenate([fan, np.repeat(fan[:1], 8, 0)]),
        np.concatenate([zf, np.repeat(zf[:1], 8, 0)]))
    # Tall slivers, frame edges, zero height, one column, whole tiles.
    x0 = (3 + len(heights)) * TILE_W
    for _ in range(12):
        y0 = float(rng.uniform(-30, rows - 90))
        add(_band_px(rng, y0, y0 + float(rng.uniform(40, 90)),
                     x0 + float(rng.uniform(8, 120)),
                     float(rng.uniform(1, 3))))
    for y_top, y_bot in ((-25.0, 14.6), (rows - 12.4, rows + 30.0)):
        add(_band_px(rng, y_top, y_bot, x0 + float(rng.uniform(20, 100)),
                     6.0))
    for _ in range(8):
        y = float(BAND * rng.integers(2, rows // BAND - 2))
        x = x0 + float(rng.uniform(10, 110))
        add([[x, y + 0.2], [x + 9, y - 0.3], [x + 4, y + 0.4]])
    for c in (0, 127):
        for tc in (0, 3 + len(heights)):
            x = tc * TILE_W + c + 0.1
            y = float(rng.uniform(20, rows - 40))
            add([[x, y], [x + 0.3, y + 14.2], [x + 0.2, y + 3.0]])
    for tc in (0, 3 + len(heights)):
        y = float(rng.uniform(30, rows - 40))
        x = tc * TILE_W
        add([[x - 6.0, y], [x + TILE_W + 6.0, y + 0.6],
             [x + 40.0, y + 17.0]])
    # The large triangle, behind everything else.
    add([[10.0, 5.0], [frame[1] - 12.0, 40.0], [300.0, rows - 5.0]],
        np.full((1, 3), -0.45, F))
    sg = [(obj(mesh(rng, merged(*tris))), {"phong": bool(rng.integers(2))})]
    forms = []
    for th in heights:
        # the large triangle's tiles against the expansion, with a margin
        tiles = ((rows - 5) // th + 1) * cols
        claims = dict(dropped=0)
        if not 24 <= tiles <= 40:
            claims["n_large"] = int(tiles > 32)
        for path in ("fused", "gbuffer"):
            forms.append(form(sg, frame, path, "sorted", th, **claims))
    return [scene("bands", f"{rows}x{frame[1]} at {heights}", seed, sg,
                  frame, forms)]


FAMILY_SCENES = dict(thresholds=thresholds, part_edges=part_edges, ties=ties,
                     side_list=side_list, ragged=ragged, budgets=budgets,
                     textures=textures, zcull=zcull, bands=bands)


def family_scenes(family, seed):
    """The scenes of ``family`` at ``seed``, as the card's sweep runs
    them."""
    return FAMILY_SCENES[family](seed)


def cpu_scenes(family, seed=0) -> list:
    """Small scenes of ``family`` (one; budgets: a sorted and a mask
    one), for the CPU tests against the JAX package in interpret mode: no
    T of 4096 or more, no 2048-slot side list, small frames."""
    if family == "thresholds":
        return thresholds(seed, cases=((513, (54, 114)),))
    if family == "part_edges":
        rng = np.random.default_rng([2, seed])
        return [_part_dense(rng, seed, PART_ENTRIES + 1)]
    if family == "ties":
        return ties(seed)[1:2]
    if family == "side_list":
        return side_list(seed, counts=(40,), fillers=480,
                         layouts=("rows1",))
    if family == "ragged":
        return ragged(seed)[1:]
    if family == "budgets":
        return budgets(seed)[1:]
    if family == "textures":
        return textures(seed, dims=(513,))[2:3]
    if family == "zcull":
        sg = ts.stack_scene_golden(10, 10, 3, 128, 128, True)[0]
        return [scene("zcull", "rows 1 3x(10, 10) innermost first", seed,
                      sg, (128, 128), [form(sg, (128, 128), zcull=True)],
                      zcull=True)]
    if family == "bands":
        return bands(seed, heights=(24, 64), rows=192)
    raise ValueError(family)
