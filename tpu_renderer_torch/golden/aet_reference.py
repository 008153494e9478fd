"""Model-level active-edge-table golden — the reference's LITERAL algorithm.

The port's copy of ``tpu_renderer/golden/aet_reference.py``, on the port's
copy of the spec (``cpu_reference``).

Unlike cpu_reference.py (per-triangle closed form — the spec the TPU path
matches), this module walks the whole-model AET exactly like ``DrawModel``
(projekt.cpp:162-601): ALL edges of the model in one Y-sorted table,
sequential row walk with insert/retire/sort, spans between ADJACENT PAIRS of
active edges (even when they belong to different triangles), sequential
``attr += gradient`` stepping, and the crossing-swap re-sort.

Its purpose is to QUANTIFY golden divergence #2: on the scenes the reference
targets (closed, backface-culled surfaces whose front faces don't overlap in
screen space) this pairing equals per-triangle spans; on overlapping
geometry it mis-fills. tests/test_aet.py measures both.

Python-loop implementation — small frames only.
"""

from __future__ import annotations

import numpy as np

from .cpu_reference import (
    DEPTH_CLEAR,
    pack_argb,
    setup_edges,
    shade,
)

F = np.float32


class _Edge:
    __slots__ = ("ymin", "ymax", "x", "xg", "z", "zg", "oz", "ozg",
                 "u", "ug", "v", "vg", "col", "colg", "n", "ng", "left")


def _collect_edges(edges):
    """Flatten the per-triangle edge table into a mutable model-level list,
    sorted by ymin (MergeSort by YMin, projekt.cpp:4117) — numpy's stable
    mergesort matches the reference's stable merge."""
    out = []
    T = edges["valid"].shape[0]
    for t in range(T):
        if not edges["visible"][t]:
            continue
        for e in range(3):
            if not edges["valid"][t, e]:
                continue
            E = _Edge()
            E.ymin = int(edges["ymin"][t, e])
            E.ymax = int(edges["ymax"][t, e])
            E.x = F(edges["x0"][t, e])
            E.xg = F(edges["xg"][t, e])
            E.z = F(edges["z0"][t, e])
            E.zg = F(edges["zg"][t, e])
            E.oz = F(edges["oz0"][t, e])
            E.ozg = F(edges["ozg"][t, e])
            E.u = F(edges["u0"][t, e])
            E.ug = F(edges["ug"][t, e])
            E.v = F(edges["v0"][t, e])
            E.vg = F(edges["vg"][t, e])
            E.col = edges["col0"][t, e].copy()
            E.colg = edges["colg"][t, e].copy()
            E.n = edges["n0"][t, e].copy()
            E.ng = edges["ng"][t, e].copy()
            E.left = F(edges["left"][t, e])
            out.append(E)
    out.sort(key=lambda E: E.ymin)  # python sort is stable, like MergeSort
    return out


def rasterize_aet(edges, height, width):
    """Whole-model AET rasterization (DrawModel row loop,
    projekt.cpp:198-599). Returns (covered, gbuf) like cpu_reference."""
    from .cpu_reference import GBUF_CHANNELS

    model = _collect_edges(edges)
    covered = np.zeros((height, width), bool)
    gbuf = np.zeros((height, width, GBUF_CHANNELS), F)
    gbuf[:, :, 0] = DEPTH_CLEAR
    if not model:
        return covered, gbuf

    first_row = model[0].ymin
    max_row = min(max(E.ymax for E in model), height)

    active = []  # kept sorted by (x, xg, left) via insertion (cpp:202-259)
    pending = list(model)

    for row in range(first_row, max_row):
        # insert edges whose ymin == row at their sorted position
        still = []
        for E in pending:
            if E.ymin == row:
                pos = len(active)
                for i, A in enumerate(active):
                    if (E.x < A.x or (E.x == A.x and (
                            E.xg < A.xg or (E.xg == A.xg
                                            and E.left < A.left)))):
                        pos = i
                        break
                active.insert(pos, E)
            else:
                still.append(E)
        pending = still
        # retire edges past ymax (cpp:262-296)
        active = [E for E in active if E.ymax > row]

        # fill spans between adjacent pairs (cpp:298-539)
        i = 0
        while i + 1 < len(active):
            L, R = active[i], active[i + 1]
            _fill_span_seq(L, R, row, covered, gbuf, width)
            i += 2

        # step all active edges sequentially (cpp:542-560) and bubble-fix
        # crossings (cpp:562-584 does one local swap; a sort keeps the same
        # invariant)
        for E in active:
            E.x = E.x + E.xg
            E.z = E.z + E.zg
            E.col = E.col + E.colg
            nn = E.n + E.ng
            d = F(np.sqrt(np.float32(nn[0] * nn[0] + nn[1] * nn[1]
                                     + nn[2] * nn[2])))
            if d > 0:
                E.n = nn * (F(1) / d)  # per-row renormalize (cpp:551-552)
            E.u = E.u + E.ug
            E.v = E.v + E.vg
            E.oz = E.oz + E.ozg
        active.sort(key=lambda E: E.x)
    return covered, gbuf


def _fill_span_seq(L, R, row, covered, gbuf, W):
    """Sequentially-stepped span fill (projekt.cpp:303-539)."""
    xl, xr = L.x, R.x
    xd = F(np.sign(xr - xl) * np.floor(np.abs(xr - xl) + F(0.5)))  # roundf
    if xd != 0:
        inv = F(1) / xd
        zinc = (R.z - L.z) * inv
        ozinc = (R.oz - L.oz) * inv
        uinc = (R.u - L.u) * inv
        vinc = (R.v - L.v) * inv
        cinc = (R.col - L.col) * inv
        ninc = (R.n - L.n) * inv
    else:
        zinc = ozinc = uinc = vinc = F(0)
        cinc = np.zeros(4, F)
        ninc = np.zeros(3, F)
    xoff = -xl if xl < 0 else F(0)
    lx = F(0) if xl < 0 else (F(W - 1) if xl >= W else xl)
    rx = F(0) if xr < 0 else (F(W - 1) if xr >= W else xr)
    minx = min(int(np.sign(lx) * np.floor(abs(lx) + F(0.5))), W - 1)
    maxx = min(int(np.sign(rx) * np.floor(abs(rx) + F(0.5))), W - 1)
    if maxx < minx:
        return
    z = L.z + xoff * zinc
    oz = L.oz + xoff * ozinc
    u = L.u + xoff * uinc
    v = L.v + xoff * vinc
    col = L.col + xoff * cinc
    n = L.n + xoff * ninc
    for x in range(minx, maxx + 1):
        if z > gbuf[row, x, 0]:
            gbuf[row, x, 0] = z
            gbuf[row, x, 1:5] = col
            gbuf[row, x, 5:8] = n
            gbuf[row, x, 8] = u
            gbuf[row, x, 9] = v
            gbuf[row, x, 10] = oz
            covered[row, x] = True
        z = z + zinc
        oz = oz + ozinc
        u = u + uinc
        v = v + vinc
        col = col + cinc
        n = n + ninc


def render(scene, transform, lights, height, width, clear_color=0):
    """End-to-end model-level-AET render (same API as cpu_reference.render)."""
    color = np.full((height, width), np.uint32(clear_color), np.uint32)
    depth = np.full((height, width), DEPTH_CLEAR, F)
    with np.errstate(divide="ignore", invalid="ignore"):
        for obj, cfg in scene:
            phong = bool(cfg.get("phong", False))
            textured = cfg.get("texture", None) is not None
            edges = setup_edges(obj, transform, lights, phong, textured)
            covered, gbuf = rasterize_aet(edges, height, width)
            rgba, covered = shade(
                covered, gbuf, transform, lights, phong,
                cfg.get("texture"), cfg.get("uv_mode", "scalar"),
                cfg.get("filter_mode", "nearest"),
            )
            packed = pack_argb(rgba)
            win = covered & (gbuf[:, :, 0] > depth)
            depth = np.where(win, gbuf[:, :, 0], depth)
            color = np.where(win, packed, color)
    return color, depth
