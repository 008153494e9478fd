"""The boundary sweep's ``bands`` scenes (tpu_renderer_torch/models/
sweep_scenes.py) sit on the band walk's edges, on CPU tensors, without
JAX.

The band walk (csrc/raster.cu, "The band form") folds each part over the
rows its entries reach, fragment by fragment. Each test prepares the
family's forms as chip_smoke.py's sweep phase does (``sweep_launch``,
loaded from the script by file path) and reads the launch's entries,
reaches and in-span rows through the script's ``band_entries`` (which
raises if an in-span pair falls outside its entry's reach): rows ending
and starting on band boundaries, parts reaching only a tile's first and
last band, entries reaching into a tile from above and below, zero-height
triangles, spans of one and of 128 columns, exact ties across parts, a
pixel under many fragments, and the in-span pair count, which does not
depend on the tile height.
"""

import functools
import importlib.util
import os

import torch
from torch_threads import one_torch_thread  # noqa: F401

from tpu_renderer_torch.geometry.vertex import (EDGE_STRIDE, F_VALID,
                                                F_YMAX, F_YMIN, F_ZG,
                                                GID_LANE)
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.models import sweep_scenes as ss

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 320  # the family's frame rows on the card


@functools.lru_cache(maxsize=1)
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_module", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def fused_entries(seed):
    """{tile_h: (launch, band_entries)} of the family's fused forms."""
    cs = chip_smoke()
    sc, = ss.family_scenes("bands", seed)
    assert sc.frame[0] == ROWS
    scene = ts.to_torch_scene(sc.sg, *sc.camera(), device="cpu")
    out = {}
    for form in sc.forms:
        if form.path != "fused":
            continue
        launch = cs.sweep_launch(sc, form, *scene)
        cs.sweep_check_form(f"bands seed {seed} {form}", form, launch,
                            sc.exact)
        out[form.tile_h] = (launch, cs.band_entries(launch))
    assert sorted(out) == sorted(ss.BAND_HEIGHTS)
    return out


def every_form():
    """(tile_h, (launch, band_entries)) of every fused form at every seed
    of the card's sweep."""
    for seed in ss.SEEDS:
        yield from fused_entries(seed).items()


def span_rows(be):
    """(first, last) in-span tile row of each entry, -1 where none."""
    span = be["span"]
    rows = torch.arange(span.shape[1])
    first = torch.where(span, rows, span.shape[1]).min(1).values
    last = torch.where(span, rows, -1).max(1).values
    return torch.where(last >= 0, first, -1), last


def test_rows_on_both_sides_of_band_boundaries():
    """At every band boundary B inside a tile (B = 8k, not a multiple of
    the tile height), some entry's spans end on row B - 1, some start on
    row B and some cover both; the records hold edges ending and starting
    exactly on B."""
    for th, (launch, be) in every_form():
        first, last = span_rows(be)
        ty = be["tile"] // launch.options["tiles_x"]
        top = ty * th  # frame row of each entry's tile row 0
        ends = set((top + last + 1)[last >= 0].tolist())
        starts = set((top + first)[first >= 0].tolist())
        crosses = set()
        for b in range(ss.BAND, th, ss.BAND):
            over = be["span"][:, b - 1] & be["span"][:, b]
            crosses |= set((top[over] + b).tolist())
        rec = launch.operands[0][be["tri"]]
        edges = rec[:, :GID_LANE].reshape(-1, 3, EDGE_STRIDE)
        valid = edges[..., F_VALID] > 0.5
        ymax = set(edges[..., F_YMAX][valid].tolist())
        ymin = set(edges[..., F_YMIN][valid].tolist())
        inside = [b for b in range(ss.BAND, ROWS, ss.BAND) if b % th]
        assert inside
        for b in inside:
            assert b in ends and b in starts and b in crosses, (th, b)
            assert float(b) in ymax and float(b) in ymin, (th, b)


def test_parts_reach_only_first_and_last_band():
    """In the tile column of each height, every stream part of every
    tile reaches the tile's first and last band and no other, and the
    tiles hold two parts each."""
    p = ss.PART_ENTRIES
    for th, (launch, be) in every_form():
        i = ss.BAND_HEIGHTS.index(th)
        bands = th // ss.BAND
        lit = be["span"].reshape(-1, bands, ss.BAND).any(-1)
        nfb = launch.options["tiles_y"] * launch.options["tiles_x"]
        stream = torch.arange(be["tri"].shape[0]) < int(
            launch.qbins.counts[:nfb].sum())
        mine = stream & (be["tile"] % launch.options["tiles_x"] == 2 + i)
        parts = torch.unique(be["part"][mine])
        assert len(parts) >= 2 * (ROWS // th), th
        for part in parts.tolist():
            got = lit[be["part"] == part].any(0)
            want = torch.zeros(bands, dtype=torch.bool)
            want[[0, -1]] = True
            assert torch.equal(got, want), (th, part, got)
        tiles, n = torch.unique(be["tile"][mine], return_counts=True)
        assert bool((n > p).all()) and bool((n <= 2 * p).all()), (th, n)


def test_entries_reach_in_and_zero_heights():
    """Entries reach into a tile from above (reach from row 0, edges from
    above the tile) and from below (reach to the last row, edges past
    it); the zero-height triangles (valid edges, each with ymin == ymax)
    bin into no tile, so the walk never sees them."""
    for th, (launch, be) in every_form():
        recs = launch.operands[0]
        edges = recs[be["tri"], :GID_LANE].reshape(-1, 3, EDGE_STRIDE)
        valid = edges[..., F_VALID] > 0.5
        big = torch.finfo(torch.float32).max
        ymin = torch.where(valid, edges[..., F_YMIN], big).min(1).values
        ymax = torch.where(valid, edges[..., F_YMAX], -big).max(1).values
        top = (be["tile"] // launch.options["tiles_x"] * th).float()
        lo, hi = be["lo"], be["hi"]
        above = (lo == 0) & (hi > 0) & (ymin < top) & (top > 0)
        below = (hi == th) & (ymax > top + th)
        assert int(above.sum()) >= 4 and int(below.sum()) >= 4, th
        edges = recs[:, :GID_LANE].reshape(-1, 3, EDGE_STRIDE)
        valid = edges[..., F_VALID] > 0.5
        flat = (valid.sum(1) >= 2) & (
            (edges[..., F_YMIN] == edges[..., F_YMAX]) | ~valid).all(1)
        assert int(flat.sum()) >= 8, th
        assert not bool(flat[be["tri"]].any())


def test_spans_of_one_and_128_columns():
    """Some (entry, row) pairs cover all 128 columns of their tile, in a
    stream and on the side list; some cover one column only, tile column
    0 and tile column 127."""
    for th, (launch, be) in every_form():
        frags = be["frags"]
        n = torch.bincount(frags.pair, minlength=be["span"].numel())
        wp = launch.options["tiles_x"] * ss.TILE_W
        col = frags.pix % wp % ss.TILE_W
        entry = torch.arange(be["span"].numel()) // th
        nfb = launch.options["tiles_y"] * launch.options["tiles_x"]
        side = entry >= int(launch.qbins.counts[:nfb].sum())
        full = n == ss.TILE_W
        assert bool((full & ~side).any()) and bool((full & side).any()), th
        one = frags.pair[(n == 1)[frags.pair]]
        cols = set(col[(n == 1)[frags.pair]].tolist())
        assert len(one) and {0, ss.TILE_W - 1} <= cols, (th, cols)
        assert int(launch.qbins.n_large) == 1


def test_ties_across_parts_and_a_crowded_pixel():
    """Copies of triangles (the same edges and depths, other colours and
    gids) share their tile's stream in different parts, and tie in depth
    on every pixel both cover; one pixel lies under 40 or more
    fragments."""
    for th, (launch, be) in every_form():
        # the depth lanes of each edge: valid, ymin, ymax, x0, xg, z0, zg
        rec = launch.operands[0][be["tri"], :GID_LANE].reshape(
            -1, 3, EDGE_STRIDE)[..., :F_ZG + 1]
        first, pairs = {}, []
        for i, row in enumerate(rec.reshape(len(rec), -1)
                                .view(torch.int32).tolist()):
            k = (int(be["tile"][i]), tuple(row))
            if k in first:
                j = first[k]
                assert int(be["part"][j]) != int(be["part"][i]), th
                pairs.append((int(be["tri"][j]), int(be["tri"][i])))
            else:
                first[k] = i
        assert len(pairs) >= 24 + 7, (th, len(pairs))
        frags = be["frags"]
        assert int(torch.bincount(frags.pix).max()) >= 40, th
        z = {}  # gid -> {pixel: z bits}
        for p_, g, v in zip(frags.pix.tolist(), frags.gid.tolist(),
                            frags.z.view(torch.int32).tolist()):
            z.setdefault(g, {})[p_] = v
        shared = 0
        for a, b in pairs:
            for p_ in z.get(a, {}).keys() & z.get(b, {}).keys():
                assert z[a][p_] == z[b][p_], (th, a, b, p_)
                shared += 1
        assert shared > 100, th


def test_in_span_pairs_alike_at_24_and_64():
    """The pairs whose row lies in the triangle's span, counted as
    ``fold_work`` counts them, are as many at 24 as at 64 rows on the
    family's small scene (its 192 rows are whole tiles at both); the band
    walk runs stage A on just those, the PR 11 walk on every row of every
    band, and at 64 rows more of its (part, band) items held nothing."""
    cs = chip_smoke()
    sc, = ss.cpu_scenes("bands")
    assert sc.frame[0] % 24 == 0 and sc.frame[0] % 64 == 0
    scene = ts.to_torch_scene(sc.sg, *sc.camera(), device="cpu")
    got = {}
    for form in sc.forms:
        if form.path == "fused":
            got[form.tile_h] = cs.band_pairs(cs.sweep_launch(sc, form,
                                                             *scene))
    a, b = got[24], got[64]
    assert a["pairs_in_span"] == b["pairs_in_span"] > 0
    for th, g in got.items():
        assert g["pairs_in_span"] <= g["pairs_new"] < g["pairs_old"]
        assert g["pairs_old"] == g["entries"] * th
    assert b["items_empty"] / b["items"] > a["items_empty"] / a["items"]
