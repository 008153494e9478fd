"""The shaded routes' split fold and K11's per-part cull replay on the CPU.

On the card K2, K3, K4 and K11 fold each tile's streams in parts of at
most P entries (``ops.raster.RASTER_PART_ENTRIES``), the side list one
more part of each tile it reaches, many blocks at once, merge the parts'
winners per pixel by one atomicMax on a 64-bit (z desc, gid asc) key, and
shade each pixel's winner in a finalize per tile (csrc/raster.cu, "The
sorted strategy, each tile's entries split"). The CUDA code cannot run
here, so these tests hold the rules it rests on, with the key mirror of
tests/test_torch_split.py:

- the plain shaded split fold: ``raster_plain``'s fragments grouped by
  part (parts of 1, 3 and 16 entries of each stream), each part's winners
  merged by the key, then ``_finalize_plain``, equal bit for bit to
  ``raster_plain`` on route scenes of K2's route (two streams a tile), K3's
  and K4's at 16 and 32 rows, with the side list, textured objects (K5),
  several objects, and a scene drawn twice, so that equal-z ties cross
  part boundaries in both streams;
- ``zcull_skips_plain(..., part_entries=P)``, the floor under K11's count
  of skipped batches: at a P that holds every stream in one part it equals
  the serial replay, at smaller P it is at most that, on both zcull
  stacks.

Imports no JAX: seconds in all.
"""

import functools

import pytest
import torch

from tpu_renderer_torch.engine.renderer import prepare_scene
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.models.route_scenes import (
    route_scene,
    zcull_stack,
)
from tpu_renderer_torch.ops import raster as trp

from test_torch_split import doubled, split_merge, split_parts
from torch_threads import one_torch_thread  # noqa: F401

PART_SIZES = (1, 3, 16)


@functools.lru_cache(maxsize=None)
def launch_and_plain(name, variant, tile_h):
    """The fused launch of a route scene's variant ('doubled': the base
    scene with every triangle drawn twice) on the CPU, on the sorted
    strategy at ``tile_h`` rows (None: the 'auto' route), and
    raster_plain's output for it."""
    sg, (h, w) = route_scene(name, "base" if variant == "doubled"
                             else variant)
    if variant == "doubled":
        sg = doubled(sg)
    scene, tr, li = ts.to_torch_scene(sg, *ts.baseline_camera_lights(h, w),
                                      device="cpu")
    knobs = {} if tile_h is None else dict(strategy="sorted", tile_h=tile_h)
    launch = prepare_scene(scene, tr, li, h, w, **knobs)
    assert launch.route.strategy == "sorted"
    assert int(launch.stats()["bins_dropped"]) == 0
    return launch, launch.run_plain()


def split_shaded_plain(launch, part_entries):
    """The plain shaded split fold: the launch's fragments with the planes
    its objects read, merged part by part (``split_merge``), then the
    finalize (``_finalize_plain``). Returns ((z, gid, colour), parts per
    tile, (pixel, z, gid) of every part's winner at each pixel)."""
    recs, qbins, lcounts, params, objs, texs, atlas = launch.operands
    o, tile_h = launch.options, launch.route.tile_h
    nfb = o["tiles_y"] * o["tiles_x"]
    hp, wp = o["tiles_y"] * tile_h, o["tiles_x"] * trp.TILE_W
    offs = trp.launch_fields(objs, texs)
    frags = trp.raster_fragments(
        recs, qbins, lcounts, tile_h=tile_h, tiles_y=o["tiles_y"],
        tiles_x=o["tiles_x"], row0=o["row0"], col0=o["col0"],
        frame_width=o["frame_width"], fields=offs[0])
    part, tri, per_tile = split_parts(qbins, lcounts, nfb, tile_h,
                                      part_entries)
    assert torch.equal(tri, frags.pair_tri.to(torch.int64))
    z, gid, planes, groups = split_merge(frags, part, hp, wp)
    px = (torch.arange(wp) + o["col0"]).to(torch.float32)[None, :].expand(
        hp, wp)
    py = (torch.arange(hp) + o["row0"]).to(torch.float32)[:, None].expand(
        hp, wp)
    color = trp._finalize_plain(z, gid, planes, params, objs, texs, atlas,
                                px, py, o["n_lights"], offs)
    return (z, gid, color), per_tile, groups


@pytest.mark.parametrize("name, variant, tile_h, route", [
    ("mixed", "sidelist", None, (8, 2, 2)),  # K2: two objects
    ("k2multi", "textured", None, (8, 2, 4)),  # K2: four, K5 nearest
    ("mixed", "doubled", None, (8, 2, 2)),  # K2: equal-z ties
    ("k3", "sidelist", None, (8, 1, 1)),  # K3
    ("k3", "textured", None, (8, 1, 1)),  # K3, K5 bilinear
    ("k4", "sidelist", None, (16, 1, 1)),  # K4
    ("k4", "sidelist", 32, (32, 1, 1)),  # K4 on 32-row tiles
])
def test_split_shaded_fold_equals_raster_plain(name, variant, tile_h, route):
    """Parts of 1, 3 and 16 stream entries merged by the key and shaded
    give raster_plain's z, gid and colour bit for bit, with tiles of
    several parts in each stream and the side list a part of its own; on
    the doubled scene, equal-z winners of different parts meet at many
    pixels of both strips and the smaller gid (the first copy) wins."""
    launch, want = launch_and_plain(name, variant, tile_h)
    r = launch.route
    assert (r.tile_h, r.rows, launch.objs.shape[0]) == route
    if variant == "sidelist":
        assert int(launch.qbins.n_large) > 0
    textured = int((launch.texs[:, 1] > 0).sum())
    assert (textured > 0) == (variant == "textured")
    for part_entries in PART_SIZES:
        got, per_tile, (gpix, gz, gg) = split_shaded_plain(launch,
                                                           part_entries)
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), (
                part_entries)
        assert int(per_tile.max()) > 2
        assert int((got[1] >= 0).sum()) > 1000
        if variant == "doubled":
            order = torch.argsort(gpix * 2 ** 32 + gg.to(torch.int64))
            p, z, g = gpix[order], gz[order], gg[order]
            tie = (p[1:] == p[:-1]) & (z[1:] == z[:-1]) & (g[1:] != g[:-1])
            assert int(tie.sum()) > 100
            wp = launch.options["tiles_x"] * trp.TILE_W
            for h in range(r.rows):  # ties in both streams' strips
                rows = p[1:][tie] // wp % r.tile_h
                assert bool(((rows // (r.tile_h // r.rows)) == h).any())
            objs = launch.objs.tolist()
            half = [(lo + hi) // 2 for lo, hi, _ in objs]
            g = got[1][got[1] >= 0]
            first = torch.zeros_like(g, dtype=torch.bool)
            for (lo, _, _), mid in zip(objs, half):
                first |= (g >= lo) & (g < mid)
            assert bool(first.all())


@pytest.mark.parametrize("rows", [1, 2])
def test_zcull_part_replay(rows):
    """zcull_skips_plain with each stream cut into parts that cull against
    their own winners alone: at a part size that holds every stream whole
    it is the serial replay; at smaller part sizes that are whole numbers
    of batches (so the batches are the serial replay's) it never skips
    more, nor at a part size that divides another more than at that one;
    at 256 entries a part it still skips batches (at 64 none: K11's count
    at its default part size rests on the keys)."""
    scene, tr, li, (h, w) = zcull_stack(rows, "cpu")
    launch = prepare_scene(scene, tr, li, h, w, zcull=True)
    assert launch.kernel is trp.ZCULL_KERNELS[(8, rows)]
    kw = dict(tile_h=8, **launch.options)
    ops = launch.operands[:2]
    serial = trp.zcull_skips_plain(*ops, **kw)
    most = int(launch.qbins.counts.max())
    assert trp.zcull_skips_plain(*ops, part_entries=most, **kw) == serial
    assert trp.zcull_skips_plain(*ops, part_entries=2 ** 31 - 1,
                                 **kw) == serial
    by_part = [trp.zcull_skips_plain(*ops, part_entries=p, **kw)
               for p in (256, 128, 64)]
    assert serial >= by_part[0] >= by_part[1] >= by_part[2] >= 0
    assert by_part[0] > 0
