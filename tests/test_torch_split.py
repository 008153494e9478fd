"""K9's split fold and key merge (csrc/raster.cu, "The sorted strategy,
each tile's entries split") on the CPU.

On the card K9 folds each tile's stream in parts of at most P entries
(``ops.raster.RASTER_PART_ENTRIES``), the side list one more part of each
tile it reaches, many blocks at once, and merges the parts' winners per
pixel by one atomicMax on a 64-bit key. The CUDA code cannot run here, so
these tests hold its two rules with a mirror in torch:

- the key: its unsigned order is the fold's (z descending, gid ascending)
  order, +-0 one z, on -FLT_MAX, subnormals, +-inf and random f32;
- the plain split fold: ``gbuffer_plain``'s fragments grouped by part
  (parts of 1, 3 and 16 entries), each part's winners by
  ``resolve_winners``, merged by the key, equal bit for bit to
  ``gbuffer_plain`` on route scenes at 8 and 32 rows with the side list
  (here k4's; K3's and k4's with every triangle drawn twice, so that
  equal-z ties cross part boundaries, in test_torch_split_doubled.py,
  which keeps each file under ten cases).

Imports no JAX: a few seconds in all.
"""

import functools

import numpy as np
import pytest
import torch

from tpu_renderer_torch.models import primitives as tp
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.models.route_scenes import route_scene
from tpu_renderer_torch.ops import gbuffer as tgb
from tpu_renderer_torch.ops import raster as trp
from tpu_renderer_torch.ops import setup as tsp
from torch_threads import one_torch_thread  # noqa: F401

I64_MIN = -(2 ** 63)


def winner_key(z, g):
    """The u64 key of ``winner_key`` in csrc/raster.cu, as int64 bits: the
    high word z's bits made monotone after -0 becomes +0, the low word
    0xFFFFFFFF - g."""
    u = z.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(u == 0x80000000, 0, u)
    ordered = torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)
    low = 0xFFFFFFFF - g.to(torch.int64)
    # (ordered << 32) | low as u64, written in int64 without overflow.
    return ((ordered - 2 ** 31) << 32 | low) ^ I64_MIN


def unsigned_order(key):
    """int64 whose signed order is the u64 key's unsigned order."""
    return key ^ I64_MIN


def test_key_order_is_the_folds_order():
    """For every pair of (z, gid), z never NaN: key a > key b (unsigned)
    exactly when the fold keeps a over b, z_a > z_b or z_a == z_b and
    g_a < g_b; equal keys exactly when both are equal (+-0 one z)."""
    rng = np.random.default_rng(7)
    f32 = np.float32
    tiny = np.finfo(f32).tiny
    special = np.array(
        [0.0, -0.0, np.finfo(f32).max, -np.finfo(f32).max, np.inf, -np.inf,
         tiny, -tiny, 1e-45, -1e-45, 3e-39, -3e-39, 1.0, -1.0, 0.5, -0.5],
        f32)
    rand = np.concatenate([
        rng.normal(size=60).astype(f32),
        (rng.normal(size=30) * 1e30).astype(f32),
        (rng.normal(size=30) * 1e-40).astype(f32)])
    zs = np.concatenate([special, rand, rand[:20]])  # repeats make ties
    gs = rng.integers(0, 8, zs.size)
    gs[:4] = [0, 0, 2 ** 31 - 1, 2 ** 31 - 2]
    z, g = torch.from_numpy(zs), torch.from_numpy(gs)
    k = unsigned_order(winner_key(z, g))
    za, zb = z[:, None], z[None, :]
    ga, gb = g[:, None], g[None, :]
    keeps_a = (za > zb) | ((za == zb) & (ga < gb))
    same = (za == zb) & (ga == gb)
    assert torch.equal(k[:, None] > k[None, :], keeps_a)
    assert torch.equal(k[:, None] == k[None, :], same)


def test_key_bits():
    """The key's bits, worked by hand: +-0 share one key, gid 0 has the
    largest low word, and a negative z's high word lies below a positive
    one's (sign bit flipped, negative z inverted)."""
    z = torch.tensor([0.0, -0.0, 1.0, -1.0, float("inf")])
    g = torch.tensor([0, 0, 5, 5, 2 ** 31 - 1])
    want = [(0x80000000 << 32) | 0xFFFFFFFF,
            (0x80000000 << 32) | 0xFFFFFFFF,
            (0xBF800000 << 32) | (0xFFFFFFFF - 5),
            (0x407FFFFF << 32) | (0xFFFFFFFF - 5),
            (0xFF800000 << 32) | 0x80000000]
    got = [int(v) % 2 ** 64 for v in winner_key(z, g)]
    assert got == want


def split_parts(qbins, lcounts, nfb, tile_h, part_entries):
    """(part id of every (entry, row) pair in ``raster_fragments``' pair
    order, tri of every pair, parts of every tile), with rs streams a tile
    (rs = 1 on K9's route): entry i of stream h of tile t goes to part
    part_off[t] + (the parts of t's streams before h) + i // P, t's side
    list (where lcounts[t] > 0) to the part after its streams' parts,
    part_off the exclusive prefix sum of the parts per tile
    (part_scan_kernel)."""
    rs = qbins.starts.shape[0] // (nfb + 1)
    counts = qbins.counts[:rs * nfb].to(torch.int64).reshape(nfb, rs)
    starts = qbins.starts[:rs * nfb].to(torch.int64).reshape(nfb, rs)
    side = (lcounts > 0).to(torch.int64)
    stream_parts = (counts + part_entries - 1) // part_entries
    per_tile = stream_parts.sum(dim=1) + side
    part_off = torch.cumsum(per_tile, 0) - per_tile
    before = torch.cumsum(stream_parts, 1) - stream_parts
    strip = functools.partial(torch.repeat_interleave, repeats=tile_h // rs)
    parts, tris = [], []
    for h in range(rs):
        cn = counts[:, h]
        tile = torch.repeat_interleave(torch.arange(nfb), cn)
        first = torch.cumsum(cn, 0) - cn
        pos = torch.arange(tile.shape[0]) - first[tile]
        tris.append(strip(qbins.sorted_tri.to(torch.int64)[
            starts[tile, h] + pos]))
        parts.append(strip(part_off[tile] + before[tile, h]
                           + pos // part_entries))
    nl = int(qbins.n_large)
    ltiles = torch.nonzero(lcounts > 0).reshape(-1)
    side_part = (part_off + stream_parts.sum(dim=1))[ltiles]
    rows = functools.partial(torch.repeat_interleave, repeats=nl * tile_h)
    side_tri = qbins.large_ids[:nl].to(torch.int64).repeat_interleave(
        tile_h).repeat(ltiles.shape[0])
    return (torch.cat(parts + [rows(side_part)]),
            torch.cat(tris + [side_tri]), per_tile)


def split_merge(frags, part, hp, wp):
    """The fragments (``raster_fragments``) folded part by part (``part``
    the part of each pair), each part's winner at each pixel by
    ``resolve_winners``, the parts of a pixel merged by the max unsigned
    key. Returns (z (hp, wp), DEPTH_CLEAR where uncovered; gid (hp, wp)
    i32, -1; the winner's plane of each of ``frags.attrs``, 0) and (pixel,
    z, gid) of every part's winner at each pixel it covers."""
    group, pix_of = torch.unique(part[frags.pair] * (hp * wp) + frags.pix,
                                 return_inverse=True)
    gz, gg, gplanes = trp.resolve_winners(frags._replace(pix=pix_of), 1,
                                          group.shape[0])
    gz, gg = gz[0], gg[0]
    assert bool((gg >= 0).all())  # every group holds a fragment
    gpix = group % (hp * wp)
    gkey = unsigned_order(winner_key(gz, gg))
    best = torch.full((hp * wp,), I64_MIN, dtype=torch.int64)
    best = best.scatter_reduce(0, gpix, gkey, "amax")
    win = gkey == best[gpix]
    assert int(win.sum()) == int(torch.unique(gpix).numel())
    wpix = gpix[win]
    gid = torch.full((hp * wp,), -1, dtype=torch.int32)
    gid[wpix] = gg[win]
    planes = []
    for fill, plane in [(trp.DEPTH_CLEAR, gz[None])] + [
            (0.0, p) for p in gplanes]:
        out = torch.full((hp * wp,), fill, dtype=torch.float32)
        out[wpix] = plane[0][win]
        planes.append(out.reshape(hp, wp))
    return planes[0], gid.reshape(hp, wp), planes[1:], (gpix, gz, gg)


def split_gbuffer_plain(launch, part_entries):
    """The plain split fold of a G-buffer launch: its fragments with the 10
    attribute planes merged part by part (``split_merge``). Returns ((gid,
    gbuf), parts per tile, (pixel, z, gid) of every group's winner)."""
    recs, qbins, lcounts = launch.operands
    o = launch.options
    nfb = o["tiles_y"] * o["tiles_x"]
    hp, wp = o["tiles_y"] * o["tile_h"], o["tiles_x"] * trp.TILE_W
    frags = trp.raster_fragments(recs, qbins, lcounts, **o,
                                 fields=tgb.ATTR_FIELDS)
    part, tri, per_tile = split_parts(qbins, lcounts, nfb, o["tile_h"],
                                      part_entries)
    assert torch.equal(tri, frags.pair_tri.to(torch.int64))
    z, gid, planes, groups = split_merge(frags, part, hp, wp)
    return (gid, torch.stack([z] + planes)), per_tile, groups


def doubled(sg):
    """The scene with every object's triangles drawn twice (the copy after
    the original, so its gids are larger): equal-z ties at every pixel."""
    return [(dict(p=obj["p"], **tp.merge_meshes(obj, obj)), cfg)
            for obj, cfg in sg]


@functools.lru_cache(maxsize=None)
def launch_and_plain(name, tile_h):
    """The sorted G-buffer launch of a route scene's side-list variant (or
    'k4 doubled': k4's, every triangle twice) at ``tile_h`` rows on the
    CPU, and gbuffer_plain's output for it."""
    base = name.split()[0]
    sg, (h, w) = route_scene(base, "sidelist")
    if name.endswith("doubled"):
        sg = doubled(sg)
    tr_d, li_d = ts.baseline_camera_lights(h, w)
    scene, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    obj, cfg = scene[0]
    table = tsp.setup_for_raster(obj, tr, li, cfg, frame_height=h,
                                 frame_width=w)
    launch = tgb.prepare_gbuffer(table, h, w, strategy="sorted",
                                 tile_h=tile_h)
    assert (launch.route.strategy, launch.route.tile_h) == ("sorted", tile_h)
    assert int(launch.stats()["bins_dropped"]) == 0
    assert int(launch.qbins.n_large) > 0
    return launch, launch.run_plain(), obj.num_triangles


def check_split_fold(name, tile_h, part_entries):
    """Parts of ``part_entries`` entries merged by the key give
    gbuffer_plain's gid and 11 planes bit for bit (the test below and
    test_torch_split_doubled.py)."""
    launch, want, n_tri = launch_and_plain(name, tile_h)
    got, per_tile, (gpix, gz, gg) = split_gbuffer_plain(launch,
                                                        part_entries)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert int(per_tile.max()) > 2
    assert int((got[0] >= 0).sum()) > 1000
    if name.endswith("doubled"):
        # Pixels where two parts' winners tie in z with different gids.
        order = torch.argsort(gpix * 2 ** 32 + gg.to(torch.int64))
        p, z, g = gpix[order], gz[order], gg[order]
        tie = (p[1:] == p[:-1]) & (z[1:] == z[:-1]) & (g[1:] != g[:-1])
        assert int(tie.sum()) > 100
        assert int(got[0].max()) < n_tri // 2  # the first copy wins


@pytest.mark.parametrize("part_entries", [1, 3, 16])
@pytest.mark.parametrize("name, tile_h", [("k4", 8), ("k4", 32)])
def test_split_fold_equals_gbuffer_plain(name, tile_h, part_entries):
    """Parts of 1, 3 and 16 entries merged by the key give gbuffer_plain's
    gid and 11 planes bit for bit, with tiles of several parts and the
    side list a part of its own (K3's scene and the doubled ones:
    test_torch_split_doubled.py)."""
    check_split_fold(name, tile_h, part_entries)
