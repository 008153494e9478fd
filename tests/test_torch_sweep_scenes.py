"""The boundary sweep's scenes (tpu_renderer_torch/models/sweep_scenes.py)
take the routes they are built for, on CPU tensors, without JAX.

For every family at every seed the card's sweep runs (``SEEDS``), each
form of each scene is prepared as chip_smoke.py's sweep phase prepares it
(``sweep_launch``, loaded from the script by file path) and held by
``sweep_check_form``: the route and C entry it claims, the chosen tile's
stream count (part_edges), the side list's length and drops (side_list,
part_edges), the drops of a budget, and none where the scene is exact.
Then per family: the setup form (K1 or the small-object chain) each
single-object scene claims; the duplicated triangles' records equal but
for the gid (ties); tiles that only the side list reaches and an empty
tile column beside filled ones (part_edges). The thresholds the scenes
are built against are ``ops.raster``'s and ``ops.setup``'s.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from tpu_renderer_torch.geometry.vertex import GID_LANE, setup_records
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.models import sweep_scenes as ss
from tpu_renderer_torch.ops import raster as trp
from tpu_renderer_torch.ops import setup as tsp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_module", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cpu_scene(sc):
    return ts.to_torch_scene(sc.sg, *sc.camera(), device="cpu")


def checked_launches(sc):
    """[(form, launch)] of every form of ``sc`` on CPU tensors, each held
    to its claims."""
    cs = chip_smoke()
    scene = cpu_scene(sc)
    out = []
    for form in sc.forms:
        launch = cs.sweep_launch(sc, form, *scene)
        cs.sweep_check_form(f"{sc.family} seed {sc.seed} {sc.name} {form}",
                            form, launch, sc.exact)
        out.append((form, launch))
    if len(sc.sg) == 1:
        (obj, cfg), = scene[0]
        table = tsp.setup_for_raster(obj, scene[1], scene[2], cfg,
                                     frame_height=sc.frame[0],
                                     frame_width=sc.frame[1])
        assert isinstance(table, tsp.SetupOut) == ("tr_setup" in sc.setup)
    return out


def test_thresholds_match_the_port():
    """The generator's thresholds are the port's, and a seed makes the
    same scenes twice."""
    assert ss.AUTO_SORTED_THRESHOLD == trp.AUTO_SORTED_THRESHOLD
    assert ss.FUSED_SETUP_MIN == tsp.FUSED_SETUP_MIN
    assert ss.TILE8_PX_PER_TRI == trp.TILE8_PX_PER_TRI
    assert ss.PACK_ROWS_MAX_PX_PER_TRI == trp.PACK_ROWS_MAX_PX_PER_TRI
    assert ss.PART_ENTRIES == trp.RASTER_PART_ENTRIES
    assert ss.LARGE_CAPACITY == trp.LARGE_CAPACITY
    assert ss.MAX_FUSED_TEX_DIM == trp.MAX_FUSED_TEX_DIM
    assert ss.TILE_W == trp.TILE_W
    for fam in ss.FAMILIES:
        a, b = ss.family_scenes(fam, 1), ss.family_scenes(fam, 1)
        assert [s.name for s in a] == [s.name for s in b]
        for sa, sb in zip(a, b):
            for (oa, _), (ob, _) in zip(sa.sg, sb.sg):
                np.testing.assert_array_equal(oa["vertices"], ob["vertices"])


@pytest.mark.parametrize("family", [f for f in ss.FAMILIES
                                    if f not in ("part_edges", "ties")])
def test_scenes_take_their_routes(family):
    entries = set()
    for seed in ss.SEEDS:
        for sc in ss.family_scenes(family, seed):
            entries |= {f.entry for f, _ in checked_launches(sc)}
    want = {
        "thresholds": {"tr_raster_mask", "tr_raster", "tr_raster_rows1",
                       "tr_raster_narrow_any", "tr_gbuffer_mask",
                       "tr_gbuffer_queue", "tr_raster_zcull",
                       "tr_raster_rows1_zcull"},
        "side_list": {"tr_raster", "tr_raster_rows1", "tr_raster_zcull",
                      "tr_raster_rows1_zcull", "tr_gbuffer_queue"},
        "ragged": {"tr_raster", "tr_raster_rows1", "tr_raster_narrow_any",
                   "tr_raster_mask", "tr_gbuffer_queue", "tr_gbuffer_mask"},
        "budgets": {"tr_raster", "tr_raster_mask", "tr_gbuffer_mask",
                    "tr_gbuffer_queue"},
        "textures": {"tr_raster_mask", "tr_raster_narrow_any",
                     "tr_gbuffer_mask", "tr_gbuffer_queue", "tr_raster"},
        "zcull": {"tr_raster_zcull", "tr_raster_rows1_zcull", "tr_raster",
                  "tr_raster_rows1"},
        "bands": {"tr_raster_narrow_any", "tr_gbuffer_queue"},
    }[family]
    assert want <= entries, want - entries


def test_part_edges_streams_and_tiles():
    """The chosen tile's stream holds k * P - 1, k * P, k * P + 1 entries
    on every form (sweep_check_form); the wide layout's fused forms below
    64 rows have a tile that only the side list reaches and an empty tile
    column between filled ones."""
    seen = set()
    for seed in ss.SEEDS:
        for sc in ss.family_scenes("part_edges", seed):
            for form, launch in checked_launches(sc):
                seen.add((form.claims["stream"][1], form.entry))
                if not sc.name.startswith("wide") or form.path != "fused":
                    continue
                o = launch.options
                nfb = o["tiles_y"] * o["tiles_x"]
                counts = launch.qbins.counts[:-1].reshape(nfb, -1).sum(1)
                lcounts = launch.operands[2]
                assert bool(((counts == 0) & (lcounts > 0)).any())
                cols = counts.reshape(o["tiles_y"], o["tiles_x"]).sum(0)
                empty = torch.nonzero((cols[1:-1] == 0) & (cols[:-2] > 0)
                                      & (cols[2:] > 0))
                assert len(empty) >= 1, cols
    assert {n for n, _ in seen} == set(ss.PART_COUNTS)
    assert {e for _, e in seen} >= {
        "tr_raster", "tr_raster_rows1", "tr_raster_narrow_any",
        "tr_gbuffer_queue", "tr_raster_zcull", "tr_raster_rows1_zcull"}


def parts_apart(launch, pairs):
    """The number of pairs that share a stream of ``launch``, raising
    unless every such pair lies in different parts of it."""
    qb = launch.qbins
    sorted_tri = qb.sorted_tri.tolist()
    shared = set()
    for start, count in zip(qb.starts.tolist(), qb.counts.tolist()):
        pos = {g: i for i, g in enumerate(sorted_tri[start:start + count])}
        for a, b in pairs:
            if a in pos and b in pos:
                assert pos[a] // ss.PART_ENTRIES != pos[b] // ss.PART_ENTRIES
                shared.add((a, b))
    return len(shared)


def test_ties_records_and_parts():
    """Duplicated triangles set up into records equal but for the gid;
    every tie pair shares a stream on each sorted form, in different
    parts of it."""
    for seed in ss.SEEDS:
        for sc in ss.family_scenes("ties", seed):
            launches = checked_launches(sc)
            scene, tr, li = cpu_scene(sc)
            obj, cfg = scene[0]
            rec = setup_records(obj, tr, li, cfg)
            a, b = (torch.tensor(x) for x in zip(*sc.dups))
            assert len(sc.dups) == 24 and len(sc.ties) == 40
            assert torch.equal(rec[:GID_LANE, a].view(torch.int32),
                               rec[:GID_LANE, b].view(torch.int32))
            assert bool((rec[GID_LANE, a] != rec[GID_LANE, b]).all())
            assert bool((rec[:GID_LANE, a] != 0).any())
            for form, launch in launches:
                if form.route[0] == "sorted":
                    assert parts_apart(launch, sc.ties) == len(sc.ties)
            assert {f.entry for f, _ in launches} >= (
                {"tr_raster", "tr_raster_zcull"} if sc.name == "dense" else
                {"tr_raster_mask", "tr_raster_rows1",
                 "tr_raster_narrow_any"})
