"""The one-launch multi-object scenes of tests/test_torch_batch.py (its
scenes and fixtures, whose module docstring states the bars): each
scene's launch and its frame against the NumPy golden. (Split from that
file so that each file keeps under ten cases.)"""

import numpy as np

from test_torch_batch import case  # noqa: F401 (the scenes' fixture)
from test_torch_render import assert_frame_parity
from tpu_renderer_torch.engine import renderer as tre
from tpu_renderer_torch.ops import raster as trp
from torch_threads import one_torch_thread  # noqa: F401


def test_route(case, monkeypatch):
    """One launch for the whole scene on the route's kernel, the object
    table holding each object's [gid_lo, gid_lo + T) range with the padded
    gids in between, and the side list as each scene fills it; the
    Renderer's frame is that launch's output."""
    k7, plain7 = [], trp.finish_records_plain
    monkeypatch.setattr(trp, "finish_records_plain", lambda r: (
        k7.append(tuple(r.shape)) or plain7(r)))
    scene_t, tr, li = case["scene"]
    h, w = case["hw"]
    launch = tre.prepare_scene(scene_t, tr, li, h, w)
    want = (16, 1) if case["route"] == "k4" else (8, 2)
    assert (launch.route.tile_h, launch.route.rows) == want
    assert launch.kernel is trp.RASTER_KERNELS.get(
        want, trp.raster_narrow_any_kernel)
    gid, table = 0, []
    for obj, cfg in scene_t:
        T = obj.num_triangles
        table.append([gid, gid + T, int(cfg.phong)])
        gid += T + (-T % 128)
    np.testing.assert_array_equal(launch.operands[4].numpy(), table)
    assert k7 == [(85, gid)]  # one K7 on the concatenated table
    if want == (8, 2):
        assert launch.route.budget_factor == (1.2 * 0.45) * (2.0 / 2)
    # The cube of config 5 already spans more than the 2 strip slots of the
    # row-packed streams; the side-list variants add the quad's 2.
    want_large = {("k4", "base"): [], ("k4", "sidelist"): [528, 529],
                  ("k2", "base"): [3328, 3329, 3332, 3333],
                  ("k2", "sidelist"): [3328, 3329, 3332, 3333, 3456, 3457]}
    n_large = int(launch.qbins.n_large)
    assert launch.qbins.large_ids[:n_large].tolist() == want_large[
        case["route"], case["variant"]]
    z, _, color = (a[:h, :w].numpy() for a in launch.run())
    np.testing.assert_array_equal(color, case["port"][0])
    np.testing.assert_array_equal(z, case["port"][1])


def test_frame_vs_golden(case):
    assert_frame_parity(*case["port"], *case["gold"])
    assert int(case["stats"]["bins_dropped"]) == 0
    assert (case["port"][1] > -3.0e38).sum() > 1000
