"""Each route scene's one raster launch (tests/test_torch_routes.py's
scenes and fixtures): the route's kernel, the setup form the JAX gates
pick, the side list, and the Renderer's frame that launch's output. (Split
from that file so that each file keeps under ten cases.)"""

import numpy as np
import pytest

from test_torch_routes import case  # noqa: F401 (the scenes' fixture)
from tpu_renderer_torch.engine import renderer as tre
from tpu_renderer_torch.ops import raster as trp
from tpu_renderer_torch.ops import setup as tsp
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def spies(monkeypatch):
    """Record every call of K1's and K7's plain versions (the CPU stand-ins
    of those kernels)."""
    seen = dict(k1=[], k7=[])
    k1, k7 = tsp.setup_plain, trp.finish_records_plain

    def k1_spy(*a, **k):
        seen["k1"].append(a[1].shape[2])
        return k1(*a, **k)

    def k7_spy(rec_t):
        seen["k7"].append(tuple(rec_t.shape))
        return k7(rec_t)

    monkeypatch.setattr(tsp, "setup_plain", k1_spy)
    monkeypatch.setattr(trp, "finish_records_plain", k7_spy)
    return seen


ROUTES = {  # route -> (tile_h, rows), K1 inputs, K7 inputs
    "k3": ((8, 1), [5428], []),
    "k4": ((16, 1), [], [(85, 528)]),
    "mixed": ((8, 2), [4140, 12], []),
}


def test_route(case, spies):
    """The scene's one raster launch, on the route's kernel, with the
    port's setup form (one object: K1 from 4096 triangles, else
    setup_records and K7; several of 4096 or more in all: K1's grouped
    form, every object through K1's plain version), and the side list
    filled only in the side-list variant; the Renderer's frame is that
    launch's output."""
    scene_t, tr, li = case["scene"]
    h, w = case["hw"]
    launch = tre.prepare_scene(scene_t, tr, li, h, w)
    want, k1, k7 = ROUTES[case["route"]]
    if case["variant"] == "sidelist":
        # The quad's 2 triangles join the one object (in the mixed scene
        # they join the cube, which still pads to 128).
        k1 = k1[:-1] + [k1[-1] + 2] if case["route"] == "mixed" else [
            t + 2 for t in k1]
        k7 = [(r, t + 2) for r, t in k7]
    assert spies["k1"] == k1 and spies["k7"] == k7
    assert (launch.route.strategy, launch.route.tile_h,
            launch.route.rows) == ("sorted",) + want
    assert launch.kernel is trp.RASTER_KERNELS.get(
        want, trp.raster_narrow_any_kernel)
    assert launch.operands[4].shape == (len(scene_t), 3)
    n_large = int(launch.qbins.n_large)
    assert (n_large > 0) == (case["variant"] == "sidelist")
    assert (int(launch.operands[2].sum()) > 0) == (n_large > 0)
    z, _, color = (a[:h, :w].numpy() for a in launch.run())
    np.testing.assert_array_equal(color, case["port"][0])
    np.testing.assert_array_equal(z, case["port"][1])
