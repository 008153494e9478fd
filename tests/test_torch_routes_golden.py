"""Each route scene's frame through Renderer (tests/test_torch_routes.py's
scenes and fixtures) against the NumPy golden, within the budgets of that
file. (Split from it so that each file keeps under ten cases.)"""

from test_torch_render import assert_frame_parity
from test_torch_routes import case  # noqa: F401 (the scenes' fixture)
from torch_threads import one_torch_thread  # noqa: F401


def test_frame_vs_golden(case):
    assert_frame_parity(*case["port"], *case["gold"])
    assert int(case["stats"]["bins_dropped"]) == 0
    assert (case["port"][1] > -3.0e38).sum() > 1000
