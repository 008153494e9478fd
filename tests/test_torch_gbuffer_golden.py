"""The port's rasterize_gbuffer (K8, K9, K10's plain versions) against the
NumPy golden on every case of tests/test_torch_gbuffer.py's RASTER_CASES:
coverage and every channel bit-exact. (Split from that file, which holds
the cases, so that each file keeps under ten cases.)"""

import numpy as np

from test_torch_gbuffer import gcase  # noqa: F401 (the cases' fixture)
from torch_threads import one_torch_thread  # noqa: F401


def test_gbuffer_vs_golden(gcase):
    (cov, gbuf, _), (gcov, ggbuf) = gcase["port"], gcase["gold"]
    np.testing.assert_array_equal(cov, gcov)
    np.testing.assert_array_equal(gbuf.view(np.uint32), ggbuf.view(np.uint32))
