"""The port's rasterize_gbuffer on JAX's own setup table against the JAX
package's jitted rasterize_pallas (interpret mode), on JAX_CASES of
tests/test_torch_gbuffer.py, whose module docstring states the bars.
(Split from that file, which holds the cases and their cached JAX
references, so that each file keeps under ten cases.)"""

import numpy as np
import pytest

from test_torch_gbuffer import JAX_CASES, jax_case
from test_torch_render import assert_depth_parity
from tpu_renderer_torch.ops import gbuffer as tgb
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("case", JAX_CASES)
def test_gbuffer_vs_jax(case):
    """The raster stage alone: JAX's own setup table through the port's
    rasterize_gbuffer and through rasterize_pallas."""
    (jcov, jgbuf, _), (cov, gbuf, _) = jax_case(case)
    np.testing.assert_array_equal(cov, jcov)
    assert_depth_parity(gbuf[0], jgbuf[0])
    same_z = cov & (gbuf[0] == jgbuf[0])
    assert same_z.mean() > 0.5 * cov.mean()
    for ch in range(1, tgb.GBUF_CHANNELS):
        np.testing.assert_allclose(gbuf[ch][same_z], jgbuf[ch][same_z],
                                   rtol=1e-6, atol=2.4e-7,
                                   err_msg=f"channel {ch}")


@pytest.mark.parametrize("case", JAX_CASES)
def test_gbuffer_stats_vs_jax(case):
    """Binning stats of the same table as JAX's: the counts and the policy
    factor equal, the utilization within 1 ulp."""
    (_, _, jstats), (_, _, stats) = jax_case(case)
    assert set(stats) == set(jstats)
    for k, v in jstats.items():
        if k == "bins_budget_utilization":
            np.testing.assert_allclose(np.asarray(stats[k]), v, rtol=2 ** -23)
        else:
            np.testing.assert_array_equal(np.asarray(stats[k]), v, err_msg=k)
    assert int(stats["bins_dropped"]) == 0
