"""binning.host_ms (binning): the host's self ms a frame in ``tr.binning``:
the route, the operand tables and the bins (``prepare_raster``,
``prepare_gbuffer`` after ``setup_out``), its child spans left out; from the
spans' block with the profiler off (portbench/spans.py)."""

from portbench import spans


def read(r):
    return spans.host_ms(r, "binning")
