"""setup.host_ms (setup): the host's self ms a frame in ``tr.setup``:
``setup_for_raster`` (K1) and ``setup_out``'s K7 branch, its child spans
left out; from the spans' block with the profiler off (portbench/spans.py)."""

from portbench import spans


def read(r):
    return spans.host_ms(r, "setup")
