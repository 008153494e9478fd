"""raster.host_ms (raster): the host's self ms a frame in ``tr.raster``: the
launch's ``run`` (K2, or K9 + K10) and its crop and stats, its child spans
left out; from the spans' block with the profiler off (portbench/spans.py)."""

from portbench import spans


def read(r):
    return spans.host_ms(r, "raster")
