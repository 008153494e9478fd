"""geometry.host_ms (geometry): the host's self ms a frame in
``tr.geometry``: the rotation of every object (``rotate_object``), its child
spans left out; from the spans' block with the profiler off
(portbench/spans.py)."""

from portbench import spans


def read(r):
    return spans.host_ms(r, "geometry")
