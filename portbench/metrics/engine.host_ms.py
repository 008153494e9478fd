"""engine.host_ms (engine): the host's self ms a frame in ``tr.render``: the
engine's glue outside every layer's span (stats, specs, merge bookkeeping),
its child spans left out; from the spans' block with the profiler off
(portbench/spans.py)."""

from portbench import spans


def read(r):
    return spans.host_ms(r, "engine")
