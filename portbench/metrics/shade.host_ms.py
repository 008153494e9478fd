"""shade.host_ms (shade): the host's self ms a frame in ``tr.shade``: the
deferred shade, pack and merge (``_draw_deferred``), its child spans left
out; from the spans' block with the profiler off (portbench/spans.py)."""

from portbench import spans


def read(r):
    return spans.host_ms(r, "shade")
