"""engine.launches (engine): device ops a frame launched while the host was
in ``tr.render`` and in none of its child spans, each op matched to its
launch by correlation id; from the spans' profiled block
(portbench/spans.py)."""

from portbench import spans


def read(r):
    return spans.credited(r, "engine", "launches")
