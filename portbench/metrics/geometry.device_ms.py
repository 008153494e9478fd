"""geometry.device_ms (geometry): device ms a frame of the ops launched in
``tr.geometry`` (the rotation), the union of their intervals; from the
spans' profiled block (portbench/spans.py)."""

from portbench import spans


def read(r):
    return spans.credited(r, "geometry", "device_ms")
