"""frame_ms_p95 (end to end, CUDA events): the 95th percentile, nearest
rank, of all the window's frame latencies, each from the host starting
the frame's rotation to its planes being ready."""

import math


def p95(values):
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def read(r):
    return p95(r.latencies_ms)
