"""frame_ms_p95.host_paced (per layer): frame_ms_p95's statistic in a
cell whose card is idle most of the window, where the host paces frames
and the tail swings with the host; it moves frame_ms."""


def read(r):
    return r.metric("frame_ms_p95").p95(r.latencies_ms)
