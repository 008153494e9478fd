"""shade.device_ms (shade): device ms a frame after the raster's last
kernel: the deferred shade, the pack and the merge; from the traced
frames."""


def read(r):
    if r.trace is None:
        return None
    return r.trace_segment(r.metric("setup.device_ms").KERNELS,
                           r.metric("raster.device_ms").KERNELS, "shade")
