"""binning.device_ms (binning): device ms a frame between the last setup
kernel and the raster's first op, from the traced frames."""


def read(r):
    if r.trace is None:
        return None
    return r.trace_segment(r.metric("setup.device_ms").KERNELS,
                           r.metric("raster.device_ms").KERNELS, "binning")
