"""setup.device_ms (setup): device ms a frame from the first to the last
setup kernel (K1), from the traced frames."""

KERNELS = ("setup_kernel", "records_kernel")


def read(r):
    if r.trace is None:
        return None
    raster = r.metric("raster.device_ms").KERNELS
    return r.trace_segment(KERNELS, raster, "setup")
