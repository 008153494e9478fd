"""raster.device_ms (raster): device ms a frame from the raster's first
op (its key fill) to its last kernel: K2's part scan, walk and finalize on
the fused route, K9 + K10 on the G-buffer route; from the traced
frames."""

KERNELS = ("part_scan_kernel", "split_walk_kernel", "split_finalize_kernel",
           "band_walk_kernel", "mask_kernel")


def read(r):
    if r.trace is None:
        return None
    return r.trace_segment(r.metric("setup.device_ms").KERNELS, KERNELS,
                           "raster")
