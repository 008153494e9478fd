"""raster_roofline (raster, %): the least time of the raster's work
(``work.raster_work``: the kept triangles' record lanes read once, the
output written once, stage A, and the pack and Phong where the raster
shades, per covered pixel) over raster.device_ms."""


def read(r):
    ms = r.metric("raster.device_ms").read(r)
    if ms is None or not ms or r.peaks is None:
        return None
    w = r.work
    nbytes, ops = r.yardstick.raster_work(
        w["kept_triangles"], w["covered_px"], w["height"] * w["width"],
        w["raster_px_bytes"], w["raster_fields"], w["raster_shades"],
        w["lights"])
    return 100.0 * r.yardstick.bound_ms(nbytes, ops, r.peaks) / ms
