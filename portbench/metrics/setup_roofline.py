"""setup_roofline (setup, %): the least time of setup's work
(``work.setup_work``: planes read, record table and bbox rows written,
counted from the triangles alone) over setup.device_ms."""


def read(r):
    ms = r.metric("setup.device_ms").read(r)
    if ms is None or not ms or r.peaks is None:
        return None
    w = r.work
    nbytes, ops = r.yardstick.setup_work(w["triangles"], w["textured"])
    return 100.0 * r.yardstick.bound_ms(nbytes, ops, r.peaks) / ms
