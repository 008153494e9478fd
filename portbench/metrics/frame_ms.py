"""frame_ms (end to end, host clock): the window's wall time over the
frames completed in it."""


def read(r):
    return r.window_s * 1e3 / r.frames
