"""setup_s (end to end, host clock): process start to the first timed
frame: imports, the kernel library (built on a checkout's first run,
loaded after), the scene built and moved to the card, the warm frames."""


def read(r):
    return r.setup_s
