"""scene.launches (scene): device ops a frame launched while the host was
in ``tr.scene`` and in none of its child spans (the upload of the setup's
device table, the atlas), each op matched to its launch by correlation id;
from the spans' profiled block (portbench/spans.py). None where the
program opens no such span."""

from portbench import spans

SPAN = "tr.scene"


def read(r):
    got = spans.blocks(r)
    if got is None or got.credit is None:
        return None
    c = got.credit
    return c.launches.get(SPAN, 0.0) if SPAN in c.spans else None
