"""scene.host_ms (scene): the host's self ms a frame in ``tr.scene``: the
multi-object assembly of ``engine.renderer._scene_table`` (the objects'
rows and gid offsets, their specs, the setup's device table, the texture
atlas), its child span ``tr.setup`` left out; from the spans' block with
the profiler off (portbench/spans.py). None where the program opens no
such span."""

from portbench import spans

SPAN = "tr.scene"


def read(r):
    got = spans.blocks(r)
    return None if got is None else got.host_ms.get(SPAN)
