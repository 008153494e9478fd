"""Building the port's native golden from several processes at once.

When the test suite runs on six workers, each collects every test file
at once, and every one that renders the native golden first builds it.
``tpu_renderer_torch.golden.native.build`` has g++ write a name of its own
process and renames the library into place when it is whole, so a
process never loads a library that another is still writing. Six
spawned processes, released together, build into one fresh directory;
each must load a whole library and render the same frame as this
process. (With g++ writing the final name itself, most runs of this test
fail: a process loads the file while another is writing it, "file too
short".) No JAX here: the spawned processes import this module.
"""

import multiprocessing

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

from tpu_renderer_torch.golden import native
from tpu_renderer_torch.models import scenes

WORKERS = 6  # as many as the suite's test workers
SIDE = 64  # frame side of the test render


def _render(config):
    sg, tr, li = scenes.baseline_scene(config, SIDE, SIDE)
    return native.render(sg, tr, li, SIDE, SIDE, num_threads=1)


def _build_and_render(build_dir, barrier, results, rank):
    """One spawned process: wait for the others, then build (or find) the
    library in ``build_dir`` and render config 5 with it."""
    native.BUILD_DIR = build_dir
    try:
        barrier.wait(timeout=120)
        color, depth = _render(5)
        results.put((rank, None, (color, depth)))
    except Exception as e:  # reported to the parent, which fails the test
        results.put((rank, repr(e), None))


@pytest.mark.skipif(not native.available(), reason="no g++")
def test_concurrent_builds_each_load_a_whole_library(tmp_path):
    build_dir = tmp_path / "build"
    ctx = multiprocessing.get_context("spawn")
    barrier = ctx.Barrier(WORKERS)
    results = ctx.Queue()
    procs = [ctx.Process(target=_build_and_render,
                         args=(build_dir, barrier, results, r))
             for r in range(WORKERS)]
    for p in procs:
        p.start()
    try:
        got = [results.get(timeout=300) for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs)
    errors = {rank: err for rank, err, _ in got if err is not None}
    assert not errors, errors
    libs = sorted(p.name for p in build_dir.iterdir())
    assert libs == [native.library_path(build_dir=build_dir).name], libs
    want = _render(5)
    assert (want[1] > -3.0e38).sum() > 300
    for _, _, frame in got:
        color, depth = frame
        np.testing.assert_array_equal(color, want[0])
        np.testing.assert_array_equal(depth.view(np.int32),
                                      want[1].view(np.int32))
