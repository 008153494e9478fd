"""The port's entry hooks (tpu_renderer_torch.entry), its demos
(tpu_renderer_torch.examples) and ``pad_scene_triangles``, on the CPU.

``dryrun_multichip(4, device="cpu")`` spawns four gloo ranks and holds the
four mesh shapes of ``__graft_entry__.dryrun_multichip`` bit-equal to the
unsharded frame inside the ranks; the multichip demo spawns two. Ranks run
single-threaded on the kernels' plain versions. No JAX here: the sharded
frames are held to JAX in tests/test_torch_mesh.py.
"""

import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from tpu_renderer_torch import entry
from tpu_renderer_torch.engine.renderer import Renderer, render_scene
from tpu_renderer_torch.examples import demo, multichip
from tpu_renderer_torch.parallel.mesh import pad_scene_triangles
from tpu_renderer_torch.utils.image import read_png
from torch_threads import one_torch_thread  # noqa: F401


def test_entry_renders_config5():
    fn, args = entry.entry(device="cpu")
    color, depth = fn(*args)
    assert color.shape == depth.shape == (256, 256)
    assert color.dtype == torch.uint32
    scene, tr, li = entry.scene_by_name("config5", 256, 256, "cpu")
    want = Renderer(256, 256, device="cpu").render(scene, tr, li)
    assert torch.equal(color.view(torch.int32), want.color.view(torch.int32))
    assert torch.equal(depth.view(torch.int32), want.depth.view(torch.int32))
    assert int((depth > -3.0e38).sum()) > 0


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multichip(2)


def test_dryrun_multichip_on_four_cpu_ranks():
    per_rank = entry.dryrun_multichip(4, device="cpu")
    assert len(per_rank) == 4
    for shapes in per_rank:
        assert set(shapes) == {"tiled", "geometry", "object", "2level"}


def test_a_failing_rank_fails_the_call():
    """A rank's exception reaches the caller; nothing is swallowed."""
    bad = (("bad", "tiled", (1, 2), ("ty", "tx"), "config9", "kernels",
            32, 256),)
    with pytest.raises(mp.ProcessRaisedException,
                       match="config must be 1-5, got 9"):
        entry.run_ranks(entry.mesh_frames, 2, bad, device="cpu")


def test_pad_scene_triangles_adds_culled_triangles():
    scene, tr, li = entry.scene_by_name("config1", 64, 128, "cpu")
    padded = pad_scene_triangles(scene, 5)
    (obj, _), (pobj, cfg) = scene[0], padded[0]
    assert obj.num_triangles == 12 and pobj.num_triangles == 15
    for name in ("vertices", "colors", "normals", "uvs"):
        a, b = getattr(obj, name), getattr(pobj, name)
        assert torch.equal(b[..., :12], a)
        assert not b[..., 12:].any()
    fb0 = render_scene(None, scene, tr, li, "kernels", 64, 128)
    fb1 = render_scene(None, padded, tr, li, "kernels", 64, 128)
    assert torch.equal(fb1.color.view(torch.int32),
                       fb0.color.view(torch.int32))
    assert torch.equal(fb1.depth, fb0.depth)
    assert pad_scene_triangles(scene, 4)[0][0] is obj


def test_demo_writes_its_frames(tmp_path, capsys):
    demo.main(["--frames", "2", "--size", "64", "--device", "cpu",
               "--out", str(tmp_path)])
    names = sorted(os.listdir(tmp_path))
    assert names == ["frame_000.png", "frame_001.png"]
    px = read_png(str(tmp_path / names[1]))
    assert px.shape[:2] == (64, 64) and px.any()
    assert "steady state" in capsys.readouterr().out


def test_multichip_demo_writes_its_png(tmp_path, capsys):
    out = tmp_path / "multichip.png"
    multichip.main(["--devices", "2", "--device", "cpu", "--out", str(out)])
    px = read_png(str(out))
    assert px.shape[:2] == (64, 256) and np.asarray(px).any()
    text = capsys.readouterr().out
    assert "tiled (1x2)" in text and "2-level (2 hosts x 1)" in text
