"""Animated demo: the reference's spinning-scene use case, on the port.

Renders N frames of the multi-object baseline scene (config 5: Phong
sphere, Gouraud torus and cube, textured quad), every object rotated about
y a little more each frame, through the port's ``Renderer``, times each
frame with ``utils.profiling.FrameTimer`` (waiting for the card at its
end) and writes the frames as PNGs. Frame 0 also loads the kernels (and
builds them on a fresh checkout), so it is reported apart from the steady
state.

    python -m tpu_renderer_torch.examples.demo [--frames 24] [--size 512] \\
        [--out demo_frames] [--backend kernels] [--device cuda]
"""

from __future__ import annotations

import argparse
import math
import os

from ..core.types import resolve_device
from ..engine.renderer import Renderer
from ..geometry.transform import rotate_object, rotation_y
from ..models import scenes
from ..utils.image import write_png
from ..utils.profiling import FrameTimer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--out", default="demo_frames")
    ap.add_argument("--backend", default="kernels",
                    choices=["kernels", "reference"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    h = w = args.size
    scene_g, tr_d, li_d = scenes.baseline_scene(5, h, w)
    scene, transform, lights = scenes.to_torch_scene(scene_g, tr_d, li_d,
                                                     device=device)
    renderer = Renderer(h, w, backend=args.backend, device=device)

    os.makedirs(args.out, exist_ok=True)
    timer = FrameTimer()
    for i in range(args.frames):
        rot = rotation_y(2.0 * math.pi * i / args.frames, device=device)
        frame = []
        with timer.tick(frame):
            spun = [(rotate_object(o, rot), c) for o, c in scene]
            frame.append(renderer.render(spun, transform, lights))
        write_png(os.path.join(args.out, f"frame_{i:03d}.png"),
                  frame[0].color)
    steady = FrameTimer(samples=timer.samples[1:])
    print(f"wrote {args.frames} frames to {args.out} ({device})")
    print(f"first frame (kernels loaded): {timer.samples[0] * 1e3:.1f} ms; "
          f"steady state: {steady.summary().get('ms_mean', 0):.2f} "
          f"ms/frame ({steady.fps:.1f} fps)")


if __name__ == "__main__":
    main()
