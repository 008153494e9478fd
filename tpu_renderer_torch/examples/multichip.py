"""Multi-rank rendering example: a tile mesh and a two-level mesh over
spawned ranks (``entry.run_ranks``), each gathered into the whole frame
with ``gather_framebuffer``; rank 0 writes the tiled frame as a PNG.

With a card for every rank, the ranks join NCCL, rank r on cuda:r. With
fewer cards they join gloo and share them (on one card, cuda:0 for every
rank): that shows the sharded code paths working, and measures time
slicing, not scale-out. ``--device cpu`` runs the kernels' plain
versions on gloo ranks.

    python -m tpu_renderer_torch.examples.multichip [--devices 4] \\
        [--device cuda] [--out multichip.png]
"""

from __future__ import annotations

import argparse

from ..entry import run_ranks, scene_by_name
from ..parallel.mesh import (
    device_mesh,
    gather_framebuffer,
    render_scene_2level,
    render_scene_tiled,
)
from ..utils.image import write_png


def _covered(fb) -> int:
    return int((fb.depth > -3.0e38).sum())


def _rank(rank: int, n: int, device, out: str) -> list:
    """Rank body: the tiled and two-level frames of config 5; returns the
    report lines."""
    ny = max(d for d in range(1, n + 1) if n % d == 0 and d * d <= n)
    nx = n // ny
    h, w = 64 * ny, 128 * nx
    scene, tr, li = scene_by_name("config5", h, w, device)
    # 1) Tile mesh: frame sharded (ty, tx), geometry replicated, no
    # collective until the gather.
    mesh = device_mesh((ny, nx), ("ty", "tx"), device.type)
    fb = gather_framebuffer(
        render_scene_tiled(scene, tr, li, h, w, mesh), mesh)
    lines = [f"tiled ({ny}x{nx}): frame {tuple(fb.color.shape)}, "
             f"covered {_covered(fb)} px"]
    # 2) Two-level mesh: triangles over the outer 'host' dim (the frame's
    # one all-gather), tiles over 'ty' within each host (no collective).
    if n % 2 == 0:
        mesh2 = device_mesh((2, n // 2), ("host", "ty"), device.type)
        h2, w2 = 32 * (n // 2), 128
        scene2, tr2, li2 = scene_by_name("config5", h2, w2, device)
        fb2 = gather_framebuffer(
            render_scene_2level(scene2, tr2, li2, h2, w2, mesh2), mesh2)
        lines.append(f"2-level (2 hosts x {n // 2}): frame "
                     f"{tuple(fb2.color.shape)}, covered {_covered(fb2)} px")
    if rank == 0:
        write_png(out, fb.color)
    return lines


def main(argv=None) -> None:
    from . import multichip  # _rank under its importable name

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=4,
                    help="ranks to spawn (one a card where the cards "
                         "suffice, else sharing them)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="multichip.png")
    args = ap.parse_args(argv)
    lines = run_ranks(multichip._rank, args.devices, args.out,
                      device=args.device)[0]
    print("\n".join(lines))
    print("wrote", args.out)


if __name__ == "__main__":
    main()
