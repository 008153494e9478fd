"""Entry hooks of the port: a one-device render step and a multi-rank dry
run of every sharding mode.

PyTorch counterpart of the repository's ``__graft_entry__.py``:

- ``entry(device)`` returns ``(fn, args)``; ``fn(*args)`` renders config 5
  at 256x256 through ``render_scene`` on the card and returns (color,
  depth);
- ``dryrun_multichip(n, device)`` spawns ``n`` gloo ranks in place of the
  JAX package's virtual XLA devices and renders the four mesh shapes of
  ``__graft_entry__.py``, each held bit-equal to the unsharded frame.

The multi-rank helpers live here so that a spawned rank imports only this
package: ``run_ranks(body, n, *args, device=...)`` starts ``n`` processes
with the spawn method, joins them in one gloo group (rendezvous through a
file in a fresh temporary directory, so concurrent calls never collide),
runs ``body(rank, n, device, *args)`` in each and returns what each rank
returned. A rank that raises fails the call: the others are stopped and
the parent raises. On the card every rank uses cuda:(rank % cards), so
several ranks share one card (NCCL refuses that; gloo takes it), each
running the kernels and exchanging its collectives through gloo; on the
CPU every rank runs the kernels' plain versions single-threaded.

    python -m tpu_renderer_torch.entry [--devices 4] [--device cuda]
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time

import numpy as np
import torch

from .core.types import resolve_device
from .engine.renderer import render_scene
from .models import scenes
from .parallel import mesh as pm
from .utils.image import argb_array

RANK_TIMEOUT = datetime.timedelta(seconds=600)  # one collective's limit


def entry(device="cuda"):
    """Returns (fn, example_args): the forward render step on the default
    path (the fused kernels; the textured quad samples in the raster
    kernel's finalize) of config 5's multi-object scene with Phong,
    Gouraud and textured materials, at 256x256. Runs on the card unless
    given ``device="cpu"``; raises without a card."""
    height, width = 256, 256
    scene_g, tr_d, li_d = scenes.baseline_scene(5, height, width)
    scene, transform, lights = scenes.to_torch_scene(
        scene_g, tr_d, li_d, device=resolve_device(device))
    objs = tuple(obj for obj, _ in scene)
    cfgs = tuple(cfg for _, cfg in scene)

    def fn(objs, transform, lights):
        # framebuffer=None = the fresh-frame fast path (no clear + merge),
        # exactly what Renderer(clear_color=0) runs.
        fb = render_scene(None, list(zip(objs, cfgs)), transform, lights,
                          backend="kernels", frame_height=height,
                          frame_width=width)
        return fb.color, fb.depth

    return fn, (objs, transform, lights)


def _rank_main(rank: int, world_size: int, rdzv_dir: str, device: str,
               body, args) -> None:
    """One spawned rank: its device, the gloo group, ``body``, and its
    result saved for the parent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    # The ranks share the host's cores (and the test workers' cores).
    torch.set_num_threads(1)
    # All ranks are on this host: gloo talks over the loopback device.
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.distributed.init_process_group(
        "gloo", init_method="file://" + os.path.join(rdzv_dir, "rendezvous"),
        rank=rank, world_size=world_size, timeout=RANK_TIMEOUT)
    out = body(rank, world_size, dev, *args)
    torch.distributed.destroy_process_group()
    torch.save(out, os.path.join(rdzv_dir, f"rank{rank}.pt"))


def run_ranks(body, world_size: int, *args, device="cuda") -> list:
    """``body(rank, world_size, device, *args)`` in ``world_size`` spawned
    processes joined in one gloo group; returns the ranks' return values in
    rank order. ``body`` must be importable from this package (a spawned
    child imports it by name). The kernels are built once, here, before
    any rank starts. A failing rank fails the call."""
    import torch.multiprocessing as mp

    device = resolve_device(device)
    if device.type == "cuda":
        from . import _cuda

        _cuda.build()
    with tempfile.TemporaryDirectory(prefix="tr_ranks_") as rdzv_dir:
        mp.spawn(_rank_main, args=(world_size, rdzv_dir, device.type, body,
                                   args),
                 nprocs=world_size, join=True, start_method="spawn")
        return [torch.load(os.path.join(rdzv_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world_size)]


def scene_by_name(name: str, height: int, width: int, device):
    """(scene, transform, lights) of 'config<N>' (``baseline_scene``),
    'spheres<N>' or 'twins<N>' (``sphere_cluster_scene``, the second with
    each sphere twice) or 'headline' (the 1,001,112
    triangle Phong sphere, ``construct_sphere_grid(708, 707)``) at
    (height, width)."""
    if name == "headline":
        return scenes.stack_scene(708, 707, 1, height, width, device=device)
    if name.startswith("config"):
        sg, tr_d, li_d = scenes.baseline_scene(int(name[6:]), height, width)
        return scenes.to_torch_scene(sg, tr_d, li_d, device=device)
    if name.startswith(("spheres", "twins")):
        twins = name.startswith("twins")
        return scenes.sphere_cluster_scene(int(name[5 if twins else 7:]),
                                           height, width, device=device,
                                           twins=twins)
    raise ValueError(f"unknown scene: {name}")


def host_frame(fb):
    """(color as u32, depth) of a framebuffer as host arrays."""
    return argb_array(fb.color), fb.depth.cpu().numpy()


def launch_counters() -> dict:
    """{name: wrapper} of every kernel wrapper that counts its launches
    (``wrapper.launches``: one per CUDA launch, none on the CPU)."""
    from .ops import gbuffer, raster, setup

    return {f"{m.__name__.rsplit('.', 1)[1]}.{n}": f
            for m in (setup, raster, gbuffer)
            for n, f in sorted(vars(m).items())
            if callable(f) and hasattr(f, "launches")}


SHARDED = {"tiled": pm.render_scene_tiled,
           "geometry": pm.render_scene_geometry_sharded,
           "2level": pm.render_scene_2level,
           "object": pm.render_scene_object_sharded}


def mesh_frames(rank: int, world_size: int, device, cases,
                warmup: bool = False) -> dict:
    """Rank body: each case ``(name, mode, shape, dim names, scene name,
    backend, height, width)`` rendered over a mesh of that shape by
    ``SHARDED[mode]``, and gathered where the mesh cuts the frame into
    tiles -> {name: (this rank's frame, the whole frame, render ms, gather
    ms, launches)}: frames as host (color, depth) arrays; the wall ms of
    the sharded render (its fold included) and of the gather on this
    rank, each to the card's end, the render's from a barrier; the kernel
    launches of that run ({wrapper: count}, the counts set to 0 just
    before it). ``warmup`` runs each case once more before."""
    counters = launch_counters()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    out = {}
    for name, mode, shape, names, scene_name, backend, h, w in cases:
        mesh = pm.device_mesh(shape, names, device.type)
        scene, tr, li = scene_by_name(scene_name, h, w, device)
        tiles = {"ty", "tx"} & set(names)
        for _ in range(2 if warmup else 1):
            torch.distributed.barrier()
            for f in counters.values():
                f.launches = 0
            t0 = sync()
            local = SHARDED[mode](scene, tr, li, h, w, mesh, backend)
            t1 = sync()
            full = pm.gather_framebuffer(local, mesh) if tiles else local
            t2 = sync()
        launches = {n: f.launches for n, f in counters.items()}
        out[name] = (host_frame(local), host_frame(full), 1e3 * (t1 - t0),
                     1e3 * (t2 - t1), launches)
    return out


def frame_difference(got, want) -> str | None:
    """Where two host frames ((color, depth) arrays) differ bit for bit,
    or None when they are equal."""
    for plane, a, b in zip(("color", "depth"), got, want):
        if a.shape != b.shape:
            return f"{plane} is {a.shape}, want {b.shape}"
        bad = np.argwhere(a.view(np.int32) != b.view(np.int32))
        if len(bad):
            return (f"{plane} differs at {len(bad)} pixels, first "
                    f"{tuple(int(i) for i in bad[0])}")
    return None


def reference_frame(scene, transform, lights, height: int, width: int):
    """The unsharded render of the same scene, the value every sharded
    mesh shape must match EXACTLY (the folds are deterministic and keep the
    submission order, so the contract is bit-equality); also asserts that
    the frame drops nothing, so an overflowing binning budget cannot fake a
    match."""
    stats: dict = {}
    fb = render_scene(None, scene, transform, lights, backend="kernels",
                      frame_height=height, frame_width=width, stats=stats)
    if int(stats["bins_dropped"]):
        raise AssertionError(f"reference frame dropped "
                             f"{int(stats['bins_dropped'])} entries")
    return fb


def dryrun_shapes(n_devices: int):
    """The four mesh cases of ``__graft_entry__.dryrun_multichip`` for
    ``n_devices`` ranks, in ``mesh_frames``' form: tiles ('ty', 'tx'),
    ('tr', 'ty', 'tx'), ('obj', 'ty') and ('host', 'ty'), config 5, each
    rank's rect at least one 32 x 128 tile."""
    ny = max(c for c in range(1, int(np.sqrt(n_devices)) + 1)
             if n_devices % c == 0)
    nx = n_devices // ny
    cases = [("tiled", "tiled", (ny, nx), ("ty", "tx"), "config5",
              "kernels", 32 * ny, 128 * nx)]
    if n_devices % 2 == 0:
        half = n_devices // 2
        cases += [
            ("geometry", "geometry", (2, half, 1), ("tr", "ty", "tx"),
             "config5", "kernels", 32 * half, 128),
            ("object", "object", (2, half), ("obj", "ty"), "config5",
             "kernels", 32 * half, 128),
            ("2level", "2level", (2, half), ("host", "ty"), "config5",
             "kernels", 32 * half, 128),
        ]
    return cases


def _dryrun_rank(rank: int, world_size: int, device) -> dict:
    """Rank body of ``dryrun_multichip``: each shape rendered sharded and
    gathered; rank 0 holds every whole frame bit-equal to the unsharded
    render. Returns {shape: (render ms, gather ms) on this rank}."""
    cases = dryrun_shapes(world_size)
    frames = mesh_frames(rank, world_size, device, cases)
    if rank == 0:
        for name, _, _, _, scene_name, _, h, w in cases:
            scene, tr, li = scene_by_name(scene_name, h, w, device)
            want = host_frame(reference_frame(scene, tr, li, h, w))
            diff = frame_difference(frames[name][1], want)
            if diff:
                raise AssertionError(f"{name}: {diff}")
    return {name: frames[name][2:4] for name in frames}


def dryrun_multichip(n_devices: int, device="cuda") -> list:
    """Render every sharding mode over ``n_devices`` spawned gloo ranks on
    small frames and hold each to the unsharded render, bit for bit
    (``__graft_entry__.dryrun_multichip``'s four shapes). On the card the
    ranks share it; ``device="cpu"`` runs the plain versions. Raises when
    any rank fails. Returns each rank's {shape: (render ms, gather ms)}."""
    return run_ranks(_dryrun_rank, n_devices, device=device)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=4,
                    help="ranks of the dry run")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    fn, fn_args = entry(args.device)
    color, _ = fn(*fn_args)
    print("entry ok:", tuple(color.shape), color.dtype)
    dryrun_multichip(args.devices, args.device)
    print(f"dryrun_multichip({args.devices}) ok")


if __name__ == "__main__":
    main()
