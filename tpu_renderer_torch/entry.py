"""Entry hooks of the port: a one-device render step and a multi-rank dry
run of every sharding mode.

PyTorch counterpart of the repository's ``__graft_entry__.py``:

- ``entry(device)`` returns ``(fn, args)``; ``fn(*args)`` renders config 5
  at 256x256 through ``render_scene`` on the card and returns (color,
  depth);
- ``dryrun_multichip(n, device, backend)`` spawns ``n`` ranks in place of
  the JAX package's XLA devices and renders the four mesh shapes of
  ``__graft_entry__.py``, each held bit-equal to the unsharded frame.

The multi-rank helpers live here so that a spawned rank imports only this
package: ``run_ranks(body, n, *args, device=..., backend=...)`` starts
``n`` processes with the spawn method, joins them in one process group
(rendezvous through a file in a fresh temporary directory, so concurrent
calls never collide), runs ``body(rank, n, device, *args)`` in each and
returns what each rank returned. A rank that raises fails the call: the
others are stopped and the parent raises. The group
(``process_group_backend``):

- at least ``n`` cards: NCCL, rank r bound to cuda:r, the collectives on
  the cards (over NVLink where the cards have it), as the JAX package's
  run on its devices;
- fewer cards: gloo, rank r on cuda:(r % cards), several ranks sharing a
  card (NCCL refuses that), the collectives staged through host memory;
- the CPU: gloo, every rank running the kernels' plain versions
  single-threaded.

    python -m tpu_renderer_torch.entry [--devices 4] [--device cuda] \\
        [--backend nccl|gloo]
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


BACKENDS = ("nccl", "gloo")


def process_group_backend(device_type: str, world_size: int, cards: int,
                          backend: str | None = None) -> str:
    """The process group backend of ``world_size`` ranks on ``device_type``
    with ``cards`` cards: NCCL where every rank has a card of its own, gloo
    where ranks share a card (NCCL refuses two ranks on one card) or run
    on the CPU. ``backend`` asks for one: 'gloo' is always taken, 'nccl'
    raises where it cannot run rather than fall back."""
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"unknown process group backend: {backend}")
    nccl_ok = device_type == "cuda" and cards >= world_size
    if backend == "nccl" and not nccl_ok:
        where = ("on the CPU" if device_type != "cuda" else
                 f"on {cards} card(s)")
        raise ValueError(f"backend 'nccl' needs a card for each rank, not "
                         f"{world_size} ranks {where}")
    if backend is not None:
        return backend
    return "nccl" if nccl_ok else "gloo"


def rank_device(rank: int, cards: int) -> torch.device:
    """The device of ``rank`` with ``cards`` cards: cuda:(rank % cards),
    so rank r on cuda:r where the cards suffice; the CPU without cards."""
    if not cards:
        return torch.device("cpu")
    return torch.device("cuda", rank % cards)


def _rank_main(rank: int, world_size: int, rdzv_dir: str, device: str,
               backend: str, body, args) -> None:
    """One spawned rank: its device, the process group, ``body``, and its
    result saved for the parent."""
    dev = rank_device(rank, torch.cuda.device_count()
                      if device == "cuda" else 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # The ranks share the host's cores (and the test workers' cores).
    torch.set_num_threads(1)
    # All ranks are on this host: gloo, and NCCL's bootstrap, talk over the
    # loopback device (another interface may be down and hang the join).
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.distributed.init_process_group(
        backend,
        init_method="file://" + os.path.join(rdzv_dir, "rendezvous"),
        rank=rank, world_size=world_size, timeout=RANK_TIMEOUT,
        device_id=dev if backend == "nccl" else None)
    out = body(rank, world_size, dev, *args)
    torch.distributed.destroy_process_group()
    torch.save(out, os.path.join(rdzv_dir, f"rank{rank}.pt"))


def run_ranks(body, world_size: int, *args, device="cuda",
              backend: str | None = None) -> list:
    """``body(rank, world_size, device, *args)`` in ``world_size`` spawned
    processes joined in one process group; returns the ranks' return
    values in rank order. The group is ``process_group_backend``'s: NCCL
    with rank r on cuda:r where there are at least ``world_size`` cards,
    else gloo (ranks sharing cards, cuda:(r % cards), or on the CPU);
    ``backend`` asks for one, and a 'nccl' that cannot run raises here,
    before any rank starts. ``body`` must be importable from this package
    (a spawned child imports it by name). The kernels are built once,
    here, before any rank starts. A failing rank fails the call."""
    import torch.multiprocessing as mp

    device = resolve_device(device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    backend = process_group_backend(device.type, world_size, cards, backend)
    if device.type == "cuda":
        from . import _cuda

        _cuda.build()
    with tempfile.TemporaryDirectory(prefix="tr_ranks_") as rdzv_dir:
        mp.spawn(_rank_main, args=(world_size, rdzv_dir, device.type,
                                   backend, body, args),
                 nprocs=world_size, join=True, start_method="spawn")
        return [torch.load(os.path.join(rdzv_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world_size)]


def scene_by_name(name: str, height: int, width: int, device):
    """(scene, transform, lights) of 'config<N>' (``baseline_scene``),
    'spheres<N>' or 'twins<N>' (``sphere_cluster_scene``, the second with
    each sphere twice), 'headline' (the 1,001,112 triangle Phong sphere,
    ``construct_sphere_grid(708, 707)``) or 'stack6' (six nested spheres
    of ``construct_sphere_grid(409, 409)``, 2,007,372 triangles, innermost
    first: ``stack_scene(409, 409, 6, inner_first=True)``) at (height,
    width)."""
    if name == "headline":
        return scenes.stack_scene(708, 707, 1, height, width, device=device)
    if name == "stack6":
        return scenes.stack_scene(409, 409, 6, height, width, device=device,
                                  inner_first=True)
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
    (``wrapper.launches``: one per CUDA launch, none on the CPU), each
    under the module that defines it (``ops.gbuffer`` imports
    ``raster.bin_for_raster``, counted once)."""
    from .ops import gbuffer, raster, setup

    return {f"{m.__name__.rsplit('.', 1)[1]}.{n}": f
            for m in (setup, raster, gbuffer)
            for n, f in sorted(vars(m).items())
            if callable(f) and hasattr(f, "launches")
            and getattr(f, "__module__", None) == m.__name__}


SHARDED = {"tiled": pm.render_scene_tiled,
           "geometry": pm.render_scene_geometry_sharded,
           "2level": pm.render_scene_2level,
           "object": pm.render_scene_object_sharded}
FOLD_AXIS = {"geometry": "tr", "2level": "host", "object": "obj"}


def mesh_frames(rank: int, world_size: int, device, cases,
                warmup: bool = False) -> dict:
    """Rank body: each case ``(name, mode, shape, dim names, scene name,
    backend, height, width)`` rendered over a mesh of that shape by
    ``SHARDED[mode]``, and gathered where the mesh cuts the frame into
    tiles -> {name: (this rank's frame, the whole frame, render ms, gather
    ms, launches)}: frames as host (color, depth) arrays; the wall ms of
    the sharded render (its fold included) and of the gather on this
    rank, each from a barrier to the card's end; the kernel
    launches of that run ({wrapper: count}, the counts set to 0 just
    before it). Where the mesh has no tile dim, the frame needs no gather,
    and the gather ms are those of the fold's one collective (the
    all-gather of this rank's (z, color, key) planes over ``FOLD_AXIS``),
    run again alone after the frame, from a barrier. ``warmup`` runs each
    case once more before."""
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
            # The gather starts from a barrier too: its ms are the
            # collective's, not the wait for a slower rank's render.
            torch.distributed.barrier()
            t2 = sync()
            full = pm.gather_framebuffer(local, mesh) if tiles else local
            t3 = sync()
        launches = {n: f.launches for n, f in counters.items()}
        render_ms, gather_ms = 1e3 * (t1 - t0), 1e3 * (t3 - t2)
        if not tiles:
            planes = torch.empty((3, *local.depth.shape), dtype=torch.int32,
                                 device=device)
            torch.distributed.barrier()
            t1 = sync()
            pm._all_gather(planes, mesh, FOLD_AXIS[mode])
            gather_ms = 1e3 * (sync() - t1)
        out[name] = (host_frame(local), host_frame(full), render_ms,
                     gather_ms, launches)
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


def dryrun_multichip(n_devices: int, device="cuda",
                     backend: str | None = None) -> list:
    """Render every sharding mode over ``n_devices`` spawned ranks on small
    frames and hold each to the unsharded render, bit for bit
    (``__graft_entry__.dryrun_multichip``'s four shapes). The ranks join
    ``run_ranks``' group: NCCL, one rank a card, where the cards suffice,
    else gloo (ranks sharing cards); ``backend`` asks for one;
    ``device="cpu"`` runs the plain versions. Raises when any rank fails.
    Returns each rank's {shape: (render ms, gather ms)}."""
    return run_ranks(_dryrun_rank, n_devices, device=device,
                     backend=backend)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=4,
                    help="ranks of the dry run")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", choices=BACKENDS, default=None,
                    help="the ranks' process group (default: NCCL where "
                         "every rank has a card, else gloo)")
    args = ap.parse_args(argv)
    fn, fn_args = entry(args.device)
    color, _ = fn(*fn_args)
    print("entry ok:", tuple(color.shape), color.dtype)
    device = resolve_device(args.device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    backend = process_group_backend(device.type, args.devices, cards,
                                    args.backend)
    per_rank = dryrun_multichip(args.devices, device, backend)
    print(f"dryrun_multichip({args.devices}) ok on {backend}, {cards} "
          f"card(s); render and gather ms a rank: {per_rank}")


if __name__ == "__main__":
    main()
