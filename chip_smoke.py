#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (tpu_renderer_torch) once on one GPU,
and its sharded paths on four where the machine has them.

Run from the root of the repository, on a machine with NVIDIA GPUs:

    python3 chip_smoke.py

Phases 1-9 and 11 use cuda:0 (the mesh phase's ranks spread over the
cards where there are more); phase 10 needs four cards and says so when
it does not run.

Phases (any failure raises and the script exits nonzero):

1. device: torch's view of the card and nvidia-smi's name and power limit;
   without a CUDA device the script stops before doing anything else;
2. build: compiles the CUDA kernels from tpu_renderer_torch/csrc with nvcc,
   one process per source (cached under tpu_renderer_torch/_build by a
   hash of the sources), and prints the registers, shared memory, stack
   frame and spills of each of K1's four instantiations, of the mask
   kernel's two (K6 and K8, a frame row a block) and of the band form's
   walk (K4, and K9 above 8 rows: one instantiation, which must report its
   registers and spills) from ``-Xptxas -v``;
3. kernels: each kernel against its plain-PyTorch version on the card,
   bit-equal outputs required, with the route of every launch asserted:
   - K1 (setup) and K2 (raster + shade, 8-row tiles, row packing 2) on a
     51,200-triangle sphere grid at 512x512, with and without a merged
     large quad (side list non-empty), and textured (K1's u/z, v/z, 1/z
     fields; K5, the texture fetch in the finalize, bilinear);
   - K1 and K3 (8-row tiles, one stream) on config 2's teapot at 512x512,
     with and without a merged large quad, and textured (K5 bilinear);
   - K1 in its four forms (Phong / Gouraud x textured / not), gid0 = 7,
     at ragged padded lengths: config 2's teapot at tp = T and T + 1000,
     the headline sphere at tp = T;
   - K7 (record transpose) on config 4's channel-major table, and K4
     (16-row tiles, the band form) on config 4's sphere at 1920x1080, and
     on config 5's objects at 1920x1080 in one launch: the three
     untextured ones, and all four (K5 nearest on the quad);
   - K2 on config 5's three untextured objects at 96x128 (several objects
     under row packing);
   - K6 (the mask strategy) on config 1 (16-row tiles), config 3 (K5
     bilinear) at 512x512, and a 2-object scene on 8-row tiles at 128x128,
     untextured and with two quads, nearest and bilinear;
   - the G-buffer kernels, gid and all 11 planes: K9 (sorted, one
     stream, each tile's entries split into parts that many blocks fold,
     merged by the (z, gid) key) on the 51,200-triangle sphere grid at
     512x512 (8-row tiles),
     with and without the merged large quad (K10, the side-list fold, runs
     inside K9's launch with it), and on config 4's sphere at 1920x1080
     (16-row tiles, the band form); K8 (mask) on config 3 with 'avx'
     addressing and on config 1 at 512x512;
   - the route scenes of models/route_scenes.py forced to 32-row tiles:
     K4 (sorted, the band form) and K6 (mask), with and without side-list
     triangles, textured (K5) and not, one and several objects; K8 and K9
     (K10 on the side-list scenes), gid and all 11 planes; K6 (K5
     bilinear) and K8 on 64-row tiles, which only the mask kernels run, on
     the 528-triangle sphere forced to the mask strategy;
   - the band form (K4, and K9 with K10, on sorted heights above 8 rows)
     at 24, 40, 48, 56 and 64 rows, at the default part size and at 16
     entries a part, the parts read back: K4 on the route scenes'
     528-triangle sphere with and without the side list, textured
     (K5), and their multi-object scenes, K9 on the sphere, its side-list
     and G-buffer variants, both on a cube with a 16-unit quad behind it
     at 1408x256, whose quad takes the side list at every height;
   - K11 (the occlusion skip) on K3's and K2's routes, on the stacks of
     models/route_scenes.py ZCULL_STACKS (six sphere layers at 640x640,
     innermost first), at the default part size, at 256 entries a part
     and at one part a stream: bit-equal to its plain version and to the
     non-culling K3 / K2 on the same operands, with at
     least as many batches skipped as the per-part replay of its decisions
     (``zcull_skips_plain(..., part_entries=P)``, each part culling against
     its own winners alone; more than none at 256), at most the stream
     batches, and at one part a stream exactly the serial replay;
4. card against CPU: each route's small scene (models/route_scenes.py,
   with and without side-list triangles, textured, the mask routes and
   the G-buffer routes, whose G-buffers are compared too) and a
   4,140-triangle sphere grid, rendered on the card and by the plain
   versions on the CPU: bit-equal; the Renderer's knobs the same way:
   clear_color != 0 on the 51,200-triangle sphere at 512x512 (K1, K2),
   Renderer.calibrate on the 4,140-triangle sphere (the same factor
   applied), and backend="reference" on config 1 at 512x512; the route
   knobs: strategy='sorted' with tile_h=8 on scenes of at most 512
   triangles (K2's route, K3's on two objects), strategy='mask' on the
   528-triangle sphere; render_scene into a sub-rect at (37, 21), off the
   tile grid, on the fused, G-buffer and reference branches, also against
   the crop of the card's whole frame;
5. paths, each through Renderer(device="cuda") for 3 warm-up and 20 timed
   frames, every object rotated about y each frame (one launch a frame:
   K13's grouped form on several objects, K13 on one), every sorted draw
   binned by K14 (once a frame), the launch counts
   set to 0 just before the path and read just after:
   - headline: a 1,001,112-triangle dense Phong sphere
     (construct_sphere_grid(708, 707)) at 1920x1080: K1 and K2 once per
     frame; its last frame is held to the sphere's analytic silhouette
     and depth range;
   - config 2: the 5,428-triangle Gouraud teapot at 512x512: K1 and K3;
   - config 4: the 2,208-triangle Phong sphere, 2 lights, at 1920x1080:
     K7 and K4;
   - config 5 untextured: sphere + torus + cube, 3,244 triangles, at
     1920x1080 in one launch: K7 and K4, once per frame each;
   - textured 250k: a 250,632-triangle Gouraud sphere
     (construct_sphere_grid(354, 354)) sampling a 128x128 checkerboard
     bilinearly, at 1920x1080 (bench.py's textured scale point): K1 and K2
     (with K5), K1 and K2 first held bit-equal to their plain versions at
     that shape;
   - config 1 and config 3: the 12-triangle cube at 512x512, flat and
     bilinear-textured: K7 and K6;
   - config 5: sphere, torus, cube and the textured quad (nearest), 3,246
     triangles (3,584 padded), at 1920x1080 in one launch: K7 and K4;
   - deferred 1M: the headline sphere with a 2.2-unit quad 0.6 behind it
     merged in, 1,001,114 triangles, Phong, a 1024x1024 checkerboard
     sampled bilinearly, over the fused limits, at 1920x1080: K1 and K9
     (the quad's two triangles on the side list, K10) into a G-buffer,
     then the deferred shade (K12); K9 held bit-equal to its plain version
     at that shape first, and K12 to its plain chain on that G-buffer at
     1920x1080 and at 3840x2160, over a fresh frame and a cleared one; the
     last frame held to the scene's depth range, colours and alpha;
   - config 3 avx: config 3 with 'avx' addressing at 512x512: K7, K8 and
     K12;
   - stack6 zcull: bench.py's 2,007,372-triangle stack
     (stack_scene(409, 409, 6)), innermost layer first, at 1920x1080
     through Renderer(zcull=True): one launch of K1's grouped form (the
     six objects, one kind) and one K11 per frame, no K2; its first frame bit-equal to the same frame without zcull,
     and K11 skipping batches on it at the default part size (the probe
     counter);
   - stack6: the same scene without zcull (K1 grouped, K2), the A/B
     partner;
   - the 32-row paths, through the ops entry points with the route knobs
     (rasterize_shaded, or rasterize_gbuffer + shade_merge): config 4
     @32 (K7, K4's band form on 32-row tiles, expansion 32, budget 4);
     40k @32 (construct_sphere_grid(140, 143), 40,040 Phong triangles,
     bench.py --scale's first point, at 1920x1080: K1, K4 at 32 rows,
     expansion 8, budget 2); config 3 @32 (K7, K6 at 32 rows with K5
     bilinear); config 3 avx @32 (K7, K8 at 32 rows, the deferred shade);
     deferred 40k @32 (deferred 1M's construction on the 40k sphere: K1,
     K9's band form at 32 rows with the quad on the side list, K10);
   - the band paths, the same way: 40k @24 and 40k @64 (K1, K4 in the band
     form), deferred 40k @24 and @64 (K1, K9 + K10 in the band form, the
     shade), headline @64 (the headline's sphere forced to 64-row tiles:
     K1, K4 in the band form), each one's frame 0 also bit-equal to the
     same scene at 16 rows on the card, its drops reported;
   every frame must drop no entry and cover pixels, and the first frame
   of each path since config 2 (but deferred 1M, the stacks and headline
   @64) must equal the CPU plain run of it bit for bit;
6. timings: median ms per frame (CUDA events) of each path, the headline's
   host ms a frame by span (``utils.profiling.spans``, each layer's self
   time) and its ``FrameTimer`` summary, and
   each kernel at its path's shapes (the headline for K1 and K2, the
   textured 250k point for K1 textured, config 3 for K6), first held
   bit-equal to its plain version on those inputs, then timed beside its
   plain version's (K1 also on deferred 1M's textured mesh, with its
   device time from a profiler trace and the time of zeroing its outputs,
   the card's own write of those bytes; K1's grouped form on stack6's six
   objects, also bit-equal to and timed beside one K1 launch an object at
   the same rows; K13 on the headline's planes, and its grouped form on
   sphere_cluster's 137 objects beside one K13 an object, with a frame's
   whole deferred rotation beside the eager one; K14, the sorted binning,
   on K1's bboxes of each of the benchmark's five cells (portbench's
   configurations at their frame sizes, the fused or G-buffer route the
   engine takes), integer-exact against ``bin_for_raster_plain``, with its
   device ops (none named like a kernel the benchmark's order split finds,
   the last no memset) and its byte bound (the bbox planes read, the keys
   written, the sort's radix passes over keys and indices, the outputs); K3,
   K4, K6, K8 and the 32-row K4, K6, K8, whose event times are near the
   launch floor, also with their device and host time from a profiler
   trace; K6 and K8, 16 and 32 rows, also beside the card zeroing their
   outputs, their floor; K7 also beside ``t().contiguous()``,
   the one PyTorch call that
   transposes, in turns, and each call's host and device time from a
   profiler trace); K5, which has no launch of its own, as the
   device time of the shaded finalize kernel (which samples the texture)
   on the textured 250k path beside the finalize on the same mesh
   untextured and ``grid_sample`` (bilinear, border) on the textured
   pixels, the library call, all three from profiler traces taken in
   turns, with their spread; K8 on config 3
   avx, K9 on deferred 1M, and K10 as K9's time on deferred 1M beside
   K9's on the same sphere without the quad; the split kernels (K2 on the
   headline, K4's band form on 32-row tiles on 40k, K9 on deferred 1M and
   deferred 40k @32, K11 on stack6 zcull) also held bit-equal at 16
   entries a part,
   with their part counts read back from the kernel and held equal to the
   bins', timed beside one part a stream of a tile in turns, and (but
   K11) over a sweep of the entries a part; K11 on stack6 zcull's first
   frame beside K2 on the same operands in turns, bit-equal to it, its
   skipped batches at the default part size and at one part a stream,
   its bound the launch's work scaled to the batches it folds, and on
   bench.py's order of the stack (outermost first); the 32-row forms (K4
   on config 4 and 40k, K6 on config 3, K8 on config 3 avx, K9 and K10 on
   deferred 40k); the band form
   (K4 on 40k @24, 40k @64 and headline @64, frame 0 of that path held to
   its plain version on the card; K9 on deferred 40k @24 and @64; each
   with the walk's device time and its stage A pairs and empty (part,
   band) items against a per-band walk's, counted from the launch's data;
   the split phase at 24 rows; K10 as K9's band form with the quad beside
   the sphere alone); K12, the deferred shade,
   on deferred 1M's G-buffer at 1920x1080 and 3840x2160 beside its plain
   chain (shade, pack, merge), by events and by device time from profiler
   traces, with its byte bound, and the fused-against-deferred
   A/B: ms per frame of the textured 250k scene through the fused route
   (K2 with K5) and through the G-buffer path (K9, K12); each kernel
   with the least time the card could take for the same work (bytes at
   3.35 TB/s against f32 operations at 67 TFLOP/s); and the launch
   guard's cost: config 5's ms/frame through Renderer with every C entry
   called through ``_cuda.launch`` (its tensors' card made current) and
   called as before it, frame by frame in turns, frames bit-equal, and
   the guard's device query alone (``launch_guard_ab``);
7. with --profile only: host enqueue time, device time, top kernels,
   K1's device time and share, and device idle share of 10 frames of
   each path, from a torch.profiler trace;
8. golden (``golden_phase``): frame 0 of each path (no rotation), rendered
   on the card through the path's own entry, held to the port's NumPy spec
   (tpu_renderer_torch/golden/cpu_reference.py), which the CPU tests hold
   bit-equal to the JAX package's: whole, bit-equal in colour and depth
   bits, for configs 1, 2, 3, 3 avx at 512x512, configs 4, 5 untextured
   and 5 at 1920x1080, config 4 @32, config 3 @32 and config 3 avx @32;
   in GOLDEN_WINDOWS windows of 32x32 (the frame's centre, a silhouette
   pixel, the rest centred on covered pixels drawn by a seeded generator),
   bit-equal in each, for the paths whose whole golden frame is too slow:
   headline and headline @64, textured 250k, deferred 1M, stack6 and stack6
   zcull, 40k (the Renderer's route, @24, @32, @64) and deferred 40k (@24,
   @32, @64). A window's golden renders only the triangles whose projected
   bbox meets it (``window_scene``); the spec draws one triangle at a time,
   so that is the whole frame's inside the window. The golden renders run
   in spawned processes, one a core. Then the native C++ golden
   (golden/native.py, built with g++ for this host) of each path's scene,
   at one thread and at all the host's, as the CPU baseline beside the
   path's ms/frame, with its agreement with the card's frame (not a gate:
   it steps attributes sequentially);
9. mesh (``mesh_phase``, tpu_renderer_torch/parallel/mesh.py): a
   world-size-1 NCCL group renders the headline tiled over a (1, 1) mesh
   and gathers it; four gloo ranks (spawned by ``entry.run_ranks`` with
   backend="gloo", the kernels built once before; on one card they share
   it) render the headline at 1920x1080 tiled over ('ty', 'tx') = (2, 2),
   each rank launching K1, K14 and K2 once (its counts set to 0 just before
   and read just after), and config 5 object-sharded over ('obj', 'ty') =
   (2, 2); then ``dryrun_multichip(4)`` on gloo. Every frame bit-equal to
   the unsharded one; a failing rank fails the script. The wall ms of
   each part go on a line with the card's name and power limit: four
   ranks time-slice one card, so they measure no scale-out;
10. cards (``cards_phase``), with four cards or more: four NCCL ranks,
   rank r on cuda:r, each a warm-up and one timed frame at 1920x1080 of
   the headline tiled over ('ty', 'tx') = (2, 2) (K1, K14 and K2 once a rank
   and nothing else), the headline over ('tr',) = 4 (250,278 triangles a
   card, then one all-gather of the (z, colour, key) planes), stack6 over
   ('host', 'ty') = (2, 2) and config 5 over ('obj', 'ty') = (2, 2), then
   ``dryrun_multichip(4)`` on NCCL. Every rank's rect and every gathered
   or folded frame bit-equal to cuda:0's unsharded frame through
   Renderer. Each rank's render and gather ms (host clock between syncs)
   and the one-card ms go on a line with every card's name and power
   limit: information, not a claim. With fewer cards one line says how
   many it found and that the phase did not run;
11. sweep (``sweep_phase``, on cuda:0): the seeded boundary scenes of
   tpu_renderer_torch/models/sweep_scenes.py, every family at each of its
   SEEDS: T across 512 and 4096 and frames across the 8-row and packing
   thresholds; a tile's stream at k * 32 - 1, k * 32 and k * 32 + 1
   entries (k = 1, 2, 5) beside empty and side-list-only tiles; exact
   depth ties that only the gid breaks, in different parts and objects;
   2047 / 2048 / 2049 side-list triangles; ragged frames, sub-rects and
   forced tile heights 8-64; budgets and mask capacities that drop;
   textures 511 / 512 / 513 texels on a side; zcull stacks innermost
   first and last; the band walk's edges (rows ending and starting on
   band boundaries, parts reaching a tile's first and last band only,
   entries reaching in from above and below, zero heights, spans of one
   and of 128 columns, exact ties across parts, one pixel under many
   fragments, the side list among small triangles) at 24-64 rows. Each
   form's launch takes the route and C entry its scene was built for,
   with the claimed stream counts, side list and drops; its outputs (z,
   gid, colour; the G-buffer's gid and 11 planes) are bit-equal to its
   plain version on the card, its stats to the CPU's;
   K11's skipped batches equal the serial replay; every sorted form's bins
   and side-list gate from K14 integer-exact against the CPU's plain
   binning, one K14 launch a sorted draw; K1 and K7 against their plain
   versions; scenes that drop nothing (up to 10,000 triangles) are
   bit-equal to the NumPy spec, each fused form and the whole frame. One
   line per family; every kernel form (K1-K11, K9 at 8 rows and in the
   band form) launched. ``python3 chip_smoke.py --sweep-only
   [FAMILY ...]`` runs the device, build and sweep phases alone.

``python3 chip_smoke.py --band-ab OTHER`` runs the device and build
phases, then times the band form's paths with the package of the
repository copy at OTHER (``git archive`` of an earlier commit, or a
variant of the band walk, unpacked inside this one) and with this one's,
back to back (other, this, this, other; ``--band-times TREE`` in a
process each, every band launch first held bit-equal to its plain
version), and prints both.

The line before the last is a JSON object with one entry per kernel
({"kernels": [...]}); the last line is {"ok": true, "device": {...}}.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WARMUP, FRAMES = 3, 20
BYTES_PER_MS = 3.35e12 / 1e3  # H100 SXM device memory
F32_OPS_PER_MS = 67e12 / 1e3  # H100 SXM f32 outside the tensor cores
# f32 operations per unit of work, counted from the kernels' sources
# (csrc/setup.cu, csrc/raster.cu) and rounded: the bound they give is a
# floor on the work, not a cycle count.
SETUP_OPS = 250  # per triangle: projection, cull, 3 edges' fields
SETUP_LIGHT_OPS = 40  # per vertex and light, Gouraud only
STAGE_A_OPS, STAGE_A_FIELD_OPS = 110, 12  # per (entry, row) pair
FRAG_OPS, FRAG_FIELD_OPS = 8, 2  # per in-span fragment
SETUP_TEX_OPS = 40  # per triangle: the u/z, v/z, 1/z fields
PACK_OPS = 24  # per covered pixel
PHONG_OPS, PHONG_LIGHT_OPS = 40, 70  # per Phong-shaded pixel
# Per textured pixel: u/z, v/z, 1/z from the span (~12 each), 1/z's
# reciprocal and two products, index math (~12), 4 texels unpacked (~16)
# and the bilinear lerp (24); nearest does a quarter of the fetch and no
# lerp, so this counts every textured pixel as bilinear (an upper count).
TEX_OPS = 90
KERNELS = {
    "K1 setup": dict(
        source="tpu_renderer_torch/csrc/setup.cu",
        replaces="tpu_renderer/ops/setup_pallas.py:174", path="headline"),
    "K1 setup textured": dict(
        source="tpu_renderer_torch/csrc/setup.cu",
        replaces="tpu_renderer/ops/setup_pallas.py:278",
        path="textured 250k"),
    "K2 raster+shade": dict(
        source="tpu_renderer_torch/csrc/raster.cu",
        replaces="tpu_renderer/ops/raster_pallas.py:2192", path="headline"),
    "K3 raster+shade rows 1": dict(
        source="tpu_renderer_torch/csrc/raster.cu",
        replaces="tpu_renderer/ops/raster_pallas.py:2355", path="config 2"),
    "K4 raster+shade band 16-row": dict(
        source="tpu_renderer_torch/csrc/raster.cu",
        replaces="tpu_renderer/ops/raster_pallas.py:2372", path="config 4"),
    "K5 texture sampling": dict(
        source="tpu_renderer_torch/csrc/raster.cu",
        replaces="tpu_renderer/ops/raster_pallas.py:863",
        path="textured 250k"),
    "K6 raster+shade mask": dict(
        source="tpu_renderer_torch/csrc/raster.cu",
        replaces="tpu_renderer/ops/raster_pallas.py:2121", path="config 3"),
    "K7 record transpose": dict(
        source="tpu_renderer_torch/csrc/records.cu",
        replaces="tpu_renderer/ops/raster_pallas.py:469", path="config 4"),
    "K8 G-buffer mask": dict(
        source="tpu_renderer_torch/csrc/raster.cu",
        replaces="tpu_renderer/ops/raster_pallas.py:1756",
        path="config 3 avx"),
    "K9 G-buffer sorted": dict(
        source="tpu_renderer_torch/csrc/raster.cu",
        replaces="tpu_renderer/ops/raster_pallas.py:1853",
        path="deferred 1M"),
    "K10 G-buffer side list": dict(
        source="tpu_renderer_torch/csrc/raster.cu",
        replaces="tpu_renderer/ops/raster_pallas.py:2018",
        path="deferred 1M"),
    "K11 zcull": dict(
        source="tpu_renderer_torch/csrc/raster.cu",
        replaces="tpu_renderer/ops/raster_pallas.py:2384",
        path="stack6 zcull"),
    "K4 raster+shade band 32-row": dict(
        source="tpu_renderer_torch/csrc/raster.cu",
        replaces="tpu_renderer/ops/raster_pallas.py:2372",
        path="config 4 @32"),
    "K6 raster+shade mask 32-row": dict(
        source="tpu_renderer_torch/csrc/raster.cu",
        replaces="tpu_renderer/ops/raster_pallas.py:2121",
        path="config 3 @32"),
    "K8 G-buffer mask 32-row": dict(
        source="tpu_renderer_torch/csrc/raster.cu",
        replaces="tpu_renderer/ops/raster_pallas.py:1756",
        path="config 3 avx @32"),
    "K9 G-buffer sorted band 32-row": dict(
        source="tpu_renderer_torch/csrc/raster.cu",
        replaces="tpu_renderer/ops/raster_pallas.py:1853",
        path="deferred 40k @32"),
    "K10 G-buffer side list band 32-row": dict(
        source="tpu_renderer_torch/csrc/raster.cu",
        replaces="tpu_renderer/ops/raster_pallas.py:2018",
        path="deferred 40k @32"),
    "K4 raster+shade band": dict(
        source="tpu_renderer_torch/csrc/raster.cu",
        replaces="tpu_renderer/ops/raster_pallas.py:2372",
        path="40k @24"),
    "K9 G-buffer sorted band": dict(
        source="tpu_renderer_torch/csrc/raster.cu",
        replaces="tpu_renderer/ops/raster_pallas.py:1853",
        path="deferred 40k @24"),
    "K10 G-buffer side list band": dict(
        source="tpu_renderer_torch/csrc/raster.cu",
        replaces="tpu_renderer/ops/raster_pallas.py:2018",
        path="deferred 40k @24"),
    "K12 deferred shade": dict(
        source="tpu_renderer_torch/csrc/shade.cu",
        replaces="none: tpu_renderer/ops/shading.py:182 shade is XLA ops",
        path="deferred 1M"),
    "K1 grouped": dict(
        source="tpu_renderer_torch/csrc/setup.cu",
        replaces="tpu_renderer/ops/setup_pallas.py:174", path="stack6"),
    "K13 rotate": dict(
        source="tpu_renderer_torch/csrc/transform.cu",
        replaces="none: tpu_renderer/geometry/transform.py rotate_object "
                 "is XLA ops", path="headline"),
    "K14 binning": dict(
        source="tpu_renderer_torch/csrc/binning.cu",
        replaces="none: tpu_renderer/ops/binning.py bin_triangles_queue "
                 "is XLA ops", path="headline"),
}
# The kernels of the sorted strategy's draws, each binned once by K14.
SORTED = {"K2 raster+shade", "K3 raster+shade rows 1",
          "K4 raster+shade band", "K9 G-buffer sorted", "K11 zcull",
          "K11 zcull rows 1"}
# K14 at the benchmark's cells (portbench/configs, BENCHMARK.json): (cell,
# configuration, frame height, width); each binned on the route the engine
# takes for it, the fused one or the G-buffer one (deferred).
K14_CELLS = (
    ("sphere1m_phong.orbit_1080p", "sphere1m_phong", 1080, 1920),
    ("sphere1m_deferred.orbit_1080p", "sphere1m_deferred", 1080, 1920),
    ("sphere1m_phong.orbit_2160p", "sphere1m_phong", 2160, 3840),
    ("sphere1m_deferred.orbit_2160p", "sphere1m_deferred", 2160, 3840),
    ("sphere_cluster.orbit_1080p", "sphere_cluster", 1080, 1920))
# Kernel names the benchmark's order split (portbench/trace.py) finds by
# substring: none of K14's may hold one.
SPLIT_NAMES = ("setup_kernel", "records_kernel", "part_scan_kernel",
               "split_walk_kernel", "split_finalize_kernel",
               "band_walk_kernel", "mask_kernel")
# The wrapper whose launch counter a KERNELS entry reads: K1 textured is
# K1's wrapper with uvs; K5 runs inside K2's launches on its path, K10
# inside K9's; the rows at other heights are their wrappers (K4's band
# form at 16 and 32 rows is K4's band wrapper, K9's band form K9's).
COUNTER = {"K1 setup textured": "K1 setup", "K5 texture sampling":
           "K2 raster+shade", "K10 G-buffer side list": "K9 G-buffer sorted",
           "K4 raster+shade band 16-row": "K4 raster+shade band",
           "K4 raster+shade band 32-row": "K4 raster+shade band",
           "K6 raster+shade mask 32-row": "K6 raster+shade mask",
           "K8 G-buffer mask 32-row": "K8 G-buffer mask",
           "K9 G-buffer sorted band 32-row": "K9 G-buffer sorted",
           "K10 G-buffer side list band 32-row": "K9 G-buffer sorted",
           "K9 G-buffer sorted band": "K9 G-buffer sorted",
           "K10 G-buffer side list band": "K9 G-buffer sorted"}
GBUF_BYTES_PER_PX = 48  # gid and 11 f32 planes
ONE_PART = 2 ** 31 - 1  # a part size that keeps each stream of a tile whole
K5_ROUNDS = 6  # profiler traces of each K5 call, in turns
BAND_HEIGHTS = (24, 40, 48, 56, 64)  # sorted heights run in the band form


def log(*args):
    print(*args, flush=True)


def bit_diff(a, b):
    """(equal bit for bit, max |a - b| over differing elements)."""
    import torch

    if a.dtype == torch.float32:
        same = a.view(torch.int32) == b.view(torch.int32)
        err = (a.double() - b.double()).abs()
    else:
        a, b = a.view(torch.int32).long(), b.view(torch.int32).long()
        same = a == b
        err = (a - b).abs().double()
    err = torch.where(same, torch.zeros_like(err), err)
    err = torch.nan_to_num(err, nan=math.inf)
    return bool(same.all()), float(err.max()) if err.numel() else 0.0


def assert_equal(what, got, want):
    """Raise unless every output is bit-equal; returns the max error (0)."""
    import torch

    torch.cuda.synchronize()
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        same, err = bit_diff(a, b.to(a.device))
        worst = max(worst, err)
        if not same:
            raise AssertionError(f"{what}: output {i} differs, max |diff| "
                                 f"{err}")
    return worst


def event_ms(fn, reps):
    """Median ms per call of ``fn`` over ``reps`` calls, CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def in_turns(fn, plain, reps=20, plain_reps=3):
    """(kernel ms, plain ms), taken in turns plain, kernel, kernel, plain;
    each the median of its two readings."""
    p1 = event_ms(plain, plain_reps)
    k1 = event_ms(fn, reps)
    k2 = event_ms(fn, reps)
    p2 = event_ms(plain, plain_reps)
    return statistics.median([k1, k2]), statistics.median([p1, p2])


def bound(nbytes, ops):
    """(least ms the card could take, what bounds it)."""
    tb, to = nbytes / BYTES_PER_MS, ops / F32_OPS_PER_MS
    return (tb, "bytes") if tb >= to else (to, "operations")


def trace_calls(fn, n, attempts=3):
    """The events of one torch.profiler trace of ``n`` calls of ``fn``
    (after 3 untraced ones), each call in a record_function span named
    "call". The profiler now and then records no device activity at all
    in a trace of a few hundred microseconds; such a trace is taken again,
    up to ``attempts`` traces in all, and the callers refuse one that
    still has none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(3):
        fn()
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                with record_function("call"):
                    fn()
            torch.cuda.synchronize()
        events = prof.events()
        if any(e.device_type == DeviceType.CUDA for e in events):
            break
    return events


def profile_calls(fn, n):
    """(host ms, device ms, device op names) per call of ``fn`` over ``n``
    calls, from one torch.profiler trace: the host time of each call is
    its record_function span, the device time the sum of its device
    operations."""
    from torch.autograd import DeviceType

    events = trace_calls(fn, n)
    host = [e.time_range.elapsed_us() for e in events
            if e.name == "call" and e.device_type == DeviceType.CPU]
    dev = [e for e in events
           if e.device_type == DeviceType.CUDA and e.name != "call"]
    if len(host) != n or not dev:
        raise AssertionError(f"profile of {n} calls: {len(host)} host "
                             f"spans, {len(dev)} device ops")
    return (sum(host) / 1e3 / n,
            sum(e.time_range.elapsed_us() for e in dev) / 1e3 / n,
            sorted({e.name[:60] for e in dev}))


def parts_plain(launch, part_entries):
    """(parts a tile, entries of the busiest part) that a sorted launch
    split into parts of at most ``part_entries`` entries of each stream
    should have, the side list one more part of each tile whose lcounts
    gate is open (csrc/raster.cu, part_scan_kernel), counted from the bins
    on the host."""
    nfb = launch.options["tiles_y"] * launch.options["tiles_x"]
    counts = launch.qbins.counts.long().reshape(nfb + 1, -1)[:nfb]
    side = launch.operands[2] > 0
    per_tile = ((counts + part_entries - 1) // part_entries).sum(dim=1) + (
        side.long())
    n_large = int(launch.qbins.n_large) if bool(side.any()) else 0
    return per_tile.cpu(), max(min(part_entries, int(counts.max())),
                               n_large)


def stream_batches(launch, part_entries):
    """Stream batches of a split K11 launch: each stream of each tile cut
    into parts of at most ``part_entries`` entries, each part into batches
    of 128 / strip rows entries."""
    nfb = launch.options["tiles_y"] * launch.options["tiles_x"]
    counts = launch.qbins.counts.long().reshape(nfb + 1, -1)[:nfb]
    batch = 128 // (launch.route.tile_h // counts.shape[1])
    full, rest = counts // part_entries, counts % part_entries
    return int((full * -(-part_entries // batch)
                + (rest + batch - 1) // batch).sum())


def with_part_entries(value, fn, wrapper=None, seen=None):
    """``fn`` run with ``ops.raster.RASTER_PART_ENTRIES`` (the split
    kernels' part size) set to ``value``; keeps the call's part offsets,
    left on ``wrapper.part_offsets``, in ``seen[value]``."""
    from tpu_renderer_torch.ops import raster

    def run():
        old = raster.RASTER_PART_ENTRIES
        raster.RASTER_PART_ENTRIES = value
        try:
            return fn()
        finally:
            raster.RASTER_PART_ENTRIES = old
            if seen is not None:
                seen[value] = wrapper.part_offsets
    return run


def kernel_device_ms(fn, n, name_part, attempts=3):
    """Device ms per launch of the one kernel of ``fn`` whose name holds
    ``name_part``, over ``n`` calls, from one torch.profiler trace (the
    mean over the launches the trace recorded: it may miss one). The
    profiler now and then loses most of a short trace's device events; a
    trace holding fewer than half the launches is taken again, up to
    ``attempts`` traces in all, and refused if none holds them."""
    from torch.autograd import DeviceType

    for _ in range(attempts):
        dev = [e for e in trace_calls(fn, n)
               if e.device_type == DeviceType.CUDA and name_part in e.name]
        if n // 2 <= len(dev) <= n:
            return sum(e.time_range.elapsed_us() for e in dev) / 1e3 / len(dev)
        log(f"# profile of {n} calls: {len(dev)} device ops named like "
            f"{name_part!r}, traced again")
    raise AssertionError(f"profile of {n} calls: {len(dev)} device ops "
                         f"named like {name_part!r} in {attempts} traces")


def device_ms_in_turns(calls, n, rounds):
    """For each ``(fn, name_part)`` of ``calls``, ``kernel_device_ms`` of
    ``rounds`` traces of ``n`` calls each, the traces taken in turns: the
    calls in order, then in reverse, and so on (A B B A A B ...)."""
    got = [[] for _ in calls]
    for r in range(rounds):
        order = range(len(calls))
        for i in (order if r % 2 == 0 else reversed(order)):
            got[i].append(kernel_device_ms(calls[i][0], n, calls[i][1]))
    return got


def finalize_work(launch, gid_out):
    """(bytes, f32 operations) of a split launch's shaded finalize on
    this run's data: the (hp, wp) u64 keys read, 12 bytes per output pixel
    written, the 88 record lanes of every distinct winner, the shading
    tables and texture atlas; per covered pixel the winner's stage A with
    the planes its object reads, the pack, the texture fetch per textured
    pixel and Phong per Phong pixel (``raster_work``'s finalize terms)."""
    import torch
    from tpu_renderer_torch.ops import raster

    params, objs, atlas = launch.operands[-4], launch.objs, launch.operands[-1]
    fields, _, nrm_off, _ = raster.launch_fields(objs, launch.texs)
    cov = gid_out >= 0
    n_cov = int(cov.sum())
    n_win = int(torch.unique(gid_out[cov]).numel())
    n_phong = (int(raster._phong_mask(gid_out, objs).sum())
               if nrm_off is not None else 0)
    n_tex = int(textured_pixels(launch, gid_out).sum())
    nbytes = (gid_out.numel() * (8 + 12) + n_win * 88 * 4
              + params.numel() * 4 + objs.shape[0] * 7 * 4
              + (0 if atlas is None else atlas.numel() * 4))
    ops = (n_cov * (STAGE_A_OPS + STAGE_A_FIELD_OPS * len(fields) + PACK_OPS)
           + n_tex * TEX_OPS
           + n_phong * (PHONG_OPS + PHONG_LIGHT_OPS
                        * launch.options["n_lights"]))
    return nbytes, ops


def setup_work(T, tp, phong, n_lights, textured=False):
    """(bytes, f32 operations) of K1 on T triangles padded to tp: vertex,
    colour, normal (and uv) planes in, the record table and bbox rows
    out."""
    chans = 3 + 4 + 3 + (2 if textured else 0)
    nbytes = T * 3 * chans * 4 + tp * 128 * 4 + 8 * tp * 4
    ops = (T * SETUP_OPS + (T * SETUP_TEX_OPS if textured else 0)
           + (0 if phong else T * 3 * n_lights * SETUP_LIGHT_OPS))
    return nbytes, ops


def textured_pixels(launch, gid_out):
    """Covered pixels whose object samples a texture."""
    import torch
    from tpu_renderer_torch.ops import raster

    specs, tspecs = launch.objs.tolist(), launch.texs.tolist()
    n = torch.zeros_like(gid_out >= 0)
    for m, t in zip(raster._object_masks(gid_out, specs), tspecs):
        if t[1] > 0:
            n = n | m
    return n


def raster_work(launch, gid_out):
    """(bytes, f32 operations) this shaded raster launch's data needs:
    ``fold_work`` with the planes its objects read and 12 bytes per output
    pixel, the shading tables and texture atlas, and the finalize per
    covered pixel (the texture fetch per textured pixel, Phong per Phong
    pixel)."""
    from tpu_renderer_torch.ops import raster

    params, objs, atlas = launch.operands[-4], launch.objs, launch.operands[-1]
    fields, _, nrm_off, _ = raster.launch_fields(objs, launch.texs)
    nbytes, ops = fold_work(launch, len(fields), 12)
    n_cov = int((gid_out >= 0).sum())
    n_phong = (int(raster._phong_mask(gid_out, objs).sum())
               if nrm_off is not None else 0)
    n_tex = int(textured_pixels(launch, gid_out).sum())
    nbytes += (params.numel() * 4 + objs.shape[0] * 7 * 4
               + (0 if atlas is None else atlas.numel() * 4))
    ops += (n_cov * PACK_OPS + n_tex * TEX_OPS
            + n_phong * (PHONG_OPS + PHONG_LIGHT_OPS
                         * launch.options["n_lights"]))
    return nbytes, ops


def gbuffer_work(launch):
    """(bytes, f32 operations) of a G-buffer launch on this run's data:
    the fold's work over all 10 attribute planes, 48 bytes per output
    pixel (gid and 11 f32 planes), no shading."""
    from tpu_renderer_torch.ops import gbuffer

    return fold_work(launch, len(gbuffer.ATTR_FIELDS), GBUF_BYTES_PER_PX)


def fold_work(launch, n_fields, px_bytes):
    """(bytes, f32 operations) that every raster launch's data needs: the
    88 record lanes of every distinct triangle it reads, its kept entries,
    tile tables and side list, ``px_bytes`` per output pixel; stage A per
    (entry, row) pair whose row lies in the triangle's span, and the fold
    per in-span fragment, with ``n_fields`` attribute planes. Rows of a
    tile that an entry does not reach are the kernel's own waste, not the
    frame's work, so the bound does not grow with the tile height."""
    import torch
    from tpu_renderer_torch.ops import raster

    recs, qbins, o = launch.operands[0], launch.qbins, launch.options
    nfb = o["tiles_y"] * o["tiles_x"]
    lcounts = (launch.operands[2] if launch.route.strategy == "sorted"
               else torch.zeros(nfb, dtype=torch.int32, device=recs.device))
    frags = raster.raster_fragments(
        recs, qbins, lcounts, tile_h=launch.route.tile_h,
        tiles_y=o["tiles_y"], tiles_x=o["tiles_x"], row0=o["row0"],
        col0=o["col0"], frame_width=o["frame_width"], fields=())
    n_tris = int(torch.unique(frags.pair_tri).numel())
    n_px = nfb * launch.route.tile_h * raster.TILE_W
    nbytes = (n_tris * 88 * 4 + int(qbins.counts.sum()) * 4
              + (qbins.starts.numel() + qbins.counts.numel()
                 + int(qbins.n_large) + lcounts.numel()) * 4
              + n_px * px_bytes)
    ops = (int(frags.pair_in_span.sum()) * (STAGE_A_OPS + STAGE_A_FIELD_OPS
                                            * n_fields)
           + frags.z.numel() * (FRAG_OPS + FRAG_FIELD_OPS * n_fields))
    return nbytes, ops


def band_reach(recs, tri, row_base, tile_h):
    """[lo, hi) of each entry's reach in its tile, as the band walk finds
    it (csrc/raster.cu, ``entry_reach``): per edge the run of tile rows r
    where valid && ymin <= (f32)(row_base + r) < ymax, by the same binary
    searches, then the hull of the three runs' pairwise overlaps. ``tri``
    (E,) records' rows, ``row_base`` (E,) i64 the frame row of each
    entry's tile row 0."""
    import torch
    from tpu_renderer_torch.geometry.vertex import (EDGE_STRIDE, F_VALID,
                                                    F_YMAX, F_YMIN)

    rec = recs[tri]
    n = tile_h

    def first_row(y, after):
        lo = torch.zeros_like(row_base)
        hi = torch.full_like(row_base, n)
        for _ in range(n.bit_length() + 1):
            mid = (lo + hi) // 2
            yf = (row_base + mid).to(torch.float32)
            ok = ~(yf < y) if after else (y <= yf)
            live = lo < hi
            hi = torch.where(live & ok, mid, hi)
            lo = torch.where(live & ~ok, mid + 1, lo)
        return lo

    a, b = [], []
    for e in range(3):
        valid = rec[:, e * EDGE_STRIDE + F_VALID] > 0.5
        a.append(torch.where(valid, first_row(
            rec[:, e * EDGE_STRIDE + F_YMIN], False), n))
        b.append(torch.where(valid, first_row(
            rec[:, e * EDGE_STRIDE + F_YMAX], True), 0))
    lo = torch.full_like(row_base, n)
    hi = torch.zeros_like(row_base)
    for i, j in ((0, 1), (0, 2), (1, 2)):
        l, h = torch.maximum(a[i], a[j]), torch.minimum(b[i], b[j])
        lo = torch.where(l < h, torch.minimum(lo, l), lo)
        hi = torch.where(l < h, torch.maximum(hi, h), hi)
    return lo, hi


def band_entries(launch, part_entries=None):
    """Every entry a band walk launch (one stream a tile) folds, in the
    order of ``raster_fragments``' pairs (each tile's stream, then each
    open tile's side list): ``tile``, ``tri`` (its record), ``part`` (its
    part, numbered over the launch: stream parts of at most
    ``part_entries`` (default ``ops.raster.RASTER_PART_ENTRIES``) entries,
    then the side lists), ``parts`` (their number), the reach ``lo``,
    ``hi`` (``band_reach``), ``span`` (E, tile_h) bool, the rows whose
    pair has a span, as ``fold_work`` counts them, and ``frags``
    (``raster_fragments``, no planes). Raises unless every in-span pair
    lies in its entry's reach."""
    import torch
    from tpu_renderer_torch.ops import raster

    recs, qbins, o = launch.operands[0], launch.qbins, launch.options
    lcounts = launch.operands[2]
    th = launch.route.tile_h
    p = part_entries or raster.RASTER_PART_ENTRIES
    nfb = o["tiles_y"] * o["tiles_x"]
    dev = recs.device
    if qbins.starts.shape[0] != nfb + 1:
        raise ValueError("band_entries takes one stream a tile")
    cn = qbins.counts[:nfb].long()
    tile = torch.repeat_interleave(torch.arange(nfb, device=dev), cn)
    first = torch.cumsum(cn, 0) - cn
    pos = torch.arange(tile.shape[0], device=dev) - first[tile]
    tri = qbins.sorted_tri.long()[qbins.starts[:nfb].long()[tile] + pos]
    sparts = (cn + p - 1) // p
    part = (torch.cumsum(sparts, 0) - sparts)[tile] + pos // p
    nl = int(qbins.n_large)
    ltiles = torch.nonzero(lcounts > 0).reshape(-1)
    tile = torch.cat([tile, ltiles.repeat_interleave(nl)])
    tri = torch.cat([tri, qbins.large_ids[:nl].long().repeat(
        ltiles.shape[0])])
    part = torch.cat([part, int(sparts.sum()) + torch.arange(
        ltiles.shape[0], device=dev).repeat_interleave(nl)])
    lo, hi = band_reach(recs, tri, o["row0"] + tile // o["tiles_x"] * th,
                        th)
    frags = raster.raster_fragments(
        recs, qbins, lcounts, tile_h=th, tiles_y=o["tiles_y"],
        tiles_x=o["tiles_x"], row0=o["row0"], col0=o["col0"],
        frame_width=o["frame_width"], fields=())
    span = frags.pair_in_span.reshape(-1, th)
    rows = torch.arange(th, device=dev)
    outside = span & ~((rows >= lo[:, None]) & (rows < hi[:, None]))
    if span.shape[0] != tri.shape[0] or bool(outside.any()):
        raise AssertionError(f"band walk: {int(outside.sum())} in-span "
                             "pairs outside their entry's reach")
    return dict(tile=tile, tri=tri, part=part,
                parts=int(sparts.sum()) + ltiles.shape[0], lo=lo, hi=hi,
                span=span, frags=frags)


def band_pairs(launch, part_entries=None):
    """The band walk's work on a sorted launch against a per-band walk's
    (one that folds every part once per 8-row band of its tile),
    counted on the launch's own data (``band_entries``): ``entries``,
    ``pairs_old`` (stage A on every (entry, tile row) pair: every band of
    every part), ``pairs_new`` (the rows of each entry's reach),
    ``pairs_in_span`` (``fold_work``'s count), ``items`` (the per-band walk's
    (part, band) items) and ``items_empty`` (those holding no in-span
    pair)."""
    import torch

    be = band_entries(launch, part_entries)
    th = launch.route.tile_h
    bands = th // 8
    lit = be["span"].reshape(-1, bands, 8).any(-1)
    item = be["part"][:, None] * bands + torch.arange(
        bands, device=lit.device)
    n = be["tri"].shape[0]
    return dict(entries=n, pairs_old=n * th,
                pairs_new=int((be["hi"] - be["lo"]).clamp(min=0).sum()),
                pairs_in_span=int(be["span"].sum()),
                items=be["parts"] * bands,
                items_empty=be["parts"] * bands - int(
                    torch.unique(item[lit]).numel()))


def backdrop_mesh(lat, lon):
    """A sphere grid with a 2.2-unit quad moved to z = -0.6 behind it as a
    backdrop, merged into one mesh (the quad's two triangles take the side
    list): deferred 1M's mesh at (708, 707), 1,001,114 triangles."""
    from tpu_renderer_torch.models import primitives as prim

    quad = prim.construct_quad(2.2)
    quad["vertices"][:, 2] -= 0.6
    return prim.merge_meshes(prim.construct_sphere_grid(lat, lon), quad)


BAND_PATHS = ("40k @24", "40k @64", "headline @64", "deferred 40k @24",
              "deferred 40k @64")


def band_times(dev, reps=20):
    """{path: ms, walk_device_ms} of the band form's launch on each of
    BAND_PATHS (frame 0, no rotation), through the package first on
    ``sys.path``: K4's band form through ``prepare_scene`` with the route
    knobs, K9 + K10's through ``setup_for_raster`` and ``prepare_gbuffer``
    (the entry points every tree since the band form came in has); ms by
    CUDA events (median of two runs of ``reps`` launches), the walk's
    device time from a profiler trace of ``reps`` launches."""
    from tpu_renderer_torch.engine.renderer import prepare_scene
    from tpu_renderer_torch.models import primitives as prim
    from tpu_renderer_torch.models.textures import checkerboard
    from tpu_renderer_torch.ops import gbuffer, setup

    h, w = 1080, 1920
    launches = {}
    sg40 = phong_mesh_scene(prim.construct_sphere_grid(140, 143))
    for path, sg in (("40k", sg40), ("headline", phong_mesh_scene(
            prim.construct_sphere_grid(708, 707)))):
        sc, tr, li = torch_scene(sg, h, w, dev)
        for th in ((24, 64) if path == "40k" else (64,)):
            launches[f"{path} @{th}"] = prepare_scene(
                sc, tr, li, h, w, strategy="sorted", tile_h=th)
    sg40d = [(dict(p=(0.0, 0.0, 0.0), **backdrop_mesh(140, 143)),
              {"phong": True, "texture": checkerboard(1024, 1024, 64),
               "filter_mode": "bilinear"})]
    sc, tr, li = torch_scene(sg40d, h, w, dev)
    (obj, cfg), = sc
    table = setup.setup_for_raster(obj, tr, li, cfg, frame_height=h,
                                   frame_width=w)
    for th in (24, 64):
        launches[f"deferred 40k @{th}"] = gbuffer.prepare_gbuffer(
            table, h, w, strategy="sorted", tile_h=th)
    out = {}
    for path in BAND_PATHS:
        run = launches[path].run
        assert_equal(f"the band form at {path}", run(),
                     launches[path].run_plain())
        out[path] = dict(
            ms=round(statistics.median([event_ms(run, reps)
                                        for _ in range(2)]), 4),
            walk_device_ms=round(kernel_device_ms(run, reps,
                                                  "band_walk_kernel"), 4))
    return out


def band_ab(other, smi_line):
    """The band rows' times of the repository copy at ``other`` (an
    earlier commit, or a variant of the band walk) and of this one, back
    to back on one card: ``python3 chip_smoke.py --band-times TREE`` in a
    process each, in the order other, this, this, other, each holding
    every band launch bit-equal to its plain version first; each row's
    pair of readings beside the card's name and power limit. Returns
    {"other" / "this": {path: [reading, reading]}}."""
    got = {"other": {}, "this": {}}
    for tag, tree in (("other", other), ("this", ROOT), ("this", ROOT),
                      ("other", other)):
        r = subprocess.run(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--band-times", os.path.abspath(tree)],
            capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            raise AssertionError(f"--band-times {tree}: exit {r.returncode}"
                                 f"\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        times = json.loads(r.stdout.strip().splitlines()[-1])["band_times"]
        for path, v in times.items():
            got[tag].setdefault(path, []).append(v)
    for path in BAND_PATHS:
        log(f"# band A/B, {path}: kernel ms {other} "
            f"{[v['ms'] for v in got['other'][path]]}, this tree "
            f"{[v['ms'] for v in got['this'][path]]}; the walk's device ms "
            f"{[v['walk_device_ms'] for v in got['other'][path]]} against "
            f"{[v['walk_device_ms'] for v in got['this'][path]]} "
            f"({smi_line})")
    return got


def profile_frames(label, frame, angles, frame_ms):
    """Host enqueue time and device time of a path's frames.

    ``frame(angle)`` renders one frame; ``frame_ms`` is the median frame
    time measured without the profiler. Prints the host's enqueue time per
    frame (no sync inside the loop), then from a torch.profiler trace the
    device time per frame, its top kernels, the idle share of the traced
    window, and the idle share estimated as 1 - device time / frame_ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = len(angles)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in angles:
        frame(a)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        for a in angles:
            frame(a)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise AssertionError("torch.profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, end = 0.0, -math.inf
    for s, e in spans:  # union of the device intervals, us
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    window = spans[-1][1] - spans[0][0]
    by_name = {}  # summed by the name's first 60 characters
    for e in dev:
        key = e.name[:60]
        by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    dev_ms = busy / 1e3 / n
    k1_ms = sum(e.time_range.elapsed_us() for e in dev
                if "setup_kernel" in e.name) / 1e3 / n
    out = {
        "frames": n,
        "host_enqueue_ms_per_frame": round((t1 - t0) * 1e3 / n, 4),
        "host_wall_ms_per_frame": round((t2 - t0) * 1e3 / n, 4),
        "device_ops_per_frame": round(len(dev) / n, 2),
        "device_busy_ms_per_frame": round(dev_ms, 4),
        "traced_window_idle_share": round(1.0 - busy / window, 4),
        "idle_share_estimate_vs_frame_ms": round(1.0 - dev_ms / frame_ms, 4),
        "k1_device_ms_per_frame": round(k1_ms, 4),
        "k1_share_of_busy": round(k1_ms / dev_ms, 4),
        "top_device_ms_per_frame": {
            k: round(v / 1e3 / n, 4) for k, v in top},
    }
    log(f"# profile {label}: " + json.dumps(out))


def torch_scene(sg, h, w, device):
    """(scene, transform, lights) of a golden-form scene with the
    baseline_scene camera and lights for an h x w frame."""
    from tpu_renderer_torch.models import scenes

    tr_d, li_d = scenes.baseline_camera_lights(h, w)
    return scenes.to_torch_scene(sg, tr_d, li_d, device=device)


def phong_mesh_scene(mesh):
    return [(dict(p=(0.0, 0.0, 0.0), **mesh), {"phong": True})]


def k1_call(obj, cfg, tr, li, h, w, tp=None, gid0=0):
    """(kernel fn, plain fn, work) of K1 on one object, padded to ``tp``
    rows (default: the engine's padding)."""
    from tpu_renderer_torch.ops import setup

    T = obj.num_triangles
    if tp is None:
        blk = setup._setup_blk(T)
        tp = -(-T // blk) * blk
    args = (setup.setup_params(obj.p, tr, li), obj.vertices, obj.colors,
            obj.normals)
    kw = dict(n_lights=li.count, phong=cfg.phong, gid0=gid0, frame_height=h,
              frame_width=w, tp=tp, uvs=obj.uvs if cfg.textured else None)
    return (lambda: setup.setup_kernel(*args, **kw),
            lambda: setup.setup_plain(*args, **kw),
            setup_work(T, tp, cfg.phong, li.count, cfg.textured))


def ptxas_info(build_log, kernel, mangled):
    """Registers, shared memory, stack frame and spills of each
    instantiation of ``kernel`` whose mangled name starts with ``mangled``
    (a regex whose groups are the mangled template arguments: ``Li<n>``
    ints, ``Lb0`` / ``Lb1`` bools), from the build's ``-Xptxas -v``
    lines."""
    import re

    out, form = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            f = re.match(mangled, m[1])
            form = (None if f is None else "%s<%s>" % (kernel, ", ".join(
                {"Lb0": "false", "Lb1": "true"}.get(a, a[2:])
                for a in f.groups())))
            continue
        if form is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out.setdefault(form, {}).update(stack_bytes=int(m[1]),
                                            spill_stores=int(m[2]),
                                            spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out.setdefault(form, {}).update(
                registers=int(m[1]), smem_bytes=int(smem[1]) if smem else 0)
    return out


def rotated(scene, angle, device):
    """Every object of the scene rotated about y by ``angle``."""
    from tpu_renderer_torch.geometry.transform import rotate_object, rotation_y

    rot = rotation_y(angle, device=device)
    return [(rotate_object(obj, rot), cfg) for obj, cfg in scene]


WINDOW = 32  # side of a golden window, px
WINDOW_MARGIN = 2  # px a triangle's bbox may lie off a window and be drawn
GOLDEN_WINDOWS = 8  # windows a frame: the centre, the silhouette, 6 drawn
GOLDEN_SEED = 13
NATIVE_REPS = 5  # timed native golden frames, after one warm-up


def place_windows(covered, n, seed):
    """(row0, col0) of ``n`` >= 2 WINDOW x WINDOW windows inside the frame of
    ``covered`` (an (H, W) bool mask): one centred on the frame, one
    centred on a silhouette pixel (covered, with an uncovered 4-neighbour)
    and n - 2 centred on covered pixels, so within the covered bbox, both
    drawn by ``numpy.random.default_rng(seed)``."""
    import numpy as np

    h, w = covered.shape
    rng = np.random.default_rng(seed)

    def at(r, c):
        return (int(min(max(r - WINDOW // 2, 0), h - WINDOW)),
                int(min(max(c - WINDOW // 2, 0), w - WINDOW)))

    inner = covered.copy()
    inner[1:] &= covered[:-1]
    inner[:-1] &= covered[1:]
    inner[:, 1:] &= covered[:, :-1]
    inner[:, :-1] &= covered[:, 1:]
    edge = np.argwhere(covered & ~inner)
    if not len(edge):
        raise AssertionError("place_windows: the frame has no silhouette")
    inside = np.argwhere(covered)
    return [at(h // 2, w // 2), at(*edge[rng.integers(len(edge))])] + [
        at(*inside[i]) for i in rng.integers(len(inside), size=n - 2)]


def window_scene(scene, transform, height, width, windows):
    """(sub-scene, triangles a window) of a golden-form scene: of each
    object, in order, the triangles whose projected bbox
    (``cpu_reference.project_vertex`` over the (T, 3, 3) vertices, clamped
    to the frame, where a span off its left or right edge is drawn) meets
    one of the windows grown by WINDOW_MARGIN px, or whose projection is not
    finite. The spec draws one triangle at a time, so the sub-scene's frame
    equals the whole scene's inside every window, bit for bit."""
    import numpy as np

    from tpu_renderer_torch.golden import cpu_reference as gold

    sub, counts = [], np.zeros(len(windows), np.int64)
    for obj, cfg in scene:
        verts = np.asarray(obj["vertices"], np.float32).reshape(-1, 3, 3)
        with np.errstate(divide="ignore", invalid="ignore"):
            proj = gold.project_vertex(
                verts + np.asarray(obj["p"], np.float32), transform)
        odd = ~np.isfinite(proj[..., :2]).all(axis=(1, 2))
        x = np.clip(proj[..., 0], 0, width - 1)
        y = np.clip(proj[..., 1], 0, height - 1)
        x0, x1, y0, y1 = x.min(1), x.max(1), y.min(1), y.max(1)
        keep = odd.copy()
        lo, hi = WINDOW_MARGIN, WINDOW - 1 + WINDOW_MARGIN
        for i, (r0, c0) in enumerate(windows):
            hit = odd | ((x1 >= c0 - lo) & (x0 <= c0 + hi) & (y1 >= r0 - lo)
                         & (y0 <= r0 + hi))
            counts[i] += int(hit.sum())
            keep |= hit
        idx = np.nonzero(keep)[0]
        if not len(idx):
            continue
        part = dict(obj)
        for k in ("vertices", "colors", "normals", "uvs"):
            a = np.asarray(obj[k])
            d = a.shape[-1]
            part[k] = a.reshape(-1, 3, d)[idx].reshape(-1, d)
        sub.append((part, cfg))
    return sub, [int(c) for c in counts]


def golden_windows(scene, transform, lights, height, width, windows):
    """(color, depth, triangles a window): the spec's render of
    ``window_scene``'s sub-scene at the full height x width, equal to the
    whole scene's golden frame inside each window."""
    from tpu_renderer_torch.golden import cpu_reference as gold

    sub, counts = window_scene(scene, transform, height, width, windows)
    color, depth = gold.render(sub, transform, lights, height, width)
    return color, depth, counts


def host_frame(color, depth):
    """(color u32, depth f32) NumPy arrays of a frame's planes on any
    device."""
    import numpy as np
    import torch

    return (color.contiguous().view(torch.int32).cpu().numpy().view(
        np.uint32), depth.cpu().numpy())


def frame_arrays(fb):
    """(color u32, depth f32) NumPy arrays of a framebuffer on any
    device."""
    return host_frame(fb.color, fb.depth)


def golden_diff(what, got, want):
    """Raise unless colour and depth bits are equal; ``got`` and ``want``
    are (color, depth) NumPy pairs of one shape."""
    import numpy as np

    bad = (got[0] != want[0]) | (got[1].view(np.int32)
                                 != want[1].view(np.int32))
    if bad.any():
        r, c = np.argwhere(bad)[0]
        raise AssertionError(
            f"{what}: {int(bad.sum())} px differ from the golden, first at "
            f"row {r}, col {c}: color {got[0][r, c]:#010x} against "
            f"{want[0][r, c]:#010x}, depth {got[1][r, c]!r} against "
            f"{want[1][r, c]!r}")


def host_cpu():
    """The host CPU as /proc/cpuinfo names it: model name, vendor, family,
    model, stepping and MHz of its first processor, and whether it has
    AVX2 and AVX-512F (the native golden is built for this host)."""
    import platform

    from tpu_renderer_torch.golden.native import cpu_info

    info = cpu_info()
    flags = info.get("flags", "").split()
    return (f"{info.get('model name', platform.processor())} "
            f"({info.get('vendor_id', platform.machine())}, family "
            f"{info.get('cpu family', '?')}, model {info.get('model', '?')}, "
            f"stepping {info.get('stepping', '?')}, "
            f"{info.get('cpu MHz', '?')} MHz, avx2 {'avx2' in flags}, "
            f"avx512f {'avx512f' in flags})")


def golden_phase(smi_line, paths, path_ms):
    """Each path's frame 0 on the card held to the port's NumPy spec at
    full size; the native golden timed as the CPU baseline.

    ``paths``: (path, scene key, golden-form scene, transform dict, lights
    dict, h, w, whole, frame) tuples; ``frame()`` renders the path's frame
    0 (no rotation) on the card through the path's own entry. Paths of one
    scene key share one golden render:
    - whole: the golden frame of the whole scene, against which every
      such path is bit-equal (colour and depth bits, hence coverage);
    - else GOLDEN_WINDOWS WINDOW x WINDOW windows (``place_windows`` on the
      key's first path's coverage, seeded GOLDEN_SEED), the golden of
      ``window_scene`` (the union of the windows' triangles), every such
      path bit-equal inside every window.
    The golden renders run in spawned processes, one a core. Then each
    scene's native golden (golden/native.py, built here if need be) at one
    thread and at all the host's threads, the median of NATIVE_REPS after a
    warm-up, with its agreement with the card's frame, for information.
    Raises on any difference; returns the phase's record."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    from tpu_renderer_torch.golden import cpu_reference as gold
    from tpu_renderer_torch.golden import native

    t_phase = time.perf_counter()
    frames, scenes_, info = {}, {}, {"windows": {}, "whole": {}}
    for path, key, sg, tr_d, li_d, h, w, whole, frame in paths:
        frames[path] = frame_arrays(frame())
        if key not in scenes_:
            scenes_[key] = dict(sg=sg, tr=tr_d, li=li_d, h=h, w=w,
                                whole=whole, first=path, paths=[])
        scenes_[key]["paths"].append(path)
    card_s = time.perf_counter() - t_phase

    jobs = {}
    for key, s in scenes_.items():
        if s["whole"]:
            jobs[key] = (s["sg"], sum(len(o["vertices"]) for o, _ in s["sg"]))
            continue
        cov = frames[s["first"]][1] > gold.DEPTH_CLEAR
        s["windows"] = place_windows(cov, GOLDEN_WINDOWS, GOLDEN_SEED)
        sub, s["counts"] = window_scene(s["sg"], s["tr"], s["h"], s["w"],
                                        s["windows"])
        jobs[key] = (sub, sum(len(o["vertices"]) for o, _ in sub))
    t_gold = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    workers = min(len(jobs) + 1, os.cpu_count() or 1)
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        built = pool.submit(native.build)  # g++, beside the golden renders
        futures = {key: pool.submit(gold.render, sg_, scenes_[key]["tr"],
                                    scenes_[key]["li"], scenes_[key]["h"],
                                    scenes_[key]["w"])
                   for key, (sg_, _) in sorted(jobs.items(),
                                               key=lambda kv: -kv[1][1])}
        golden = {key: f.result() for key, f in futures.items()}
        library = built.result()
    gold_s = time.perf_counter() - t_gold

    for key, s in scenes_.items():
        want = golden[key]
        tris = jobs[key][1] // 3
        if s["whole"]:
            cov = int((want[1] > gold.DEPTH_CLEAR).sum())
            if cov < 1000:
                raise AssertionError(f"golden {key}: {cov} px covered")
            for path in s["paths"]:
                golden_diff(f"path {path} frame 0, whole", frames[path], want)
            info["whole"][key] = dict(paths=s["paths"], tris=tris,
                                      covered=cov)
            log(f"# golden {key} {s['w']}x{s['h']} ({tris} tris): whole "
                f"frame 0 == the NumPy spec, bit-equal, {cov} px covered, "
                f"paths {s['paths']}")
            continue
        cov = []
        for r0, c0 in s["windows"]:
            win = (slice(r0, r0 + WINDOW), slice(c0, c0 + WINDOW))
            cov.append(int((want[1][win] > gold.DEPTH_CLEAR).sum()))
            for path in s["paths"]:
                golden_diff(f"path {path} frame 0, window at ({r0}, {c0})",
                            tuple(a[win] for a in frames[path]),
                            tuple(a[win] for a in want))
        info["windows"][key] = dict(
            paths=s["paths"], windows=s["windows"], tris=s["counts"],
            union_tris=tris, covered=cov)
        log(f"# golden {key} {s['w']}x{s['h']}: frame 0 == the NumPy spec "
            f"in {len(s['windows'])} windows of {WINDOW}x{WINDOW}, "
            f"bit-equal; windows (row0, col0) {s['windows']}, triangles a "
            f"window {s['counts']} ({tris} in their union), px covered a "
            f"window {cov}; paths {s['paths']}")

    cpu, threads = host_cpu(), os.cpu_count() or 1
    t_nat = time.perf_counter()
    native_ms = {}
    for key, s in scenes_.items():
        args = (s["sg"], s["tr"], s["li"], s["h"], s["w"])
        ms = {}
        for nt in (1, threads):
            native.render(*args, num_threads=nt)
            times = []
            for _ in range(NATIVE_REPS):
                t0 = time.perf_counter()
                out = native.render(*args, num_threads=nt)
                times.append(1e3 * (time.perf_counter() - t0))
            ms[nt] = statistics.median(times)
        card = frames[s["first"]]
        cov_n, cov_c = out[1] > gold.DEPTH_CLEAR, card[1] > gold.DEPTH_CLEAR
        both = cov_n & cov_c
        agree = dict(
            coverage=float((cov_n == cov_c).mean()),
            color_on_both=float((out[0] == card[0])[both].mean()),
            depth_bits_on_both=float((out[1].view(np.int32)
                                      == card[1].view(np.int32))[both]
                                     .mean()))
        native_ms[key] = dict(ms_1_thread=ms[1], ms_all_threads=ms[threads],
                              agreement_with_card=agree)
        for path in s["paths"]:
            card_ms = path_ms.get(path)
            log(f"# golden native {path} ({s['w']}x{s['h']}; {smi_line}; "
                f"host CPU {cpu}, {threads} threads): card "
                + (f"{card_ms:.4f}" if card_ms is not None else "not driven")
                + f" ms/frame; native golden {ms[1]:.4f} ms at 1 thread, "
                f"{ms[threads]:.4f} ms at {threads} threads (median of "
                f"{NATIVE_REPS}); agreement with the card's frame (not a "
                f"gate): {json.dumps(agree)}")
    info.update(
        native_ms=native_ms, native_library=str(library),
        host_cpu=cpu, host_threads=threads, card=smi_line,
        seconds=dict(card_frames=card_s, golden_renders=gold_s,
                     golden_workers=workers,
                     native=time.perf_counter() - t_nat,
                     phase=time.perf_counter() - t_phase))
    log(f"# golden phase: {json.dumps(info['seconds'])} s")
    return info


MESH_RANKS = 4  # gloo ranks of the mesh phase, all on cuda:0 on one card
CARD_RANKS = 4  # NCCL ranks of the cards phase, one a card


def mesh_phase(dev, smi_line, head_scene, head_tr, head_li, h, w):
    """The sharded paths (tpu_renderer_torch/parallel/mesh.py) on the card,
    each held bit-equal to the unsharded frame; returns their wall ms.

    1. A world-size-1 NCCL group: render_scene_tiled on a (1, 1) mesh and
       gather_framebuffer (an NCCL all-gather), against Renderer's frame.
    2. MESH_RANKS gloo ranks (entry.run_ranks with backend="gloo"), on one
       card sharing it, on more spread over them (cuda:(rank % cards)):
       the headline at h x w over ('ty', 'tx') = (2, 2), a warm-up frame,
       then
       the launch counts set to 0 and one frame: every rank launches K1 and
       K2 once and nothing else; each rank's rect and the gathered frame
       against the headline's unsharded frame. In the same ranks, config 5
       at h x w object-sharded over ('obj', 'ty') = (2, 2), against
       Renderer's config 5 frame.
    3. dryrun_multichip(MESH_RANKS, backend="gloo") on the card: its four
       mesh shapes, held in the ranks.
    Four ranks on one card time-slice it: their ms are no scale-out (the
    cards phase runs NCCL, one rank a card)."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    import tpu_renderer_torch as trt
    from tpu_renderer_torch import entry
    from tpu_renderer_torch.models import scenes
    from tpu_renderer_torch.parallel import mesh as pm

    def frame_of(arrays):
        c, d = arrays
        return (torch.from_numpy(c.view(np.int32)).to(dev),
                torch.from_numpy(d).to(dev))

    def planes(fb):
        return fb.color.view(torch.int32), fb.depth

    torch.cuda.empty_cache()
    head_want = planes(trt.Renderer(h, w, device=dev).render(
        head_scene, head_tr, head_li))
    sg5, tr5_d, li5_d = scenes.baseline_scene(5, h, w)
    s5, tr5, li5 = scenes.to_torch_scene(sg5, tr5_d, li5_d, device=dev)
    want5 = planes(trt.Renderer(h, w, device=dev).render(s5, tr5, li5))
    torch.cuda.synchronize()
    cards = torch.cuda.device_count()
    shared = (f"{MESH_RANKS} gloo ranks on {cards} card(s)"
              + (", time slicing, not scale-out" if cards < MESH_RANKS
                 else ""))
    info = {"card": smi_line, "ranks": MESH_RANKS, "note": shared}

    # 1. NCCL at world size 1.
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tr_nccl_") as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/rdzv",
                                rank=0, world_size=1)
        try:
            mesh = pm.device_mesh((1, 1), ("ty", "tx"), "cuda")
            # The render, the first gather (it opens NCCL's communicator)
            # and a second one, each timed alone between syncs.
            for key in ("render", "gather_first", "gather"):
                t1 = time.perf_counter()
                if key == "render":
                    local = pm.render_scene_tiled(head_scene, head_tr,
                                                  head_li, h, w, mesh)
                else:
                    fb = pm.gather_framebuffer(local, mesh)
                torch.cuda.synchronize()
                info[f"nccl_1x1_{key}_ms"] = 1e3 * (time.perf_counter() - t1)
        finally:
            dist.destroy_process_group()
    info["nccl_1x1_wall_ms"] = 1e3 * (time.perf_counter() - t0)
    assert_equal("NCCL (1, 1) mesh, headline", planes(fb), head_want)
    log("# mesh NCCL world size 1: headline tiled over (1, 1) and "
        "gathered == Renderer's frame, bit-equal")

    # 2. Gloo ranks sharing the card.
    cases = (("headline", "tiled", (2, 2), ("ty", "tx"), "headline",
              "kernels", h, w),
             ("config 5 object", "object", (2, 2), ("obj", "ty"), "config5",
              "kernels", h, w))
    t0 = time.perf_counter()
    ranks = entry.run_ranks(entry.mesh_frames, MESH_RANKS, cases, True,
                            device=dev, backend="gloo")
    info["gloo_ranks_wall_ms"] = 1e3 * (time.perf_counter() - t0)
    lh, lw = h // 2, w // 2
    for rank, frames in enumerate(ranks):
        local, full, ms, gather_ms, launches = frames["headline"]
        counted = {n: c for n, c in launches.items() if c}
        if counted != {"setup.setup_kernel": 1, "raster.bin_for_raster": 1,
                       "raster.raster_kernel": 1}:
            raise AssertionError(f"mesh headline, rank {rank}: launches "
                                 f"{counted}, want K1, K14 and K2 once")
        r0, c0 = (rank // 2) * lh, (rank % 2) * lw
        assert_equal(f"mesh headline, rank {rank}'s rect", frame_of(local),
                     tuple(p[r0:r0 + lh, c0:c0 + lw] for p in head_want))
        assert_equal(f"mesh headline, rank {rank} gathered", frame_of(full),
                     head_want)
        _, full5, ms5, gather5_ms, launches5 = frames["config 5 object"]
        assert_equal(f"mesh config 5 object-sharded, rank {rank}",
                     frame_of(full5), want5)
        info.setdefault("headline_2x2_rank_render_ms", []).append(ms)
        info.setdefault("headline_2x2_rank_gather_ms", []).append(gather_ms)
        info.setdefault("config5_obj_2x2_rank_render_ms", []).append(ms5)
        info.setdefault("config5_obj_2x2_rank_gather_ms", []).append(
            gather5_ms)
        info.setdefault("headline_rank_launches", []).append(counted)
        info.setdefault("config5_obj_rank_launches", []).append(
            {n: c for n, c in launches5.items() if c})
    n_tris = head_scene[0][0].num_triangles
    log(f"# mesh gloo x{MESH_RANKS} on {dev}: headline ({n_tris} tris) "
        f"{w}x{h} tiled over (2, 2), {lw}x{lh} a "
        f"rank, K1, K14 and K2 once on every rank, each rect and the gathered "
        f"frame == the unsharded frame, bit-equal; config 5 object-sharded "
        f"over ('obj', 'ty') = (2, 2) == Renderer's frame, bit-equal")

    # 3. The dry run.
    t0 = time.perf_counter()
    dry = entry.dryrun_multichip(MESH_RANKS, device=dev, backend="gloo")
    info["dryrun_multichip_wall_ms"] = 1e3 * (time.perf_counter() - t0)
    info["dryrun_rank_ms"] = dry
    log(f"# mesh dryrun_multichip({MESH_RANKS}) on the card: tiled, "
        f"geometry, object and two-level shapes == the unsharded frames, "
        f"bit-equal")
    log(f"# mesh wall ms ({smi_line}; {shared}): " + json.dumps(info))
    return info


def launch_guard_ab(dev, smi_line, scene, tr, li, h, w, frames=200,
                    queries=100_000):
    """Config 5's ms/frame through Renderer with the launch guard
    (``_cuda.launch``: the C entry called with its tensors' card current)
    and without it (the C entry called as before the guard, with the
    stream of the tensors' card, whatever card is current), frame by frame
    in turns (without, with, with, without, ...; ``frames`` frames, each
    timed alone by CUDA events), medians of each; both frames bit-equal.
    The scene lies on the current card, so the guard adds one device query
    a launch: its host cost is timed alone too, over ``queries`` calls."""
    import torch

    import tpu_renderer_torch as trt
    from tpu_renderer_torch import _cuda

    guarded = _cuda.launch

    def unguarded(name, device, *args):
        index = (torch.cuda.current_device() if device.index is None
                 else device.index)
        _cuda.check_launch(name, getattr(_cuda.library(), name)(
            *args, torch._C._cuda_getCurrentRawStream(index)))

    renderer = trt.Renderer(h, w, device=dev)
    ms = {"with": [], "without": []}
    out = {}
    try:
        for key in ("without", "with"):
            _cuda.launch = guarded if key == "with" else unguarded
            for _ in range(3):
                out[key] = renderer.render(scene, tr, li)
        assert_equal("config 5 with and without the launch guard",
                     (out["with"].color, out["with"].depth),
                     (out["without"].color, out["without"].depth))
        for i in range(frames):
            key = "with" if i % 4 in (1, 2) else "without"
            _cuda.launch = guarded if key == "with" else unguarded
            ms[key].append(event_ms(lambda: renderer.render(scene, tr, li),
                                    1))
    finally:
        _cuda.launch = guarded
    t0 = time.perf_counter()
    for _ in range(queries):
        torch._C._cuda_getDevice()
    query_us = 1e6 * (time.perf_counter() - t0) / queries
    info = {k: statistics.median(v) for k, v in ms.items()}
    info.update(frames=frames, quartiles={
        k: statistics.quantiles(v, n=4) for k, v in ms.items()},
        device_query_us=query_us)
    log(f"# launch guard A/B, config 5 at {w}x{h} through Renderer "
        f"({smi_line}), ms/frame, {frames} frames in turns, medians: with "
        f"the guard {info['with']}, without {info['without']} (quartiles "
        f"{info['quartiles']}); the guard's device query "
        f"{query_us} us a call; frames bit-equal")
    return info


def cards_phase(smi_lines, h, w):
    """The sharded paths with one NCCL rank a card (entry.run_ranks with
    backend="nccl": rank r on cuda:r, the collectives on the cards), where
    the machine has CARD_RANKS cards; returns what it measured.

    Cases, each at h x w, a warm-up frame then one timed frame a rank
    (entry.mesh_frames; the launch counts set to 0 just before it):
    - the headline tiled over ('ty', 'tx') = (2, 2): every rank launches
      K1, K14 and K2 once and nothing else, then gather_framebuffer;
    - the headline geometry-sharded over ('tr',) = 4: 250,278 triangles a
      card through K1, K9 + K10 and the shade, then the fold's one
      all-gather of the (z, colour, key) planes (its gather ms: that
      collective run again alone);
    - stack6 over ('host', 'ty') = (2, 2): each 'host' coordinate draws
      one half of every object's triangles into its rank's half frame
      (K1, K9 + K10, the shade), the fold's all-gather runs over 'host',
      then gather_framebuffer over 'ty';
    - config 5 object-sharded over ('obj', 'ty') = (2, 2).
    Every rank's rect and every gathered or folded frame is held bit-equal
    to the unsharded frame of the same scene that cuda:0 renders through
    Renderer (warm-up, then one timed frame: the one-card ms). Then
    dryrun_multichip(CARD_RANKS) on NCCL. A mismatch raises."""
    import numpy as np
    import torch

    import tpu_renderer_torch as trt
    from tpu_renderer_torch import entry

    cards = torch.cuda.device_count()
    if cards < CARD_RANKS:
        log(f"# cards phase: {cards} card(s) found, {CARD_RANKS} needed "
            f"for one NCCL rank a card: not run")
        return {"cards": cards, "ran": False}
    dev = torch.device("cuda", 0)
    lh, lw = h // 2, w // 2
    # name: (mode, mesh shape, dim names, scene, rank r's rect (row0, col0,
    # rows, cols))
    cases = {
        "headline tiled": ("tiled", (2, 2), ("ty", "tx"), "headline",
                           lambda r: ((r // 2) * lh, (r % 2) * lw, lh, lw)),
        "headline tr": ("geometry", (CARD_RANKS,), ("tr",), "headline",
                        lambda r: (0, 0, h, w)),
        "stack6 host": ("2level", (2, 2), ("host", "ty"), "stack6",
                        lambda r: ((r % 2) * lh, 0, lh, w)),
        "config 5 object": ("object", (2, 2), ("obj", "ty"), "config5",
                            lambda r: ((r % 2) * lh, 0, lh, w)),
    }
    info = {"cards": cards, "ran": True, "card_lines": smi_lines,
            "ranks": CARD_RANKS, "backend": "nccl", "one_card_ms": {}}
    want = {}
    for scene_name in ("headline", "stack6", "config5"):
        scene, tr, li = entry.scene_by_name(scene_name, h, w, dev)
        renderer = trt.Renderer(h, w, device=dev)
        renderer.render(scene, tr, li)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fb = renderer.render(scene, tr, li)
        torch.cuda.synchronize(dev)
        info["one_card_ms"][scene_name] = 1e3 * (time.perf_counter() - t0)
        want[scene_name] = entry.host_frame(fb)
        del scene, fb
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = entry.run_ranks(
        entry.mesh_frames, CARD_RANKS,
        tuple((name, mode, shape, names, scene_name, "kernels", h, w)
              for name, (mode, shape, names, scene_name, _)
              in cases.items()),
        True, device=dev, backend="nccl")
    info["ranks_wall_ms"] = 1e3 * (time.perf_counter() - t0)
    for name, (mode, shape, names, scene_name, rect) in cases.items():
        whole = want[scene_name]
        per = info[name] = {"mesh": dict(zip(names, shape)),
                            "render_ms": [], "gather_ms": [],
                            "launches": []}
        for rank, frames in enumerate(ranks):
            local, full, ms, gather_ms, launches = frames[name]
            r0, c0, rh, rw = rect(rank)
            for what, got, ref in (
                    ("rect", local, tuple(a[r0:r0 + rh, c0:c0 + rw]
                                          for a in whole)),
                    ("gathered frame", full, whole)):
                diff = entry.frame_difference(got, ref)
                if diff:
                    raise AssertionError(f"cards phase, {name}, rank "
                                         f"{rank}'s {what}: {diff}")
            counted = {n: c for n, c in launches.items() if c}
            if mode == "tiled" and counted != {"setup.setup_kernel": 1,
                                               "raster.bin_for_raster": 1,
                                               "raster.raster_kernel": 1}:
                raise AssertionError(f"cards phase, {name}, rank {rank}: "
                                     f"launches {counted}, want K1, K14 and "
                                     f"K2 once")
            per["render_ms"].append(ms)
            per["gather_ms"].append(gather_ms)
            per["launches"].append(counted)
        covered = int((whole[1] > np.float32(-3.0e38)).sum())
        log(f"# cards {name}: {CARD_RANKS} NCCL ranks, one a card, mesh "
            f"{per['mesh']}, {w}x{h}; every rank's rect and gathered frame "
            f"== cuda:0's unsharded frame ({covered} px covered), "
            f"bit-equal; render ms a rank {per['render_ms']}, gather ms a "
            f"rank {per['gather_ms']}; one card "
            f"{info['one_card_ms'][scene_name]} ms; launches a rank "
            f"{per['launches']}")

    t0 = time.perf_counter()
    info["dryrun_rank_ms"] = entry.dryrun_multichip(CARD_RANKS, device=dev,
                                                    backend="nccl")
    info["dryrun_multichip_wall_ms"] = 1e3 * (time.perf_counter() - t0)
    log(f"# cards dryrun_multichip({CARD_RANKS}) on NCCL, one rank a card: "
        f"tiled, geometry, object and two-level shapes == the unsharded "
        f"frames, bit-equal")
    log(f"# cards wall ms ({'; '.join(smi_lines)}; {CARD_RANKS} NCCL "
        f"ranks, one a card, host clock between syncs; information, not a "
        f"claim): " + json.dumps(info))
    return info


# (C entry) -> the kernel a sweep launch counts as
SWEEP_KERNELS = {
    "tr_setup": "K1", "tr_setup_grouped": "K1 grouped", "tr_records": "K7",
    "tr_raster": "K2",
    "tr_raster_rows1": "K3", "tr_raster_narrow_any": "K4 band",
    "tr_raster_mask": "K6", "tr_gbuffer_mask": "K8",
    "tr_raster_zcull": "K11 rows 2", "tr_raster_rows1_zcull": "K11 rows 1"}
# every kernel form the sweep must launch at least once
SWEEP_MUST = ("K1", "K1 grouped", "K2", "K3", "K4 band", "K5", "K6", "K7",
              "K8", "K9 + K10 <8>", "K9 + K10 band", "K10", "K11 rows 1",
              "K11 rows 2", "K14")
SWEEP_GOLDEN_MAX_TRIS = 10000  # larger scenes are held to the plain versions


def sweep_wrappers():
    """{C entry: its wrapper}, for the launch counters."""
    from tpu_renderer_torch.ops import gbuffer, raster, setup

    return {
        "tr_setup": setup.setup_kernel,
        "tr_setup_grouped": setup.setup_scene_kernel,
        "tr_records": raster.finish_records,
        "tr_raster": raster.raster_kernel,
        "tr_raster_rows1": raster.raster_rows1_kernel,
        "tr_raster_narrow_any": raster.raster_narrow_any_kernel,
        "tr_raster_mask": raster.raster_mask_kernel,
        "tr_raster_zcull": raster.raster_zcull_kernel,
        "tr_raster_rows1_zcull": raster.raster_rows1_zcull_kernel,
        "tr_gbuffer_mask": gbuffer.raster_pass,
        "tr_gbuffer_queue": gbuffer.raster_pass_queue,
    }


def sweep_kernel(entry, tile_h):
    """The kernel form a launch of ``entry`` counts as in the sweep: K9's
    by its tile height (8 rows, or the band form)."""
    if entry == "tr_gbuffer_queue":
        return "K9 + K10 <8>" if tile_h == 8 else "K9 + K10 band"
    return SWEEP_KERNELS[entry]


def sweep_launch(sc, form, scene, tr, li):
    """The launch of a sweep scene's form (``models.sweep_scenes``) on the
    scene's tensors (any device): 'fused' through
    ``engine.renderer.prepare_scene``, 'gbuffer' through
    ``setup_for_raster`` and ``ops.gbuffer.prepare_gbuffer``, with the
    scene's rect, origin, capacity and budget and the form's knobs."""
    from tpu_renderer_torch.engine.renderer import prepare_scene
    from tpu_renderer_torch.ops import gbuffer, setup

    (h, w), (fh, fw), (row0, col0) = sc.hw, sc.frame, sc.origin
    if form.path == "fused":
        return prepare_scene(scene, tr, li, h, w, fh, fw, row0, col0,
                             sc.capacity, sc.budget_override, form.zcull,
                             form.strategy, form.tile_h)
    (obj, cfg), = scene
    table = setup.setup_for_raster(obj, tr, li, cfg, frame_height=fh,
                                   frame_width=fw)
    return gbuffer.prepare_gbuffer(table, h, w, sc.capacity, fh, fw, row0,
                                   col0, form.strategy, form.tile_h,
                                   sc.budget_override)


def sweep_stats(launch):
    """A launch's binning stats as Python numbers (f32 values exactly)."""
    return {k: v.item() if hasattr(v, "item") else v
            for k, v in launch.stats().items()}


def sweep_check_form(what, form, launch, exact):
    """Raise unless ``launch`` takes the form's route and C entry and its
    bins hold the form's claims (a stream's entries, the side list's
    length, the drops); an ``exact`` scene drops nothing. Returns the
    launch's stats."""
    r = launch.route
    got_entry = {v: k for k, v in sweep_wrappers().items()}.get(
        launch.kernel)
    if (r.strategy, r.tile_h, r.rows) != tuple(form.route) or \
            got_entry != form.entry:
        raise AssertionError(f"{what}: route {tuple(r[:3])} on {got_entry}, "
                             f"built for {form.route} on {form.entry}")
    stats = sweep_stats(launch)
    claims = form.claims
    got = {"dropped": int(stats["bins_dropped"])}
    if "stream" in claims:
        got["stream"] = (claims["stream"][0], int(
            launch.qbins.counts[claims["stream"][0]]))
    if "n_large" in claims:
        got["n_large"] = int(launch.qbins.n_large)
    for key in ("stream", "n_large", "dropped"):
        if key in claims and got[key] != claims[key]:
            raise AssertionError(f"{what}: {key} {got[key]}, built for "
                                 f"{claims[key]}")
    if got["dropped"] < claims.get("dropped_min", 0) or (
            exact and got["dropped"]):
        raise AssertionError(f"{what}: {got['dropped']} entries dropped")
    return stats


def sweep_bits_differ(what, names, got, want, origin):
    """Raise at the first element whose bits differ between two output
    tuples (a tile-padded local rect each; ``names`` of the outputs),
    naming its pixel in the rect and in the frame."""
    import torch

    for name, a, b in zip(names, got, want):
        a = a.contiguous().view(torch.int32)
        b = b.to(a.device).contiguous().view(torch.int32)
        if a.shape != b.shape:
            raise AssertionError(f"{what}: {name} of shape {tuple(a.shape)}"
                                 f" against {tuple(b.shape)}")
        bad = a != b
        if bool(bad.any()):
            idx = tuple(int(v) for v in bad.nonzero()[0])
            r, c = idx[-2:]
            raise AssertionError(
                f"{what}: {name} differs at {idx}, rect pixel (row {r}, col "
                f"{c}), frame pixel ({origin[0] + r}, {origin[1] + c}): bits "
                f"{int(a[idx]):#010x} against {int(b[idx]):#010x}; "
                f"{int(bad.sum())} elements differ")


def sweep_skips(what, launch, want):
    """K11's skipped batches on a form's operands: at one part a stream
    equal to ``zcull_skips_plain``'s serial replay (on host copies of the
    operands, the same f32 operations) where no side-list gate is open, at
    least it otherwise; at the default part size at most the stream
    batches (the per-part replay's floor is 0 at 32 entries a part: a part
    holds one or two batches, and its first never skips). Both launches
    bit-equal to the plain version ``want``. Returns (skipped at P, at one
    part a stream, the replay, batches)."""
    import torch

    from tpu_renderer_torch.ops import raster

    names = ("z", "gid", "color")
    out = {}
    for p in (raster.RASTER_PART_ENTRIES, ONE_PART):
        sk = torch.zeros(1, dtype=torch.int32, device=launch.operands[0].device)
        got = with_part_entries(p, lambda: launch.kernel(
            *launch.operands, **launch.options, skipped=sk))()
        sweep_bits_differ(f"{what}, P = {p}", names, got, want,
                          (launch.options["row0"], launch.options["col0"]))
        out[p] = int(sk)
    # The replay loops over batches in Python: on host copies of the
    # operands each batch's few small ops take microseconds, where on the
    # card each waits for a launch and a sync.
    recs = launch.operands[0].cpu()
    qbins = type(launch.operands[1])(*(t.cpu() for t in launch.operands[1]))
    serial = raster.zcull_skips_plain(recs, qbins, tile_h=launch.route.tile_h,
                                      **launch.options)
    batches = stream_batches(launch, raster.RASTER_PART_ENTRIES)
    side = bool((launch.operands[2] > 0).any())
    one, at_p = out[ONE_PART], out[raster.RASTER_PART_ENTRIES]
    if (one != serial if not side else one < serial) or not (
            0 <= at_p <= batches):
        raise AssertionError(
            f"{what}: skipped {one} at one part a stream against the serial "
            f"replay's {serial} (side list {side}), {at_p} at P = "
            f"{raster.RASTER_PART_ENTRIES}, outside [0, {batches}]")
    return at_p, one, serial, batches


def sweep_phase(dev, smi_line, families=None, seeds=None):
    """Phase 11: every kernel route on the seeded boundary scenes of
    ``models.sweep_scenes`` (all families, ``SEEDS``), on one card.

    For each scene and each of its forms: the launch on the card takes the
    route and C entry the scene was built for, with the stream counts,
    side-list length and drops it claims, and its setup launches K1 / K7
    as claimed; its outputs (z, gid and colour; gid and all 11 G-buffer
    planes) are bit-equal to its plain version on the same operands on the
    card, and its stats (drops, real entries, budget utilization) to the
    same form's on CPU tensors; a K11 form's skipped batches equal the
    serial replay (``sweep_skips``). Per scene, K1, its grouped form and
    K7 against their plain versions on its inputs, and for scenes that
    drop nothing and hold at most SWEEP_GOLDEN_MAX_TRIS triangles, every fused form's frame
    and the whole frame through ``render_scene`` (the rect at the scene's
    origin) bit-equal to the NumPy spec, rendered in spawned processes
    while the card works. The first difference raises, naming the family,
    seed, scene, form, route, kernel and pixel. One line per family
    (seeds, routes hit, launches per kernel, seconds); every kernel form
    of SWEEP_MUST launched. Returns the phase's record."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from tpu_renderer_torch.core.types import make_framebuffer
    from tpu_renderer_torch.engine.renderer import render_scene
    from tpu_renderer_torch.geometry.vertex import (
        scene_setup_params,
        setup_records,
    )
    from tpu_renderer_torch.golden import cpu_reference as gold
    from tpu_renderer_torch.models import scenes, sweep_scenes
    from tpu_renderer_torch.ops import raster, setup

    families = tuple(families or sweep_scenes.FAMILIES)
    seeds = tuple(seeds or sweep_scenes.SEEDS)
    wrappers = sweep_wrappers()
    t_phase = time.perf_counter()
    todo = [(fam, seed, sc) for fam in families for seed in seeds
            for sc in sweep_scenes.family_scenes(fam, seed)]
    ctx = multiprocessing.get_context("spawn")
    info = {"card": smi_line, "families": {}}
    pool = ProcessPoolExecutor(max_workers=max(1, (os.cpu_count() or 2) - 1),
                               mp_context=ctx)
    try:
        golden = {}
        for i, (_, _, sc) in sorted(enumerate(todo),
                                    key=lambda t: -t[1][2].triangles):
            if sc.exact and sc.triangles <= SWEEP_GOLDEN_MAX_TRIS:
                golden[i] = pool.submit(gold.render, sc.sg, *sc.camera(),
                                        *sc.frame)
        frames = {}
        for fam in families:
            t_fam = time.perf_counter()
            counts, routes, n_forms, n_scenes, skips = {}, set(), 0, 0, []
            spent = dict(cpu_stats=0.0, k11_replay=0.0)
            for i, (fam_, seed, sc) in enumerate(todo):
                if fam_ != fam:
                    continue
                n_scenes += 1
                label = f"sweep {fam}, seed {seed}, {sc.name}"
                tr_d, li_d = sc.camera()
                scene, tr, li = scenes.to_torch_scene(sc.sg, tr_d, li_d,
                                                      device=dev)
                cpu = scenes.to_torch_scene(sc.sg, tr_d, li_d, device="cpu")
                fh, fw = sc.frame
                if "tr_setup_grouped" in sc.setup:  # K1 grouped, its inputs
                    plan = setup.plan_scene_setup(scene, li.count)
                    params = scene_setup_params(torch.stack(
                        [o.p for o, _ in scene]), tr, li)
                    kw = dict(n_lights=li.count, frame_height=fh,
                              frame_width=fw)
                    assert_equal(f"{label}: K1 grouped",
                                 setup.setup_scene_kernel(params, plan, **kw),
                                 setup.setup_scene_plain(params, plan, **kw))
                    counts["K1 grouped"] = counts.get("K1 grouped", 0) + 1
                for obj, cfg in scene:  # K1 / K7 on this scene's inputs
                    if "tr_setup" in sc.setup and obj.num_triangles >= \
                            sweep_scenes.FUSED_SETUP_MIN:
                        fn, plain, _ = k1_call(obj, cfg, tr, li, fh, fw)
                        assert_equal(f"{label}: K1", fn(), plain())
                        counts["K1"] = counts.get("K1", 0) + 1
                    elif "tr_records" in sc.setup:
                        table = setup_records(obj, tr, li, cfg)
                        assert_equal(f"{label}: K7",
                                     (raster.finish_records(table),),
                                     (raster.finish_records_plain(table),))
                        counts["K7"] = counts.get("K7", 0) + 1
                        break
                for form in sc.forms:
                    n_forms += 1
                    what = (f"{label}, {form.path} {form.strategy} tile_h "
                            f"{form.tile_h} zcull {form.zcull} (route "
                            f"{form.route}, {form.entry})")
                    before = {k: w.launches for k, w in wrappers.items()}
                    k14_before = raster.bin_for_raster.launches
                    launch = sweep_launch(sc, form, scene, tr, li)
                    mid = {k: w.launches for k, w in wrappers.items()}
                    setup_got = {k: mid[k] - before[k] for k in mid
                                 if mid[k] != before[k]}
                    setup_want = (sc.setup if form.path == "fused" else
                                  sweep_scenes.setup_launches(sc.sg))
                    if setup_got != setup_want:
                        raise AssertionError(f"{what}: setup launched "
                                             f"{setup_got}, want {setup_want}")
                    stats = sweep_check_form(what, form, launch, sc.exact)
                    got = launch.run()
                    after = {k: w.launches for k, w in wrappers.items()}
                    ran = {k: after[k] - mid[k] for k in after
                           if after[k] != mid[k]}
                    if ran != {form.entry: 1}:
                        raise AssertionError(f"{what}: launched {ran}")
                    want = launch.run_plain()
                    names = (("gid", "G-buffer") if form.path == "gbuffer"
                             else ("z", "gid", "color"))
                    sweep_bits_differ(what, names, got, want, sc.origin)
                    t0 = time.perf_counter()
                    cpu_launch = sweep_launch(sc, form, *cpu)
                    cpu_stats = sweep_stats(cpu_launch)
                    spent["cpu_stats"] += time.perf_counter() - t0
                    if stats != cpu_stats:
                        raise AssertionError(f"{what}: stats {stats} on the "
                                             f"card, {cpu_stats} on the CPU")
                    # K14: the bins and the side-list gate, integer-exact
                    # against the CPU's plain binning, one launch a draw
                    sorted_form = launch.route.strategy == "sorted"
                    k14 = raster.bin_for_raster.launches - k14_before
                    if k14 != int(sorted_form):
                        raise AssertionError(f"{what}: K14 launched {k14}")
                    if sorted_form:
                        assert_equal(
                            f"{what}: K14 bins against the CPU's",
                            tuple(launch.operands[1]) + (launch.operands[2],),
                            tuple(cpu_launch.operands[1])
                            + (cpu_launch.operands[2],))
                        counts["K14"] = counts.get("K14", 0) + 1
                    for k, n in list(setup_got.items()) + list(ran.items()):
                        key = sweep_kernel(k, launch.route.tile_h)
                        counts[key] = counts.get(key, 0) + n
                    if form.path == "fused" and int((
                            launch.texs[:, 1] > 0).sum()):
                        counts["K5"] = counts.get("K5", 0) + 1
                    if launch.route.strategy == "sorted" and bool(
                            (launch.operands[2] > 0).any()):
                        key = ("K10" if form.path == "gbuffer" else
                               "side list in K2-K4, K11")
                        counts[key] = counts.get(key, 0) + 1
                    if form.entry.endswith("_zcull"):
                        t0 = time.perf_counter()
                        skips.append(sweep_skips(what, launch, want))
                        spent["k11_replay"] += time.perf_counter() - t0
                        key = sweep_kernel(form.entry, 8)
                        counts[key] += 2
                    if form.path == "fused" and i in golden:
                        h, w = sc.hw
                        frames.setdefault(i, []).append((what, host_frame(
                            want[2][:h, :w], want[0][:h, :w])))
                    routes.add((form.path,) + tuple(form.route))
                # the whole frame, as Renderer draws it, into the rect
                fb = render_scene(make_framebuffer(*sc.hw, device=dev),
                                  scene, tr, li, frame_height=fh,
                                  frame_width=fw, row0=sc.origin[0],
                                  col0=sc.origin[1], capacity=sc.capacity,
                                  budget_override=sc.budget_override,
                                  zcull=sc.zcull)
                if i in golden:
                    frames.setdefault(i, []).append((
                        f"{label}: render_scene", frame_arrays(fb)))
            info["families"][fam] = dict(
                seeds=list(seeds), scenes=n_scenes, forms=n_forms,
                routes=sorted(" ".join(map(str, r)) for r in routes),
                launches=dict(sorted(counts.items())), golden_scenes=0,
                k11_skips=skips,
                seconds=round(time.perf_counter() - t_fam, 2),
                **{k + "_seconds": round(v, 2) for k, v in spent.items()})
        # The spec's frames, rendered meanwhile on the host's cores.
        t0 = time.perf_counter()
        for i, held in sorted(frames.items()):
            color, depth = golden[i].result()
            fam, _, sc = todo[i]
            (h, w), (r0, c0) = sc.hw, sc.origin
            want = (color[r0:r0 + h, c0:c0 + w], depth[r0:r0 + h, c0:c0 + w])
            for what, got in held:
                golden_diff(what + " against the NumPy spec", got, want)
            info["families"][fam]["golden_scenes"] += 1
        info["golden_wait_seconds"] = round(time.perf_counter() - t0, 2)
    finally:  # a failure leaves no golden render running
        pool.shutdown(wait=True, cancel_futures=True)
    total = {}
    for fam, rec in info["families"].items():
        for k, n in rec["launches"].items():
            total[k] = total.get(k, 0) + n
        log(f"# sweep {fam} ({smi_line}): seeds {rec['seeds']}, "
            f"{rec['scenes']} scenes, {rec['forms']} forms, every launch == "
            f"its plain version and the CPU's stats, bit-equal; "
            f"{rec['golden_scenes']} scenes == the NumPy spec; routes hit "
            f"{rec['routes']}; launches {json.dumps(rec['launches'])}; K11 "
            f"skips (P, one part, replay, batches) {rec['k11_skips']}; "
            f"{rec['seconds']} s on the card (of it CPU stats "
            f"{rec['cpu_stats_seconds']}, K11 replays "
            f"{rec['k11_replay_seconds']})")
    missing = [k for k in SWEEP_MUST if not total.get(k)]
    info["launches"] = total
    info["seconds"] = round(time.perf_counter() - t_phase, 2)
    if missing and families == sweep_scenes.FAMILIES:
        raise AssertionError(f"sweep: no launch of {missing}")
    log(f"# sweep phase: {info['seconds']} s ({smi_line}), launches "
        f"{json.dumps(total)}")
    return info


def main():
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace 10 frames of each path with "
                         "torch.profiler and print host enqueue time, device "
                         "time and idle share per frame")
    ap.add_argument("--sweep-only", nargs="*", metavar="FAMILY",
                    help="run the device, build and sweep phases only (the "
                         "named families of models/sweep_scenes.py, or "
                         "all), then print the sweep's record")
    ap.add_argument("--band-times", metavar="TREE",
                    help="run the device and build phases and time the "
                         "band form's paths (BAND_PATHS) with the package "
                         "of the repository copy at TREE, then print them")
    ap.add_argument("--band-ab", metavar="OTHER",
                    help="run the device and build phases, then time the "
                         "band paths of the repository copy at OTHER and "
                         "of this one back to back (--band-times of each, "
                         "other, this, this, other) and print both")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    sys.path.insert(0, os.path.abspath(args.band_times or ROOT))
    import tpu_renderer_torch as trt
    from tpu_renderer_torch import _cuda
    from tpu_renderer_torch.core.math import unpack_argb
    from tpu_renderer_torch.core.types import Framebuffer
    from tpu_renderer_torch.engine.renderer import (
        _draw_deferred,
        _obj_fusable,
        prepare_scene,
    )
    from tpu_renderer_torch.geometry.vertex import setup_records
    from tpu_renderer_torch.models import primitives as prim
    from tpu_renderer_torch.models import scenes
    from tpu_renderer_torch.models.route_scenes import (
        GBUFFER_NAMES,
        MASK_NAMES,
        ROUTE_NAMES,
        TEXTURED_NAMES,
        route_scene,
        zcull_stack,
    )
    from tpu_renderer_torch.models.route_scenes import \
        torch_scene as route_torch_scene
    from tpu_renderer_torch.models.sphere import construct_sphere
    from tpu_renderer_torch.models.textures import checkerboard
    from tpu_renderer_torch.ops import binning, gbuffer, raster, setup
    from tpu_renderer_torch.ops.shading import shade_merge, shade_merge_plain
    from tpu_renderer_torch.geometry.transform import (
        resolve_scene,
        rotate_kernel,
        rotate_kernel_grouped,
        rotate_object,
        rotate_plain,
        rotation_y,
    )
    from tpu_renderer_torch.geometry.vertex import scene_setup_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    wrappers = {
        "K1 setup": setup.setup_kernel,
        "K1 grouped": setup.setup_scene_kernel,
        "K2 raster+shade": raster.raster_kernel,
        "K3 raster+shade rows 1": raster.raster_rows1_kernel,
        "K6 raster+shade mask": raster.raster_mask_kernel,
        "K7 record transpose": raster.finish_records,
        "K8 G-buffer mask": gbuffer.raster_pass,
        "K9 G-buffer sorted": gbuffer.raster_pass_queue,
        "K11 zcull": raster.raster_zcull_kernel,
        "K11 zcull rows 1": raster.raster_rows1_zcull_kernel,
        "K4 raster+shade band": raster.raster_narrow_any_kernel,
        "K12 deferred shade": shade_merge,
        "K13 rotate": rotate_kernel,
        "K13 grouped": rotate_kernel_grouped,
        "K14 binning": raster.bin_for_raster,
    }

    # 1. Device.
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"# device: {kind} x{count}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, python {sys.version.split()[0]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_lines = smi.stdout.strip().splitlines()
    smi_line = smi_lines[0]
    log(smi_line)

    # 2. Build.
    t0 = time.perf_counter()
    _cuda.library()
    log(f"# build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_cuda.build_info['seconds']:.2f} s, "
        f"cached={_cuda.build_info['cached']})")
    for line in _cuda.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("#   " + line.strip())
    k1_ptxas = ptxas_info(_cuda.build_info["log"], "setup_kernel",
                          r"_ZN2tr12setup_kernelI(Lb[01])E(Lb[01])E")
    mask_ptxas = ptxas_info(_cuda.build_info["log"], "mask_kernel",
                            r"_ZN2tr11mask_kernelI(Li\d+)E(Lb[01])E")
    band_ptxas = ptxas_info(_cuda.build_info["log"], "band_walk_kernel",
                            r"_ZN2tr16band_walk_kernelE")
    k1g_ptxas = ptxas_info(_cuda.build_info["log"], "setup_kernel_grouped",
                           r"_ZN2tr20setup_kernel_groupedI(Lb[01])E(Lb[01])E")
    k13_ptxas = ptxas_info(_cuda.build_info["log"], "rotate_kernel",
                           r"_ZN2tr13rotate_kernelE")
    k13_ptxas.update(ptxas_info(_cuda.build_info["log"],
                                "rotate_kernel_grouped",
                                r"_ZN2tr21rotate_kernel_groupedE"))
    if len(k1_ptxas) != 4 or len(mask_ptxas) != 2 or \
            len(band_ptxas) != 1 or len(k1g_ptxas) != 4 or \
            len(k13_ptxas) != 2 or not all(
                {"registers", "spill_stores"} <= set(v)
                for v in band_ptxas.values()):
        raise AssertionError(f"ptxas lines of K1: {k1_ptxas}; of the mask "
                             f"kernel: {mask_ptxas}; of the band walk: "
                             f"{band_ptxas}; of K1 grouped: {k1g_ptxas}; "
                             f"of K13: {k13_ptxas}")
    k14_ptxas = {}
    for label, mangled in (
            ("bin_entries_kernel<short, 1>",
             r"_ZN2tr18bin_entries_kernelIsLi1EEE"),
            ("bin_entries_kernel<short, 2>",
             r"_ZN2tr18bin_entries_kernelIsLi2EEE"),
            ("bin_entries_kernel<int, 1>",
             r"_ZN2tr18bin_entries_kernelIiLi1EEE"),
            ("bin_entries_kernel<int, 2>",
             r"_ZN2tr18bin_entries_kernelIiLi2EEE"),
            ("bin_bounds_kernel<short>", r"_ZN2tr17bin_bounds_kernelIsE"),
            ("bin_bounds_kernel<int>", r"_ZN2tr17bin_bounds_kernelIiE"),
            ("bin_finish_kernel", r"_ZN2tr17bin_finish_kernelE")):
        for info in ptxas_info(_cuda.build_info["log"], label,
                               mangled).values():
            k14_ptxas[label] = info
    for form, info in k1_ptxas.items():
        log(f"# K1 ptxas {form}: {json.dumps(info)}")
    log(f"# K14 ptxas: {json.dumps(k14_ptxas)}")
    for form, info in mask_ptxas.items():
        log(f"# K6/K8 ptxas {form}: {json.dumps(info)}")
    for form, info in band_ptxas.items():
        log(f"# K4/K9 band form ptxas {form}: {json.dumps(info)}")
    if args.sweep_only is not None:
        log(json.dumps({"sweep": sweep_phase(dev, smi_line,
                                             args.sweep_only)}))
        return
    if args.band_times is not None:
        log(json.dumps({"band_times": band_times(dev)}))
        return
    if args.band_ab is not None:
        log(json.dumps({"band_ab": band_ab(args.band_ab, smi_line)}))
        return

    # 3. Each kernel against its plain version on the card.
    max_err = {name: 0.0 for name in KERNELS}

    def check_launch(name, label, launch, want_route, n_obj, n_tex=0,
                     err_key=None):
        """A launch on ``name``'s wrapper and route (tile_h, rows), bit-equal
        to its plain version; the error goes to ``err_key`` (default
        ``name``) and K5's where an object is textured. Returns n_large."""
        r = launch.route
        textured = int((launch.texs[:, 1] > 0).sum())
        if (r.tile_h, r.rows) != want_route or launch.kernel is not \
                wrappers[name] or launch.objs.shape[0] != n_obj or \
                textured != n_tex:
            raise AssertionError(f"{label} took route {r} on "
                                 f"{launch.kernel.__name__}, {textured} "
                                 "textured object(s)")
        err = assert_equal(f"{name} on {label}", launch.run(),
                           launch.run_plain())
        err_key = err_key or name
        max_err[err_key] = max(max_err[err_key], err)
        if textured:
            key = "K5 texture sampling"
            max_err[key] = max(max_err[key], err)
        log(f"# {name} == plain on {label} (tile_h {r.tile_h}, rows "
            f"{r.rows}, {n_obj} object(s), {textured} textured, n_large "
            f"{int(launch.qbins.n_large)}): bit-equal")
        return int(launch.qbins.n_large)

    def check_k1(label, obj, cfg, tr, li, h, w):
        fn, plain, _ = k1_call(obj, cfg, tr, li, h, w)
        key = "K1 setup textured" if cfg.textured else "K1 setup"
        max_err[key] = max(max_err[key], assert_equal(
            f"{key} on {label}", fn(), plain()))

    def check_k1_ragged(label, mesh, tps, h, w):
        """K1 in its four forms (Phong / Gouraud x textured / not) at each
        padded length of ``tps(T)``, gid0 = 7: bit-equal to setup_plain,
        the ragged last warp and the padding rows included."""
        for phong in (True, False):
            for textured in (False, True):
                cfg_d = {"phong": phong}
                if textured:
                    cfg_d.update(texture=tex128, filter_mode="bilinear")
                sc, tr_, li_ = torch_scene(
                    [(dict(p=(0.0, 0.0, 0.0), **mesh), cfg_d)], h, w, dev)
                o, c = sc[0]
                key = "K1 setup textured" if textured else "K1 setup"
                for tp_ in tps(o.num_triangles):
                    fn, plain, _ = k1_call(o, c, tr_, li_, h, w, tp_, 7)
                    max_err[key] = max(max_err[key], assert_equal(
                        f"{key} (phong {phong}) on {label}, tp {tp_}",
                        fn(), plain()))
                    log(f"# {key} (phong {phong}) == plain on {label}: "
                        f"{o.num_triangles} tris, tp {tp_}, gid0 7, "
                        "bit-equal")

    grid = prim.construct_sphere_grid(160, 160)
    teapot = {k: v for k, v in scenes.baseline_scene(2, 512, 512)[0][0][
        0].items() if k != "p"}
    tex128 = checkerboard(128, 128, 16)
    for label, mesh, kname, want, hw, quad, tex in (
            ("51,200-tri sphere", grid, "K2 raster+shade", (8, 2), 512,
             None, False),
            ("sphere + large quad", grid, "K2 raster+shade", (8, 2), 512,
             1.2, False),
            ("textured 51,200-tri sphere", grid, "K2 raster+shade", (8, 2),
             512, None, True),
            ("config 2 teapot", teapot, "K3 raster+shade rows 1", (8, 1),
             512, None, False),
            ("teapot + large quad", teapot, "K3 raster+shade rows 1",
             (8, 1), 512, 2.2, False),
            ("textured teapot", teapot, "K3 raster+shade rows 1", (8, 1),
             512, None, True)):
        if quad is not None:
            mesh = prim.merge_meshes(mesh, prim.construct_quad(quad))
        cfg_d = {"phong": True} if kname.startswith("K2") else {}
        if tex:
            cfg_d = dict(cfg_d, texture=tex128, filter_mode="bilinear")
        sg = [(dict(p=(0.0, 0.0, 0.0), **mesh), cfg_d)]
        scene, tr, li = torch_scene(sg, hw, hw, dev)
        check_k1(label, *scene[0], tr, li, hw, hw)
        n_large = check_launch(kname, f"{label} at {hw}x{hw}",
                               prepare_scene(scene, tr, li, hw, hw), want, 1,
                               int(tex))
        if (quad is not None) != (n_large > 0):
            raise AssertionError(f"{label}: n_large {n_large}")
    check_k1_ragged("config 2 teapot", teapot, lambda n: (n, n + 1000), 512,
                    512)

    H, W = 1080, 1920
    sg4 = scenes.baseline_scene(4, H, W)[0]
    scene4, tr4, li4 = torch_scene(sg4, H, W, dev)
    table4 = setup_records(scene4[0][0], tr4, li4, scene4[0][1])
    max_err["K7 record transpose"] = assert_equal(
        "K7 on config 4's table", (raster.finish_records(table4),),
        (raster.finish_records_plain(table4),))
    log(f"# K7 == plain on config 4's {tuple(table4.shape)} table: "
        "bit-equal")
    check_launch("K4 raster+shade band", "config 4 at 1920x1080",
                 prepare_scene(scene4, tr4, li4, H, W), (16, 1), 1,
                 err_key="K4 raster+shade band 16-row")
    sg5full = scenes.baseline_scene(5, H, W)[0]
    sg5 = sg5full[:3]
    scene5, tr5, li5 = torch_scene(sg5, H, W, dev)
    check_launch("K4 raster+shade band",
                 "config 5 untextured at 1920x1080",
                 prepare_scene(scene5, tr5, li5, H, W), (16, 1), 3,
                 err_key="K4 raster+shade band 16-row")
    scene5f, tr5f, li5f = torch_scene(sg5full, H, W, dev)
    check_launch("K4 raster+shade band", "config 5 at 1920x1080",
                 prepare_scene(scene5f, tr5f, li5f, H, W), (16, 1), 4, 1,
                 err_key="K4 raster+shade band 16-row")
    sg, (h, w) = route_scene("k2multi")
    scene, tr, li = torch_scene(sg, h, w, dev)
    check_launch("K2 raster+shade", f"config 5 untextured at {w}x{h}",
                 prepare_scene(scene, tr, li, h, w), (8, 2), 3)
    sg1 = scenes.baseline_scene(1, 512, 512)[0]
    sg3 = scenes.baseline_scene(3, 512, 512)[0]
    scene1, tr1, li1 = torch_scene(sg1, 512, 512, dev)
    scene3, tr3, li3 = torch_scene(sg3, 512, 512, dev)
    check_launch("K6 raster+shade mask", "config 1 at 512x512",
                 prepare_scene(scene1, tr1, li1, 512, 512), (16, 1), 1)
    check_launch("K6 raster+shade mask", "config 3 at 512x512",
                 prepare_scene(scene3, tr3, li3, 512, 512), (16, 1), 1, 1)
    for variant, n_tex in (("base", 0), ("textured", 2)):
        sg, (h, w) = route_scene("k6multi", variant)
        scene, tr, li = torch_scene(sg, h, w, dev)
        check_launch("K6 raster+shade mask",
                     f"2-object {variant} scene at {w}x{h}",
                     prepare_scene(scene, tr, li, h, w), (8, 1), 2, n_tex)

    def check_gbuffer(name, label, launch, want_route, suffix=""):
        """A G-buffer launch on its route's kernel, gid and 11 planes
        bit-equal to the plain version; K10's error where the side list is
        not empty, both under their names plus ``suffix``. Returns
        n_large."""
        r = launch.route
        if (r.strategy, r.tile_h) != want_route or \
                launch.kernel is not wrappers[name]:
            raise AssertionError(f"{label} took route {r} on "
                                 f"{launch.kernel.__name__}")
        err = assert_equal(f"{name} on {label}", launch.run(),
                           launch.run_plain())
        max_err[name + suffix] = max(max_err[name + suffix], err)
        n_large = int(launch.qbins.n_large)
        if n_large:
            key = "K10 G-buffer side list" + suffix
            max_err[key] = max(max_err[key], err)
        log(f"# {name} == plain on {label} ({r.strategy}, tile_h "
            f"{r.tile_h}, n_large {n_large}): bit-equal, gid and 11 planes")
        return n_large

    def gbuffer_launch(obj, cfg, tr, li, h, w, **knobs):
        """The G-buffer launch of one object (``knobs``: strategy,
        tile_h)."""
        table = setup.setup_for_raster(obj, tr, li, cfg, frame_height=h,
                                       frame_width=w)
        return gbuffer.prepare_gbuffer(table, h, w, **knobs)

    for label, quad in (("51,200-tri sphere", None),
                        ("sphere + large quad", 1.2)):
        mesh = grid if quad is None else prim.merge_meshes(
            grid, prim.construct_quad(quad))
        scene, tr, li = torch_scene(phong_mesh_scene(mesh), 512, 512, dev)
        n_large = check_gbuffer(
            "K9 G-buffer sorted", f"{label} at 512x512",
            gbuffer_launch(*scene[0], tr, li, 512, 512), ("sorted", 8))
        if (quad is not None) != (n_large > 0):
            raise AssertionError(f"{label}: n_large {n_large}")
    check_gbuffer("K9 G-buffer sorted", "config 4 at 1920x1080",
                  gbuffer.prepare_gbuffer(table4, H, W), ("sorted", 16),
                  " band")
    sg3avx = [(sg3[0][0], dict(sg3[0][1], uv_mode="avx"))]
    scene3avx, _, _ = torch_scene(sg3avx, 512, 512, dev)
    for label, (obj_, cfg_), tr_, li_ in (
            ("config 3 avx", scene3avx[0], tr3, li3),
            ("config 1", scene1[0], tr1, li1)):
        check_gbuffer("K8 G-buffer mask", f"{label} at 512x512",
                      gbuffer_launch(obj_, cfg_, tr_, li_, 512, 512),
                      ("mask", 16))

    # The route scenes forced to 32-row tiles: K4 (sorted, the band form)
    # and K6 (mask) with and without the side
    # list, textured (K5) and not, one and several objects; K8 and K9 (K10
    # on the side-list scenes: the 2.2-unit quad covers 36 tiles of 32 rows
    # at 384x384, more than the expansion of 32), gid and all 11 planes.
    for name, variant, n_obj, n_tex in (
            ("k4", "base", 1, 0), ("k4", "sidelist", 1, 0),
            ("k4", "textured", 1, 1), ("k4multi", "sidelist", 3, 0),
            ("k2multi", "textured", 4, 1), ("k6", "base", 1, 0),
            ("k6", "textured", 1, 1), ("k6multi", "base", 2, 0),
            ("k6multi", "textured", 2, 2)):
        mask = name in MASK_NAMES
        sg, (h, w) = route_scene(name, variant)
        scene, tr, li = torch_scene(sg, h, w, dev)
        kname = "K6 raster+shade mask" if mask else "K4 raster+shade band"
        n_large = check_launch(
            kname, f"route {name} ({variant}) at {w}x{h}, 32-row tiles",
            prepare_scene(scene, tr, li, h, w, tile_h=32,
                          strategy="mask" if mask else "sorted"),
            (32, 1), n_obj, n_tex, err_key=(
                "K6 raster+shade mask 32-row" if mask else
                "K4 raster+shade band 32-row"))
        if (variant == "sidelist") != (n_large > 0):
            raise AssertionError(f"route {name} ({variant}) at 32 rows: "
                                 f"n_large {n_large}")
    for name, variant, strategy in (
            ("k4", "base", "sorted"), ("k4", "sidelist", "sorted"),
            ("k4", "gbuffer", "sorted"), ("k6", "base", "mask"),
            ("k6", "gbuffer", "mask")):
        sg, (h, w) = route_scene(name, variant)
        scene, tr, li = torch_scene(sg, h, w, dev)
        n_large = check_gbuffer(
            "K8 G-buffer mask" if strategy == "mask" else
            "K9 G-buffer sorted",
            f"route {name} ({variant}) at {w}x{h}, 32-row tiles",
            gbuffer_launch(*scene[0], tr, li, h, w, strategy=strategy,
                           tile_h=32), (strategy, 32),
            " 32-row" if strategy == "mask" else " band 32-row")
        if (variant != "base" and strategy == "sorted") != (n_large > 0):
            raise AssertionError(f"route {name} ({variant}) G-buffer at 32 "
                                 f"rows: n_large {n_large}")
    # 64-row tiles, which only the mask kernels run (any multiple of 8
    # rows): K6 with K5 bilinear and K8 on the 528-triangle sphere forced to
    # the mask strategy, whose longest list outgrows one batch of a row.
    sg_k4, (h_k4, w_k4) = route_scene("k4", "textured")
    sg_k4 = [(sg_k4[0][0], dict(sg_k4[0][1], filter_mode="bilinear"))]
    scene_k4, tr_k4, li_k4 = torch_scene(sg_k4, h_k4, w_k4, dev)
    check_launch("K6 raster+shade mask", f"route k4 (528 tris, bilinear), "
                 f"strategy='mask', at {w_k4}x{h_k4}, 64-row tiles",
                 prepare_scene(scene_k4, tr_k4, li_k4, h_k4, w_k4,
                               strategy="mask", tile_h=64), (64, 1), 1, 1)
    check_gbuffer("K8 G-buffer mask", f"route k4 (528 tris), strategy='mask',"
                  f" at {w_k4}x{h_k4}, 64-row tiles", gbuffer_launch(
                      *scene_k4[0], tr_k4, li_k4, h_k4, w_k4,
                      strategy="mask", tile_h=64), ("mask", 64))

    # The band form (K4 and K9 + K10 on sorted heights above 8 rows) at
    # every height of BAND_HEIGHTS, at the default part size
    # and at 16 entries a part, the parts the kernel counted read back and
    # held to the bins': K4 on the route scenes with and without the side
    # list, textured (K5) and not, one and several objects, and on a cube
    # with a 16-unit quad behind it at 1408x256, whose quad takes the side
    # list at every height; K9 on the sphere, its side-list and G-buffer
    # variants and the cube with the quad (K10).
    def check_band(name, label, launch, want_route, err_key, n_tex=0):
        """A band-form launch on ``name``'s wrapper and route, bit-equal to
        its plain version at P = the default and 16, its part offsets equal
        to the bins' count; the error to ``err_key`` and, where the side
        list is not empty (K9) or an object textured (K4), K10's / K5's.
        Returns n_large."""
        r = launch.route
        if (r.strategy, r.tile_h, r.rows) != want_route or \
                launch.kernel is not wrappers[name]:
            raise AssertionError(f"{label} took route {r} on "
                                 f"{launch.kernel.__name__}")
        n_large = int(launch.qbins.n_large)
        keys = [err_key] + (["K5 texture sampling"] if n_tex else []) + (
            ["K10 G-buffer side list band"]
            if n_large and err_key.startswith("K9") else [])
        want = launch.run_plain()
        for p_ in (raster.RASTER_PART_ENTRIES, 16):
            seen = {}
            out = with_part_entries(p_, launch.run, launch.kernel, seen)()
            err = assert_equal(f"{name} on {label}, P = {p_}", out, want)
            for k in keys:
                max_err[k] = max(max_err[k], err)
            off, (parts, _) = seen[p_].cpu(), parts_plain(launch, p_)
            if int(off[0]) != 0 or not torch.equal(off[1:] - off[:-1],
                                                   parts.int()):
                raise AssertionError(f"{name} on {label}, P = {p_}: the "
                                     f"kernel counted {int(off[-1])} parts,"
                                     f" the bins give {int(parts.sum())}")
        log(f"# {name} (band form) == plain on {label} (tile_h {r.tile_h},"
            f" n_large {n_large}): bit-equal at P = "
            f"{raster.RASTER_PART_ENTRIES} and 16, parts as the bins give")
        return n_large

    quad16 = prim.construct_quad(16.0, color=(0.3, 0.9, 0.4, 1.0))
    quad16["vertices"] = quad16["vertices"] + np.float32([0.0, 0.0, -0.5])
    sg_cq = [(dict(p=(0.0, 0.0, 0.0),
                   **prim.merge_meshes(prim.construct_cube(), quad16)), {})]
    sc_cq, tr_cq, li_cq = scenes.to_torch_scene(
        sg_cq, *scenes.baseline_scene(1, 256, 1408)[1:], device=dev)
    band_scenes = [("cube + 16-unit quad at 1408x256", sc_cq, tr_cq, li_cq,
                    256, 1408, 0, True)]
    for n, v, n_tex, gbuf_ in (("k4", "base", 0, True),
                               ("k4", "sidelist", 0, True),
                               ("k4", "textured", 1, False),
                               ("k4", "gbuffer", 0, True),
                               ("k4multi", "sidelist", 0, False),
                               ("k2multi", "textured", 1, False)):
        sc_, tr_, li_, (h_, w_) = route_torch_scene(n, v, dev)
        band_scenes.append((f"route {n} ({v}) at {w_}x{h_}", sc_, tr_, li_,
                            h_, w_, n_tex, gbuf_))
    for tile_h in BAND_HEIGHTS:
        sides = 0
        for label, sc_, tr_, li_, h_, w_, n_tex, gbuf_ in band_scenes:
            if "gbuffer" not in label:
                check_band("K4 raster+shade band", label, prepare_scene(
                    sc_, tr_, li_, h_, w_, strategy="sorted", tile_h=tile_h),
                    ("sorted", tile_h, 1), "K4 raster+shade band", n_tex)
            if gbuf_:
                sides += check_band(
                    "K9 G-buffer sorted", label, gbuffer_launch(
                        *sc_[0], tr_, li_, h_, w_, strategy="sorted",
                        tile_h=tile_h), ("sorted", tile_h, 1),
                    "K9 G-buffer sorted band") > 0
        if not sides:
            raise AssertionError(f"band form at {tile_h} rows: no K9 launch "
                                 "reached the side list")

    # K11 on K3's and K2's routes: bit-equal to its plain version and to the
    # non-culling kernel on the same operands; its skipped batches at least
    # the per-part replay (each part culling against its own winners alone)
    # and at most the stream batches, at the default part size, at 256
    # entries a part (where that replay skips batches, so the kernel must)
    # and at one part a stream, and there, with every side-list gate closed
    # (the rows-2 stack also runs with its lcounts zeroed), equal to the
    # serial replay.
    for rows in (1, 2):
        sc, tr, li, (h, w) = zcull_stack(rows, dev)
        launch = prepare_scene(sc, tr, li, h, w, zcull=True)
        if launch.kernel is not raster.ZCULL_KERNELS[(8, rows)]:
            raise AssertionError(f"K11 stack rows {rows} took "
                                 f"{launch.kernel.__name__}")
        label = (f"the {rows}-stream stack, "
                 f"{sum(o.num_triangles for o, _ in sc)} tris {w}x{h}")
        gates = launch.operands[2]
        closed = launch.operands[:2] + (torch.zeros_like(gates),) + (
            launch.operands[3:])
        replay = {p_: raster.zcull_skips_plain(
            *launch.operands[:2], tile_h=8,
            part_entries=None if p_ == ONE_PART else p_, **launch.options)
            for p_ in (raster.RASTER_PART_ENTRIES, 256, ONE_PART)}
        if replay[256] <= 0:
            raise AssertionError(f"K11 on {label}: the replay at 256 "
                                 "entries a part skips nothing")
        cases = [("", launch.operands, p_) for p_ in replay]
        if bool((gates > 0).any()):
            cases.append((" gates closed", closed, ONE_PART))
        got = {}
        for tag, operands, p_ in cases:
            want = raster.raster_plain(*operands, tile_h=8, **launch.options)
            unculled = raster.RASTER_KERNELS[(8, rows)](*operands,
                                                        **launch.options)
            skipped = torch.zeros(1, dtype=torch.int32, device=dev)

            def k11(operands=operands, skipped=skipped):
                return launch.kernel(*operands, skipped=skipped,
                                     **launch.options)
            out = with_part_entries(p_, k11)()
            what = f"K11 on {label}{tag}, P = {p_}"
            max_err["K11 zcull"] = max(max_err["K11 zcull"],
                                       assert_equal(what, out, want))
            assert_equal(f"{what}, against the non-culling kernel", out,
                         unculled)
            n, floor = int(skipped), replay[p_]
            batches = stream_batches(launch, p_)
            exact = p_ == ONE_PART and not bool((operands[2] > 0).any())
            if not floor <= n <= batches or (exact and n != floor):
                raise AssertionError(f"{what}: skipped {n}, the replay "
                                     f"{floor}, batches {batches}")
            got[f"P={p_}{tag}"] = n
        log(f"# K11 zcull == plain and == K{4 - rows} on {label}: "
            f"bit-equal; batches skipped {json.dumps(got)}, the per-part "
            f"replay {json.dumps(replay)} (P = {ONE_PART}: the serial one)")

    # 4. Small scenes on the card against the plain versions on the CPU
    # (the CPU runs are what the tests hold to the JAX package and golden).
    def card_vs_cpu(label, sg, h, w, min_cov=1, **knobs):
        fbs = []
        for d in ("cpu", dev):
            sc, tr_, li_ = torch_scene(sg, h, w, d)
            fbs.append(trt.Renderer(h, w, device=d, **knobs).render(
                sc, tr_, li_))
        torch.cuda.synchronize()
        cpu_fb, gpu_fb = fbs
        same_z, err_z = bit_diff(gpu_fb.depth.cpu(), cpu_fb.depth)
        same_c, _ = bit_diff(gpu_fb.color.cpu(), cpu_fb.color)
        cov = int((cpu_fb.depth > -3.0e38).sum())
        if not (same_z and same_c) or cov < min_cov:
            raise AssertionError(
                f"{label} on the card differs from the CPU run (depth "
                f"equal {same_z}, max err {err_z}; color equal {same_c}; "
                f"covered {cov})")
        log(f"# {label} {w}x{h}: card == CPU plain, bit-equal, {cov} px "
            "covered")
        return cov

    cov = card_vs_cpu("4,140-tri sphere grid",
                      phong_mesh_scene(prim.construct_sphere_grid(46, 45)),
                      128, 128)
    if cov != 2174:
        raise AssertionError(f"4,140-tri frame covers {cov} px, not 2174")
    for name, variant in ([(n, v) for n in ROUTE_NAMES
                           for v in ("base", "sidelist")]
                          + [(n, "base") for n in MASK_NAMES]
                          + [(n, "textured") for n in TEXTURED_NAMES]
                          + [(n, "gbuffer") for n in GBUFFER_NAMES]):
        sg, (h, w) = route_scene(name, variant)
        card_vs_cpu(f"route {name} ({variant})", sg, h, w, 100)

    # The Renderer's knobs, card against CPU: a clear colour on K2's route,
    # calibrate (the same factor, then its frame), the reference backend.
    card_vs_cpu("51,200-tri sphere, clear_color 0xFF203040",
                phong_mesh_scene(grid), 512, 512, 1000,
                clear_color=0xFF203040)
    factors = []
    for d in ("cpu", dev):
        sc, tr_, li_ = torch_scene(
            phong_mesh_scene(prim.construct_sphere_grid(46, 45)), 128, 128,
            d)
        r = trt.Renderer(128, 128, device=d)
        factors.append((r.calibrate(sc, tr_, li_), r.budget_factor))
    if factors[0] != factors[1] or factors[0][0] is None:
        raise AssertionError(f"calibrate: CPU {factors[0]}, card "
                             f"{factors[1]}")
    card_vs_cpu(f"4,140-tri sphere at the calibrated budget "
                f"{factors[0][0]:.6f}",
                phong_mesh_scene(prim.construct_sphere_grid(46, 45)), 128,
                128, 2174, budget_factor=factors[0][0])
    card_vs_cpu("config 1, backend='reference'", sg1, 512, 512, 1000,
                backend="reference")

    # The G-buffers of the G-buffer route scenes, card against CPU.
    for name in GBUFFER_NAMES:
        sg, (h, w) = route_scene(name, "gbuffer")
        outs = []
        for d in ("cpu", dev):
            sc, tr_, li_ = torch_scene(sg, h, w, d)
            obj_, cfg_ = sc[0]
            assert not _obj_fusable(obj_, cfg_), name
            table = setup.setup_for_raster(obj_, tr_, li_, cfg_,
                                           frame_height=h, frame_width=w)
            outs.append(gbuffer.rasterize_gbuffer(table, h, w)[:2])
        assert_equal(f"route {name} G-buffer, card against CPU", outs[1],
                     outs[0])
        log(f"# route {name} (gbuffer) {w}x{h}: G-buffer card == CPU "
            f"plain, bit-equal, {int(outs[0][0].sum())} px covered")

    # Forced routes, card against CPU, through the launch the ops entry
    # points run (prepare_scene with strategy and tile_h): the sorted
    # strategy on 8-row tiles for scenes of at most 512 triangles (K2's
    # route with row packing, K3's on two objects), the mask strategy for
    # one above 512.
    def launch_vs_cpu(label, sg, h, w, want, **knobs):
        outs = []
        for d in ("cpu", dev):
            sc, tr_, li_ = torch_scene(sg, h, w, d)
            launch = prepare_scene(sc, tr_, li_, h, w, **knobs)
            r = launch.route
            if (r.strategy, r.tile_h, r.rows) != want:
                raise AssertionError(f"{label} took route {r}")
            outs.append(raster.run_shaded(launch, h, w)[1:3])
        assert_equal(f"{label}, card against CPU", outs[1], outs[0])
        cov = int((outs[0][0] > -3.0e38).sum())
        if cov < 500:
            raise AssertionError(f"{label}: {cov} px covered")
        log(f"# {label} {w}x{h} ({want}): card == CPU plain, bit-equal, "
            f"{cov} px covered")

    launch_vs_cpu("360-tri sphere, strategy='sorted', tile_h=8",
                  phong_mesh_scene(construct_sphere(10)), 64, 64,
                  ("sorted", 8, 2), strategy="sorted", tile_h=8)
    launch_vs_cpu("route k6multi (108 tris), strategy='sorted', tile_h=8",
                  route_scene("k6multi")[0], 128, 128, ("sorted", 8, 1),
                  strategy="sorted", tile_h=8)
    launch_vs_cpu("route k4 (528 tris), strategy='mask'",
                  route_scene("k4")[0], 384, 384, ("mask", 16, 1),
                  strategy="mask")

    # render_scene into a sub-rect off the tile grid, called in JAX's order
    # (..., backend, frame_height, frame_width, row0, col0), on the fused,
    # G-buffer and reference branches: card against CPU, and against the
    # crop of the card's whole frame.
    r0, c0 = 37, 21
    for name, variant, backend, (hs, ws) in (
            ("k4multi", "sidelist", "kernels", (300, 300)),
            ("k6", "gbuffer", "kernels", (60, 100)),
            ("k6", "textured", "reference", (60, 100))):
        sg, (h, w) = route_scene(name, variant)
        fbs = []
        for d in ("cpu", dev):
            sc, tr_, li_ = torch_scene(sg, h, w, d)
            fbs.append(trt.render_scene(
                trt.make_framebuffer(hs, ws, device=d), sc, tr_, li_,
                backend, h, w, r0, c0))
        full = trt.render_scene(None, sc, tr_, li_, backend, h, w)
        label = (f"route {name} ({variant}, {backend}) sub-rect {ws}x{hs} "
                 f"at ({r0}, {c0})")
        assert_equal(f"{label}, card against CPU",
                     (fbs[1].depth, fbs[1].color),
                     (fbs[0].depth, fbs[0].color))
        assert_equal(f"{label}, against the crop of the whole frame",
                     (fbs[1].depth, fbs[1].color),
                     (full.depth[r0:r0 + hs, c0:c0 + ws],
                      full.color[r0:r0 + hs, c0:c0 + ws]))
        cov = int((fbs[0].depth > -3.0e38).sum())
        if cov < 500:
            raise AssertionError(f"{label}: {cov} px covered")
        log(f"# {label}: card == CPU plain == the whole frame's crop, "
            f"bit-equal, {cov} px covered")

    # 5. Paths.
    def drive(path, scene, tr, li, h, w, n_frames, kernels, render=None,
              **knobs):
        """Render n_frames of the scene, rotated a little each frame,
        through Renderer(**knobs) on the card (or ``render(scene)`` ->
        (framebuffer, stats)), the launch counts set to 0 just before and
        read just after: each of ``kernels`` launched once a frame, the
        rotation (``rotated``) once a frame, K13's grouped form on a scene
        of several objects and K13 on one, the others never. Returns (ms per frame, the last framebuffer,
        launches)."""
        if render is None:
            renderer = trt.Renderer(h, w, device=dev, **knobs)

            def render(sc):
                return renderer.render(sc, tr, li, with_stats=True)
        angles = [0.6 * i / max(n_frames - 1, 1) for i in range(n_frames)]
        events, frame_stats = [], []
        for wrapper in wrappers.values():
            wrapper.launches = 0
        for a in angles:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fb, st = render(rotated(scene, a, dev))
            e1.record()
            events.append((e0, e1))
            frame_stats.append((st["bins_dropped"],
                                (fb.depth > -3.0e38).sum(),
                                st.get("bins_real_entries", -1)))
        torch.cuda.synchronize()
        launches = {n: wr.launches for n, wr in wrappers.items()}
        want = {n: n_frames if n in kernels else 0 for n in wrappers}
        many = len(scene) > 1
        want["K13 rotate"] = 0 if many else n_frames
        want["K13 grouped"] = n_frames if many else 0
        want["K14 binning"] = n_frames if set(kernels) & SORTED else 0
        if launches != want:
            raise AssertionError(f"{path}: launches {launches} in "
                                 f"{n_frames} frames, want {want}")
        drops = [int(d) for d, _, _ in frame_stats]
        covered = [int(c) for _, c, _ in frame_stats]
        if any(drops) or min(covered) <= 0:
            raise AssertionError(f"{path}: drops {drops}, covered {covered}")
        ms = [e0.elapsed_time(e1) for e0, e1 in events[WARMUP:]]
        entries = int(frame_stats[-1][2])
        log(f"# path {path}: {sum(o.num_triangles for o, _ in scene)} "
            f"tris in {len(scene)} object(s), {w}x{h}, {n_frames} frames "
            f"({WARMUP} warm-up), drops 0, covered {covered[-1]} px, real "
            f"entries {entries if entries >= 0 else 'none (mask)'}, "
            f"launches {launches}")
        log(f"# path {path} ms/frame (CUDA events, median of "
            f"{len(ms)}): {statistics.median(ms):.4f} (min {min(ms):.4f}, "
            f"max {max(ms):.4f})")
        return statistics.median(ms), fb, launches

    def first_frame_vs_cpu(path, sg, h, w):
        """Frame 0 of a path (no rotation) on the card against the CPU
        plain run at full size."""
        card_vs_cpu(f"path {path} frame 0", sg, h, w, 1000)

    n_frames = WARMUP + FRAMES
    path_ms, path_launches = {}, {}
    mesh = prim.construct_sphere_grid(708, 707)
    head_scene, head_tr, head_li = torch_scene(phong_mesh_scene(mesh), H, W,
                                               dev)
    obj, cfg = head_scene[0]
    T = obj.num_triangles
    assert T == 1_001_112, T
    check_k1_ragged("the headline sphere", mesh, lambda n: (n,), H, W)
    path_ms["headline"], fb, path_launches["headline"] = drive(
        "headline", head_scene, head_tr, head_li, H, W, n_frames,
        ("K1 setup", "K2 raster+shade"))
    # The last frame, held to the sphere: its silhouette (radius
    # m2p * R / sqrt(d^2 - R^2) px), camera-space z within [-R, R], opaque
    # alpha on every covered pixel.
    z = fb.depth
    cov_mask = z > -3.0e38
    r_px = 1.2 * H * 0.5 / math.sqrt(3.0 ** 2 - 0.5 ** 2)
    zc = z[cov_mask]
    alpha = (fb.color.view(torch.int32)[cov_mask] >> 24) & 0xFF
    checks = {
        "coverage/disc": int(cov_mask.sum()) / (math.pi * r_px ** 2),
        "z_min": float(zc.min()), "z_max": float(zc.max()),
        "alpha_255_frac": float((alpha == 255).double().mean()),
    }
    if not (0.95 < checks["coverage/disc"] < 1.05
            and -0.5 - 1e-3 <= checks["z_min"] <= checks["z_max"]
            <= 0.5 + 1e-3 and checks["alpha_255_frac"] == 1.0
            and bool(torch.isfinite(zc).all())):
        raise AssertionError(f"headline frame fails its checks: {checks}")
    log(f"# headline frame checks: {json.dumps(checks)}")

    # The CPU runs first, so that no timed frame shares the host with
    # them.
    sg2 = scenes.baseline_scene(2, 512, 512)[0]
    scene2, tr2, li2 = torch_scene(sg2, 512, 512, dev)
    for path, sg_, h, w in (("config 2", sg2, 512, 512),
                            ("config 4", sg4, H, W),
                            ("config 5 untextured", sg5, H, W),
                            ("config 1", sg1, 512, 512),
                            ("config 3", sg3, 512, 512),
                            ("config 5", sg5full, H, W),
                            ("config 3 avx", sg3avx, 512, 512)):
        first_frame_vs_cpu(path, sg_, h, w)
    path_ms["config 2"], _, path_launches["config 2"] = drive(
        "config 2", scene2, tr2, li2, 512, 512, n_frames,
        ("K1 setup", "K3 raster+shade rows 1"))
    path_ms["config 4"], _, path_launches["config 4"] = drive(
        "config 4", scene4, tr4, li4, H, W, n_frames,
        ("K7 record transpose", "K4 raster+shade band"))
    path_ms["config 5 untextured"], _, path_launches[
        "config 5 untextured"] = drive(
        "config 5 untextured", scene5, tr5, li5, H, W, n_frames,
        ("K7 record transpose", "K4 raster+shade band"))

    # The textured 250k point: K1 and K2 held to their plain versions at
    # full shape, then driven.
    mesh250 = prim.construct_sphere_grid(354, 354)
    sg250 = [(dict(p=(0.0, 0.0, 0.0), **mesh250),
              {"texture": tex128, "filter_mode": "bilinear"})]
    scene250, tr250, li250 = torch_scene(sg250, H, W, dev)
    T250 = scene250[0][0].num_triangles
    assert T250 == 250_632, T250
    check_k1(f"textured {T250} tris", *scene250[0], tr250, li250, H, W)
    log(f"# K1 setup textured == plain at {T250} tris {W}x{H}: bit-equal")
    launch250 = prepare_scene(scene250, tr250, li250, H, W)
    check_launch("K2 raster+shade", f"textured {T250} tris {W}x{H}",
                 launch250, (8, 2), 1, 1)
    path_ms["textured 250k"], fb250, path_launches["textured 250k"] = drive(
        "textured 250k", scene250, tr250, li250, H, W, n_frames,
        ("K1 setup", "K2 raster+shade"))
    c250 = fb250.color.view(torch.int32)[fb250.depth > -3.0e38]
    n_colors = int(torch.unique(c250).numel())
    if n_colors < 100 or not bool(((c250 >> 24) & 0xFF).eq(255).all()):
        raise AssertionError(f"textured 250k frame: {n_colors} colours")
    log(f"# textured 250k frame checks: {n_colors} distinct colours, "
        "opaque")
    for path, sc_, tr_, li_, h, w, kern in (
            ("config 1", scene1, tr1, li1, 512, 512, "K6 raster+shade mask"),
            ("config 3", scene3, tr3, li3, 512, 512, "K6 raster+shade mask"),
            ("config 5", scene5f, tr5f, li5f, H, W,
             "K4 raster+shade band")):
        path_ms[path], _, path_launches[path] = drive(
            path, sc_, tr_, li_, h, w, n_frames,
            ("K7 record transpose", kern))

    # The G-buffer paths: config 3 avx (K7, K8) and deferred 1M (K1, K9
    # with K10), K9 first held bit-equal to its plain version at that
    # shape.
    path_ms["config 3 avx"], _, path_launches["config 3 avx"] = drive(
        "config 3 avx", scene3avx, tr3, li3, 512, 512, n_frames,
        ("K7 record transpose", "K8 G-buffer mask", "K12 deferred shade"))
    tex1024 = checkerboard(1024, 1024, 64)
    sg_def = [(dict(p=(0.0, 0.0, 0.0), **backdrop_mesh(708, 707)),
               {"phong": True, "texture": tex1024,
                "filter_mode": "bilinear"})]
    scene_def, tr_def, li_def = torch_scene(sg_def, H, W, dev)
    obj_def, cfg_def = scene_def[0]
    T_def = obj_def.num_triangles
    assert T_def == 1_001_114, T_def
    assert not _obj_fusable(obj_def, cfg_def)
    launch_def = gbuffer_launch(obj_def, cfg_def, tr_def, li_def, H, W)
    n_large = check_gbuffer("K9 G-buffer sorted",
                            f"deferred 1M {T_def} tris {W}x{H}", launch_def,
                            ("sorted", 8))
    if n_large != 2:
        raise AssertionError(f"deferred 1M: n_large {n_large}, not 2")
    # K12 on deferred 1M's G-buffer at both of the benchmark's sizes,
    # before any frame of the path runs it.
    k12_shapes = {(W, H): (obj_def, cfg_def, tr_def, li_def)}
    scene_uhd, tr_uhd, li_uhd = torch_scene(sg_def, 2 * H, 2 * W, dev)
    k12_shapes[(2 * W, 2 * H)] = (*scene_uhd[0], tr_uhd, li_uhd)
    k12_inputs = {}
    for (w_, h_), (o_, c_, t_, l_) in k12_shapes.items():
        gid_, gbuf_ = gbuffer_launch(o_, c_, t_, l_, h_, w_).run()
        k12_inputs[(w_, h_)] = args_ = (
            gid_[:h_, :w_] >= 0, gbuf_[:, :h_, :w_], t_, l_, c_, o_.texture)
        cleared = trt.make_framebuffer(h_, w_, 0xFF204060, device=dev)
        for label, fb_ in (("a fresh frame", None), ("a cleared one",
                                                     cleared)):
            max_err["K12 deferred shade"] = max(
                max_err["K12 deferred shade"], assert_equal(
                    f"K12 deferred shade at deferred 1M {w_}x{h_} over "
                    f"{label}", shade_merge(*args_, 0, 0, fb_),
                    shade_merge_plain(*args_, 0, 0, fb_)))
        log(f"# K12 deferred shade == plain chain at deferred 1M {w_}x{h_}"
            f", over a fresh frame and a cleared one: bit-equal")
    path_ms["deferred 1M"], fb_def, path_launches["deferred 1M"] = drive(
        "deferred 1M", scene_def, tr_def, li_def, H, W, n_frames,
        ("K1 setup", "K9 G-buffer sorted", "K12 deferred shade"))
    # The last frame (0.6 rad): the sphere within [-0.5, 0.5], the quad's
    # plane 0.6 behind the centre, its corners at -0.6 cos 0.6 +- 1.1 sin
    # 0.6, so z within [-1.2, 0.5]; opaque texels, Phong-lit.
    cov_def = fb_def.depth > -3.0e38
    z_def = fb_def.depth[cov_def]
    c_def = fb_def.color.view(torch.int32)[cov_def]
    checks_def = {
        "covered": int(cov_def.sum()), "z_min": float(z_def.min()),
        "z_max": float(z_def.max()),
        "distinct_colours": int(torch.unique(c_def).numel()),
        "alpha_255_frac": float(((c_def >> 24) & 0xFF).eq(255).double()
                                .mean()),
        "n_large_last_frame": int(gbuffer_launch(
            *rotated(scene_def, 0.6, dev)[0], tr_def, li_def, H,
            W).qbins.n_large),
    }
    if not (-1.2 - 1e-3 <= checks_def["z_min"] <= checks_def["z_max"]
            <= 0.5 + 1e-3 and checks_def["distinct_colours"] >= 100
            and checks_def["alpha_255_frac"] == 1.0
            and checks_def["n_large_last_frame"] == 2
            and bool(torch.isfinite(z_def).all())):
        raise AssertionError(f"deferred 1M frame fails its checks: "
                             f"{checks_def}")
    log(f"# deferred 1M frame checks: {json.dumps(checks_def)}")

    # The stack paths: bench.py's 2M-triangle stack, innermost layer
    # first, with zcull (K11) and without (K2). Frame 0 with and without
    # zcull bit-equal, and K11's skipped batches on it (the probe).
    scene6, tr6, li6 = scenes.stack_scene(409, 409, 6, H, W, device=dev,
                                          inner_first=True)
    T6 = sum(o.num_triangles for o, _ in scene6)
    assert T6 == 2_007_372, T6
    fb6 = [trt.Renderer(H, W, device=dev, zcull=z).render(scene6, tr6, li6)
           for z in (True, False)]
    assert_equal("stack6 frame 0, zcull against none",
                 (fb6[0].depth, fb6[0].color), (fb6[1].depth, fb6[1].color))
    launch6 = prepare_scene(scene6, tr6, li6, H, W, zcull=True)
    if launch6.kernel is not raster.raster_zcull_kernel:
        raise AssertionError(f"stack6 took {launch6.kernel.__name__}")
    skipped6 = torch.zeros(1, dtype=torch.int32, device=dev)
    launch6.kernel(*launch6.operands, skipped=skipped6, **launch6.options)
    batches6 = stream_batches(launch6, raster.RASTER_PART_ENTRIES)
    if int(skipped6) <= 0:
        raise AssertionError("K11 skipped nothing on stack6")
    log(f"# stack6 frame 0: zcull == none, bit-equal; K11 skipped "
        f"{int(skipped6)} of {batches6} batches; "
        f"{int((fb6[0].depth > -3.0e38).sum())} px covered")
    path_ms["stack6 zcull"], _, path_launches["stack6 zcull"] = drive(
        "stack6 zcull", scene6, tr6, li6, H, W, n_frames,
        ("K1 grouped", "K11 zcull"), zcull=True)
    path_ms["stack6"], _, path_launches["stack6"] = drive(
        "stack6", scene6, tr6, li6, H, W, n_frames,
        ("K1 grouped", "K2 raster+shade"))

    # The forced-height paths, through the ops entry points with the route
    # knobs (neither package's Renderer takes a tile height): the setup,
    # then rasterize_shaded (fused) or rasterize_gbuffer + shade + the
    # merge into a fresh frame (deferred). The 32-row paths, and the band
    # form's at 24 and 64 rows (K4 on the 40k sphere and on the headline's
    # 1M one, K9 + K10 on deferred 40k). Frame 0 of each on the card
    # against the CPU plain run first (but the headline's, whose kernel is
    # held to its plain version on the card in 6b), the band paths' also
    # against the same scene at 16 rows on the card, with their drops;
    # then 23 frames each.
    def fused_ops_frame(h, w, strategy, tile_h):
        def frame(sc, tr_, li_):
            (o, c), = sc
            table = setup.setup_for_raster(o, tr_, li_, c, frame_height=h,
                                           frame_width=w)
            _, z, color, st = raster.rasterize_shaded(
                table, tr_, li_, c.phong, h, w, None, h, w, 0, 0, strategy,
                tile_h, o.texture if c.textured else None, c.filter_mode)
            return Framebuffer(color=color, depth=z), st
        return frame

    def deferred_ops_frame(h, w, strategy, tile_h):
        def frame(sc, tr_, li_):
            (o, c), = sc
            table = setup.setup_for_raster(o, tr_, li_, c, frame_height=h,
                                           frame_width=w)
            cov, gbuf, st = gbuffer.rasterize_gbuffer(
                table, h, w, None, h, w, 0, 0, strategy, tile_h)
            return shade_merge(cov, gbuf, tr_, li_, c, o.texture), st
        return frame

    mesh40k = prim.construct_sphere_grid(140, 143)
    sg40 = phong_mesh_scene(mesh40k)
    sg40d = [(dict(p=(0.0, 0.0, 0.0), **backdrop_mesh(140, 143)),
              sg_def[0][1])]
    forced_paths = (
        ("config 4 @32", sg4, H, W, fused_ops_frame(H, W, "sorted", 32),
         ("K7 record transpose", "K4 raster+shade band")),
        ("40k @32", sg40, H, W, fused_ops_frame(H, W, "sorted", 32),
         ("K1 setup", "K4 raster+shade band")),
        ("config 3 @32", sg3, 512, 512, fused_ops_frame(512, 512, "mask", 32),
         ("K7 record transpose", "K6 raster+shade mask")),
        ("config 3 avx @32", sg3avx, 512, 512,
         deferred_ops_frame(512, 512, "auto", 32),
         ("K7 record transpose", "K8 G-buffer mask", "K12 deferred shade")),
        ("deferred 40k @32", sg40d, H, W,
         deferred_ops_frame(H, W, "sorted", 32),
         ("K1 setup", "K9 G-buffer sorted", "K12 deferred shade")),
        *((f"40k @{t}", sg40, H, W, fused_ops_frame(H, W, "sorted", t),
           ("K1 setup", "K4 raster+shade band")) for t in (24, 64)),
        *((f"deferred 40k @{t}", sg40d, H, W,
           deferred_ops_frame(H, W, "sorted", t),
           ("K1 setup", "K9 G-buffer sorted", "K12 deferred shade"))
          for t in (24, 64)),
        ("headline @64", phong_mesh_scene(mesh), H, W,
         fused_ops_frame(H, W, "sorted", 64),
         ("K1 setup", "K4 raster+shade band")))
    band_drops = {}
    for path, sg_, h, w, frame, _ in forced_paths:
        if path.endswith("@32"):
            continue
        sc, tr_, li_ = torch_scene(sg_, h, w, dev)
        fb, st = frame(sc, tr_, li_)
        make16 = (deferred_ops_frame if path.startswith("deferred")
                  else fused_ops_frame)
        fb16, st16 = make16(h, w, "sorted", 16)(sc, tr_, li_)
        assert_equal(f"path {path} frame 0 against 16-row tiles",
                     (fb.depth, fb.color), (fb16.depth, fb16.color))
        band_drops[path] = dict(
            drops=int(st["bins_dropped"]), drops_16=int(st16["bins_dropped"]),
            real_entries=int(st["bins_real_entries"]),
            real_entries_16=int(st16["bins_real_entries"]))
        if band_drops[path]["drops"] or band_drops[path]["drops_16"]:
            raise AssertionError(f"path {path}: {band_drops[path]}")
        log(f"# path {path} frame 0 {w}x{h}: == the same scene at 16 rows on "
            f"the card, bit-equal; {json.dumps(band_drops[path])}")
    for path, sg_, h, w, frame, _ in forced_paths:
        if path.startswith("headline"):
            continue
        outs = []
        for d in ("cpu", dev):
            sc, tr_, li_ = torch_scene(sg_, h, w, d)
            fb, _ = frame(sc, tr_, li_)
            outs.append((fb.depth, fb.color))
        assert_equal(f"path {path} frame 0, card against CPU", outs[1],
                     outs[0])
        cov = int((outs[0][0] > -3.0e38).sum())
        if cov < 1000:
            raise AssertionError(f"path {path} frame 0: {cov} px covered")
        log(f"# path {path} frame 0 {w}x{h}: card == CPU plain, bit-equal, "
            f"{cov} px covered")
    for path, sg_, h, w, frame, kernels in forced_paths:
        sc, tr_, li_ = torch_scene(sg_, h, w, dev)
        path_ms[path], _, path_launches[path] = drive(
            path, sc, tr_, li_, h, w, n_frames, kernels,
            render=lambda s_, f=frame, t=tr_, l=li_: f(s_, t, l))

    # 6a. The headline's frame time and host time a layer through the
    # profiling module: FrameTimer around 13 Renderer frames, each tick
    # waiting for its frame (the summary of the last 10), and the spans'
    # self time over those 10 frames (each layer's span less its
    # children's, host clock).
    from tpu_renderer_torch.utils import profiling

    timer = profiling.FrameTimer()
    head_renderer = trt.Renderer(H, W, device=dev)

    def tick(angle):
        out = []  # the frame tick waits for
        with timer.tick(out):
            out.append(head_renderer.render(rotated(head_scene, angle, dev),
                                            head_tr, head_li))

    angles = [0.05 * i for i in range(WARMUP + 10)]
    for a in angles[:WARMUP]:
        tick(a)
    with profiling.spans() as records:
        for a in angles[WARMUP:]:
            tick(a)
    span_ms = {k: round(v / 10, 4)
               for k, v in profiling.self_ms(records).items()}
    log(f"# headline host ms a frame by span (self time, 10 frames): "
        f"{json.dumps(span_ms)}")
    frame_timer = profiling.FrameTimer(samples=timer.samples[WARMUP:]
                                       ).summary()
    log(f"# headline FrameTimer (host clock, {WARMUP} warm-up frames "
        f"left out): {json.dumps(frame_timer)}")

    # 6b. Each kernel at its path's shapes: held bit-equal to its plain
    # version on the same inputs, then timed beside it in turns (plain,
    # kernel, kernel, plain), with its bound.
    timing = {}

    dev_info = {}  # kernel -> the profiler's device and host ms a call

    def device_time(name, label, launch):
        """The device time (the sum of the call's device operations) and the
        host time of ``launch.run``, from a profiler trace of 50 calls: for
        the kernels whose event time is near the launch floor."""
        host_ms, dev_ms, ops = profile_calls(launch.run, 50)
        dev_info.setdefault(name, dict(device_ms=round(dev_ms, 4),
                                       host_ms=round(host_ms, 4)))
        log(f"# {name} at {label}, profiler: device {dev_ms:.4f} ms, host "
            f"{host_ms:.4f} ms a call, {len(ops)} device kernel(s)")

    def mask_floor(name, label, launch):
        """The card's own write of a mask launch's outputs (z, gid and
        colour, or gid and the 11 planes): their zeroing, by CUDA events
        (median of two runs of 20) and by its device time from a profiler
        trace of 50 calls; the kernel's floor."""
        outs = launch.run()

        def fill():
            for t in outs:
                t.zero_()
        ev_ms = statistics.median([event_ms(fill, 20) for _ in range(2)])
        _, fill_dev, _ = profile_calls(fill, 50)
        dev_info.setdefault(name, {}).update(
            zero_outputs_ms=round(ev_ms, 4),
            zero_outputs_device_ms=round(fill_dev, 4),
            zero_outputs_bytes=sum(t.numel() * t.element_size()
                                   for t in outs))
        log(f"# {name} at {label}: zeroing its outputs {ev_ms:.4f} ms "
            f"(events), device {fill_dev:.4f} ms")

    def time_launch(name, label, launch, device=False):
        key = name.split(" (")[0]
        max_err[key] = max(max_err[key], assert_equal(
            f"{key} at {label}", launch.run(), launch.run_plain()))
        log(f"# {key} == plain at {label}: bit-equal")
        kms, pms = in_turns(launch.run, launch.run_plain)
        _, gid, _ = launch.run()
        bms, by = bound(*raster_work(launch, gid))
        timing.setdefault(name, (kms, pms, bms, by, None))
        log(f"# {name} at {label}: kernel {kms:.4f} ms, plain {pms:.4f} "
            f"ms, bound {bms:.4f} ms ({by})")
        if device:
            device_time(name, label, launch)
        return kms, pms, gid

    k1_paths = {}  # path -> K1's time there; the first of a form is its row

    def time_k1(path, obj_, cfg_, tr_, li_):
        name = "K1 setup textured" if cfg_.textured else "K1 setup"
        fn, plain, work = k1_call(obj_, cfg_, tr_, li_, H, W)
        n = obj_.num_triangles
        max_err[name] = max(max_err[name], assert_equal(
            f"{name} at {n} tris", fn(), plain()))
        log(f"# {name} == plain at {n} tris {W}x{H}: bit-equal")
        kms, pms = in_turns(fn, plain)
        host_ms, dev_ms, _ = profile_calls(fn, 20)
        recs, bbox = fn()

        def fill():  # the card's own write of K1's output bytes
            recs.zero_()
            bbox.zero_()
        fill_ms = statistics.median([event_ms(fill, 20) for _ in range(2)])
        bms, by = bound(*work)
        timing.setdefault(name, (kms, pms, bms, by, None))
        k1_paths[path] = dict(
            kernel=name, phong=bool(cfg_.phong), tris=n, ms=round(kms, 4),
            device_ms=round(dev_ms, 4), host_ms=round(host_ms, 4),
            plain_ms=round(pms, 4), bound_ms=round(bms, 6), bound_by=by,
            zero_outputs_ms=round(fill_ms, 4))
        log(f"# {name} at {path}, {n} tris {W}x{H} (phong {cfg_.phong}): "
            f"kernel {kms:.4f} ms (profiler: device {dev_ms:.4f}, host "
            f"{host_ms:.4f}), plain {pms:.4f} ms, bound {bms:.4f} ms "
            f"({by}); zeroing its outputs {fill_ms:.4f} ms")

    time_k1("headline", obj, cfg, head_tr, head_li)
    time_k1("textured 250k", *scene250[0], tr250, li250)
    time_k1("deferred 1M", obj_def, cfg_def, tr_def, li_def)

    k1_grouped_info, k13_info = {}, {}

    def time_k1_grouped(path, scene_, tr_, li_):
        """K1's grouped form on a whole scene's inputs, as the engine
        launches it: bit-equal to its plain version and to one K1 launch
        an object at the same rows (the setup such a scene took before),
        timed beside both, with the bound of all the objects' bytes."""
        name = "K1 grouped"
        plan = setup.plan_scene_setup(scene_, li_.count)
        params = scene_setup_params(
            torch.stack([o.p for o, _ in scene_]), tr_, li_)
        kw = dict(n_lights=li_.count, frame_height=H, frame_width=W)

        def fn():
            return setup.setup_scene_kernel(params, plan, **kw)

        def plain():
            return setup.setup_scene_plain(params, plan, **kw)
        one = [k1_call(o, c, tr_, li_, H, W, tp=n, gid0=r0)[0]
               for (o, c), r0, n in zip(scene_, plan.row0, plan.rows)]

        def per_object():
            return [f() for f in one]
        max_err[name] = max(max_err[name], assert_equal(
            f"{name} at {path}", fn(), plain()))
        tables = per_object()
        assert_equal(f"{name} at {path} against one K1 an object", fn(),
                     (torch.cat([r for r, _ in tables]),
                      torch.cat([b for _, b in tables], dim=1)))
        del tables
        tris = plan.num_triangles
        log(f"# {name} == plain == one K1 an object at {path}, "
            f"{len(scene_)} objects, {tris} tris {W}x{H}: bit-equal")
        kms, pms = in_turns(fn, plain)
        obj_ms = statistics.median([event_ms(per_object, 20)
                                    for _ in range(2)])
        host_ms, dev_ms, _ = profile_calls(fn, 20)
        obj_host, obj_dev, _ = profile_calls(per_object, 20)
        works = [setup_work(o.num_triangles, n, c.phong, li_.count,
                            c.textured) for (o, c), n in zip(scene_,
                                                             plan.rows)]
        bms, by = bound(sum(w[0] for w in works), sum(w[1] for w in works))
        timing.setdefault(name, (kms, pms, bms, by, None))
        k1_grouped_info[path] = dict(
            objects=len(scene_), kinds=len(plan.kinds), tris=tris,
            rows=plan.total, ms=round(kms, 4), device_ms=round(dev_ms, 4),
            host_ms=round(host_ms, 4), plain_ms=round(pms, 4),
            bound_ms=round(bms, 6), bound_by=by,
            one_k1_an_object_ms=round(obj_ms, 4),
            one_k1_an_object_device_ms=round(obj_dev, 4),
            one_k1_an_object_host_ms=round(obj_host, 4))
        log(f"# {name} at {path}: kernel {kms:.4f} ms (profiler: device "
            f"{dev_ms:.4f}, host {host_ms:.4f}), plain {pms:.4f} ms, bound "
            f"{bms:.4f} ms ({by}); one K1 an object {obj_ms:.4f} ms "
            f"(device {obj_dev:.4f}, host {obj_host:.4f})")

    def time_k13(path, obj_):
        """K13 on one object's planes: bit-equal to ``rotate_plain``,
        timed beside it, with its byte bound (9 T floats of vertices and
        of normals read and written once)."""
        name = "K13 rotate"
        rot = rotation_y(0.3, device=dev)

        def fn():
            return rotate_kernel(rot, obj_.vertices, obj_.normals)

        def plain():
            return rotate_plain(rot, obj_.vertices, obj_.normals)
        max_err[name] = max(max_err[name], assert_equal(
            f"{name} at {path}", fn(), plain()))
        n = obj_.num_triangles
        log(f"# {name} == plain at {path}, {n} tris: bit-equal")
        kms, pms = in_turns(fn, plain)
        host_ms, dev_ms, _ = profile_calls(fn, 20)
        _, plain_dev, _ = profile_calls(plain, 20)
        bms, by = bound(2 * 2 * 9 * n * 4, 2 * 9 * n * 5)
        timing.setdefault(name, (kms, pms, bms, by, None))
        k13_info[path] = dict(
            tris=n, ms=round(kms, 4), device_ms=round(dev_ms, 4),
            host_ms=round(host_ms, 4), plain_ms=round(pms, 4),
            plain_device_ms=round(plain_dev, 4), bound_ms=round(bms, 6),
            bound_by=by)
        log(f"# {name} at {path}, {n} tris: kernel {kms:.4f} ms (profiler: "
            f"device {dev_ms:.4f}, host {host_ms:.4f}), plain {pms:.4f} ms "
            f"(device {plain_dev:.4f}), bound {bms:.4f} ms ({by})")

    def time_k13_grouped(path, config, h, w):
        """K13's grouped form on a benchmark configuration's objects (one
        matrix, as the benchmark's frames turn them), bit-equal to
        ``rotate_plain`` and to one K13 launch an object, timed beside
        those launches in turns; then a frame's whole rotation through the
        program, every ``rotate_object`` call and the draw's
        ``resolve_scene``, beside the eager calls it replaced (one K13 and
        a ``_replace`` an object)."""
        from portbench import harness as pb_harness
        from portbench import scene as pb_scene

        name = "K13 rotate"
        with open(os.path.join(ROOT, "portbench", "configs",
                               config + ".json")) as f:
            cfg_ = json.load(f)
        sg_, tr_d, li_d = pb_scene.build(cfg_, h, w,
                                         np.random.default_rng(0))
        sc_, _, _ = pb_harness.device_scene(sg_, tr_d, li_d, dev)
        rot = rotation_y(0.3, device=dev)
        items = [(rot, o.vertices, o.normals) for o, _ in sc_]

        def fn():
            return rotate_kernel_grouped(items)

        def per_object():
            return [rotate_kernel(*it) for it in items]

        def flat(outs):
            return [t for pair in outs for t in pair]
        want = flat(rotate_plain(*it) for it in items)
        max_err[name] = max(max_err[name], assert_equal(
            f"K13 grouped at {path}", flat(fn()), want))
        assert_equal(f"K13 an object at {path}", flat(per_object()), want)
        del want
        tris = sum(o.num_triangles for o, _ in sc_)
        log(f"# K13 grouped == plain == one K13 an object at {path}, "
            f"{len(sc_)} objects, {tris} tris: bit-equal")
        o1 = event_ms(per_object, 20)
        g1, g2 = event_ms(fn, 20), event_ms(fn, 20)
        o2 = event_ms(per_object, 20)
        kms, obj_ms = statistics.median([g1, g2]), statistics.median([o1, o2])
        host_ms, dev_ms, _ = profile_calls(fn, 20)
        obj_host, obj_dev, _ = profile_calls(per_object, 20)

        def deferred():
            return resolve_scene([(rotate_object(o, rot), c) for o, c in sc_])

        def eager():
            return [(o._replace(vertices=v, normals=n_), c) for (o, c), (
                v, n_) in zip(sc_, per_object())]
        before = (rotate_kernel_grouped.launches, rotate_kernel.launches)
        deferred()
        if (rotate_kernel_grouped.launches - before[0],
                rotate_kernel.launches - before[1]) != (1, 0):
            raise AssertionError(f"K13 grouped at {path}: a frame's "
                                 f"rotation launched more than once")
        d_host, d_dev, _ = profile_calls(deferred, 20)
        e_host, e_dev, _ = profile_calls(eager, 20)
        bms, by = bound(2 * 2 * 9 * tris * 4, 2 * 9 * tris * 5)
        k13_info[path] = dict(
            objects=len(sc_), tris=tris, grouped_ms=round(kms, 4),
            grouped_device_ms=round(dev_ms, 4),
            grouped_host_ms=round(host_ms, 4),
            one_k13_an_object_ms=round(obj_ms, 4),
            one_k13_an_object_device_ms=round(obj_dev, 4),
            one_k13_an_object_host_ms=round(obj_host, 4),
            frame_rotation_host_ms=round(d_host, 4),
            frame_rotation_device_ms=round(d_dev, 4),
            eager_frame_rotation_host_ms=round(e_host, 4),
            eager_frame_rotation_device_ms=round(e_dev, 4),
            bound_ms=round(bms, 6), bound_by=by)
        log(f"# K13 grouped at {path}, {len(sc_)} objects, {tris} tris: "
            f"kernel {kms:.4f} ms (profiler: device {dev_ms:.4f}, host "
            f"{host_ms:.4f}); one K13 an object {obj_ms:.4f} ms (device "
            f"{obj_dev:.4f}, host {obj_host:.4f}); a frame's rotation, "
            f"deferred: host {d_host:.4f}, device {d_dev:.4f}; eager: host "
            f"{e_host:.4f}, device {e_dev:.4f}; bound {bms:.4f} ms ({by})")

    def k14_cell(config, h, w):
        """K1's bbox planes of a benchmark configuration's scene at a frame
        size (its objects unturned, portbench's own constructors) and the
        route the engine bins it on: the fused one, or the G-buffer one
        where an object is over the fused limits."""
        from portbench import harness as pb_harness
        from portbench import scene as pb_scene
        from tpu_renderer_torch.engine.renderer import _scene_table

        with open(os.path.join(ROOT, "portbench", "configs",
                               config + ".json")) as f:
            cfg_ = json.load(f)
        sg_, tr_d, li_d = pb_scene.build(cfg_, h, w,
                                         np.random.default_rng(0))
        sc_, tr_, li_ = pb_harness.device_scene(sg_, tr_d, li_d, dev)
        if len(sc_) == 1:
            (o, c), = sc_
            table = setup.setup_for_raster(o, tr_, li_, c, frame_height=h,
                                           frame_width=w)
            fused = _obj_fusable(o, c)
        else:
            table, _, _ = _scene_table(sc_, tr_, li_, h, w)
            fused = True
        t_ = table.num_triangles
        route = (raster.raster_route(t_, h, w, len(sc_)) if fused
                 else gbuffer.gbuffer_route(t_, h, w))
        return table.bbox, route

    def call_ops(fn, n=5, attempts=3):
        """The device ops of one call of ``fn``, in the order they ran: the
        first call's of a trace of ``n`` (one stream, so the calls' ops do
        not interleave). The profiler now and then loses a short trace's
        device ops; a trace whose ops are not n calls' worth is taken
        again, up to ``attempts`` traces, and refused if none is."""
        from torch.autograd import DeviceType

        for _ in range(attempts):
            ops = sorted((e for e in trace_calls(fn, n)
                          if e.device_type == DeviceType.CUDA
                          and e.name != "call"),
                         key=lambda e: e.time_range.start)
            if ops and len(ops) % n == 0:
                return [e.name for e in ops[:len(ops) // n]]
        raise AssertionError(f"profile of {n} calls: {len(ops)} device ops "
                             f"in each of {attempts} traces")

    def time_k14(cell, config, h, w):
        """K14 on a benchmark cell's bbox planes and route: integer-exact
        against ``bin_for_raster_plain``, timed beside it, its device ops
        (none named like a kernel the benchmark's order split looks for,
        the last no memset), and its byte bound: the five bbox planes read
        (17 B a triangle), the keys written, each radix pass of the sort
        reading and writing every key and its 8-byte index (8-bit digits:
        as many passes as key bytes), the outputs written."""
        name = "K14 binning"
        bbox, route = k14_cell(config, h, w)

        def fn():
            return raster.bin_for_raster(bbox, route, h, w)

        def plain():
            return raster.bin_for_raster_plain(bbox, route, h, w)

        def flat(out):
            return tuple(out[0]) + (out[1],)
        max_err[name] = max(max_err[name], assert_equal(
            f"{name} at {cell}", flat(fn()), flat(plain())))
        kms, pms = in_turns(fn, plain)
        host_ms, dev_ms, _ = profile_calls(fn, 20)
        _, plain_dev, _ = profile_calls(plain, 5)
        ops = call_ops(fn)
        if "Memset" in ops[-1] or any(k in op for op in ops
                                      for k in SPLIT_NAMES):
            raise AssertionError(f"{name} at {cell}: device ops {ops}")
        n = int(bbox[0].numel())
        lay = binning.queue_layout(n, h, w, route.tile_h, raster.TILE_W,
                                   route.blk, route.expansion,
                                   route.budget_factor, route.rows)
        kb = 2 if lay.key_dtype is torch.int16 else 4
        nbytes = (17 * n + kb * lay.n_keys + kb * 2 * (kb + 8) * lay.n_keys
                  + 4 * lay.streams * (lay.eb + 2 * (lay.ntiles + 1))
                  + 4 * (lay.ntiles + raster.LARGE_CAPACITY))
        bms, by = bound(nbytes, 0)
        timing.setdefault(name, (kms, pms, bms, by, None))
        q = fn()[0]
        k14_info[cell] = dict(
            tris=n, frame=[w, h], route=list(route[:4]),
            key_bits=8 * kb, keys=lay.n_keys, eb=lay.eb,
            real_entries=int(q.n_real), n_large=int(q.n_large),
            ms=round(kms, 4), device_ms=round(dev_ms, 4),
            host_ms=round(host_ms, 4), plain_ms=round(pms, 4),
            plain_device_ms=round(plain_dev, 4), bound_ms=round(bms, 6),
            bound_by=by, device_ops=len(ops),
            ops=[op[:48] for op in ops])
        log(f"# {name} at {cell} ({n} tris, route {tuple(route[:4])}, "
            f"{8 * kb}-bit keys): kernel {kms:.4f} ms (profiler: device "
            f"{dev_ms:.4f}, host {host_ms:.4f}; {len(ops)} device ops), "
            f"plain {pms:.4f} ms (device {plain_dev:.4f}), bound "
            f"{bms:.4f} ms ({by}); ops {[op[:40] for op in ops]}")

    time_k1_grouped("stack6", scene6, tr6, li6)
    time_k13("headline", obj)
    time_k13_grouped("cluster", "sphere_cluster", 1080, 1920)
    k14_info = {}
    for cell_, config_, h_, w_ in K14_CELLS:
        time_k14(cell_, config_, h_, w_)
    head_launch = prepare_scene(head_scene, head_tr, head_li, H, W)
    per_tile = head_launch.qbins.counts[:-2].reshape(-1, 2).sum(dim=1)
    log(f"# K2 load: {int((per_tile > 0).sum())} of {per_tile.numel()} "
        f"tiles hold entries, {int(per_tile.sum())} entries, max "
        f"{int(per_tile.max())} in one tile")
    time_launch("K2 raster+shade", f"headline {T} tris {W}x{H}", head_launch)
    time_launch("K3 raster+shade rows 1", "config 2 5,428 tris 512x512",
                prepare_scene(scene2, tr2, li2, 512, 512), device=True)
    time_launch("K4 raster+shade band 16-row", "config 4 2,208 tris "
                "1920x1080", prepare_scene(scene4, tr4, li4, H, W),
                device=True)
    time_launch("K4 raster+shade band 16-row (config 5)",
                "config 5 3,246 tris 1920x1080",
                prepare_scene(scene5f, tr5f, li5f, H, W))
    time_launch("K6 raster+shade mask", "config 3 12 tris 512x512",
                prepare_scene(scene3, tr3, li3, 512, 512), device=True)
    mask_floor("K6 raster+shade mask", "config 3 12 tris 512x512",
               prepare_scene(scene3, tr3, li3, 512, 512))
    time_launch("K6 raster+shade mask (config 1)",
                "config 1 12 tris 512x512",
                prepare_scene(scene1, tr1, li1, 512, 512))

    # K5, which runs inside the shaded finalize: the finalize kernel's
    # device time on the textured 250k mesh beside the same mesh
    # untextured, and K2's whole time on both (events). The library call:
    # grid_sample (bilinear, border, corners aligned: u * (tw - 1), as K5)
    # of the texture's four channels at as many (u, v) points as the frame
    # has textured pixels (spread over the texture; grid_sample is not
    # bit-equal to K5, and its time is not used by the port). The three
    # device times come from torch.profiler traces of 20 calls each, taken
    # in turns over K5_ROUNDS rounds, so the row's ms and library_ms read
    # one clock; K5's own cost is bounded by the textured-minus-untextured
    # difference of each round, reported with its spread.
    k2t_ms, k5_plain, gid250 = time_launch(
        "K2 raster+shade (textured 250k)", f"textured {T250} tris {W}x{H}",
        launch250)
    sg250u = [(sg250[0][0], {})]
    sc_u, tr_u, li_u = torch_scene(sg250u, H, W, dev)
    launch250u = prepare_scene(sc_u, tr_u, li_u, H, W)
    k2u_ms, _, _ = time_launch("K2 raster+shade (untextured 250k)",
                               f"untextured {T250} tris {W}x{H}", launch250u)
    tmask = textured_pixels(launch250, gid250)
    n_texpx = int(tmask.sum())
    grid_uv = torch.rand((1, 1, n_texpx, 2), device=dev,
                         generator=torch.Generator(dev).manual_seed(0))
    grid_uv = grid_uv * 2.0 - 1.0
    tex_f = torch.stack(unpack_argb(launch250.operands[-1]))[None]

    def grid_sample():
        return torch.nn.functional.grid_sample(
            tex_f, grid_uv, mode="bilinear", padding_mode="border",
            align_corners=True)
    lib_event_ms = statistics.median([event_ms(grid_sample, 20)
                                      for _ in range(2)])
    tex_r, untex_r, lib_r = device_ms_in_turns(
        [(launch250.run, "split_finalize_kernel"),
         (launch250u.run, "split_finalize_kernel"),
         (grid_sample, "grid_sampler")], 20, K5_ROUNDS)
    fin_tex, fin_untex, lib_dev_ms = (statistics.median(r) for r in
                                      (tex_r, untex_r, lib_r))
    diffs = [a - b for a, b in zip(tex_r, untex_r)]
    bms5, by5 = bound(*finalize_work(launch250, gid250))
    bms5s, by5s = bound(128 * 128 * 4, n_texpx * TEX_OPS)
    timing["K5 texture sampling"] = (fin_tex, k5_plain, bms5, by5,
                                     lib_dev_ms)
    if max(diffs) < lib_dev_ms:
        verdict = "does not lose: every round's difference is under it"
    elif min(diffs) > lib_dev_ms:
        verdict = "loses: every round's difference is over it"
    else:
        verdict = "not resolved: the rounds' differences straddle it"

    def spread(vals):
        return [round(min(vals), 4), round(max(vals), 4)]
    k5_info = dict(
        clocks=dict(ms="device, profiler: the whole shaded finalize, "
                    "textured", plain_ms="events: plain K2, textured",
                    library_ms="device, profiler: grid_sample",
                    bound_ms="the textured finalize's work"),
        rounds=K5_ROUNDS, finalize_textured_ms_spread=spread(tex_r),
        finalize_untextured_ms=round(fin_untex, 4),
        finalize_untextured_ms_spread=spread(untex_r),
        finalize_difference_ms=round(statistics.median(diffs), 4),
        finalize_difference_ms_spread=spread(diffs),
        library_ms_spread=spread(lib_r),
        library_event_ms=round(lib_event_ms, 4),
        sampling_bound_ms=round(bms5s, 6), sampling_bound_by=by5s,
        k2_textured_ms=round(k2t_ms, 4), untextured_k2_ms=round(k2u_ms, 4),
        textured_pixels=n_texpx, against_library=verdict)
    log(f"# K5 texture sampling ({n_texpx} textured px), device times in "
        f"turns over {K5_ROUNDS} traces each (median [min, max]): the "
        f"shaded finalize {fin_tex:.4f} {spread(tex_r)} ms textured, "
        f"{fin_untex:.4f} {spread(untex_r)} untextured on the same mesh, "
        f"difference {statistics.median(diffs):.4f} {spread(diffs)}; "
        f"grid_sample {lib_dev_ms:.4f} {spread(lib_r)} (events "
        f"{lib_event_ms:.4f}); K5 {verdict}; K2 whole {k2t_ms:.4f} / "
        f"{k2u_ms:.4f} ms (events); bound of the finalize {bms5:.6f} ms "
        f"({by5}), of the sampling alone {bms5s:.6f} ms ({by5s})")

    # K8, K9 and K10: each held bit-equal to its plain version, then timed
    # beside it, with its bound. K10 is K9's time on deferred 1M beside
    # K9's on the same sphere without the quad, its bound the difference
    # of the two launches' work. Library: none (no PyTorch call
    # rasterizes).
    def time_gbuffer(name, label, launch, device=False):
        max_err[name] = max(max_err[name], assert_equal(
            f"{name} at {label}", launch.run(), launch.run_plain()))
        kms, pms = in_turns(launch.run, launch.run_plain)
        work = gbuffer_work(launch)
        bms, by = bound(*work)
        log(f"# {name} at {label}: kernel {kms:.4f} ms, plain {pms:.4f} "
            f"ms, bound {bms:.4f} ms ({by}), bit-equal")
        if device:
            device_time(name, label, launch)
        return kms, pms, work

    # The split kernels (K9, K2, K4 and K9 on 32-row tiles in the band
    # form, K11): at P = 16 held
    # bit-equal to the plain version (the default P is held where each is
    # timed), the parts of the A/B's calls read back and held to the
    # bins' count, the A/B of the default P against one part a stream of a
    # tile (P = 2^31 - 1, the side list a part of its own either way) in
    # turns, and the sweep of P.
    split_info = {}

    def split_run(launch, part_entries, seen=None):
        """``launch.run`` at ``part_entries`` entries a part."""
        return with_part_entries(part_entries, launch.run, launch.kernel,
                                 seen)

    def split_load(key, label, launch, seen, p0):
        """The parts of the A/B's last calls as the kernel counted them
        (its part offsets), held equal to the count from the bins."""
        nfb = launch.options["tiles_y"] * launch.options["tiles_x"]
        rs = launch.qbins.counts.shape[0] // (nfb + 1)
        per_tile = launch.qbins.counts[:rs * nfb]
        parts, busiest = [], []
        for p_ in (p0, ONE_PART):
            off = seen[p_].cpu()
            want, most = parts_plain(launch, p_)
            if int(off[0]) != 0 or not torch.equal(off[1:] - off[:-1],
                                                   want.int()):
                raise AssertionError(
                    f"{key} at {label}, P = {p_}: the kernel counted "
                    f"{int(off[-1])} parts, the bins give {int(want.sum())}")
            parts.append(int(off[-1]))
            busiest.append(most)
        log(f"# {key} load at {label}: {int((per_tile > 0).sum())} of "
            f"{per_tile.numel()} streams hold entries, "
            f"{int(per_tile.sum())} entries, max {int(per_tile.max())} in "
            f"one stream; the kernel counted {parts[0]} parts of at most "
            f"{p0} entries and {parts[1]} at one part a stream, as the bins "
            f"give; the busiest part {busiest[0]} entries ({busiest[1]} at "
            f"one part a stream), from the bins")
        return parts

    def split_phase(key, label, launch, sweep=True):
        p0 = raster.RASTER_PART_ENTRIES
        max_err[key] = max(max_err[key], assert_equal(
            f"{key} at {label}, P = 16", split_run(launch, 16)(),
            launch.run_plain()))
        log(f"# {key} == plain at {label}, P = 16: bit-equal")
        seen = {}
        ms_split, ms_one = in_turns(split_run(launch, p0, seen),
                                    split_run(launch, ONE_PART, seen), 20,
                                    20)
        log(f"# {key} A/B at {label}: P = {p0} {ms_split:.4f} ms against "
            f"one part a stream {ms_one:.4f} ms (in turns)")
        parts, parts1 = split_load(key, label, launch, seen, p0)
        info = dict(part_entries=p0, parts=parts, one_part_parts=parts1,
                    split_ms=round(ms_split, 4), one_part_ms=round(ms_one, 4))
        if sweep:
            ms = {p_: statistics.median([event_ms(split_run(launch, p_), 20)
                                         for _ in range(2)])
                  for p_ in (16, 32, 64, 128, 256, 512, 1024)}
            log(f"# {key} sweep of P at {label} (ms): " + json.dumps(
                {p_: round(v, 4) for p_, v in ms.items()}))
            info["sweep_ms"] = {p_: round(v, 4) for p_, v in ms.items()}
        split_info[key] = info

    split_phase("K2 raster+shade", f"headline {T} tris {W}x{H}", head_launch)

    c3_launch = gbuffer_launch(*scene3avx[0], tr3, li3, 512, 512)
    kms, pms, work = time_gbuffer("K8 G-buffer mask",
                                  "config 3 avx 12 tris 512x512", c3_launch,
                                  device=True)
    mask_floor("K8 G-buffer mask", "config 3 avx 12 tris 512x512", c3_launch)
    timing["K8 G-buffer mask"] = (kms, pms) + bound(*work) + (None,)
    k9_ms, k9_plain, work_q = time_gbuffer(
        "K9 G-buffer sorted", f"deferred 1M {T_def} tris {W}x{H}",
        launch_def)
    timing["K9 G-buffer sorted"] = (k9_ms, k9_plain) + bound(*work_q) + (
        None,)
    split_phase("K9 G-buffer sorted", f"deferred 1M {T_def} tris {W}x{H}",
                launch_def)
    sphere_only = [(dict(p=(0.0, 0.0, 0.0), **mesh), sg_def[0][1])]
    sc_s, tr_s, li_s = torch_scene(sphere_only, H, W, dev)
    launch_s = gbuffer_launch(*sc_s[0], tr_s, li_s, H, W)
    k9s_ms, _, work_s = time_gbuffer(
        "K9 G-buffer sorted", f"the sphere alone {T} tris {W}x{H}",
        launch_s)
    work_side = tuple(max(a - b, 0) for a, b in zip(work_q, work_s))
    bms10, by10 = bound(*work_side)
    timing["K10 G-buffer side list"] = (k9_ms, k9_plain, bms10, by10, None)
    log(f"# K10 G-buffer side list ({n_large} triangles): K9 with it "
        f"{k9_ms:.4f} ms against K9 on the sphere alone {k9s_ms:.4f} ms, "
        f"bound {bms10:.6f} ms ({by10})")

    # The 32-row forms at their paths' shapes: K4 and K9 (with K10) in the
    # band form, K6 and K8 in rows, each held bit-equal to its plain
    # version, timed beside it, with its bound (K10 as K9's time with the
    # quad beside K9's on the 40k sphere alone, both at 32 rows).
    def check_route(label, launch, want):
        r = launch.route
        got = (r.strategy, r.tile_h, r.rows, r.expansion, r.policy_factor)
        if got != want or int(launch.stats()["bins_dropped"]) != 0:
            raise AssertionError(f"{label}: route {r}, drops "
                                 f"{int(launch.stats()['bins_dropped'])}")

    sc40, tr40, li40 = torch_scene(sg40, H, W, dev)
    sc40d, tr40d, li40d = torch_scene(sg40d, H, W, dev)
    sc40s, _, _ = torch_scene([(sg40[0][0], sg_def[0][1])], H, W, dev)
    T40 = sc40[0][0].num_triangles
    assert T40 == 40_040, T40
    forms32 = {
        "config 4": prepare_scene(scene4, tr4, li4, H, W, strategy="sorted",
                                  tile_h=32),
        "40k": prepare_scene(sc40, tr40, li40, H, W, strategy="sorted",
                             tile_h=32),
        "config 3": prepare_scene(scene3, tr3, li3, 512, 512,
                                  strategy="mask", tile_h=32),
        "config 3 avx": gbuffer_launch(*scene3avx[0], tr3, li3, 512, 512,
                                       strategy="mask", tile_h=32),
        "deferred 40k": gbuffer_launch(*sc40d[0], tr40d, li40d, H, W,
                                       strategy="sorted", tile_h=32),
    }
    check_route("config 4 @32", forms32["config 4"], ("sorted", 32, 1, 32, 4))
    check_route("40k @32", forms32["40k"], ("sorted", 32, 1, 8, 2))
    check_route("deferred 40k @32", forms32["deferred 40k"],
                ("sorted", 32, 1, 8, 2))
    per_tile = forms32["40k"].qbins.counts[:-1]
    log(f"# K4 band 32-row load on 40k: {int((per_tile > 0).sum())} of "
        f"{per_tile.numel()} tiles hold entries, {int(per_tile.sum())} "
        f"entries, max {int(per_tile.max())} in one tile")
    time_launch("K4 raster+shade band 32-row", "config 4 2,208 tris "
                "1920x1080, 32-row tiles", forms32["config 4"], device=True)
    time_launch("K4 raster+shade band 32-row (40k)", f"40k {T40} tris "
                "1920x1080, 32-row tiles", forms32["40k"])
    split_phase("K4 raster+shade band 32-row", f"40k {T40} tris 1920x1080, "
                "32-row tiles", forms32["40k"])
    time_launch("K6 raster+shade mask 32-row", "config 3 12 tris 512x512, "
                "32-row tiles", forms32["config 3"], device=True)
    mask_floor("K6 raster+shade mask 32-row", "config 3 12 tris 512x512, "
               "32-row tiles", forms32["config 3"])
    kms, pms, work = time_gbuffer(
        "K8 G-buffer mask 32-row", "config 3 avx 12 tris 512x512, 32-row "
        "tiles", forms32["config 3 avx"], device=True)
    mask_floor("K8 G-buffer mask 32-row", "config 3 avx 12 tris 512x512, "
               "32-row tiles", forms32["config 3 avx"])
    timing["K8 G-buffer mask 32-row"] = (kms, pms) + bound(*work) + (None,)
    d40 = forms32["deferred 40k"]
    n_large40 = int(d40.qbins.n_large)
    if n_large40 != 2:
        raise AssertionError(f"deferred 40k @32: n_large {n_large40}, not 2")
    k9_32, k9p_32, work_q32 = time_gbuffer(
        "K9 G-buffer sorted band 32-row", f"deferred 40k {T40 + 2} tris "
        "1920x1080, 32-row tiles", d40)
    timing["K9 G-buffer sorted band 32-row"] = (k9_32, k9p_32) + bound(
        *work_q32) + (None,)
    split_phase("K9 G-buffer sorted band 32-row", f"deferred 40k {T40 + 2} "
                "tris 1920x1080, 32-row tiles", d40)
    k9s_32, _, work_s32 = time_gbuffer(
        "K9 G-buffer sorted band 32-row", f"the 40k sphere alone {T40} tris "
        "1920x1080, 32-row tiles", gbuffer_launch(
            *sc40s[0], tr40d, li40d, H, W, strategy="sorted", tile_h=32))
    bms10b, by10b = bound(*(max(a - b, 0) for a, b in zip(work_q32,
                                                          work_s32)))
    timing["K10 G-buffer side list band 32-row"] = (k9_32, k9p_32, bms10b,
                                                    by10b, None)
    log(f"# K10 G-buffer side list band 32-row ({n_large40} triangles): K9 "
        f"with it {k9_32:.4f} ms against K9 on the 40k sphere alone "
        f"{k9s_32:.4f} ms, bound {bms10b:.6f} ms ({by10b})")

    # The band form at its paths' shapes: K4 on 40k @24 (its row), 40k @64
    # and headline @64 (frame 0 of that path, held to its plain version on
    # the card), K9 + K10 on deferred 40k @24 (its row) and @64: each held
    # bit-equal to its plain version, timed beside it, with its bound and
    # drops, the walk's device time (a profiler trace of 20 launches) and
    # its work against a per-band walk's (``band_pairs``: stage A pairs,
    # and the (part, band) items that held no in-span pair); the split
    # phase at 24 rows (P = 16, the parts read back, one part a stream);
    # K10 as K9's band form with the quad beside the 40k sphere alone at
    # 24 rows.
    band_info = {"K4 raster+shade band": {}, "K9 G-buffer sorted band": {}}

    def band_walk(path, launch):
        """The band walk's device ms a launch and its work against a
        per-band walk's on ``launch``, logged and returned."""
        walk_ms = kernel_device_ms(launch.run, 20, "band_walk_kernel")
        bp = band_pairs(launch)
        share = bp["items_empty"] / max(bp["items"], 1)
        log(f"# band walk at {path}: device {walk_ms:.4f} ms a launch; "
            f"stage A on {bp['pairs_new']} (entry, row) pairs against the "
            f"per-band walk's {bp['pairs_old']} (every entry x band row; "
            f"{bp['entries']} entries, {bp['pairs_in_span']} pairs in "
            f"span)")
        log(f"# band walk at {path}: {bp['items_empty']} of a per-band "
            f"walk's {bp['items']} (part, band) items held no in-span pair "
            f"({share:.4f})")
        return dict(walk_device_ms=round(walk_ms, 4), **bp,
                    items_empty_share=round(share, 4))

    torch.cuda.reset_peak_memory_stats()
    band_launches = {}
    for path, name, sc_, tr_, li_, n_tris in (
            ("40k @24", "K4 raster+shade band", sc40, tr40, li40, T40),
            ("40k @64", "K4 raster+shade band (40k @64)", sc40, tr40, li40,
             T40),
            ("headline @64", "K4 raster+shade band (headline @64)",
             head_scene, head_tr, head_li, T)):
        tile_h = int(path.split("@")[1])
        launch = prepare_scene(sc_, tr_, li_, H, W, strategy="sorted",
                               tile_h=tile_h)
        check_route(path, launch, ("sorted", tile_h, 1, 8, 2))
        band_launches[path] = launch
        time_launch(name, f"{path} {n_tris} tris {W}x{H}", launch)
        kms, pms, bms, by, _ = timing[name]
        band_info["K4 raster+shade band"][path] = dict(
            ms=round(kms, 4), plain_ms=round(pms, 4), bound_ms=round(bms, 6),
            bound_by=by, expansion=launch.route.expansion,
            budget_factor=launch.route.policy_factor,
            drops=int(launch.stats()["bins_dropped"]),
            real_entries=int(launch.stats()["bins_real_entries"]),
            parts=int(raster.raster_narrow_any_kernel.part_offsets[-1]),
            **band_walk(path, launch))
    band_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"# band form: peak device memory of its K4 checks {band_peak_gib:.2f}"
        " GiB (the plain version's record gather at 64 rows on 1M tris)")
    split_phase("K4 raster+shade band", f"40k {T40} tris 1920x1080, 24-row "
                "tiles", band_launches["40k @24"], sweep=False)
    d40b = {t: gbuffer_launch(*sc40d[0], tr40d, li40d, H, W,
                              strategy="sorted", tile_h=t) for t in (24, 64)}
    for t, launch in d40b.items():
        kms, pms, work = time_gbuffer(
            "K9 G-buffer sorted band", f"deferred 40k {T40 + 2} tris "
            f"1920x1080, {t}-row tiles", launch)
        bms, by = bound(*work)
        band_info["K9 G-buffer sorted band"][f"deferred 40k @{t}"] = dict(
            ms=round(kms, 4), plain_ms=round(pms, 4), bound_ms=round(bms, 6),
            bound_by=by, n_large=int(launch.qbins.n_large),
            drops=int(launch.stats()["bins_dropped"]),
            parts=int(gbuffer.raster_pass_queue.part_offsets[-1]),
            **band_walk(f"deferred 40k @{t}", launch))
        if t == 24:
            timing["K9 G-buffer sorted band"] = (kms, pms, bms, by, None)
            k9b_24, k9bp_24, work_b24 = kms, pms, work
    if d40b[24].qbins.n_large <= 0:
        raise AssertionError("deferred 40k @24: the quad is not on the side "
                             "list")
    split_phase("K9 G-buffer sorted band", f"deferred 40k {T40 + 2} tris "
                "1920x1080, 24-row tiles", d40b[24], sweep=False)
    launch40s = gbuffer_launch(*sc40s[0], tr40d, li40d, H, W,
                               strategy="sorted", tile_h=24)
    k9s_b, _, work_sb = time_gbuffer(
        "K9 G-buffer sorted band", f"the 40k sphere alone {T40} tris "
        "1920x1080, 24-row tiles", launch40s)
    bms10c, by10c = bound(*(max(a - b, 0) for a, b in zip(work_b24,
                                                          work_sb)))
    timing["K10 G-buffer side list band"] = (k9b_24, k9bp_24, bms10c, by10c,
                                             None)
    walk10 = kernel_device_ms(launch40s.run, 20, "band_walk_kernel")
    walk_q = band_info["K9 G-buffer sorted band"]["deferred 40k @24"][
        "walk_device_ms"]
    band_info["K10 G-buffer side list band"] = {"deferred 40k @24": dict(
        with_quad_ms=round(k9b_24, 4), sphere_alone_ms=round(k9s_b, 4),
        walk_with_quad_device_ms=walk_q,
        walk_sphere_alone_device_ms=round(walk10, 4))}
    log(f"# K10 G-buffer side list band ({int(d40b[24].qbins.n_large)} "
        f"triangles): K9 band with it {k9b_24:.4f} ms against K9 band on "
        f"the 40k sphere alone {k9s_b:.4f} ms (the walk's device time "
        f"{walk_q:.4f} against {walk10:.4f}), bound {bms10c:.6f} ms "
        f"({by10c})")

    # K11 on stack6 zcull's first frame: held bit-equal to its plain
    # version and to K2 split on the same operands, timed beside its plain
    # version, beside K2 split and beside itself at one part a stream, in
    # turns; its skipped batches at the default P and at one part a
    # stream; its bound the
    # launch's work with the entry part scaled to the batches it folds.
    # Then on bench.py's order of the stack (outermost first).
    k2_on = raster.RASTER_KERNELS[(8, 2)]

    def k2_split(launch):
        return lambda: k2_on(*launch.operands, **launch.options)

    max_err["K11 zcull"] = max(max_err["K11 zcull"], assert_equal(
        f"K11 zcull at stack6 {T6} tris {W}x{H}", launch6.run(),
        launch6.run_plain()))
    assert_equal(f"K11 zcull at stack6 {T6} tris {W}x{H} against K2 split",
                 launch6.run(), k2_split(launch6)())
    k11_ms, k11_plain = in_turns(launch6.run, launch6.run_plain)
    k11_vs_k2, k2_stack_ms = in_turns(launch6.run, k2_split(launch6), 20, 20)
    split_phase("K11 zcull", f"stack6 {T6} tris {W}x{H}", launch6,
                sweep=False)
    skips6 = {}
    for p_ in (raster.RASTER_PART_ENTRIES, ONE_PART):
        sk = torch.zeros(1, dtype=torch.int32, device=dev)
        out = with_part_entries(p_, lambda sk=sk: launch6.kernel(
            *launch6.operands, skipped=sk, **launch6.options))()
        assert_equal(f"K11 zcull at stack6, P = {p_}", out,
                     k2_split(launch6)())
        skips6[f"P={p_}"] = int(sk)
    if skips6[f"P={raster.RASTER_PART_ENTRIES}"] <= 0:
        raise AssertionError(f"K11 skipped nothing on stack6: {skips6}")
    _, gid6, _ = launch6.run()
    nbytes6, ops6 = raster_work(launch6, gid6)
    px_bytes6 = gid6.numel() * 12
    folded = 1.0 - int(skipped6) / batches6
    bms11, by11 = bound(px_bytes6 + (nbytes6 - px_bytes6) * folded,
                        ops6 * folded)
    timing["K11 zcull"] = (k11_ms, k11_plain, bms11, by11, None)
    log(f"# K11 zcull at stack6 {T6} tris {W}x{H}: kernel {k11_ms:.4f} ms, "
        f"plain {k11_plain:.4f} ms, bound {bms11:.4f} ms ({by11}; "
        f"{folded:.4f} of the batches folded), bit-equal; in turns "
        f"{k11_vs_k2:.4f} ms against K2 split on the same operands "
        f"{k2_stack_ms:.4f} ms; skipped batches by part size "
        f"{json.dumps(skips6)}")
    scene6b, _, _ = scenes.stack_scene(409, 409, 6, H, W, device=dev)
    launch6b = prepare_scene(scene6b, tr6, li6, H, W, zcull=True)
    skipped6b = torch.zeros(1, dtype=torch.int32, device=dev)
    launch6b.kernel(*launch6b.operands, skipped=skipped6b,
                    **launch6b.options)
    k11b_ms, k2b_ms = in_turns(launch6b.run, k2_split(launch6b), 20, 20)
    log(f"# K11 zcull on bench.py's order of the stack (outermost first): "
        f"{int(skipped6b)} batches skipped, kernel {k11b_ms:.4f} ms, K2 "
        f"{k2b_ms:.4f} ms (in turns)")

    # K12, the deferred shade, on deferred 1M's G-buffer at both sizes
    # (bit-equal to its plain chain above): in turns beside the plain
    # chain by events, each one's device and host time a call from
    # profiler traces, and its bound: every pixel's coverage, z and
    # written colour and depth, each winner's normal and u/z, v/z, 1/z, the
    # texture once; the winners' shading, texture and pack operations.
    k12_info = {}
    for (w_, h_), args_ in k12_inputs.items():
        def k12(a_=args_):
            return shade_merge(*a_)

        def k12_plain(a_=args_):
            return shade_merge_plain(*a_)
        kms, pms = in_turns(k12, k12_plain)
        k_dev = kernel_device_ms(k12, 50, "deferred_shade_kernel")
        k_host, k_all, k_ops = profile_calls(k12, 50)
        p_host, p_dev, p_ops = profile_calls(k12_plain, 10)
        _, _, _, li_, _, tex_ = args_
        winners = int((k12().depth > -3.0e38).sum())
        px = h_ * w_
        nbytes = px * 13 + winners * (12 + 12) + tex_.numel() * 4
        ops = winners * (PACK_OPS + PHONG_OPS + li_.count * PHONG_LIGHT_OPS
                         + TEX_OPS)
        bms, by = bound(nbytes, ops)
        k12_info[f"{w_}x{h_}"] = dict(
            ms=round(kms, 4), kernel_device_ms=round(k_dev, 4),
            device_ms=round(k_all, 4), host_ms=round(k_host, 4),
            device_ops=k_ops, plain_ms=round(pms, 4),
            plain_device_ms=round(p_dev, 4), plain_host_ms=round(p_host, 4),
            plain_op_names=len(p_ops), bound_ms=round(bms, 6),
            bound_by=by, winners=winners, pixels=px,
            roofline=round(bms / k_dev, 4))
        if (w_, h_) == (W, H):
            timing["K12 deferred shade"] = (kms, pms, bms, by, None)
        log(f"# K12 deferred shade at deferred 1M {w_}x{h_}: "
            + json.dumps(k12_info[f"{w_}x{h_}"]))

    # Fused against deferred on the textured 250k scene: whole frames
    # (rotate, setup, binning, raster, and for the G-buffer path shade
    # and merge), in turns fused, deferred, deferred, fused.
    obj250, cfg250 = scene250[0]
    r250 = trt.Renderer(H, W, device=dev)
    ab_angles = iter([0.03 * i for i in range(1000)])

    def fused_frame():
        return r250.render(rotated(scene250, next(ab_angles), dev), tr250,
                           li250)

    def deferred_frame():
        (o, c), = rotated(scene250, next(ab_angles), dev)
        return _draw_deferred(None, o, tr250, li250, c, H, W, None)

    for fn in (fused_frame, deferred_frame):
        for _ in range(WARMUP):
            fn()
    def_ms, fused_ms = in_turns(deferred_frame, fused_frame, FRAMES, FRAMES)
    log(f"# fused against deferred, textured 250k {W}x{H} (ms/frame, CUDA "
        f"events, median of two runs of {FRAMES}): fused (K1, K2 with K5) "
        f"{fused_ms:.4f}, deferred (K1, K9, shade) {def_ms:.4f}")

    R, T4 = table4.shape
    tp4 = T4 + (-T4 % raster.REC_T_BLK)
    padded = torch.nn.functional.pad(table4, (0, tp4 - T4, 0, 128 - R))

    def k7():
        return raster.finish_records(table4)

    def lib7():
        return padded.t().contiguous()

    # The kernel and the library call by events in turns (each call's host
    # work before its launch included), the plain version beside them;
    # then each call's host and device time from a profiler trace.
    kms, lms = in_turns(k7, lib7, 50, 50)
    pms = statistics.median([event_ms(
        lambda: raster.finish_records_plain(table4), 20) for _ in range(2)])
    bms, by = bound(R * T4 * 4 + tp4 * 128 * 4, 0)
    timing["K7 record transpose"] = (kms, pms, bms, by, lms)
    k7_prof = {}
    for tag, fn in (("kernel", k7), ("t().contiguous()", lib7)):
        host_ms, dev_ms, names = profile_calls(fn, 200)
        k7_prof[tag] = dict(host_ms=round(host_ms, 4),
                            device_ms=round(dev_ms, 4), ops=names)
    log(f"# K7 record transpose at config 4 ({R}, {T4}) -> ({tp4}, 128): "
        f"kernel {kms:.4f} ms, t().contiguous() {lms:.4f} ms (events, in "
        f"turns), plain {pms:.4f} ms, bound {bms:.6f} ms ({by}); profiler "
        f"per call: " + json.dumps(k7_prof))

    guard_ab = launch_guard_ab(dev, smi_line, scene5f, tr5f, li5f, H, W)

    if args.profile:
        for path, (sc, tr_, li_, h, w) in (
                ("headline", (head_scene, head_tr, head_li, H, W)),
                ("config 2", (scene2, tr2, li2, 512, 512)),
                ("config 4", (scene4, tr4, li4, H, W)),
                ("config 5 untextured", (scene5, tr5, li5, H, W)),
                ("textured 250k", (scene250, tr250, li250, H, W)),
                ("config 1", (scene1, tr1, li1, 512, 512)),
                ("config 3", (scene3, tr3, li3, 512, 512)),
                ("config 5", (scene5f, tr5f, li5f, H, W)),
                ("config 3 avx", (scene3avx, tr3, li3, 512, 512)),
                ("deferred 1M", (scene_def, tr_def, li_def, H, W)),
                ("stack6 zcull", (scene6, tr6, li6, H, W)),
                ("stack6", (scene6, tr6, li6, H, W))):
            renderer = trt.Renderer(h, w, device=dev,
                                    zcull=path == "stack6 zcull")
            profile_frames(
                path, lambda a: renderer.render(rotated(sc, a, dev), tr_,
                                                li_),
                [0.06 * i for i in range(10)], path_ms[path])
        for path, sg_, h, w, frame, _ in forced_paths:
            sc, tr_, li_ = torch_scene(sg_, h, w, dev)
            profile_frames(
                path, lambda a: frame(rotated(sc, a, dev), tr_, li_),
                [0.06 * i for i in range(10)], path_ms[path])

    # 8. Each path's frame 0 against the NumPy spec, whole or in windows,
    # through the path's own entry; the native golden as the CPU baseline.
    forced = {p_: fn for p_, _, _, _, fn, _ in forced_paths}

    def card_frame(path, sg_, h, w):
        def frame():
            sc, tr_, li_ = torch_scene(sg_, h, w, dev)
            if path in forced:
                return forced[path](sc, tr_, li_)[0]
            return trt.Renderer(h, w, device=dev,
                                zcull=path == "stack6 zcull").render(
                sc, tr_, li_)
        return frame

    sg6 = scenes.stack_scene_golden(409, 409, 6, H, W, inner_first=True)[0]
    golden_paths = []
    for path, key, sg_, h, w in (
            ("config 1", "config 1", sg1, 512, 512),
            ("config 2", "config 2", sg2, 512, 512),
            *((p_, "config 3", sg3, 512, 512)
              for p_ in ("config 3", "config 3 @32")),
            *((p_, "config 4", sg4, H, W) for p_ in ("config 4",
                                                     "config 4 @32")),
            ("config 5 untextured", "config 5 untextured", sg5, H, W),
            ("config 5", "config 5", sg5full, H, W),
            *((p_, "config 3 avx", sg3avx, 512, 512)
              for p_ in ("config 3 avx", "config 3 avx @32")),
            *((p_, "headline", phong_mesh_scene(mesh), H, W)
              for p_ in ("headline", "headline @64")),
            ("textured 250k", "textured 250k", sg250, H, W),
            ("deferred 1M", "deferred 1M", sg_def, H, W),
            *((p_, "stack6", sg6, H, W) for p_ in ("stack6 zcull", "stack6")),
            *((p_, "40k", sg40, H, W)
              for p_ in ("40k", "40k @24", "40k @32", "40k @64")),
            *((f"deferred 40k @{t}", "deferred 40k", sg40d, H, W)
              for t in (24, 32, 64))):
        # The small-object scenes' whole golden frames take seconds; the
        # others are held in windows.
        golden_paths.append((path, key, sg_, *scenes.baseline_camera_lights(
            h, w), h, w, key.startswith("config"), card_frame(path, sg_, h,
                                                              w)))
    golden_info = golden_phase(smi_line, golden_paths, path_ms)

    # 9. The sharded paths; 10. one NCCL rank a card.
    mesh_info = mesh_phase(dev, smi_line, head_scene, head_tr, head_li, H, W)
    cards_info = cards_phase(smi_lines, H, W)
    # 11. Every kernel route on the seeded boundary scenes.
    sweep_info = sweep_phase(dev, smi_line)

    kernels = []
    for name, meta in KERNELS.items():
        kms, pms, bms, by, lms = timing[name]
        entry = dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], path=meta["path"],
            launches=path_launches[meta["path"]][COUNTER.get(name, name)],
            max_abs_err=max_err[name], ms=round(kms, 4),
            plain_ms=round(pms, 4), bound_ms=round(bms, 6), bound_by=by,
            library_ms=None if lms is None else round(lms, 4))
        if name == "K5 texture sampling":
            entry.update(k5_info)
        if name in ("K1 setup", "K1 setup textured"):
            entry["by_path"] = {p_: v for p_, v in k1_paths.items()
                                if v["kernel"] == name}
            entry["ptxas"] = {f: v for f, v in k1_ptxas.items()
                              if f.endswith("true>" if "textured" in name
                                            else "false>")}
        if name == "K1 grouped":
            entry["by_path"] = k1_grouped_info
            entry["ptxas"] = k1g_ptxas
        if name == "K13 rotate":
            entry["by_path"] = k13_info
            entry["ptxas"] = k13_ptxas
        if name == "K14 binning":
            entry["by_cell"] = k14_info
            entry["ptxas"] = k14_ptxas
        if name in dev_info:
            entry.update(dev_info[name])
        if name.startswith(("K6 ", "K8 ")):
            entry["ptxas"] = {f: v for f, v in mask_ptxas.items()
                              if f.endswith("true>" if "G-buffer" in name
                                            else "false>")}
        if name == "K12 deferred shade":
            entry["by_shape"] = k12_info
        if name == "K10 G-buffer side list":
            entry["k9_without_side_list_ms"] = round(k9s_ms, 4)
        if name == "K10 G-buffer side list band 32-row":
            entry["k9_without_side_list_ms"] = round(k9s_32, 4)
        if name == "K10 G-buffer side list band":
            entry["k9_without_side_list_ms"] = round(k9s_b, 4)
        if name in band_info:
            entry["by_path"] = band_info[name]
        if " band" in name:
            entry["ptxas"] = band_ptxas
        if name in split_info:
            entry.update(split_info[name])
        if name == "K7 record transpose":
            entry.update(
                host_ms=k7_prof["kernel"]["host_ms"],
                device_ms=k7_prof["kernel"]["device_ms"],
                library_host_ms=k7_prof["t().contiguous()"]["host_ms"],
                library_device_ms=k7_prof["t().contiguous()"]["device_ms"])
        if name == "K11 zcull":
            entry.update(
                skipped_batches=int(skipped6), batches=batches6,
                k2_same_operands_ms=round(k2_stack_ms, 4),
                ms_in_turns_with_k2=round(k11_vs_k2, 4),
                skipped_by_part_size=skips6,
                bench_order_skipped_batches=int(skipped6b),
                bench_order_ms=round(k11b_ms, 4),
                bench_order_k2_ms=round(k2b_ms, 4))
        kernels.append(entry)
    log("# frames: " + json.dumps({
        "ms_per_frame": {k: round(v, 4) for k, v in path_ms.items()},
        "headline_span_ms": span_ms,
        "textured_250k_fused_vs_deferred_ms": [round(fused_ms, 4),
                                               round(def_ms, 4)],
        "band_paths_frame0": band_drops,
        "band_peak_memory_gib": round(band_peak_gib, 2),
        "headline_frame_timer": frame_timer,
        "golden": golden_info,
        "mesh": mesh_info,
        "cards": cards_info,
        "sweep": sweep_info,
        "launch_guard_ab": guard_ab,
        "card": smi_line}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
