"""The reference rasterizer: every triangle over the whole frame, merged in
submission order, no tiling and no binning.

PyTorch counterpart of ``tpu_renderer.ops.raster_reference``, the oracle
of the kernels and the renderer's 'reference' backend. It reproduces the
reference's sequential depth composition: triangles merge into the frame
one at a time with the strict '>' z test (projekt.cpp:495), so the first
writer keeps depth ties. O(T * H * W): for tests and small scenes.

``rasterize_reference`` walks the triangles in chunks, in order. Within a
chunk the sequential strict '>' merge is the same as taking, per pixel,
the first triangle with the largest in-span z and merging that one (a
later triangle wins only with a larger z; NaN never wins), so a chunk
evaluates z for all of its triangles and the 10 attribute channels only
for the winners, with ``span_block``'s per-pixel operation.
"""

from __future__ import annotations

import torch

from ..core.types import DEPTH_CLEAR, resolve_device
from ..geometry.vertex import EdgeTable
from .spans import SpanBlock, TriangleSlice, span_k, span_rows

F32 = torch.float32

# G-buffer: channel-first (11, H, W): z, rgba, normal xyz, u/z, v/z, 1/z.
GBUF_CHANNELS = 11
_CHUNK_PX = 1 << 21  # triangles x pixels evaluated at once


def empty_gbuffer(height: int, width: int, device="cuda"):
    """(covered (H, W) all False, gbuf (11, H, W): DEPTH_CLEAR, zeros), on
    the card unless ``device`` says otherwise (raises without one)."""
    device = resolve_device(device)
    covered = torch.zeros((height, width), dtype=torch.bool, device=device)
    gbuf = torch.zeros((GBUF_CHANNELS, height, width), dtype=F32,
                       device=device)
    gbuf[0] = DEPTH_CLEAR
    return covered, gbuf


def merge_fragments(covered, gbuf, frag: SpanBlock):
    """Depth-test one triangle's fragment block into the G-buffer (larger z
    wins, strict '>' so earlier writers keep ties)."""
    win = frag.mask & (frag.z > gbuf[0])
    frag_cf = torch.cat([frag.z[None], frag.col.permute(2, 0, 1),
                         frag.n.permute(2, 0, 1), frag.u[None],
                         frag.v[None], frag.oz[None]])
    return covered | win, torch.where(win[None], frag_cf, gbuf)


def rasterize_reference(edges: EdgeTable, height: int, width: int,
                        frame_width: int | None = None, row0: int = 0,
                        col0: int = 0):
    """Rasterize all triangles into a fresh (covered (H, W), gbuf (11, H,
    W)) on the table's device. (height, width) is the local extent and
    (row0, col0) its origin in the frame; frame_width the frame's width,
    which the reference clamps spans against (projekt.cpp:381-400)."""
    if frame_width is None:
        frame_width = width
    dev = edges.valid.device
    rows = torch.arange(height, dtype=F32, device=dev) + float(row0)
    cols = torch.arange(width, dtype=F32, device=dev) + float(col0)
    covered, gbuf = empty_gbuffer(height, width, dev)
    T = edges.num_triangles
    chunk = max(1, _CHUNK_PX // max(height * width, 1))
    r_idx = torch.arange(height, device=dev)[:, None].expand(height, width)
    for c0 in range(0, T, chunk):
        tri = TriangleSlice(*(f[c0:c0 + chunk] for f in edges))
        sr = span_rows(tri, rows, frame_width)
        mask, k = span_k(sr, cols)  # (C, H, W)
        z = sr.left[..., 0, None] + k * sr.inc[..., 0, None]
        z = torch.where(mask & ~torch.isnan(z), z, float("-inf"))
        best = z.amax(dim=0)
        order = torch.arange(z.shape[0], device=dev)[:, None, None]
        idx = torch.where(z == best, order, z.shape[0]).amin(dim=0)
        win = best > gbuf[0]
        k_w = k.gather(0, idx[None])[0]
        vals = (sr.left[idx, r_idx] + k_w[..., None] * sr.inc[idx, r_idx])
        gbuf = torch.where(win[None], vals.permute(2, 0, 1), gbuf)
        covered = covered | win
    return covered, gbuf
