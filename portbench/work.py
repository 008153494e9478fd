"""The work a frame's layers need, counted from scene quantities alone
(triangles, kept triangles, pixels, covered pixels), and the least time
the card could do it in. Nothing here counts the program's bins, entries,
parts or records as it lays them out.

f32 operation counts per unit of work are the port's kernel-table
constants (counted from csrc/setup.cu and csrc/raster.cu and rounded):
they give a floor on the work, not a cycle count.
"""

SETUP_OPS = 250  # per triangle: projection, cull, 3 edges' fields
SETUP_TEX_OPS = 40  # per textured triangle: the u/z, v/z, 1/z fields
STAGE_A_OPS, STAGE_A_FIELD_OPS = 110, 12  # per pixel's winner, per field
PACK_OPS = 24  # per covered pixel
PHONG_OPS, PHONG_LIGHT_OPS = 40, 70  # per Phong pixel, per light
RECORD_BYTES = 544  # a triangle's record row (512 B) and bbox row (32 B)
RECORD_READ_BYTES = 88 * 4  # the record lanes the raster reads
F32 = 4


def setup_work(triangles, textured):
    """(bytes, f32 ops) of setup: the vertex, colour, normal (and uv)
    planes read once, the record table and bbox rows written once."""
    chans = 3 + 4 + 3 + (2 if textured else 0)
    nbytes = triangles * (3 * chans * F32 + RECORD_BYTES)
    ops = triangles * (SETUP_OPS + (SETUP_TEX_OPS if textured else 0))
    return nbytes, ops


def raster_work(kept, covered, pixels, px_bytes, fields, shades, lights):
    """(bytes, f32 ops) of the raster: the record lanes of every kept
    triangle read once and ``px_bytes`` a pixel written once; stage A with
    ``fields`` attribute planes per covered pixel, and where the raster
    shades (``shades``), the pack and Phong with ``lights`` lights."""
    nbytes = kept * RECORD_READ_BYTES + pixels * px_bytes
    per_px = STAGE_A_OPS + STAGE_A_FIELD_OPS * fields
    if shades:
        per_px += PACK_OPS + PHONG_OPS + PHONG_LIGHT_OPS * lights
    return nbytes, covered * per_px


def bound_ms(nbytes, ops, peaks):
    """The least ms: the larger of bytes over the memory's peak and f32
    operations over the f32 peak."""
    return max(nbytes / peaks["memory_bytes_per_s"],
               ops / peaks["f32_ops_per_s"]) * 1e3
