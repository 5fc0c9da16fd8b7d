"""Hopper budgets and the block-shape helpers derived from them.

Mirror of :mod:`repro.kernels.limits`.  The TPU's SMEM/VMEM budgets do
not carry over; these are an H100's per-block limits (NVIDIA's Hopper
tuning guide): 227 KB of shared memory a block may use, of which 48 KB
without opting in to dynamic shared memory, and 255 registers a thread.
The kernel wrappers validate launches against these numbers and the
registry uses the same helpers, so the kernel the cost model prices is
the kernel that launches.
"""
from __future__ import annotations

__all__ = [
    "WARP", "SMEM_PER_BLOCK", "SMEM_STATIC", "REGS_PER_THREAD",
    "WAVE_KB", "WAVE_SMALL_KB", "WAVE_BANDS", "WAVE_WARPS", "WAVE_ROWS",
    "WAVE_SMALL_ROWS", "WAVE_SMALL_BANDS", "WAVE_SMALL_WARPS",
    "WAVE_SMALL_CHUNK",
    "MXU_ROWS", "MXU_SLAB", "MXU_MAX_W", "MXU_HALF_ROWS", "MXU_HALF_CHUNK",
    "MXU_HALF_CLUSTER", "MXU_HALF_STAGES",
    "MXU_HALF_VEC", "BATCHED_M_BLK", "BATCHED_KB", "round_up",
    "row_blocks", "wave_chunk_steps", "wave_lag", "wave_smem_bytes",
    "wave_small_geometry", "wave_small_steps",
    "mxu_width",
]

WARP = 32
SMEM_PER_BLOCK = 232_448
SMEM_STATIC = 48 * 1024
REGS_PER_THREAD = 255

# the wavefront kernel's block: one group of WAVE_ROWS rows of A, one row
# a lane, run by WAVE_WARPS warps that each apply one band of waves, a
# fixed lag behind the warp before (the constants its source is compiled
# for: kWarps; the band kBand, the default); WAVE_BANDS are every band it
# takes, the default and WAVE_SMALL_KB (kSmallBand), for few waves, which
# runs a kernel of its own: a warp is WAVE_SMALL_ROWS rows by
# WAVE_SMALL_BANDS bands, one (row, band) pair a lane, each band a window
# behind the one before, in blocks of WAVE_SMALL_WARPS independent warps
# (kSmallRows, kSmallBands, kSmallWarps)
WAVE_KB = 16
WAVE_SMALL_KB = 4
WAVE_BANDS = (WAVE_KB, WAVE_SMALL_KB)
WAVE_WARPS = 12
WAVE_ROWS = 32
WAVE_SMALL_ROWS = 4
WAVE_SMALL_BANDS = 8
WAVE_SMALL_WARPS = 2
# steps of the small band's chunk: its plane values are staged a chunk
# ahead (the source's kSmallChunk, two register windows)
WAVE_SMALL_CHUNK = 16
# the accumulated kernel's block: MXU_ROWS rows of A, Q_t streamed in
# slabs of MXU_SLAB rows, at a padded width of 64, 128 or MXU_MAX_W
# columns (the constants its source is compiled for, kRows and kSlab; its
# ring and cluster are the source's alone)
MXU_ROWS = 32
MXU_SLAB = 32
MXU_MAX_W = 256
# the accumulated kernel's half tier (bfloat16, float16 on the tensor
# cores, the constants its source is compiled for): a block of
# MXU_HALF_ROWS rows of A (wgmma's M, kRows), the factors streamed in
# chunks of MXU_HALF_CHUNK of their K columns (kChunk), blocks in
# clusters of MXU_HALF_CLUSTER that share each chunk by TMA multicast
# (kCluster), a ring of MXU_HALF_STAGES chunks (kStages); it reads the
# factors transposed through TMA, whose row strides are 16-byte pieces of
# MXU_HALF_VEC elements, so their padded row stride is a multiple of it
# (kVec); widths as above, padded to 64, 128 or MXU_MAX_W
MXU_HALF_ROWS = 64
MXU_HALF_CHUNK = 64
MXU_HALF_CLUSTER = 2
MXU_HALF_STAGES = 4
MXU_HALF_VEC = 8
# rows of A per block of the fused batched kernel, one thread a row (the
# block size its source is compiled for, kThreads): small blocks spread
# one request over many SMs (a 1024-row request over 16).  The row's
# window is in registers and the row streams through memory, so the
# width n sets no limit.
BATCHED_M_BLK = 64
# waves a band of the fused batched kernel (kBand): each row streams
# through memory once a band
BATCHED_KB = 16

_F32 = 4


def round_up(x: int, mult: int) -> int:
    """``x`` rounded up to the next multiple of ``mult``."""
    return ((x + mult - 1) // mult) * mult


def row_blocks(m: int) -> int:
    """Row blocks of one request of the fused batched kernel:
    :data:`BATCHED_M_BLK` rows a block."""
    return -(-m // BATCHED_M_BLK)


def wave_chunk_steps(k_b: int = WAVE_KB) -> int:
    """Steps (columns of a band) in one chunk of the wavefront kernel's
    band pipeline at bands of ``k_b`` waves: 128 planes, at most its
    register window's ``2 k_b`` steps (the source's ``chunk_steps``)."""
    return min(2 * k_b, 128 // k_b)


def wave_lag(k_b: int = WAVE_KB) -> int:
    """Chunks each warp of the wavefront kernel's band pipeline runs
    behind the warp before it at bands of ``k_b`` waves (the source's
    ``L``): its register window of ``2 k_b`` steps, in chunks, and one
    more."""
    cs = wave_chunk_steps(k_b)
    return -(-(2 * k_b - 1) // cs) + 1


def wave_smem_bytes(warps=None, k_b: int = WAVE_KB) -> int:
    """Shared memory of one float32 wavefront block of ``warps`` warps
    (the band's own count by default) at bands of ``k_b`` waves (a
    half-precision block's columns take half as much).

    The band pipeline (dynamic): each warp's plane values for three
    chunks (:func:`wave_chunk_steps`), one ``float4`` a plane, and its
    ring of 32 columns of ``WAVE_ROWS`` rows that the warp before it (or,
    for the first warp, memory) hands its columns through.  The small
    band's kernel (static): each warp's two slots of a chunk of
    :data:`WAVE_SMALL_CHUNK` steps, one ``float4`` a plane of its
    ``WAVE_SMALL_BANDS`` bands, and of its first band's columns,
    ``WAVE_SMALL_ROWS`` a step.
    """
    if k_b == WAVE_SMALL_KB:
        warps = WAVE_SMALL_WARPS if warps is None else warps
        return warps * 2 * WAVE_SMALL_CHUNK * (
            4 * k_b * WAVE_SMALL_BANDS + WAVE_SMALL_ROWS) * _F32
    warps = WAVE_WARPS if warps is None else warps
    return warps * (3 * k_b * wave_chunk_steps(k_b) * 4
                    + 32 * WAVE_ROWS) * _F32


def wave_small_geometry(M: int) -> dict:
    """The small band's launch over ``M`` rows: rows and bands a warp,
    its warps (one a group of ``WAVE_SMALL_ROWS`` rows) and blocks (of
    ``WAVE_SMALL_WARPS`` warps)."""
    warps = -(-M // WAVE_SMALL_ROWS)
    return {"rows_a_warp": WAVE_SMALL_ROWS,
            "bands_a_warp": WAVE_SMALL_BANDS, "warps": warps,
            "blocks": -(-warps // WAVE_SMALL_WARPS),
            "warps_a_block": WAVE_SMALL_WARPS}


def wave_small_steps(n: int, K: int) -> int:
    """Steps a warp of the small band's kernel walks in one launch over
    ``n`` columns and ``K`` waves: a pass of ``b`` bands takes ``n + W -
    1 + W (b - 1)`` steps (``W = 2 WAVE_SMALL_KB``, each band a window
    behind the one before), ``WAVE_SMALL_BANDS`` bands a pass."""
    w = 2 * WAVE_SMALL_KB
    bands = -(-K // WAVE_SMALL_KB)
    return sum(n + w - 1 + w * (min(WAVE_SMALL_BANDS, bands - q) - 1)
               for q in range(0, bands, WAVE_SMALL_BANDS))


def mxu_width(w: int) -> int:
    """The accumulated kernel's padded width for tiles of width ``w``: the
    narrowest of its register micro-tiles (64, 128, 256 columns) that
    holds them."""
    return next(wp for wp in (64, 128, MXU_MAX_W) if w <= wp)
