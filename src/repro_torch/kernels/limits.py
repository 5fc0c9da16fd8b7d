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
    "WAVE_KB", "WAVE_WARPS", "WAVE_ROWS", "MXU_ROWS", "MXU_SLAB",
    "MXU_MAX_W", "MXU_HALF_ROWS", "MXU_HALF_CHUNK", "MXU_HALF_CLUSTER",
    "MXU_HALF_STAGES",
    "MXU_HALF_VEC", "BATCHED_M_BLK", "BATCHED_KB", "round_up",
    "row_blocks", "wave_smem_bytes", "mxu_width",
]

WARP = 32
SMEM_PER_BLOCK = 232_448
SMEM_STATIC = 48 * 1024
REGS_PER_THREAD = 255

# the wavefront kernel's block: one group of WAVE_ROWS rows of A, one row
# a lane, run by WAVE_WARPS warps that each apply one band of WAVE_KB
# waves, a fixed lag behind the warp before (the constants its source is
# compiled for, kWarps and kBand)
WAVE_KB = 16
WAVE_WARPS = 12
WAVE_ROWS = 32
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


def wave_smem_bytes(warps: int = WAVE_WARPS) -> int:
    """Dynamic shared memory of one float32 wavefront block of ``warps``
    warps (a half-precision block's rings take half as much).

    Each warp's plane values for three chunks of ``min(2 WAVE_KB, 128 //
    WAVE_KB)`` steps, one ``float4`` a plane, and its ring of 32 columns
    of ``WAVE_ROWS`` rows that the warp before it (or, for the first
    warp, memory) hands its columns through.
    """
    chunk = min(2 * WAVE_KB, 128 // WAVE_KB)
    return warps * (3 * WAVE_KB * chunk * 4 + 32 * WAVE_ROWS) * _F32


def mxu_width(w: int) -> int:
    """The accumulated kernel's padded width for tiles of width ``w``: the
    narrowest of its register micro-tiles (64, 128, 256 columns) that
    holds them."""
    return next(wp for wp in (64, 128, MXU_MAX_W) if w <= wp)
