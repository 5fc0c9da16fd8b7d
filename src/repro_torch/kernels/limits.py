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
    "WAVE_M_BLK", "MXU_MAX_W", "BATCHED_M_BLK", "round_up", "clamp_m_blk",
    "wave_smem_bytes",
]

WARP = 32
SMEM_PER_BLOCK = 232_448
SMEM_STATIC = 48 * 1024
REGS_PER_THREAD = 255

# rows of A per block of the wavefront kernel: one thread per row
WAVE_M_BLK = 128
# widest tile factor the accumulated kernel holds: 8 columns per lane
# (its rows per block and shared-memory slab are constants of the source)
MXU_MAX_W = 8 * WARP
# rows of A per block of the fused batched kernel, one thread a row (the
# block size its source is compiled for, kThreads): small blocks spread
# one request over many SMs (a 1024-row request over 16).  The row's
# window is in registers and the row streams through memory, so the
# width n sets no limit.
BATCHED_M_BLK = 64

_F32 = 4


def round_up(x: int, mult: int) -> int:
    """``x`` rounded up to the next multiple of ``mult``."""
    return ((x + mult - 1) // mult) * mult


def clamp_m_blk(m: int, m_blk: int) -> int:
    """Clamp a rows-per-block request to the target's warp-padded rows.

    A block never spans more warps than the target has rows for, so a
    small target does not launch idle warps.
    """
    return min(m_blk, round_up(max(1, m), WARP))


def wave_smem_bytes(n_b: int, k_b: int, threads: int) -> int:
    """Dynamic shared memory of one wavefront block.

    The ``(k_b + n_b)``-row column window of every thread, laid out
    ``[row][thread]``, plus one tile's c/s/g values.
    """
    return ((k_b + n_b) * threads + 3 * n_b * k_b) * _F32

