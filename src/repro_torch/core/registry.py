"""Backend registry + cost-model dispatch for rotation-sequence application.

Mirror of :mod:`repro.core.registry`.  Every backend registers a
:class:`BackendSpec` (capability record, SS6 memory-operation cost model
split into per-sequence *setup* and per-row *stream* terms, tile
candidates); :func:`select_plan` ranks the eligible (backend, tile)
candidates by modeled cost and caches the winning :class:`Plan` per
problem in this process.

:class:`Problem.platform` is the device type of the target tensor
(``"cuda"`` or ``"cpu"``), never a global probe.  The CUDA kernels
(``cuda_wave``, ``cuda_mxu``, ``cuda_batched``) are priced like the
reference's Pallas kernels: their plain versions stay eligible on the
CPU with a large penalty, so ``auto`` picks them only on the card.  The
mirror image holds on the card: the plain PyTorch backends are eager
step loops there, priced with the same penalty, so ``auto`` plans them
on ``"cuda"`` only where no kernel is eligible (float64).  The tile
factors of ``cuda_mxu`` are one ``cuda_batched`` launch a band, priced
at that kernel's measured plane rate.

``cuda_batched`` (one fused launch per serving bucket) is priced by the
reference's formula for ``rotseq_batched``, with flops on the *live*
planes only (``Problem.live_planes``): identity padding from ``pad_to``
and ``seq.T`` staircases is skipped, not multiplied through.

On the card the two row-parallel kernels (``cuda_wave``, ``cuda_batched``)
are far from the flop roofline, so there each is also priced by its
plane rate measured on an H100, by dtype (:data:`_WAVE_PLANE_SECONDS`,
:data:`_BATCHED_PLANE_SECONDS`: a half plane rounds seven times, and the
two kernels' half bodies round them differently fast): one lane walks a
row's planes in order
(``cuda_wave`` splits them over the warps of its band pipeline), so a
launch takes the planes of one chain times the time of one, for as many
rows as the card runs at once (:data:`repro_torch.hw.RESIDENT_ROWS`).

Measured autotune (``select_plan(..., autotune=True)``) times the top
modeled plans on the problem's own platform (CUDA events on the card) and
caches the fastest as ``source="measured"``; measured plans persist to a
JSON store keyed by the torch/CUDA build (:func:`save_plan_cache`,
:func:`load_plan_cache`) and lend their decision to unmeasured shapes of
the same class nearby (cross-shape interpolation).  With
:mod:`repro_torch.obs` on, :func:`select_plan` counts
``registry.plan_cache.{hits,misses,interpolated,autotune_upgrade}`` and
opens a ``resolve`` span on a miss, as the reference does;
:func:`plan_cache_stats` stays.  The cost model and the plan key read no
clock: only autotune's measurements do, through
:mod:`repro_torch.obs.timing`.

A sharded problem (``Problem.sharded``, ``devices`` shards, planned by
:mod:`repro_torch.dist`) is eligible only for backends with
``Capability.supports_sharding``; its per-row stream terms divide by the
shard count, its per-sequence setup terms do not, and a communication
term (the wave panels' broadcast over ``Hardware.link_bw`` plus
``ceil(log2 D)`` link hops) is added, as in the reference.  Its plan
key carries ``("sharded", devices)``: every shard count is a class of
its own, never measured, persisted or interpolated.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.hw import PLATFORMS, RESIDENT_ROWS, Hardware
from repro_torch.kernels.limits import (MXU_HALF_CHUNK, MXU_HALF_CLUSTER,
                                        MXU_HALF_ROWS, MXU_ROWS, MXU_SLAB,
                                        WAVE_KB, WAVE_WARPS, mxu_width)

__all__ = [
    "Hardware", "PLATFORMS", "Problem", "Plan", "Capability", "BackendSpec",
    "register", "get_backend", "registered_methods", "eligible_backends",
    "no_tiles", "blocked_tiles", "accumulated_tiles",
    "cuda_wave_tiles", "cuda_mxu_tiles",
    "cost_unoptimized", "cost_wavefront", "cost_blocked",
    "cost_accumulated", "cost_cuda_wave", "cost_cuda_mxu",
    "cost_cuda_batched",
    "select_plan", "plan_cache_stats", "clear_plan_cache",
    "cost_components", "plan_cache_path", "save_plan_cache",
    "load_plan_cache", "dtype_name",
]

# A CUDA kernel asked for off the card runs its plain version, orders of
# magnitude slower; it stays eligible there but carries this penalty, so
# "auto" never picks it while an explicit method name still works.  The
# plain backends carry the same penalty on the card, where they are eager
# step loops of small launches.
_OFF_DEVICE_PENALTY = 1e3

# One slab of the accumulated kernel on the card (csrc/rotseq_mxu.cu): a
# block of MXU_ROWS rows walks bands x tiles x slabs of MXU_SLAB rows of
# Q_t at a padded width WP (limits.mxu_width).  At m = n = 3840, k = 180
# its launches took 1.016 ms at n_b = k_b = 128 (WP = 256, 2 * 31 * 8
# slabs a block) and 1.049 ms at 64/64 (WP = 128, 3 * 61 * 4 slabs),
# 120 blocks on 132 SMs (chip_smoke.py's rotseq_mxu line, NVIDIA H100
# 80GB HBM3, 700 W): a slab takes a + b * WP seconds, fitted at those two.
_MXU_SLAB_SECONDS = (0.817e-6, 4.81e-9)
_SMS = 132
# One chunk of the accumulated kernel's half tier on the card
# (csrc/rotseq_mxu_half.cu, wgmma): a block of MXU_HALF_ROWS rows walks
# bands x tiles chain steps, each ceil(n_b / MXU_HALF_CHUNK) +
# ceil(k_b / MXU_HALF_CHUNK) chunks of Q_t at a padded width WP.  At
# m = n = 3840, k = 180 its launches took, bf16 / f16, 0.2243 / 0.2203 ms
# at n_b = k_b = 128 (WP = 256, 2 * 31 * 4 chunks a block) and 0.3070 /
# 0.3100 ms at 64/64 (WP = 128, 3 * 61 * 2 chunks), 60 blocks on 132 SMs
# (chip_smoke.py's rotseq_mxu_half line, NVIDIA H100 80GB HBM3, 700.00
# W): a chunk takes a + b * WP seconds, fitted at those two by dtype.
_MXU_HALF_CHUNK_SECONDS = {"bfloat16": (0.7728e-6, 0.5147e-9),
                           "float16": (0.8056e-6, 0.3236e-9)}
# Host time of one band of cuda_mxu's application (kernels/rotseq_mxu/
# ops.py: the factor panels, windows and identity target, the padded
# copy, two launches; some twenty PyTorch calls): the first band's is
# exposed before the card starts, and past the card's own work the host
# sets the pace.  In chip_smoke.py's rotseq_mxu line a band's factors
# took 0.29-0.37 ms (factors_ms, paced by the host; same card).
_MXU_BAND_HOST_SECONDS = 0.35e-3

# Time of one plane of one row through each row-parallel kernel's
# application on the card.  cuda_batched: plan.apply at m = n = 3840,
# k = 180 (3839 * 180 planes a row, 3840 rows) took 6.62 ms (bands of 16
# waves, 64 threads a block), measured by chip_smoke.py's main_path phase
# on an NVIDIA H100 80GB HBM3 at 700 W.  cuda_wave runs the 12 bands of a
# row group (the last padded to 16 waves) on 12 warps at once, so at that
# shape a warp's chain is 3839 * 192 / 12 planes and the row groups need
# 3840 * 12 / 32 warps, 2.7 times the card's resident ones; its one
# launch took 1.66 ms there (chip_smoke.py's rotseq_wave phase, same
# card), and the roofline term the model adds (0.30 ms) stands for the
# transposes around it (plan.apply measured 1.95 ms).  Each rate is
# fitted at that one shape and was checked on the card only there, at
# one 1024 x 1024 target and at the 16-request serving bucket; the
# queueing past the card's resident rows and the per-request loop of
# wavefront launches are extrapolated.
# In bfloat16 and float16 each plane rounds each product and sum to the
# half type (csrc/half_store.cuh).  cuda_batched's half rates are the same
# plan.apply at the paper shape in each dtype, 9.425 ms in bfloat16 and
# 14.345 ms in float16, measured by chip_smoke.py's rotseq_batched_half
# line (paper_apply_ms) on an NVIDIA H100 80GB HBM3 at 700.00 W; they
# price cuda_mxu's half factor builds too (one half rotseq_batched launch
# a band).  cuda_wave's are its one launch at that shape, 1.680 ms in
# bfloat16 and 2.027 ms in float16 (tools/wave_half_ab.py, the same card
# and limit; chip_smoke.py's rotseq_wave_half line prints the rate its
# own launch implies, paper_plane_seconds).
_WAVE_CHAIN = 3839 * 192 / 12 * (3840 * 12 / RESIDENT_ROWS["cuda"])
_WAVE_PLANE_SECONDS = {"float32": 1.66e-3 / _WAVE_CHAIN,
                       "bfloat16": 1.680e-3 / _WAVE_CHAIN,
                       "float16": 2.027e-3 / _WAVE_CHAIN}
_BATCHED_PLANE_SECONDS = {"float32": 6.62e-3 / (3839 * 180),
                          "bfloat16": 9.425e-3 / (3839 * 180),
                          "float16": 14.345e-3 / (3839 * 180)}


def _plane_seconds(rates: dict, dtype: str) -> float:
    """A row-parallel kernel's measured plane rate (``rates``, by dtype)
    for targets of ``dtype``: the float32 one for a dtype it was not
    measured in."""
    return rates.get(dtype, rates["float32"])


# --------------------------------------------------------------------------
# problem / plan records
# --------------------------------------------------------------------------

def dtype_name(dtype) -> str:
    """The name of a dtype-like, as the reference's ``str(jnp.dtype(x))``:
    ``torch.float32``, ``np.float32``, ``np.dtype("f4")`` and ``"f4"``
    all give ``"float32"``.  A string numpy does not know is taken as a
    torch dtype name (``"bfloat16"``)."""
    if isinstance(dtype, str):
        try:
            return np.dtype(dtype).name
        except TypeError:
            dtype = getattr(torch, dtype, dtype)
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


@dataclasses.dataclass(frozen=True)
class Problem:
    """Shape/dtype/platform key of one application ``A (m,n) <- k waves``.

    ``batch`` counts independent ``(m, n)`` targets of one call and
    ``shared_sequence`` whether they share one sequence (setup paid
    once) or carry one each (setup paid ``batch`` times).
    """
    m: int
    n: int
    k: int
    dtype: str = "float32"
    platform: str = "cuda"
    signs: bool = False    # needs per-entry G support
    batch: int = 1
    shared_sequence: bool = True
    # live (non-identity) planes of one sequence's (n-1, k) grid when
    # known (RotationSequence.k_live): pad_to tails and seq.T staircases
    # make the live share small, which only the plane-skipping backend
    # (cuda_batched) turns into less work
    live_planes: Optional[int] = None
    # a row-sharded execution over ``devices`` shards (repro_torch.dist):
    # the shape fields stay global; the cost models divide the per-row
    # terms by ``devices`` and add the communication term
    sharded: bool = False
    devices: int = 1

    @property
    def itemsize(self) -> int:
        return {"float64": 8, "float32": 4, "bfloat16": 2,
                "float16": 2}.get(self.dtype, 4)

    @property
    def m_total(self) -> int:
        """Total rows streamed per application (``batch * m``)."""
        return self.m * max(1, self.batch)

    @property
    def sequences(self) -> int:
        """Distinct rotation sequences the application pays setup for."""
        if self.batch <= 1 or self.shared_sequence:
            return 1
        return self.batch

    @property
    def planes_total(self) -> int:
        """Planes of the full (n-1, k) grid, identity padding included."""
        return max(0, self.n - 1) * self.k

    @property
    def planes_live(self) -> int:
        """Known live planes (the full grid when unknown)."""
        if self.live_planes is None:
            return self.planes_total
        return min(self.live_planes, self.planes_total)

    @property
    def hardware(self) -> Hardware:
        return PLATFORMS.get(self.platform, PLATFORMS["cpu"])


@dataclasses.dataclass(frozen=True)
class Plan:
    """A dispatch decision: backend + tile parameters (+ model cost)."""
    method: str
    n_b: Optional[int] = None
    k_b: Optional[int] = None
    est_seconds: float = float("inf")
    source: str = "model"

    def kwargs(self) -> dict:
        kw = {}
        if self.n_b is not None:
            kw["n_b"] = self.n_b
        if self.k_b is not None:
            kw["k_b"] = self.k_b
        return kw


@dataclasses.dataclass(frozen=True)
class Capability:
    """What a backend can run; consulted before costing it."""
    dtypes: Tuple[str, ...] = ("float32", "bfloat16", "float64", "float16")
    platforms: Tuple[str, ...] = ("cpu", "cuda")
    supports_signs: bool = True       # per-entry G (mixed rot/reflector)
    # runs on one row shard of a repro_torch.dist plan
    supports_sharding: bool = False
    tile_min: Tuple[int, int] = (1, 1)
    tile_max: Tuple[int, int] = (4096, 4096)
    # a CUDA kernel whose plain version runs (penalised) on other devices
    needs_kernel: bool = False
    # per-request batches (apply_batched with sequences=): mapped with
    # torch.func.vmap when True, looped per element when False
    supports_vmap: bool = True
    # batched execution: "flatten" runs a shared-sequence batch (b, m, n)
    # as one (b*m, n) problem (rotations act row-wise); "vmap" maps the
    # backend over the batch; "fused" takes the whole batch with shared
    # (n-1, K) or stacked (b, n-1, K) waves in one launch
    batch_via: str = "flatten"


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    name: str
    fn: Callable                       # (A, C, S, *, reflect, G, **plan_kw)
    capability: Capability
    cost: Callable[[Problem, Plan], float]
    candidates: Callable[[Problem], List[Plan]]
    doc: str = ""


_REGISTRY: Dict[str, BackendSpec] = {}


def register(spec: BackendSpec) -> BackendSpec:
    """Register (or replace) a backend spec under ``spec.name``."""
    _REGISTRY[spec.name] = spec
    return spec


def get_backend(name: str) -> BackendSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown method {name!r}; one of {registered_methods()} "
            f"(or 'auto')") from None


def registered_methods() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def eligible_backends(problem: Problem) -> List[BackendSpec]:
    """Backends whose capability record admits ``problem``."""
    out = []
    for spec in _REGISTRY.values():
        cap = spec.capability
        if problem.dtype not in cap.dtypes:
            continue
        if problem.platform not in cap.platforms and not cap.needs_kernel:
            continue
        if problem.signs and not cap.supports_signs:
            continue
        if problem.sharded and not cap.supports_sharding:
            continue
        out.append(spec)
    return out


# --------------------------------------------------------------------------
# cost models (paper SS6 memory-operation analysis)
# --------------------------------------------------------------------------

def _bands(k: int, k_b: int) -> int:
    return max(1, math.ceil(k / max(1, k_b)))


# latency floor keeps tiny problems from reading as free
_LATENCY_FLOOR = 2e-6


def _roofline_seconds(flop_term: float, byte_term: float) -> float:
    return max(flop_term, byte_term, _LATENCY_FLOOR)


def _eager_factor(p: Problem) -> float:
    """The plain backends on the card are eager step loops, not kernels."""
    return _OFF_DEVICE_PENALTY if p.platform == "cuda" else 1.0


_ZERO_SPLIT = {"setup_flops": 0.0, "setup_bytes": 0.0,
               "stream_flops": 0.0, "stream_bytes": 0.0}


def _split(setup_flops=0.0, setup_bytes=0.0,
           stream_flops=0.0, stream_bytes=0.0) -> Dict[str, float]:
    return {"setup_flops": float(setup_flops),
            "setup_bytes": float(setup_bytes),
            "stream_flops": float(stream_flops),
            "stream_bytes": float(stream_bytes)}


# Row shards are independent (rotations act on column pairs), so the only
# wire traffic of a row-sharded application is the C/S/G wave panels sent
# from the source shard to the others, a setup-side cost.  A hop latency
# keeps small sharded problems from reading as free: a broadcast to D
# shards takes ceil(log2 D) link round trips whatever its payload.
_LINK_HOP_LATENCY = 5e-6


def _comm_components(p: Problem) -> Dict[str, float]:
    """Wire traffic and seconds of one sharded application (zero at one
    device): three ``(n-1, k)`` panels a distinct sequence, ``devices -
    1`` copies, over ``Hardware.link_bw`` plus the hops' latency."""
    D = max(1, p.devices)
    if not p.sharded or D <= 1:
        return {"setup_bytes": 0.0, "stream_bytes": 0.0, "bytes": 0.0,
                "hops": 0.0, "seconds": 0.0}
    setup_bytes = 3.0 * p.sequences * p.planes_total * p.itemsize * (D - 1)
    hops = float(math.ceil(math.log2(D)))
    secs = setup_bytes / p.hardware.link_bw + hops * _LINK_HOP_LATENCY
    return {"setup_bytes": setup_bytes, "stream_bytes": 0.0,
            "bytes": setup_bytes, "hops": hops, "seconds": secs}


def _dist_terms(p: Problem) -> Tuple[float, float]:
    """``(stream_divisor, comm_seconds)``: each shard streams ``1/D`` of
    the rows, every shard pays the whole setup, and the communication
    seconds add to the per-shard time."""
    D = max(1, p.devices)
    if not p.sharded or D <= 1:
        return 1.0, 0.0
    return float(D), _comm_components(p)["seconds"]


def _components_unoptimized(p: Problem, plan: Plan) -> Dict[str, float]:
    return _split(stream_flops=6.0 * p.m_total * p.n * p.k,
                  stream_bytes=4.0 * p.m_total * p.n * p.k * p.itemsize)


def cost_unoptimized(p: Problem, plan: Plan) -> float:
    """Alg 1.2: 4 memops per rotation, no reuse (paper SS6 baseline)."""
    hw = p.hardware
    c = _components_unoptimized(p, plan)
    D, comm_s = _dist_terms(p)
    return _roofline_seconds(
        c["stream_flops"] / hw.vpu_flops / D,
        c["stream_bytes"] / hw.hbm_bw / D) * _eager_factor(p) + comm_s


def _components_wavefront(p: Problem, plan: Plan) -> Dict[str, float]:
    return _split(stream_flops=6.0 * p.m_total * p.n * p.k,
                  stream_bytes=2.0 * p.m_total * p.n * p.k * p.itemsize)


def cost_wavefront(p: Problem, plan: Plan) -> float:
    """Alg 1.3: wavefront fuses column touches to ~2 memops/rotation."""
    hw = p.hardware
    c = _components_wavefront(p, plan)
    D, comm_s = _dist_terms(p)
    return _roofline_seconds(
        c["stream_flops"] / hw.vpu_flops / D,
        c["stream_bytes"] / hw.hbm_bw / D) * _eager_factor(p) + comm_s


def _tile_grid(p: Problem, n_b: int, k_b: int) -> Tuple[int, int, int]:
    """``(bands, tiles, w)`` of the sheared-tile decomposition (SS5)."""
    w = n_b + k_b
    bands = _bands(p.k, k_b)
    tiles = max(1, math.ceil((p.n + k_b - 1) / n_b))
    return bands, tiles, w


def _pack_bytes(p: Problem, n_b: int, k_b: int) -> float:
    """Per-sequence sheared-tile packing traffic (blocked/accumulated)."""
    bands, tiles, w = _tile_grid(p, n_b, k_b)
    arrays = 3 if p.signs else 2
    read = arrays * p.planes_total
    write = arrays * bands * tiles * w * k_b
    return (read + write) * p.itemsize


def _components_blocked(p: Problem, plan: Plan) -> Dict[str, float]:
    n_b = plan.n_b or 64
    k_b = plan.k_b or 16
    return _split(
        setup_bytes=p.sequences * _pack_bytes(p, n_b, k_b),
        stream_flops=6.0 * p.m_total * p.n * p.k,
        stream_bytes=2.0 * p.m_total * p.n * p.itemsize * _bands(p.k, k_b))


def _blocked_seconds(p: Problem, plan: Plan) -> float:
    """One shard's roofline seconds (no communication)."""
    hw = p.hardware
    c = _components_blocked(p, plan)
    D, _ = _dist_terms(p)
    return _roofline_seconds(
        c["stream_flops"] / hw.vpu_flops / D,
        (c["setup_bytes"] + c["stream_bytes"] / D) / hw.hbm_bw)


def cost_blocked(p: Problem, plan: Plan) -> float:
    """Blocked wavefront: A streams once per band of k_b waves (SS5)."""
    return _blocked_seconds(p, plan) * _eager_factor(p) + _dist_terms(p)[1]


def _accumulated_flops(p: Problem, n_b: int, k_b: int) -> Tuple[float, float]:
    """(GEMM sweep flops, per-sequence factor accumulation flops)."""
    w = n_b + k_b
    bands, tiles, _ = _tile_grid(p, n_b, k_b)
    sweep = bands * tiles * 2.0 * p.m_total * w * w      # (m,w) @ (w,w)
    accum = bands * tiles * 6.0 * w * n_b * k_b          # Q_t = I rotated
    return sweep, accum


def _components_accumulated(p: Problem, plan: Plan) -> Dict[str, float]:
    n_b = plan.n_b or 128
    k_b = plan.k_b or 128
    sweep, accum = _accumulated_flops(p, n_b, k_b)
    bands, tiles, w = _tile_grid(p, n_b, k_b)
    q_bytes = bands * tiles * w * w * p.itemsize  # Q_t factors written
    return _split(
        setup_flops=p.sequences * accum,
        setup_bytes=p.sequences * (_pack_bytes(p, n_b, k_b) + q_bytes),
        stream_flops=sweep,
        stream_bytes=2.0 * p.m_total * p.n * p.itemsize * _bands(p.k, k_b))


def _accumulated_seconds(p: Problem, plan: Plan) -> float:
    """One shard's roofline seconds (no communication)."""
    hw = p.hardware
    c = _components_accumulated(p, plan)
    D, _ = _dist_terms(p)
    flop_term = (c["stream_flops"] / hw.mxu_flops / D
                 + c["setup_flops"] / hw.vpu_flops)
    return _roofline_seconds(
        flop_term, (c["setup_bytes"] + c["stream_bytes"] / D) / hw.hbm_bw)


def cost_accumulated(p: Problem, plan: Plan) -> float:
    """rs_gemm: ~4/3 extra flops (n_b = k_b) priced at the GEMM rate."""
    return (_accumulated_seconds(p, plan) * _eager_factor(p)
            + _dist_terms(p)[1])


def _off_device_factor(p: Problem) -> float:
    return 1.0 if p.platform == "cuda" else _OFF_DEVICE_PENALTY


def _row_chain_seconds(planes: int, rows: int,
                       plane_seconds: float) -> float:
    """A row-parallel kernel on the card: ``planes`` in order on each
    row, ``rows`` rows, as many at once as the card holds; past that,
    rows queue."""
    return plane_seconds * planes * max(1.0, rows / RESIDENT_ROWS["cuda"])


def cost_cuda_wave(p: Problem, plan: Plan) -> float:
    """Wavefront kernel: blocked-wavefront traffic, carry kept on chip.

    ``supports_vmap=False``: a per-request batch runs as separate
    launches, so the latency floor multiplies by the sequence count.  On
    the card each launch also costs its measured plane rate over its
    band pipeline: the padded bands of ``WAVE_KB`` waves run on
    ``min(WAVE_WARPS, bands)`` warps a row group, so each warp's chain is
    that share of a row's planes and the row groups need that many times
    the warps (the kernel has no plane skip).  The roofline term still
    orders the tiles.  A shard runs ``1/D`` of the rows; the
    communication seconds add outside the kernel's constants.
    """
    D, comm_s = _dist_terms(p)
    secs = 0.7 * _blocked_seconds(p, plan) * _off_device_factor(p)
    if p.platform == "cuda":
        rows = (p.m if p.sequences > 1 else p.m_total) / D
        bands = _bands(p.k, WAVE_KB)
        warps = max(1, min(WAVE_WARPS, bands))
        planes = max(0, p.n - 1) * bands * WAVE_KB
        secs += p.sequences * _row_chain_seconds(
            planes / warps, rows * warps,
            _plane_seconds(_WAVE_PLANE_SECONDS, p.dtype))
    return max(secs, p.sequences * _LATENCY_FLOOR) + comm_s


def _mxu_sweep_seconds(p: Problem, n_b: int, k_b: int) -> float:
    """The accumulated kernel's launches on the card: every block walks
    its bands' slabs at the measured slab time of its padded width, and
    blocks past one a streaming multiprocessor queue."""
    bands, tiles, w = _tile_grid(p, n_b, k_b)
    a, b = _MXU_SLAB_SECONDS
    slabs = bands * tiles * math.ceil(w / MXU_SLAB)
    rows = (p.m if p.sequences > 1 else p.m_total) / _dist_terms(p)[0]
    blocks = math.ceil(rows / MXU_ROWS)
    return (p.sequences * slabs * (a + b * mxu_width(w))
            * max(1.0, blocks / _SMS))


def _mxu_half_sweep_seconds(p: Problem, n_b: int, k_b: int) -> float:
    """The half tier's launches on the card: every block walks its bands'
    tiles, chunk by chunk, at the measured chunk time of its dtype and
    padded width (:data:`_MXU_HALF_CHUNK_SECONDS`), and blocks past one
    a streaming multiprocessor queue."""
    bands, tiles, w = _tile_grid(p, n_b, k_b)
    a, b = _MXU_HALF_CHUNK_SECONDS[p.dtype]
    chunks = math.ceil(n_b / MXU_HALF_CHUNK) + math.ceil(k_b / MXU_HALF_CHUNK)
    rows = (p.m if p.sequences > 1 else p.m_total) / _dist_terms(p)[0]
    blocks = math.ceil(math.ceil(rows / MXU_HALF_ROWS) / MXU_HALF_CLUSTER)
    blocks *= MXU_HALF_CLUSTER
    return (p.sequences * bands * tiles * chunks * (a + b * mxu_width(w))
            * max(1.0, blocks / _SMS))


def cost_cuda_mxu(p: Problem, plan: Plan) -> float:
    """Accumulated kernel: accumulated-path traffic at fused constants.

    On the card the GEMM sweep is priced by the kernel's measured slab
    time (:data:`_MXU_SLAB_SECONDS`), plus the padded copy of the target
    that feeds each band; in bfloat16 and float16 (the tensor-core tier)
    by its measured chunk time in that dtype
    (:data:`_MXU_HALF_CHUNK_SECONDS`), plus the same copy.  Each band's
    tile factors are one ``cuda_batched`` launch over ``T`` identity
    targets of ``w`` rows with ``n_b * k_b`` live planes each, at that
    kernel's measured plane rate, plus the packing traffic; they are
    paid once per sequence.
    The host's calls for each band (:data:`_MXU_BAND_HOST_SECONDS`) set
    the pace where the card's work is shorter.  Off the card the
    reference's formula holds.  A shard sweeps ``1/D`` of the rows and
    builds every factor; the communication seconds add outside.
    """
    D, comm_s = _dist_terms(p)
    if p.platform != "cuda":
        return max(0.7 * _accumulated_seconds(p, plan) * _OFF_DEVICE_PENALTY,
                   p.sequences * _LATENCY_FLOOR) + comm_s
    hw = p.hardware
    n_b, k_b = plan.n_b or 128, plan.k_b or 128
    c = _components_accumulated(p, plan)
    bands, tiles, w = _tile_grid(p, n_b, k_b)
    # the half tier (bfloat16, float16) runs its products on the tensor
    # cores: its own measured chunk time, not the float32 tier's slab fit
    sweep = (_mxu_half_sweep_seconds(p, n_b, k_b) if p.itemsize == 2
             else _mxu_sweep_seconds(p, n_b, k_b))
    sweep += c["stream_bytes"] / D / hw.hbm_bw
    rate = _plane_seconds(_BATCHED_PLANE_SECONDS, p.dtype)
    factors = (bands * _row_chain_seconds(n_b * k_b, tiles * w, rate)
               + c["setup_bytes"] / p.sequences / hw.hbm_bw)
    device = sweep + p.sequences * factors + _MXU_BAND_HOST_SECONDS
    host = p.sequences * bands * _MXU_BAND_HOST_SECONDS
    return max(device, host, p.sequences * _LATENCY_FLOOR) + comm_s


def _components_cuda_batched(p: Problem, plan: Plan) -> Dict[str, float]:
    # the c/s/g panels stream once per batch element (shared or not);
    # targets stream once; flops only on the live planes
    return _split(
        setup_bytes=3.0 * max(1, p.batch) * p.planes_total * p.itemsize,
        stream_flops=6.0 * p.m_total * p.planes_live,
        stream_bytes=2.0 * p.m_total * p.n * p.itemsize)


def cost_cuda_batched(p: Problem, plan: Plan) -> float:
    """Fused batched kernel: every target through memory once, one launch.

    The reference's ``rotseq_batched`` formula at the card's rates: the
    flop term counts live planes only, and one latency floor covers the
    whole batch.  On the card the launch takes at least its measured
    plane rate over each row's live planes, all requests' rows at once.
    A shard streams ``1/D`` of the rows and reads every panel; the
    communication seconds add outside.
    """
    hw = p.hardware
    c = _components_cuda_batched(p, plan)
    D, comm_s = _dist_terms(p)
    secs = _roofline_seconds(
        c["stream_flops"] / hw.vpu_flops / D,
        (c["setup_bytes"] + c["stream_bytes"] / D) / hw.hbm_bw)
    secs *= _off_device_factor(p)
    if p.platform == "cuda":
        rate = _plane_seconds(_BATCHED_PLANE_SECONDS, p.dtype)
        secs = max(secs, _row_chain_seconds(p.planes_live, p.m_total / D,
                                            rate))
    return max(secs, _LATENCY_FLOOR) + comm_s


# the setup/stream traffic split behind each cost model (the kernels move
# blocked / accumulated traffic; only their seconds constant differs)
_COMPONENT_FNS: Dict[str, Callable[[Problem, Plan], Dict[str, float]]] = {
    "unoptimized": _components_unoptimized,
    "wavefront": _components_wavefront,
    "blocked": _components_blocked,
    "accumulated": _components_accumulated,
    "cuda_wave": _components_blocked,
    "cuda_mxu": _components_accumulated,
    "cuda_batched": _components_cuda_batched,
}

# stream flops run at the GEMM rate for the GEMM family
_MXU_STREAM = ("accumulated", "cuda_mxu")


def cost_components(method: str, problem: Problem,
                    plan: Optional[Plan] = None) -> dict:
    """Predicted traffic + seconds for one dispatch, split by term.

    Returns ``{"flops", "bytes", "seconds", "setup": {...},
    "stream": {...}, "comm": {...}}``: the summed SS6 analysis of the
    named backend, the registered cost model's seconds (what
    ``select_plan`` ranked by), the per-sequence vs per-row split with
    penalty-free attribution seconds (the stream's a shard's: divided by
    the shard count of a sharded problem), and the communication term
    (bytes, link hops, seconds; zero unless sharded over more than one
    device).
    """
    spec = get_backend(method)
    plan = plan if plan is not None else Plan(method=method)
    comp_fn = _COMPONENT_FNS.get(method)
    c = comp_fn(problem, plan) if comp_fn is not None else _ZERO_SPLIT
    hw = problem.hardware
    D, _ = _dist_terms(problem)
    comm = _comm_components(problem)
    stream_rate = hw.mxu_flops if method in _MXU_STREAM else hw.vpu_flops
    setup_s = (c["setup_flops"] / hw.vpu_flops
               + c["setup_bytes"] / hw.hbm_bw)
    stream_s = (c["stream_flops"] / stream_rate
                + c["stream_bytes"] / hw.hbm_bw) / D
    return {
        "flops": float(c["setup_flops"] + c["stream_flops"]),
        "bytes": float(c["setup_bytes"] + c["stream_bytes"]),
        "seconds": float(spec.cost(problem, plan)),
        "setup": {"flops": float(c["setup_flops"]),
                  "bytes": float(c["setup_bytes"]),
                  "seconds": float(setup_s)},
        "stream": {"flops": float(c["stream_flops"]),
                   "bytes": float(c["stream_bytes"]),
                   "seconds": float(stream_s)},
        "comm": {"bytes": float(comm["bytes"]),
                 "hops": float(comm["hops"]),
                 "seconds": float(comm["seconds"])},
    }


# --------------------------------------------------------------------------
# tile candidate grids
# --------------------------------------------------------------------------

def _clip_pairs(p: Problem, pairs, cap: Capability) -> List[Tuple[int, int]]:
    lo_n, lo_k = cap.tile_min
    hi_n, hi_k = cap.tile_max
    seen, out = set(), []
    for n_b, k_b in pairs:
        n_b = max(lo_n, min(n_b, hi_n, max(8, p.n)))
        k_b = max(lo_k, min(k_b, hi_k, max(1, p.k)))
        if (n_b, k_b) not in seen:
            seen.add((n_b, k_b))
            out.append((n_b, k_b))
    return out


def no_tiles(p: Problem) -> List[Plan]:
    return [Plan(method="", n_b=None, k_b=None)]


def blocked_tiles(p: Problem) -> List[Plan]:
    pairs = [(64, 16), (32, 8), (16, 8), (8, 4), (64, 2)]
    cap = get_backend("blocked").capability
    return [Plan("", n_b=a, k_b=b) for a, b in _clip_pairs(p, pairs, cap)]


def accumulated_tiles(p: Problem) -> List[Plan]:
    pairs = [(128, 128), (96, 96), (64, 64), (32, 32), (16, 16), (8, 8),
             (64, 16)]
    cap = get_backend("accumulated").capability
    return [Plan("", n_b=a, k_b=b) for a, b in _clip_pairs(p, pairs, cap)]


def cuda_wave_tiles(p: Problem) -> List[Plan]:
    # the band the kernel is compiled for; it has no column tiles
    return [Plan("", k_b=WAVE_KB)]


def cuda_mxu_tiles(p: Problem) -> List[Plan]:
    cap = get_backend("cuda_mxu").capability
    pairs = _clip_pairs(p, [(128, 128), (64, 64), (8, 8)], cap)
    return [Plan("", n_b=a, k_b=b) for a, b in pairs]


# --------------------------------------------------------------------------
# plan selection + in-process cache
# --------------------------------------------------------------------------

_PLAN_CACHE: Dict[tuple, Plan] = {}
_CACHE_STATS = {"hits": 0, "misses": 0}
# plan sources that come from a measurement on this torch/CUDA build: the
# ones written to disk, lent to nearby shapes and taken by autotune as is
_PERSISTED_SOURCES = ("measured", "persisted")


def plan_cache_stats() -> dict:
    return dict(_CACHE_STATS, size=len(_PLAN_CACHE))


def clear_plan_cache() -> None:
    _PLAN_CACHE.clear()
    _CACHE_STATS["hits"] = _CACHE_STATS["misses"] = 0


def _plan_key(problem: Problem) -> tuple:
    """``(m, n, k, dtype, platform, signs, batch, shared_sequence)``, plus
    ``("sharded", devices)`` for a sharded problem and ``("live",
    live_planes)`` when the live planes are known."""
    key = (problem.m, problem.n, problem.k, problem.dtype,
           problem.platform, problem.signs, problem.batch,
           problem.shared_sequence)
    if problem.sharded:
        # a sharded decision never transfers to another shard count or
        # to the one-device problem of the same shape
        key = key + (("sharded", max(1, problem.devices)),)
    if problem.live_planes is not None:
        # liveness changes which backend wins: a thin staircase must not
        # share an entry with the dense grid of the same shape
        key = key + ("live", problem.live_planes)
    return key


def _split_key(key: tuple):
    """Decode a :func:`_plan_key`: ``((m, n, k, batch), class,
    live_fraction)``.

    ``class`` is ``(dtype, platform, signs, shared_sequence)``, with the
    ``("sharded", devices)`` slot appended for a sharded key: a shared
    sequence and one sequence a request are distinct classes, as every
    shard count is, and as dense and live-annotated keys are
    (``live_fraction`` is ``None`` for a dense key, else the live planes
    over ``(n-1) * k``).  Raises ``ValueError`` for a tuple of another
    layout (the reference's, say).
    """
    rest = key[8:]
    shard = ()
    if rest and isinstance(rest[0], tuple) and len(rest[0]) == 2 \
            and rest[0][0] == "sharded":
        shard, rest = (rest[0],), rest[1:]
    if len(key) < 8 or (rest and (len(rest) != 2 or rest[0] != "live")):
        raise ValueError(f"not a plan key of this package: {key!r}")
    m, n, k, dtype, platform, signs, batch, shared = key[:8]
    frac = None
    if rest:
        frac = max(1, int(rest[1])) / max(1, (n - 1) * k)
    return (m, n, k, batch), (dtype, platform, signs, shared) + shard, frac


def _modeled_plans(problem: Problem) -> List[Plan]:
    """All eligible (backend, tile) plans, costed and sorted ascending.

    Ties (problems at the latency floor) break on total modeled traffic.
    """
    plans: List[Plan] = []
    for spec in eligible_backends(problem):
        for cand in spec.candidates(problem):
            plan = dataclasses.replace(cand, method=spec.name)
            plans.append(dataclasses.replace(
                plan, est_seconds=spec.cost(problem, plan)))

    def _rank(pl: Plan):
        comp_fn = _COMPONENT_FNS.get(pl.method)
        if comp_fn is None:
            return (pl.est_seconds, float("inf"))
        c = comp_fn(problem, pl)
        return (pl.est_seconds, c["setup_bytes"] + c["stream_bytes"])

    plans.sort(key=_rank)
    return plans


# --------------------------------------------------------------------------
# cross-shape interpolation
# --------------------------------------------------------------------------

# Largest summed |log(m/m')| + |log(n/n')| + |log(k/k')| + |log(b/b')|
# (+ the live-fraction term) at which a measured plan still transfers:
# about 4x a dimension.  Further out the regime can differ (resident vs
# streaming, latency- vs issue-bound) and the cost model is the better
# guess.
_INTERP_MAX_LOGDIST = 3 * math.log(4.0)


def _interpolated_plan(problem: Problem, key: tuple) -> Optional[Plan]:
    """Borrow the nearest measured plan for an unmeasured shape.

    The donor is a measured or persisted entry of the same class
    (:func:`_split_key`) whose backend this problem is eligible for,
    nearest by log-distance over ``(m, n, k, batch)`` (plus the
    live-fraction ratio between live-annotated keys) and within
    :data:`_INTERP_MAX_LOGDIST`.  The borrowed plan keeps the donor's
    backend and tiles, is re-costed by the model for this problem, and
    is marked ``source="interpolated"``: never persisted, upgraded in
    place by a later ``autotune=True`` call.  A sharded problem borrows
    nothing.
    """
    if problem.sharded:
        return None
    eligible = {spec.name for spec in eligible_backends(problem)}
    best: Optional[Plan] = None
    best_dist = _INTERP_MAX_LOGDIST
    (m1, n1, k1, b1), cls1, frac1 = _split_key(key)
    for cached_key, plan in _PLAN_CACHE.items():
        if plan.source not in _PERSISTED_SOURCES:
            continue
        (m2, n2, k2, b2), cls2, frac2 = _split_key(cached_key)
        if cls2 != cls1 or (frac2 is None) != (frac1 is None):
            continue
        if plan.method not in eligible or min(m2, n2, k2, b2) < 1:
            continue
        dist = (abs(math.log(m1 / m2)) + abs(math.log(n1 / n2))
                + abs(math.log(k1 / k2)) + abs(math.log(b1 / b2)))
        if frac1 is not None:
            dist += abs(math.log(frac1 / frac2))
        if dist < best_dist:
            best, best_dist = plan, dist
    if best is None:
        return None
    # the donor's measured time belongs to the donor's shape
    borrowed = dataclasses.replace(best, source="interpolated")
    return dataclasses.replace(
        borrowed, est_seconds=get_backend(best.method).cost(problem,
                                                            borrowed))


# --------------------------------------------------------------------------
# measured autotune
# --------------------------------------------------------------------------

def _can_measure(platform: str) -> bool:
    """Whether this process can time a problem of ``platform``: the host
    always, the card only where there is one."""
    return platform == "cpu" or (platform == "cuda"
                                 and torch.cuda.is_available())


def _priced_off_device(method: str, platform: str) -> bool:
    """Whether ``method`` carries :data:`_OFF_DEVICE_PENALTY` on
    ``platform``: a CUDA kernel off the card, a plain backend on it."""
    return get_backend(method).capability.needs_kernel != (platform
                                                           == "cuda")


def _synthetic_waves(problem: Problem, rng):
    """One ``(C, S, G)`` float64 numpy draw matching the problem record.

    Drawn exactly as the reference draws it, so the same generator gives
    the same waves bit for bit.  ``problem.signs`` adds a per-entry sign
    grid, so sign-carrying plans are timed on the path they will serve;
    a ``live_planes`` bound identity-pads the trailing waves, so the
    plane-skipping backend is timed on about the live grid it will run.
    """
    th = rng.standard_normal((problem.n - 1, problem.k))
    Cn, Sn = np.cos(th), np.sin(th)
    if problem.live_planes is not None \
            and problem.live_planes < problem.planes_total:
        live_waves = math.ceil(problem.live_planes
                               / max(1, problem.n - 1))
        Cn[:, live_waves:] = 1.0
        Sn[:, live_waves:] = 0.0
    Gn = None
    if problem.signs:
        Gn = np.where(rng.random((problem.n - 1, problem.k)) < 0.5,
                      1.0, -1.0)
        # identity padding stays a rotation (a padded reflector is live)
        Gn[(Cn == 1.0) & (Sn == 0.0)] = -1.0
    return Cn, Sn, Gn


# Autotune times its candidates in turns, one call of each a round, for
# at least _MEASURE_MIN_ROUNDS rounds (the reference's two calls) and
# this many seconds a candidate in all (at most _MEASURE_MAX_ROUNDS
# rounds): a candidate of a fraction of a millisecond on the card is
# paced by its host work, which varies from spell to spell on a shared
# host, so candidates timed one after another, two calls each, can rank
# by the spell they fell in.
_MEASURE_SECONDS = 0.02
_MEASURE_MIN_ROUNDS = 2
_MEASURE_MAX_ROUNDS = 200
# A measured candidate replaces the model's pick only when it is faster
# by more than this factor.  At host-paced points the measurement does
# not resolve less: at the eig flush (1024, 1024, 32) on an NVIDIA H100
# 80GB HBM3 (700 W), autotune's cuda_mxu 64/32 over cuda_wave ratio and
# the same ratio timed alone through plan.apply just after differed by
# up to 0.3 (tools/autotune_flush.py), so a smaller gain picked a plan
# slower in use about as often as a faster one.  Timing the candidates
# through plan.apply, and for 0.25 s each instead of 20 ms, left the
# two ratios up to 0.23 apart in 38 trials: the ratio itself moves that
# much from one second to the next there.
_MEASURED_MARGIN = 1.10


# seconds of one call on the problem's device: CUDA events between two
# synchronizes on the card, the host clock elsewhere
_time_call = obs.timing.call_seconds


def _time_medians(fns: List[Callable],
                  device: torch.device) -> List[float]:
    """Median seconds of one call of each of ``fns``
    (:func:`_time_samples`)."""
    return [sorted(t)[len(t) // 2] for t in _time_samples(fns, device)]


def _time_samples(fns: List[Callable],
                  device: torch.device) -> List[List[float]]:
    """Seconds of each timed call of each of ``fns``, which were called
    once each already (the warm call): rounds of one call each, in a
    seeded random order a round (so no function always follows the same
    one, whose traffic leaves the caches in one state), at least
    :data:`_MEASURE_MIN_ROUNDS` rounds and more while the rounds took
    under :data:`_MEASURE_SECONDS` a function."""
    ts: List[List[float]] = [[] for _ in fns]
    order = np.random.default_rng(0)
    rounds = 0
    while rounds < _MEASURE_MIN_ROUNDS or (
            sum(map(sum, ts)) < _MEASURE_SECONDS * len(fns)
            and rounds < _MEASURE_MAX_ROUNDS):
        for i in order.permutation(len(fns)):
            ts[i].append(_time_call(fns[i], device))
        rounds += 1
    return ts


def _synthetic_workload(problem: Problem):
    """``(bind, device)``: the problem's synthetic inputs on its device,
    drawn once from ``default_rng(0)`` as the reference draws them for
    each candidate, and ``bind(plan)``, one application at ``plan``'s
    tiles.

    A shared-sequence batch runs flattened, as one ``(batch*m, n)``
    target, through ``SequencePlan.apply``: what a caller of the plan
    runs, its host packing (``cuda_mxu``'s factor calls) included.  A
    per-request batch runs ``batch`` distinct sequences through
    ``SequencePlan.apply_batched(A, sequences=..., direct=True)``: the
    route (fused launch, vmap or loop) and the per-sequence setup that
    serving pays.  The waves match the problem record
    (:func:`_synthetic_waves`).
    """
    # deferred: sequence.py imports this module
    from repro_torch.core import sequence as _sequence

    device = torch.device(problem.platform)
    dt = getattr(torch, problem.dtype)
    rng = np.random.default_rng(0)

    def put(x):
        return None if x is None else torch.from_numpy(x).to(device, dt)

    if problem.sequences > 1:
        A = put(rng.standard_normal((problem.batch, problem.m, problem.n)))
        seqs = []
        for _ in range(problem.batch):
            Cn, Sn, Gn = _synthetic_waves(problem, rng)
            seq = _sequence.RotationSequence(put(Cn), put(Sn), put(Gn))
            if problem.live_planes is not None:
                seq = dataclasses.replace(seq, k_live=min(
                    problem.live_planes, problem.planes_total))
            seqs.append(seq)

        def bind(plan: Plan) -> Callable:
            sp = _sequence.SequencePlan(
                seqs[0], plan.method, tuple(sorted(plan.kwargs().items())),
                plan)
            return lambda: sp.apply_batched(A, sequences=seqs, direct=True)
    else:
        A = put(rng.standard_normal((problem.m_total, problem.n)))
        seq = _sequence.RotationSequence(
            *(put(x) for x in _synthetic_waves(problem, rng)))

        def bind(plan: Plan) -> Callable:
            sp = _sequence.SequencePlan(
                seq, plan.method, tuple(sorted(plan.kwargs().items())),
                plan)
            return lambda: sp.apply(A)
    return bind, device


def _measure_plans(problem: Problem,
                   plans: List[Plan]) -> List[Optional[float]]:
    """Median seconds of one real application at each plan's tiles, the
    candidates timed in turns (:func:`_time_medians`) after one warm call
    each; ``None`` for a plan whose backend refused the arguments with
    ``ValueError`` on that warm call (its own checks, before a launch).
    Any other exception propagates."""
    bind, device = _synthetic_workload(problem)
    fns: List[Optional[Callable]] = []
    for plan in plans:
        fn = bind(plan)
        try:
            fn()
        except ValueError:
            fn = None
        fns.append(fn)
    timed = iter(_time_medians([fn for fn in fns if fn is not None],
                               device))
    return [None if fn is None else next(timed) for fn in fns]


def _autotune_candidates(problem: Problem, plans: List[Plan],
                         cached: Optional[Plan], top: int) -> List[Plan]:
    """The plans autotune measures: the top ``top`` modeled ones; for a
    per-request batch also the best plan of every other eligible backend
    that is not priced off its device; and an interpolated entry being
    upgraded."""
    candidates = plans[:max(1, top)]
    if problem.sequences > 1:
        seen = {pl.method for pl in candidates}
        for pl in plans:
            if pl.method not in seen \
                    and not _priced_off_device(pl.method, problem.platform):
                seen.add(pl.method)
                candidates.append(pl)
    if cached is not None and cached.source == "interpolated" and not any(
            (pl.method, pl.n_b, pl.k_b)
            == (cached.method, cached.n_b, cached.k_b) for pl in candidates):
        candidates.append(cached)
    return candidates


def select_plan(m: int, n: int, k: int, *, dtype: str = "float32",
                platform: str = "cuda", signs: bool = False,
                batch: int = 1, shared_sequence: bool = True,
                live_planes: Optional[int] = None, autotune: bool = False,
                autotune_top: int = 3, sharded: bool = False,
                devices: int = 1) -> Plan:
    """Pick ``(method, n_b, k_b)`` for a problem, with caching.

    Plans are cached per :func:`_plan_key`.  A miss first borrows the
    nearest measured plan of its class (:func:`_interpolated_plan`,
    ``source="interpolated"``), else ranks by the cost model
    (``source="model"``).

    ``autotune=True`` takes a measured or persisted entry as it is and
    otherwise measures: the top ``autotune_top`` modeled plans, an
    interpolated entry being upgraded, and for a per-request batch
    (``shared_sequence=False``) the best plan of each other eligible
    backend, timed through the batched route on ``batch`` distinct
    sequences (:func:`_measure_plans`).  The fastest is cached as
    ``source="measured"`` (reused by later plain calls) and written
    through :func:`save_plan_cache`.
    Measurement needs the problem's platform here (``"cpu"``, or
    ``"cuda"`` with a card); elsewhere ``autotune`` ranks by the model.
    ``devices`` is the shard count of a row-sharded execution
    (``devices > 1`` implies ``sharded``): only shard-capable backends
    are eligible, the communication term is priced, and the plan is
    ranked by the model alone (a shard's sub-problem is not measured
    standalone), cached in its own class and never persisted.

    Four port rules differ from the reference:

    * The candidates are timed in turns, one call of each a round, on
      inputs drawn once, not one candidate after another: on the card's
      shared host the spell a candidate fell in could rank it.

    * The per-request widening takes only backends that are not priced
      with :data:`_OFF_DEVICE_PENALTY` on the platform.  The penalised
      ones are eager step loops on the card (or a kernel's plain
      version on the host), seconds a call at a serving bucket, and
      cannot win.
    * A candidate is skipped only when its backend refuses the
      arguments with ``ValueError`` in its own checks, before a launch.
      Any other exception (a failed build or launch) propagates: a
      kernel fault never hands the pick to another backend.
    * The model's pick stays unless a measured candidate beats it by
      more than :data:`_MEASURED_MARGIN`: a smaller measured gain is
      inside what the measurement resolves at host-paced points.
    """
    dtype = dtype_name(dtype)
    batch = max(1, int(batch))
    devices = max(1, int(devices))
    sharded = bool(sharded) or devices > 1
    shared_sequence = bool(shared_sequence) or batch <= 1
    autotune = autotune and _can_measure(platform) and not sharded
    problem = Problem(m=m, n=n, k=k, dtype=dtype, platform=platform,
                      signs=signs, batch=batch,
                      shared_sequence=shared_sequence,
                      live_planes=live_planes, sharded=sharded,
                      devices=devices)
    key = _plan_key(problem)
    cached = _PLAN_CACHE.get(key)
    if cached is not None and (not autotune
                               or cached.source in _PERSISTED_SOURCES):
        _CACHE_STATS["hits"] += 1
        obs.inc("registry.plan_cache.hits")
        return cached
    _CACHE_STATS["misses"] += 1
    obs.inc("registry.plan_cache.misses")
    if n < 2 or k < 1 or m < 1:
        # zero rotations: application is a no-op
        best = Plan(method="blocked" if signs else "unoptimized",
                    est_seconds=0.0)
        _PLAN_CACHE[key] = best
        return best
    with obs.span("resolve", m=m, n=n, k=k, batch=batch, dtype=dtype,
                  platform=platform, autotune=autotune) \
            if obs.enabled() else obs.NULL_SPAN as sp:
        if not autotune:
            borrowed = _interpolated_plan(problem, key)
            if borrowed is not None:
                _PLAN_CACHE[key] = borrowed
                obs.inc("registry.plan_cache.interpolated")
                sp.set(method=borrowed.method, source="interpolated")
                return borrowed
        plans = _modeled_plans(problem)
        if not plans:
            raise ValueError(f"no registered backend is eligible for "
                             f"{problem}")
        best = plans[0]
        if autotune:
            candidates = _autotune_candidates(problem, plans, cached,
                                              autotune_top)
            timed = [dataclasses.replace(plan, est_seconds=secs,
                                         source="measured")
                     for plan, secs in zip(
                         candidates, _measure_plans(problem, candidates))
                     if secs is not None]
            if timed:
                best = min(timed, key=lambda pl: pl.est_seconds)
                model = next((pl for pl in timed
                              if (pl.method, pl.n_b, pl.k_b)
                              == (plans[0].method, plans[0].n_b,
                                  plans[0].k_b)), None)
                if model is not None and \
                        model.est_seconds <= _MEASURED_MARGIN \
                        * best.est_seconds:
                    best = model
                if cached is not None:
                    # a model or interpolated entry of this key was
                    # replaced by a fresh measurement
                    obs.inc("registry.plan_cache.autotune_upgrade")
        _PLAN_CACHE[key] = best
        sp.set(method=best.method, source=best.source)
    if best.source == "measured":
        save_plan_cache()  # no-op when persistence is off
    return best


# --------------------------------------------------------------------------
# versioned JSON stores (the plan cache and the serve-plan store)
# --------------------------------------------------------------------------
#
# ``REPRO_PLAN_CACHE`` overrides the path, as in the reference; the empty
# string, ``off``, ``0`` or ``none`` turn persistence off (the test suite
# does, through tests/conftest.py).  Stores are keyed by the running torch
# and CUDA versions: a measurement made under one build does not transfer.
# The key names no card: a plan measured on another card of the same
# build loads as it is (as the reference's "gpu" does).

_PLAN_CACHE_FORMAT = 1

_PLAN_CACHE_ENV = "REPRO_PLAN_CACHE"


def plan_cache_path() -> Optional[str]:
    """Resolved on-disk plan-cache path, or ``None`` when persistence is
    off.  The serve-plan store lives beside it."""
    override = os.environ.get(_PLAN_CACHE_ENV)
    if override is not None:
        if override.strip().lower() in ("", "off", "0", "none"):
            return None
        return os.path.expanduser(override)
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "repro_torch", "plans.json")


def _version_str() -> str:
    return f"torch {torch.__version__} cuda {torch.version.cuda}"


def _read_versioned_json(path: str, fmt: int) -> Optional[dict]:
    """Parse a versioned JSON store; ``None`` when the file is missing,
    corrupt, or stale (another format or another torch/CUDA build)."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(payload, dict) or payload.get("format") != fmt \
            or payload.get("torch") != _version_str():
        return None
    return payload


def _atomic_write_json(path: str, payload: dict,
                       prefix: str) -> Optional[str]:
    """Write ``payload`` to a temporary file and rename it into place;
    ``None`` (never raises) on I/O errors, so a read-only cache
    directory leaves planning in memory."""
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   prefix=prefix, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1)
            os.replace(tmp, path)
        except BaseException:
            os.unlink(tmp)
            raise
    except OSError:
        return None
    return path


def save_plan_cache(path: Optional[str] = None) -> Optional[str]:
    """Write every measured or persisted plan to disk, atomically.

    Entries already on disk (same format and build) that this process
    does not hold are merged in first, a best-effort courtesy to other
    processes autotuning other shapes: the unlocked read-merge-replace
    can lose a plan to a race, which is then measured again, never
    corrupted.  Returns the path written, or ``None`` when persistence
    is off, there is nothing to save or the write failed.
    """
    path = path or plan_cache_path()
    if path is None:
        return None
    merged: Dict[tuple, dict] = {}
    on_disk = _read_versioned_json(path, _PLAN_CACHE_FORMAT)
    if on_disk is not None:
        for entry in on_disk.get("plans", []):
            try:
                merged[tuple(entry["key"])] = entry
            except (KeyError, TypeError):
                continue
    for key, plan in _PLAN_CACHE.items():
        if plan.source in _PERSISTED_SOURCES:
            merged[key] = {"key": list(key), "method": plan.method,
                           "n_b": plan.n_b, "k_b": plan.k_b,
                           "est_seconds": plan.est_seconds}
    if not merged:
        return None
    payload = {"format": _PLAN_CACHE_FORMAT, "torch": _version_str(),
               "plans": list(merged.values())}
    return _atomic_write_json(path, payload, prefix=".plans.")


def load_plan_cache(path: Optional[str] = None) -> int:
    """Merge persisted plans into the in-memory cache; returns the count.

    A missing, corrupt or stale file (another format, torch or CUDA
    build) loads nothing.  Entries of another key layout or for a
    backend not registered are dropped, and an in-memory measured entry
    wins over disk.  Call it once every backend is registered
    (``core/api.py`` does, at import).
    """
    path = path or plan_cache_path()
    if path is None:
        return 0
    payload = _read_versioned_json(path, _PLAN_CACHE_FORMAT)
    if payload is None:
        return 0
    loaded = 0
    for entry in payload.get("plans", []):
        try:
            key = tuple(entry["key"])
            _split_key(key)
            cached = _PLAN_CACHE.get(key)
            plan = Plan(method=str(entry["method"]), n_b=entry.get("n_b"),
                        k_b=entry.get("k_b"),
                        est_seconds=float(entry.get("est_seconds", 0.0)),
                        source="persisted")
        except (KeyError, TypeError, ValueError):
            continue
        if plan.method not in _REGISTRY:
            continue
        if cached is not None and cached.source == "measured":
            continue
        _PLAN_CACHE[key] = plan
        loaded += 1
    return loaded
