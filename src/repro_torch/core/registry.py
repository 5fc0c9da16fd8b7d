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
plane rate measured on an H100 (:data:`_WAVE_PLANE_SECONDS`,
:data:`_BATCHED_PLANE_SECONDS`): one lane walks a row's planes in order
(``cuda_wave`` splits them over the warps of its band pipeline), so a
launch takes the planes of one chain times the time of one, for as many
rows as the card runs at once (:data:`repro_torch.hw.RESIDENT_ROWS`).

The persisted plan cache, cross-shape interpolation, measured autotune
and sharded communication term are not ported yet; of the persistence
layer only what the serve-plan store needs is here (:func:`plan_cache_path`
and the versioned JSON helpers).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.hw import PLATFORMS, RESIDENT_ROWS, Hardware
from repro_torch.kernels.limits import (MXU_ROWS, MXU_SLAB, WAVE_KB,
                                        WAVE_WARPS, mxu_width)

__all__ = [
    "Hardware", "PLATFORMS", "Problem", "Plan", "Capability", "BackendSpec",
    "register", "get_backend", "registered_methods", "eligible_backends",
    "no_tiles", "blocked_tiles", "accumulated_tiles",
    "cuda_wave_tiles", "cuda_mxu_tiles",
    "cost_unoptimized", "cost_wavefront", "cost_blocked",
    "cost_accumulated", "cost_cuda_wave", "cost_cuda_mxu",
    "cost_cuda_batched",
    "select_plan", "plan_cache_stats", "clear_plan_cache",
    "cost_components", "plan_cache_path",
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
_WAVE_PLANE_SECONDS = 1.66e-3 / (3839 * 192 / 12
                                 * (3840 * 12 / RESIDENT_ROWS["cuda"]))
_BATCHED_PLANE_SECONDS = 6.62e-3 / (3839 * 180)


# --------------------------------------------------------------------------
# problem / plan records
# --------------------------------------------------------------------------

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


def _components_unoptimized(p: Problem, plan: Plan) -> Dict[str, float]:
    return _split(stream_flops=6.0 * p.m_total * p.n * p.k,
                  stream_bytes=4.0 * p.m_total * p.n * p.k * p.itemsize)


def cost_unoptimized(p: Problem, plan: Plan) -> float:
    """Alg 1.2: 4 memops per rotation, no reuse (paper SS6 baseline)."""
    hw = p.hardware
    c = _components_unoptimized(p, plan)
    return _roofline_seconds(c["stream_flops"] / hw.vpu_flops,
                             c["stream_bytes"] / hw.hbm_bw) * _eager_factor(p)


def _components_wavefront(p: Problem, plan: Plan) -> Dict[str, float]:
    return _split(stream_flops=6.0 * p.m_total * p.n * p.k,
                  stream_bytes=2.0 * p.m_total * p.n * p.k * p.itemsize)


def cost_wavefront(p: Problem, plan: Plan) -> float:
    """Alg 1.3: wavefront fuses column touches to ~2 memops/rotation."""
    hw = p.hardware
    c = _components_wavefront(p, plan)
    return _roofline_seconds(c["stream_flops"] / hw.vpu_flops,
                             c["stream_bytes"] / hw.hbm_bw) * _eager_factor(p)


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
    hw = p.hardware
    c = _components_blocked(p, plan)
    return _roofline_seconds(
        c["stream_flops"] / hw.vpu_flops,
        (c["setup_bytes"] + c["stream_bytes"]) / hw.hbm_bw)


def cost_blocked(p: Problem, plan: Plan) -> float:
    """Blocked wavefront: A streams once per band of k_b waves (SS5)."""
    return _blocked_seconds(p, plan) * _eager_factor(p)


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
    hw = p.hardware
    c = _components_accumulated(p, plan)
    flop_term = (c["stream_flops"] / hw.mxu_flops
                 + c["setup_flops"] / hw.vpu_flops)
    return _roofline_seconds(
        flop_term, (c["setup_bytes"] + c["stream_bytes"]) / hw.hbm_bw)


def cost_accumulated(p: Problem, plan: Plan) -> float:
    """rs_gemm: ~4/3 extra flops (n_b = k_b) priced at the GEMM rate."""
    return _accumulated_seconds(p, plan) * _eager_factor(p)


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
    orders the tiles.
    """
    secs = 0.7 * _blocked_seconds(p, plan) * _off_device_factor(p)
    if p.platform == "cuda":
        rows = p.m if p.sequences > 1 else p.m_total
        bands = _bands(p.k, WAVE_KB)
        warps = max(1, min(WAVE_WARPS, bands))
        planes = max(0, p.n - 1) * bands * WAVE_KB
        secs += p.sequences * _row_chain_seconds(
            planes / warps, rows * warps, _WAVE_PLANE_SECONDS)
    return max(secs, p.sequences * _LATENCY_FLOOR)


def _mxu_sweep_seconds(p: Problem, n_b: int, k_b: int) -> float:
    """The accumulated kernel's launches on the card: every block walks
    its bands' slabs at the measured slab time of its padded width, and
    blocks past one a streaming multiprocessor queue."""
    bands, tiles, w = _tile_grid(p, n_b, k_b)
    a, b = _MXU_SLAB_SECONDS
    slabs = bands * tiles * math.ceil(w / MXU_SLAB)
    rows = p.m if p.sequences > 1 else p.m_total
    blocks = math.ceil(rows / MXU_ROWS)
    return (p.sequences * slabs * (a + b * mxu_width(w))
            * max(1.0, blocks / _SMS))


def cost_cuda_mxu(p: Problem, plan: Plan) -> float:
    """Accumulated kernel: accumulated-path traffic at fused constants.

    On the card the GEMM sweep is priced by the kernel's measured slab
    time (:data:`_MXU_SLAB_SECONDS`), plus the padded copy of the target
    that feeds each band.  Each band's tile factors are one
    ``cuda_batched`` launch over ``T`` identity targets of ``w`` rows
    with ``n_b * k_b`` live planes each, at that kernel's measured plane
    rate, plus the packing traffic; they are paid once per sequence.
    The host's calls for each band (:data:`_MXU_BAND_HOST_SECONDS`) set
    the pace where the card's work is shorter.  Off the card the
    reference's formula holds.
    """
    if p.platform != "cuda":
        return max(0.7 * _accumulated_seconds(p, plan) * _OFF_DEVICE_PENALTY,
                   p.sequences * _LATENCY_FLOOR)
    hw = p.hardware
    n_b, k_b = plan.n_b or 128, plan.k_b or 128
    c = _components_accumulated(p, plan)
    bands, tiles, w = _tile_grid(p, n_b, k_b)
    sweep = (_mxu_sweep_seconds(p, n_b, k_b)
             + c["stream_bytes"] / hw.hbm_bw)
    factors = (bands * _row_chain_seconds(n_b * k_b, tiles * w,
                                          _BATCHED_PLANE_SECONDS)
               + c["setup_bytes"] / p.sequences / hw.hbm_bw)
    device = sweep + p.sequences * factors + _MXU_BAND_HOST_SECONDS
    host = p.sequences * bands * _MXU_BAND_HOST_SECONDS
    return max(device, host, p.sequences * _LATENCY_FLOOR)


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
    """
    hw = p.hardware
    c = _components_cuda_batched(p, plan)
    secs = _roofline_seconds(
        c["stream_flops"] / hw.vpu_flops,
        (c["setup_bytes"] + c["stream_bytes"]) / hw.hbm_bw)
    secs *= _off_device_factor(p)
    if p.platform == "cuda":
        secs = max(secs, _row_chain_seconds(p.planes_live, p.m_total,
                                            _BATCHED_PLANE_SECONDS))
    return max(secs, _LATENCY_FLOOR)


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
    "stream": {...}}``: the summed SS6 analysis of the named backend,
    the registered cost model's seconds (what ``select_plan`` ranked
    by), and the per-sequence vs per-row split with penalty-free
    attribution seconds.
    """
    spec = get_backend(method)
    plan = plan if plan is not None else Plan(method=method)
    comp_fn = _COMPONENT_FNS.get(method)
    c = comp_fn(problem, plan) if comp_fn is not None else _ZERO_SPLIT
    hw = problem.hardware
    stream_rate = hw.mxu_flops if method in _MXU_STREAM else hw.vpu_flops
    setup_s = (c["setup_flops"] / hw.vpu_flops
               + c["setup_bytes"] / hw.hbm_bw)
    stream_s = (c["stream_flops"] / stream_rate
                + c["stream_bytes"] / hw.hbm_bw)
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


def plan_cache_stats() -> dict:
    return dict(_CACHE_STATS, size=len(_PLAN_CACHE))


def clear_plan_cache() -> None:
    _PLAN_CACHE.clear()
    _CACHE_STATS["hits"] = _CACHE_STATS["misses"] = 0


def _plan_key(problem: Problem) -> tuple:
    key = (problem.m, problem.n, problem.k, problem.dtype,
           problem.platform, problem.signs, problem.batch,
           problem.shared_sequence)
    if problem.live_planes is not None:
        # liveness changes which backend wins: a thin staircase must not
        # share an entry with the dense grid of the same shape
        key = key + ("live", problem.live_planes)
    return key


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


def select_plan(m: int, n: int, k: int, *, dtype: str = "float32",
                platform: str = "cuda", signs: bool = False,
                batch: int = 1, shared_sequence: bool = True,
                live_planes: Optional[int] = None) -> Plan:
    """Pick ``(method, n_b, k_b)`` for a problem, with caching.

    Cost-model ranking, cached per ``(m, n, k, dtype, platform, signs,
    batch, shared_sequence)`` plus ``("live", live_planes)`` when the
    live planes are known.
    """
    batch = max(1, int(batch))
    shared_sequence = bool(shared_sequence) or batch <= 1
    problem = Problem(m=m, n=n, k=k, dtype=dtype, platform=platform,
                      signs=signs, batch=batch,
                      shared_sequence=shared_sequence,
                      live_planes=live_planes)
    key = _plan_key(problem)
    cached = _PLAN_CACHE.get(key)
    if cached is not None:
        _CACHE_STATS["hits"] += 1
        return cached
    _CACHE_STATS["misses"] += 1
    if n < 2 or k < 1 or m < 1:
        # zero rotations: application is a no-op
        best = Plan(method="blocked" if signs else "unoptimized",
                    est_seconds=0.0)
    else:
        plans = _modeled_plans(problem)
        if not plans:
            raise ValueError(f"no registered backend is eligible for "
                             f"{problem}")
        best = plans[0]
    _PLAN_CACHE[key] = best
    return best


# --------------------------------------------------------------------------
# versioned JSON stores (the serve-plan store)
# --------------------------------------------------------------------------
#
# ``REPRO_PLAN_CACHE`` overrides the path, as in the reference; the empty
# string, ``off``, ``0`` or ``none`` turn persistence off (the test suite
# does, through tests/conftest.py).  Stores are keyed by the running torch
# and CUDA versions: a decision made under one build does not transfer.

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
