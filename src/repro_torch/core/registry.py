"""Backend registry + cost-model dispatch for rotation-sequence application.

Mirror of :mod:`repro.core.registry`.  Every backend registers a
:class:`BackendSpec` (capability record, SS6 memory-operation cost model
split into per-sequence *setup* and per-row *stream* terms, tile
candidates); :func:`select_plan` ranks the eligible (backend, tile)
candidates by modeled cost and caches the winning :class:`Plan` per
problem in this process.

:class:`Problem.platform` is the device type of the target tensor
(``"cuda"`` or ``"cpu"``), never a global probe.  The CUDA kernels
(``cuda_wave``, ``cuda_mxu``) are priced like the reference's Pallas
kernels: their plain versions stay eligible on the CPU with a large
penalty, so ``auto`` picks them only on the card, where they always
undercut the eager backends of the same family.

The reference's persisted plan cache, cross-shape interpolation,
measured autotune and sharded communication term are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.hw import PLATFORMS, Hardware

__all__ = [
    "Hardware", "PLATFORMS", "Problem", "Plan", "Capability", "BackendSpec",
    "register", "get_backend", "registered_methods", "eligible_backends",
    "no_tiles", "blocked_tiles", "accumulated_tiles",
    "cuda_wave_tiles", "cuda_mxu_tiles",
    "cost_unoptimized", "cost_wavefront", "cost_blocked",
    "cost_accumulated", "cost_cuda_wave", "cost_cuda_mxu",
    "select_plan", "plan_cache_stats", "clear_plan_cache",
    "cost_components",
]

# A CUDA kernel asked for off the card runs its plain version, orders of
# magnitude slower; it stays eligible there but carries this penalty, so
# "auto" never picks it while an explicit method name still works.
_OFF_DEVICE_PENALTY = 1e3


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
        return max(0, self.n - 1) * self.k

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
    dtypes: Tuple[str, ...] = ("float32", "float64")
    platforms: Tuple[str, ...] = ("cpu", "cuda")
    supports_signs: bool = True       # per-entry G (mixed rot/reflector)
    tile_min: Tuple[int, int] = (1, 1)
    tile_max: Tuple[int, int] = (4096, 4096)
    # a CUDA kernel whose plain version runs (penalised) on other devices
    needs_kernel: bool = False
    supports_vmap: bool = True


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
                             c["stream_bytes"] / hw.hbm_bw)


def _components_wavefront(p: Problem, plan: Plan) -> Dict[str, float]:
    return _split(stream_flops=6.0 * p.m_total * p.n * p.k,
                  stream_bytes=2.0 * p.m_total * p.n * p.k * p.itemsize)


def cost_wavefront(p: Problem, plan: Plan) -> float:
    """Alg 1.3: wavefront fuses column touches to ~2 memops/rotation."""
    hw = p.hardware
    c = _components_wavefront(p, plan)
    return _roofline_seconds(c["stream_flops"] / hw.vpu_flops,
                             c["stream_bytes"] / hw.hbm_bw)


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


def cost_blocked(p: Problem, plan: Plan) -> float:
    """Blocked wavefront: A streams once per band of k_b waves (SS5)."""
    hw = p.hardware
    c = _components_blocked(p, plan)
    return _roofline_seconds(
        c["stream_flops"] / hw.vpu_flops,
        (c["setup_bytes"] + c["stream_bytes"]) / hw.hbm_bw)


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


def cost_accumulated(p: Problem, plan: Plan) -> float:
    """rs_gemm: ~4/3 extra flops (n_b = k_b) priced at the GEMM rate."""
    hw = p.hardware
    c = _components_accumulated(p, plan)
    flop_term = (c["stream_flops"] / hw.mxu_flops
                 + c["setup_flops"] / hw.vpu_flops)
    return _roofline_seconds(
        flop_term, (c["setup_bytes"] + c["stream_bytes"]) / hw.hbm_bw)


def _off_device_factor(p: Problem) -> float:
    return 1.0 if p.platform == "cuda" else _OFF_DEVICE_PENALTY


def cost_cuda_wave(p: Problem, plan: Plan) -> float:
    """Wavefront kernel: blocked-wavefront traffic, carry kept on chip.

    ``supports_vmap=False``: a per-request batch runs as separate
    launches, so the latency floor multiplies by the sequence count.
    """
    return max(0.7 * cost_blocked(p, plan) * _off_device_factor(p),
               p.sequences * _LATENCY_FLOOR)


def cost_cuda_mxu(p: Problem, plan: Plan) -> float:
    """Accumulated kernel: accumulated-path traffic at fused constants."""
    return max(0.7 * cost_accumulated(p, plan) * _off_device_factor(p),
               p.sequences * _LATENCY_FLOOR)


# the setup/stream traffic split behind each cost model (the kernels move
# blocked / accumulated traffic; only their seconds constant differs)
_COMPONENT_FNS: Dict[str, Callable[[Problem, Plan], Dict[str, float]]] = {
    "unoptimized": _components_unoptimized,
    "wavefront": _components_wavefront,
    "blocked": _components_blocked,
    "accumulated": _components_accumulated,
    "cuda_wave": _components_blocked,
    "cuda_mxu": _components_accumulated,
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
    cap = get_backend("cuda_wave").capability
    pairs = _clip_pairs(p, [(64, 16), (32, 8), (8, 4)], cap)
    return [Plan("", n_b=a, k_b=b) for a, b in pairs]


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
    return (problem.m, problem.n, problem.k, problem.dtype,
            problem.platform, problem.signs, problem.batch,
            problem.shared_sequence)


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
                batch: int = 1, shared_sequence: bool = True) -> Plan:
    """Pick ``(method, n_b, k_b)`` for a problem, with caching.

    Cost-model ranking, cached per ``(m, n, k, dtype, platform, signs,
    batch, shared_sequence)``.
    """
    batch = max(1, int(batch))
    shared_sequence = bool(shared_sequence) or batch <= 1
    problem = Problem(m=m, n=n, k=k, dtype=dtype, platform=platform,
                      signs=signs, batch=batch,
                      shared_sequence=shared_sequence)
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
