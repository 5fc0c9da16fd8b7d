"""Backend registration + the raw-array entry point.

Mirror of :mod:`repro.core.api`.  The idiomatic API is
:mod:`repro_torch.core.sequence` (``seq.plan(like=A).apply(A)``);
``apply_rotation_sequence(A, C, S, method=...)`` wraps loose arrays for
callers that hold them.  ``method`` is one of:

  ``unoptimized``   Algorithm 1.2 (plain torch, one plane at a time)
  ``wavefront``     Algorithm 1.3 (plain torch, one anti-diagonal a step)
  ``blocked``       blocked wavefront, plain torch (paper SS2/SS5)
  ``accumulated``   rs_gemm analogue: tile factors + GEMM sweeps
  ``cuda_wave``     CUDA wavefront kernel (counterpart of ``pallas_wave``)
  ``cuda_mxu``      CUDA accumulated kernel (counterpart of ``pallas_mxu``)
  ``cuda_batched``  CUDA fused batched kernel, one launch per batch of
                    targets (counterpart of ``rotseq_batched``)
  ``auto``          the registry picks backend + tiles (cost model, or
                    measured with ``autotune=True``)

The CUDA backends run their kernels on CUDA tensors and their plain
versions on CPU tensors; off the card the cost model penalises them so
``auto`` never picks them there.
"""
from __future__ import annotations

from repro_torch.core import registry
from repro_torch.core.registry import BackendSpec, Capability, select_plan
from repro_torch.core.sequence import RotationSequence

from .accumulate import rot_sequence_accumulated
from .blocked import rot_sequence_blocked
from .ref import rot_sequence_unoptimized, rot_sequence_wavefront

__all__ = ["apply_rotation_sequence", "METHODS", "select_plan"]


def _run_unoptimized(A, C, S, *, reflect=False, G=None, **kw):
    return rot_sequence_unoptimized(A, C, S, reflect=reflect, G=G)


def _run_wavefront(A, C, S, *, reflect=False, G=None, **kw):
    return rot_sequence_wavefront(A, C, S, reflect=reflect, G=G)


def _run_blocked(A, C, S, *, n_b=64, k_b=16, reflect=False, G=None, **kw):
    return rot_sequence_blocked(A, C, S, n_b=n_b, k_b=k_b, reflect=reflect,
                                G=G)


def _run_accumulated(A, C, S, *, n_b=64, k_b=16, reflect=False, G=None,
                     **kw):
    return rot_sequence_accumulated(A, C, S, n_b=n_b, k_b=k_b,
                                    reflect=reflect, G=G)


def _run_cuda_wave(A, C, S, *, n_b=None, k_b=16, reflect=False, G=None,
                   **kw):
    from repro_torch.kernels.rotseq.ops import rot_sequence_wave
    return rot_sequence_wave(A, C, S, n_b=n_b, k_b=k_b, reflect=reflect,
                             G=G, **kw)


def _run_cuda_mxu(A, C, S, *, n_b=64, k_b=16, reflect=False, G=None, **kw):
    from repro_torch.kernels.rotseq_mxu.ops import rot_sequence_mxu
    return rot_sequence_mxu(A, C, S, n_b=n_b, k_b=k_b, reflect=reflect,
                            G=G, **kw)


def _run_cuda_batched(A, C, S, *, reflect=False, G=None, **kw):
    from repro_torch.kernels.rotseq_batched.ops import rot_sequence_batched
    return rot_sequence_batched(A, C, S, reflect=reflect, G=G, **kw)


registry.register(BackendSpec(
    name="unoptimized",
    fn=_run_unoptimized,
    capability=Capability(supports_signs=False, supports_sharding=True),
    cost=registry.cost_unoptimized,
    candidates=registry.no_tiles,
    doc="Algorithm 1.2 reference: one rotation at a time, no blocking.",
))

registry.register(BackendSpec(
    name="wavefront",
    fn=_run_wavefront,
    capability=Capability(supports_signs=False, supports_sharding=True),
    cost=registry.cost_wavefront,
    candidates=registry.no_tiles,
    doc="Algorithm 1.3 wavefront order, unblocked.",
))

registry.register(BackendSpec(
    name="blocked",
    fn=_run_blocked,
    capability=Capability(supports_sharding=True, tile_min=(2, 1)),
    cost=registry.cost_blocked,
    candidates=registry.blocked_tiles,
    doc="Blocked wavefront (paper SS2/SS5), plain torch band sweeps.",
))

registry.register(BackendSpec(
    name="accumulated",
    fn=_run_accumulated,
    # its factor accumulation writes a shared identity in place, which
    # torch.func.vmap refuses: per-request batches loop
    capability=Capability(supports_sharding=True, tile_min=(2, 1),
                          supports_vmap=False),
    cost=registry.cost_accumulated,
    candidates=registry.accumulated_tiles,
    doc="rs_gemm analogue: accumulate tile factors, sweep as GEMMs.",
))

registry.register(BackendSpec(
    name="cuda_wave",
    fn=_run_cuda_wave,
    capability=Capability(dtypes=("float32",), platforms=("cuda",),
                          tile_min=(2, 1), needs_kernel=True,
                          supports_vmap=False, batch_via="flatten"),
    cost=registry.cost_cuda_wave,
    candidates=registry.cuda_wave_tiles,
    doc="CUDA wavefront kernel (packed layout, bands pipelined across "
        "warps, one launch).",
))

registry.register(BackendSpec(
    name="cuda_mxu",
    fn=_run_cuda_mxu,
    capability=Capability(dtypes=("float32",), platforms=("cuda",),
                          tile_min=(2, 1), tile_max=(128, 128),
                          needs_kernel=True, supports_vmap=False,
                          batch_via="flatten"),
    cost=registry.cost_cuda_mxu,
    candidates=registry.cuda_mxu_tiles,
    doc="CUDA accumulated kernel (IEEE float32 tile GEMM chain).",
))

# Of the kernels only the fused one is shard-capable, as only the
# reference's rotseq_batched is: its launch is wholly a shard's own rows.
# cuda_wave and cuda_mxu stay unmarked, mirroring pallas_wave/pallas_mxu.
registry.register(BackendSpec(
    name="cuda_batched",
    fn=_run_cuda_batched,
    capability=Capability(dtypes=("float32",), platforms=("cuda",),
                          supports_signs=True, needs_kernel=True,
                          supports_vmap=False, supports_sharding=True,
                          batch_via="fused"),
    cost=registry.cost_cuda_batched,
    candidates=registry.no_tiles,
    doc="CUDA fused batched kernel: one launch per batch, dead planes "
        "skipped.",
))

METHODS = registry.registered_methods()

# persisted plans are checked against the registry, so they load once
# every backend above is registered, not when the registry is imported
registry.load_plan_cache()


def apply_rotation_sequence(A, C, S, *, method: str = "accumulated",
                            n_b: int | None = None, k_b: int | None = None,
                            reflect: bool = False, G=None,
                            autotune: bool = False, **kw):
    """Apply the rotation sequence ``(C, S)`` to ``A`` from the right.

    Wraps the loose arrays in a :class:`RotationSequence` and runs one
    freshly resolved plan with the backend's own autograd
    (``apply_direct``).  ``autotune=True`` measures the candidate plans
    under ``method="auto"``.  Empty sequences are the identity under
    every method.
    """
    seq = RotationSequence(C, S, G, reflect)
    plan = seq.plan(like=A, method=method, n_b=n_b, k_b=k_b,
                    autotune=autotune, **kw)
    return plan.apply_direct(A)
