"""Host wrapper of the wavefront kernel: packing and unpacking.

Mirror of ``repro.kernels.rotseq.ops``.  Transposes ``A`` once into the
packed layout (columns of ``A`` as rows, paper SS4), lays the waves out
wave-major with their sign grid, applies every band in one call of the
kernel wrapper and transposes back.  Rows need no padding: the kernel
masks the ragged last row group itself.
"""
from __future__ import annotations

from repro_torch import obs
from repro_torch.core.ref import sign_grid
from repro_torch.kernels.limits import WAVE_KB

from .kernel import rotseq_wave, traffic_bytes

__all__ = ["rot_sequence_wave"]


def rot_sequence_wave(A, C, S, *, n_b=None, k_b: int = WAVE_KB,
                      reflect: bool = False, G=None):
    """Apply the rotation sequence ``(C, S)`` to ``A`` from the right.

    On a CUDA tensor this is one launch of the wavefront kernel, which
    takes ``k_b = WAVE_KB`` and no ``n_b``; on a CPU tensor the plain
    version runs the blocked sweep band by band at any ``k_b``, ``n_b``.

    With :mod:`repro_torch.obs` on, a call counts its planes and the
    bytes the kernel moves for it (:func:`~.kernel.traffic_bytes`); the
    kernel wrapper counts the launch on the card, and on the CPU this
    call counts one, as the reference counts in interpret mode.
    """
    m, n = A.shape
    J, k = C.shape
    if J != n - 1:
        raise ValueError(f"waves {tuple(C.shape)} do not fit A {(m, n)}")
    G = sign_grid(C, reflect, G)
    Cw, Sw, Gw = (x.to(A.dtype).t().contiguous() for x in (C, S, G))
    out = rotseq_wave(A.t().contiguous(), Cw, Sw, Gw, k_b=k_b, n_b=n_b)
    if obs.enabled() and not obs.traced(A):
        if A.device.type == "cpu":   # the plain version: one a call
            obs.inc("kernels.rotseq.launches")
        obs.inc("kernels.rotseq.planes_applied", J * k)
        obs.inc("kernels.rotseq.bytes_moved",
                traffic_bytes(n, m, k, A.element_size()))
    return out.t().contiguous()
