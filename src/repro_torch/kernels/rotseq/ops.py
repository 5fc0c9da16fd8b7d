"""Host wrapper of the wavefront kernel: packing, band loop, unpacking.

Mirror of ``repro.kernels.rotseq.ops``.  Transposes ``A`` once into the
packed layout (columns of ``A`` as rows, paper SS4), then per band of
``k_b`` waves shear-packs the rotation tiles, builds the carry/fresh
stream and launches one kernel.  Rows need no padding: the kernel masks
the ragged last block itself.
"""
from __future__ import annotations

from repro_torch.core.blocked import band_inputs, num_tiles, pack_sheared

from .kernel import rotseq_wave

__all__ = ["rot_sequence_wave"]


def rot_sequence_wave(A, C, S, *, n_b: int = 64, k_b: int = 16,
                      reflect: bool = False, G=None):
    """Apply the rotation sequence ``(C, S)`` to ``A`` from the right.

    On a CUDA tensor every band is one launch of the wavefront kernel;
    on a CPU tensor the same bands run through its plain version.
    """
    m, n = A.shape
    J, k = C.shape
    if J != n - 1:
        raise ValueError(f"waves {tuple(C.shape)} do not fit A {(m, n)}")
    n_b = min(n_b, max(8, n))
    T = num_tiles(n, n_b, k_b)
    AT = A.t().contiguous()
    for p0 in range(0, k, k_b):
        Ct, St, Gt = pack_sheared(C, S, p0, k_b, n_b, T, reflect=reflect,
                                  G=G)
        init, fresh = band_inputs(AT, k_b, n_b, T)
        O = rotseq_wave(fresh.contiguous(), Ct.to(A.dtype), St.to(A.dtype),
                        Gt.to(A.dtype), init)
        AT = O[k_b - 1:k_b - 1 + n]
    return AT.t().contiguous()
