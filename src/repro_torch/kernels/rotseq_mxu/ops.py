"""Host wrapper of the accumulated kernel: factors, band loop, unpacking.

Mirror of ``repro.kernels.rotseq_mxu.ops``.  Per band of ``k_b`` waves
it shear-packs the rotation tiles, accumulates them into ``(w, w)``
factors (plain torch, all tiles of the band at once) and launches one
kernel over the carry/fresh stream.
"""
from __future__ import annotations

from repro_torch.core.accumulate import accumulate_tile_factors
from repro_torch.core.blocked import band_inputs, num_tiles, pack_sheared

from .kernel import rotseq_mxu

__all__ = ["rot_sequence_mxu"]


def rot_sequence_mxu(A, C, S, *, n_b: int = 128, k_b: int = 128,
                     reflect: bool = False, G=None):
    """Apply ``(C, S)`` to ``A`` from the right via accumulated tiles.

    On a CUDA tensor every band is one launch of the accumulated kernel;
    on a CPU tensor the same bands run through its plain version.
    """
    m, n = A.shape
    J, k = C.shape
    if J != n - 1:
        raise ValueError(f"waves {tuple(C.shape)} do not fit A {(m, n)}")
    n_b = min(n_b, max(8, n))
    T = num_tiles(n, n_b, k_b)
    for p0 in range(0, k, k_b):
        Ct, St, Gt = pack_sheared(C, S, p0, k_b, n_b, T, reflect=reflect,
                                  G=G)
        Q = accumulate_tile_factors(Ct, St, Gt, dtype=A.dtype)
        init, fresh = band_inputs(A.t(), k_b, n_b, T)
        O = rotseq_mxu(fresh.t().contiguous(), Q, init.t().contiguous())
        A = O[:, k_b - 1:k_b - 1 + n]
    return A.contiguous()
