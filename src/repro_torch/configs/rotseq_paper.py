"""The paper's own experimental workload (SS8): apply k = 180 waves of
rotations to square matrices, m = n swept.  Not an LM architecture, and
not in ``ARCHS``.

Mirror of the reference's ``configs/rotseq_paper.py``, data only.  It
keeps ``k``, ``sizes``, ``n_b``, ``k_b`` and the accumulated kernel's
tiles ``mxu_n_b``/``mxu_k_b``; it drops ``m_blk``, the TPU batched
kernel's rows a block: the port's batched kernel takes its rows a block
as the compiled constant ``BATCHED_M_BLK``
(:mod:`repro_torch.kernels.limits`).
"""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class RotSeqConfig:
    k: int = 180
    sizes: Tuple[int, ...] = (240, 480, 960, 1920, 3840)
    n_b: int = 64
    k_b: int = 16
    # the accumulated kernel's tiles (the reference's adaptation of the
    # paper's m_r = 16, k_r = 2)
    mxu_n_b: int = 128
    mxu_k_b: int = 128


CONFIG = RotSeqConfig()
