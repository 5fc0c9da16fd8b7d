"""Per-device peak rates used by the registry's cost model.

Mirror of :mod:`repro.hw` for the PyTorch/CUDA port.  The ``"cuda"`` row
is an NVIDIA H100 SXM from NVIDIA's data sheet: 67 TFLOP/s of float32
outside the tensor cores, 3.35 TB/s of HBM3 and 450 GB/s of NVLink each
way.  Both ``vpu_flops`` and ``mxu_flops`` carry the float32 CUDA-core
rate, because the port's GEMM kernel (``rotseq_mxu``) is IEEE float32
on the CUDA cores, not TF32 on the tensor cores.  The ``"cpu"`` row is
the reference's own, copied unchanged so that host costs agree with the
reference bit for bit.

Two fields lie outside the reference's record and the registry's cost
model reads neither; the dry run's roofline and fit check
(:mod:`repro_torch.launch.roofline`, :mod:`repro_torch.launch.dryrun`)
read them.  ``tc_bf16_flops`` is dense bf16 on the tensor cores: 989.4
TFLOP/s on an H100 SXM (NVIDIA's data sheet; 1979 is the figure with
sparsity).  ``hbm_bytes`` is the card's memory as
``torch.cuda.get_device_properties(0).total_memory`` reads it on an
NVIDIA H100 80GB HBM3 (power limit 700 W); ``chip_smoke.py`` checks it
against the card it runs on.

:data:`RESIDENT_ROWS` holds, outside the reference's record, how many
rows a row-parallel kernel (one thread a row) runs at once on the card:
one warp on each of the 4 schedulers of an H100 SXM's 132 SMs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

__all__ = ["Hardware", "PLATFORMS", "RESIDENT_ROWS"]


@dataclasses.dataclass(frozen=True)
class Hardware:
    """Per-device peak rates used by the cost model and the roofline."""
    name: str
    mxu_flops: float   # dense-matmul peak FLOP/s
    vpu_flops: float   # elementwise peak FLOP/s
    hbm_bw: float      # main-memory bandwidth B/s
    link_bw: float     # interconnect B/s per link
    tc_bf16_flops: float   # dense bf16 matmul peak FLOP/s
    hbm_bytes: int         # device memory capacity in bytes


PLATFORMS: Dict[str, Hardware] = {
    "cuda": Hardware("h100-sxm", mxu_flops=67e12, vpu_flops=67e12,
                     hbm_bw=3.35e12, link_bw=450e9,
                     tc_bf16_flops=989.4e12, hbm_bytes=85_017_493_504),
    # a host has no tensor cores: its bf16 rate is the row's dense-matmul
    # rate; its memory a nominal 96 GiB host's
    "cpu": Hardware("cpu-host", mxu_flops=1.5e12, vpu_flops=0.4e12,
                    hbm_bw=100e9, link_bw=25e9, tc_bf16_flops=1.5e12,
                    hbm_bytes=96 * 2**30),
}

RESIDENT_ROWS: Dict[str, int] = {"cuda": 132 * 4 * 32}
