# repro-torch-lint: fixture-as=src/repro_torch/serve/good_citizen.py
"""Clean fixture: a serve-layer module using only the typed API.

Must produce zero violations under every rule.
"""
import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.compat import ieee_float32
from repro_torch.core import RotationSequence
from repro_torch.core.rotations import plane_update
from repro_torch.kernels.limits import SMEM_PER_BLOCK, round_up
from repro_torch.obs import timing


def plan_and_apply(seq: RotationSequence, A):
    plan = seq.plan(like=A)
    with ieee_float32():
        t0 = timing.now()
        out = plan.apply(A)
    return out, timing.now() - t0


def host_stencil(x, y, c, s):
    return plane_update(x, y, c, s, -1.0)


def fits(planes: int, itemsize: int) -> bool:
    return round_up(3 * planes * itemsize, 128) <= SMEM_PER_BLOCK


def placed(x, mesh) -> DTensor:
    # DTensor placements are annotations: allowed everywhere
    return DTensor.from_local(x, mesh, [Shard(0)])


def public_torch():
    return torch.__version__, torch.ops.aten._softmax.default
