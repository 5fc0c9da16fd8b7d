"""Fused RoPE on q and k: mirror of :mod:`repro.kernels.rope.ops`.

:func:`apply_rope` is the counterpart of the reference's ``apply_rope``
with ``use_kernel=True``: one launch of the fused kernel for the whole
batch on the card, the plain version (exactly ``apply_rope_ref`` on q
and on k) for CPU tensors.  It has no ``use_kernel`` switch: the
tensor's device decides.  On ``DTensor`` q and k (a train step under a
mesh) it runs once a shard, on each rank's local q and k, which must
hold whole sequences and whole heads.
"""
from __future__ import annotations

from .kernel import rope
from .ref import apply_rope_ref, rope_tables

__all__ = ["apply_rope", "rope_tables", "apply_rope_ref"]


def apply_rope(q, k, cos, sin):
    """``(q, k)`` rotated by the tables ``cos``/``sin`` ``(S, D // 2)``
    (see :func:`repro_torch.kernels.rope.kernel.rope`)."""
    from torch.distributed.tensor import DTensor
    if isinstance(q, DTensor) or isinstance(k, DTensor):
        return _per_shard(q, k, cos, sin)
    return rope(q, k, cos, sin)


def _per_shard(q, k, cos, sin):
    """RoPE on each rank's shards of ``DTensor`` q and k ``(B, S, H,
    D)``: the kernel (or its plain version) on the local tensors, through
    its autograd ``Function``, so the backward launches it too; the
    outputs keep q's and k's placements.  The batch and the heads may be
    sharded (the batch alike on q and k); a placement that shards the
    sequence or the head dim, or a pending reduction, raises
    ``ValueError``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not (isinstance(q, DTensor) and isinstance(k, DTensor)):
        raise ValueError("rope: q and k must both be DTensors or neither")
    if q.device_mesh != k.device_mesh:
        raise ValueError("rope: q and k on different meshes")
    for name, x in (("q", q), ("k", k)):
        for pl in x.placements:
            if not (isinstance(pl, Replicate) or (
                    isinstance(pl, Shard) and pl.dim in (0, 2))):
                raise ValueError(
                    f"rope: {name} placed {tuple(x.placements)}; only the "
                    f"batch (dim 0) and the heads (dim 2) may be sharded")
    for pq, pk in zip(q.placements, k.placements):
        if (pq == Shard(0)) != (pk == Shard(0)):
            raise ValueError(f"rope: q's batch placed {tuple(q.placements)}"
                             f", k's {tuple(k.placements)}")
    if isinstance(cos, DTensor):
        cos, sin = cos.to_local(), sin.to_local()
    qo, ko = rope(q.to_local().contiguous(), k.to_local().contiguous(),
                  cos, sin)
    mesh = q.device_mesh
    return (DTensor.from_local(qo, mesh, q.placements, run_check=False,
                               shape=q.shape, stride=q.stride()),
            DTensor.from_local(ko, mesh, k.placements, run_check=False,
                               shape=k.shape, stride=k.stride()))
