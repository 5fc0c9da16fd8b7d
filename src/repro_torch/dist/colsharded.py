"""Column-sharded (CAQR-style panel) application of rotation sequences.

Mirror of :mod:`repro.dist.colsharded` over ``torch.distributed``.  Each
rank of the ``col_axis`` mesh dimension owns a contiguous column slab of
the target.  A band of ``k_b`` waves (a *panel* in the
communication-avoiding sense of Demmel, Grigori, Hoemmen and Langou,
CAQR) must sweep left to right across the slabs, so bands are
pipelined: at superstep ``s`` rank ``d`` sweeps band ``s - d``, and
boundary planes cross once a panel, not once a wave, in two exchanges a
superstep: one column of the right neighbour's state (leftward, the halo
its last tile consumes) and the ``(m_loc, k_b)`` carry of partly rotated
columns (rightward).  Each exchange is one ``batch_isend_irecv`` on the
``col_axis`` group, around the ring as the reference's ``ppermute``
goes; the values that cross the ring's wrap edge are discarded (rank 0
starts each band from its own slab, the last rank's halo is zero).

Drift coordinates: each band's sweep emits its output shifted right by
``k_b - 1`` columns, so after band ``pb`` a slab holds matrix column
``i - pb*(k_b - 1)`` at state index ``i``; the content drifts through
right padding and is sliced back once at the end.  Per superstep a rank
moves ``O(m_loc * k_b)`` elements against the ``O(m_loc * n_loc)`` it
computes on.  A rank idle in a superstep (before its first band or after
its last) sends its slab head and no carry its neighbour would use, and
sweeps nothing.

The tile sweep is plain torch over :func:`repro_torch.core.blocked.
apply_tile` (``blocked``) or the tile factors of :mod:`repro_torch.core.
accumulate` (``accumulated``), as the reference sweeps in ``jax.lax``.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as tdist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.core.accumulate import _ieee_f32, accumulate_tile_factors
from repro_torch.core.blocked import apply_tile, pack_sheared
from repro_torch.core.sequence import RotationSequence
from repro_torch.dist.plan import (_distribute, _mesh_devices,
                                   _placements)

__all__ = [
    "rot_sequence_column_sharded",
    "rot_sequence_column_sharded_padded",
    "column_sharded_comm_bytes",
]


def _require_sequence(seq, mesh, who: str):
    """Typed arguments only: ``(A, seq, mesh)``, never raw wave arrays."""
    if not isinstance(seq, RotationSequence):
        raise TypeError(
            f"{who}(A, seq, mesh, ...) requires a RotationSequence; wrap "
            f"the waves: RotationSequence(C, S)")
    if mesh is None:
        raise TypeError(f"{who}() missing required argument: 'mesh'")
    return seq, mesh


def _sweep(carry, fresh, Ct, St, Gt, use_mxu: bool):
    """Sweep ``T`` tiles over ``fresh`` ``(m, T*n_b)`` with a ``k_b``
    carry; returns ``(final carry, emitted (m, T*n_b))``."""
    T, n_b, _ = Ct.shape
    Q = accumulate_tile_factors(Ct, St, Gt, dtype=carry.dtype) \
        if use_mxu else None
    out = []
    for t in range(T):
        X = torch.cat([carry, fresh[:, t * n_b:(t + 1) * n_b]], dim=1)
        if use_mxu:
            with _ieee_f32():
                X = X @ Q[t]
        else:
            X = apply_tile(X, Ct[t], St[t], Gt[t])
        out.append(X[:, :n_b])
        carry = X[:, n_b:]
    return carry, torch.cat(out, dim=1)


def _ring_exchange(send, dst: int, src: int, group, D: int):
    """Send ``send`` to global rank ``dst`` and receive its like from
    ``src`` in one ``batch_isend_irecv``; around a ring of one it is the
    value itself."""
    if D == 1:
        return send
    send = send.contiguous()
    recv = torch.empty_like(send)
    reqs = tdist.batch_isend_irecv([
        tdist.P2POp(tdist.isend, send, dst, group),
        tdist.P2POp(tdist.irecv, recv, src, group)])
    for req in reqs:
        req.wait()
    return recv


def rot_sequence_column_sharded(A, seq, mesh=None, *,
                                col_axis: str = "model",
                                n_b: int = 64, k_b: int = 16,
                                row_axes=(), method: str = "blocked"):
    """Column-sharded pipelined application of a :class:`RotationSequence`.

    ``A`` ``(m, W)`` is already padded (see
    :func:`rot_sequence_column_sharded_padded`): ``W = D * n_loc`` with
    ``n_loc = T_loc * n_b``, ``T_loc >= 2`` and ``W >= n + B*(k_b - 1)``
    for ``B`` bands over ``D`` ranks of ``col_axis``.  Rows may shard
    over ``row_axes`` too.  Each superstep first sweeps tile 0 of the
    rank's band, sends that tile's first output column left (the
    right-hand value the previous band's rank needs for its last tile),
    then sweeps the remaining tiles.  Returns a ``DTensor`` of the
    drifted state, placed like the input.
    """
    seq, mesh = _require_sequence(seq, mesh, "rot_sequence_column_sharded")
    if seq.sign is not None or seq.reflect:
        raise ValueError("the column-sharded pipeline takes plain rotation "
                         "sequences only (no per-entry signs, no "
                         "reflectors)")
    C, S = seq.cos, seq.sin
    m, W = A.shape
    J, k = C.shape
    D = _mesh_devices(mesh, col_axis)
    n_loc = W // D
    T_loc = n_loc // n_b
    delta = k_b - 1
    B = math.ceil(k / k_b)
    if W % D or n_loc % n_b or T_loc < 2 or W < (J + 1) + B * delta:
        raise ValueError(
            f"width {W} over {D} slabs needs slabs of >= 2 tiles of {n_b} "
            f"and room for {B} bands' drift past {J + 1} columns; pad with "
            f"rot_sequence_column_sharded_padded")
    use_mxu = method == "accumulated"
    dims = dict.fromkeys(row_axes, 0)
    dims[col_axis] = 1
    X = _distribute(A, mesh, _placements(mesh, dims))
    A_cur = X.to_local()
    m_loc = A_cur.shape[0]
    d = mesh.get_local_rank(col_axis)
    group = mesh.get_group(col_axis)
    right = tdist.get_global_rank(group, (d + 1) % D) if D > 1 else None
    left = tdist.get_global_rank(group, (d - 1) % D) if D > 1 else None
    carry_recv = A_cur.new_zeros((m_loc, k_b))
    for s in range(B + D - 1):
        pb = s - d
        active = 0 <= pb < B
        if active:
            Ct, St, Gt = pack_sheared(C, S, pb * k_b, k_b, n_b, T_loc,
                                      u0=d * n_loc - pb * delta)
            if d == 0:
                carry_in = torch.cat([A_cur.new_zeros((m_loc, k_b - 1)),
                                      A_cur[:, :1]], dim=1)
            else:
                carry_in = carry_recv
            fresh_own = A_cur[:, 1:]
            carry1, out0 = _sweep(carry_in, fresh_own[:, :n_b], Ct[:1],
                                  St[:1], Gt[:1], use_mxu)
            send = out0[:, :1]
        else:
            send = A_cur[:, :1]
        halo = _ring_exchange(send, left, right, group, D)
        if d == D - 1:
            halo = torch.zeros_like(halo)
        if active:
            fresh_rest = torch.cat([fresh_own[:, n_b:], halo], dim=1)
            carry_out, out_rest = _sweep(carry1, fresh_rest, Ct[1:], St[1:],
                                         Gt[1:], use_mxu)
            A_cur = torch.cat([out0, out_rest], dim=1)
        else:
            carry_out = carry_recv
        carry_recv = _ring_exchange(carry_out, right, left, group, D)
    return DTensor.from_local(A_cur, mesh, X.placements, run_check=False,
                              shape=X.shape, stride=X.stride())


def rot_sequence_column_sharded_padded(A, seq, mesh=None, *,
                                       col_axis: str = "model",
                                       n_b: int = 64, k_b: int = 16,
                                       row_axes=(),
                                       method: str = "blocked"):
    """Pad ``A`` for the drift and the slabs, run the pipeline, and
    return the ``(m, n)`` result as a plain tensor on every rank (the
    drifted state is gathered once, then sliced back)."""
    seq, mesh = _require_sequence(seq, mesh,
                                  "rot_sequence_column_sharded_padded")
    if isinstance(A, DTensor):
        A = A.full_tensor()
    m, n = A.shape
    J, k = seq.shape
    if J != n - 1:
        raise ValueError(f"waves {seq.shape} do not fit A {(m, n)}")
    D = _mesh_devices(mesh, col_axis)
    delta = k_b - 1
    B = math.ceil(k / k_b)
    # slabs of whole tiles, at least 2 a slab, D slabs past n + B*delta
    n_loc = max(2 * n_b, n_b * math.ceil((n + B * delta) / (D * n_b)))
    out = rot_sequence_column_sharded(
        F.pad(A, (0, D * n_loc - n)), seq, mesh, col_axis=col_axis,
        n_b=n_b, k_b=k_b, row_axes=row_axes, method=method)
    return out.full_tensor()[:, B * delta:B * delta + n]


def _live_waves(sequence: RotationSequence) -> int:
    """Waves holding at least one live plane, by the fused kernel's rule:
    an entry is dead iff it is the identity *rotation* ``(1, 0, -1)``
    (a padded reflector is live)."""
    C = sequence.cos.detach().cpu().numpy()
    S = sequence.sin.detach().cpu().numpy()
    if sequence.sign is not None:
        G = sequence.sign.detach().cpu().numpy()
    else:
        G = np.full_like(C, 1.0 if sequence.reflect else -1.0)
    live = ~((C == 1.0) & (S == 0.0) & (G < 0))
    return int(np.count_nonzero(live.any(axis=0)))


def column_sharded_comm_bytes(m_loc: int, n: int, k: int, D: int,
                              n_b: int, k_b: int, itemsize: int = 4, *,
                              sequence: Optional[RotationSequence] = None,
                              live_planes: Optional[int] = None) -> dict:
    """A rank's modeled traffic in the pipeline against an all-gather
    baseline (the distributed analogue of the paper's SS1.2).

    Only live bands are priced: a band of identity waves moves no
    boundary planes.  ``sequence`` counts live waves exactly (the fused
    kernel's rule); ``live_planes`` (the ``k_live`` bound) models a
    ``pad_to`` tail of ``ceil(live_planes / (n-1))`` leading live waves;
    with neither every band is live.  Returns ``{"pipelined",
    "allgather", "ratio", "bands", "live_bands"}`` (bytes; ``ratio =
    allgather / pipelined``).
    """
    J = max(1, n - 1)
    B = math.ceil(k / k_b)
    if sequence is not None:
        if tuple(sequence.shape) != (n - 1, k):
            raise ValueError(f"sequence shape {tuple(sequence.shape)} != "
                             f"waves ({n - 1}, {k})")
        waves = _live_waves(sequence)
    elif live_planes is not None:
        waves = min(k, math.ceil(max(0, int(live_planes)) / J))
    else:
        waves = k
    # live waves lead (pad_to tails and staircase fills trail them)
    live_bands = min(B, math.ceil(waves / k_b))
    supersteps = live_bands + D - 1
    per_step = m_loc * (1 + k_b + (k_b - 1)) * itemsize
    pipelined = supersteps * per_step
    allgather = live_bands * m_loc * n * itemsize
    return {"pipelined": pipelined, "allgather": allgather,
            "ratio": allgather / max(pipelined, 1),
            "bands": B, "live_bands": live_bands}
