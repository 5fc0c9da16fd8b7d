"""Mixture-of-Experts FFN with capacity-based scatter dispatch.

Mirror of :mod:`repro.models.moe`.  Top-k routing with a per-expert
capacity: dispatch and combine scatter into and gather from a ``(C, E,
cap, d)`` buffer by ``(token, slot)`` indices, and the expert FFNs
(stacked SwiGLU, weights ``(E, d, d_ff)``) run as one batched product
over ``E``.  Shared experts (DeepSeek-style) run densely for every
token.  A token past its expert's capacity contributes zero.

Routing is exact (drop-free, ``cap = Nl * K``) when ``N * K <= 4096``,
so a serving step does not depend on the tokens batched with it, and
capacity-bounded above that (``cap = max(K, int(capacity_factor * Nl *
K / E))``), with chunk-local slots when ``N`` splits into ``n_chunks``.
A token's slot in its expert is its rank among the chunk's routed
``(token, k)`` pairs in token-major order: the reference's stable
``argsort``, kept by ``torch.argsort(..., stable=True)``, so the same
tokens are dropped.  ``moe_spec`` gives the reference's logical axes
(experts over ``"model"``), and its ``shard`` annotations stand where
it has them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import per_shard, shard

from .layers import dense_init, dense_spec, mlp_init, mlp_spec, mlp_swiglu

__all__ = ["moe_init", "moe_spec", "moe_route", "moe_ffn",
           "moe_ffn_dense_ref", "Route"]

_EXACT_ROUTED = 4096   # routed (token, k) pairs served drop-free


def moe_init(gen, cfg):
    d, E, dff = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    p = {
        "router": dense_init(gen, d, E, scale=0.02),
        "w_gate": torch.randn((E, d, dff), generator=gen) * d ** -0.5,
        "w_up": torch.randn((E, d, dff), generator=gen) * d ** -0.5,
        "w_down": torch.randn((E, dff, d), generator=gen) * dff ** -0.5,
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, d, dff * cfg.n_shared_experts, True)
    return p


def moe_spec(cfg):
    p = {
        "router": dense_spec("embed", None),
        "w_gate": ("experts", "embed", None),
        "w_up": ("experts", "embed", None),
        "w_down": ("experts", None, "embed"),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_spec(True)
    return p


def _gates(p, cfg, xt):
    """The router in float32: renormalised top-k gates and their experts,
    ``(N, K)`` each."""
    logits = xt.float() @ p["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.top_k, dim=-1)
    return gate_vals / gate_vals.sum(dim=-1, keepdim=True), gate_idx


class Route(NamedTuple):
    """Where :func:`moe_ffn` sends each token: ``gate_vals`` and
    ``gate_idx`` ``(N, K)``, and per chunk ``pos`` (the slot in the
    expert) and ``keep`` (``pos < cap``), ``(C, N // C, K)``."""
    gate_vals: torch.Tensor
    gate_idx: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    cap: int


def moe_route(p, cfg, xt, n_chunks: int = 1) -> Route:
    """Route the tokens ``xt (N, d)``: exact below ``_EXACT_ROUTED``
    routed pairs, else by capacity in ``n_chunks`` chunk-local groups
    (one group when ``N`` does not split)."""
    gate_vals, gate_idx = _gates(p, cfg, xt)
    return _slots(cfg, gate_vals, gate_idx, n_chunks)


def _slots(cfg, gate_vals, gate_idx, n_chunks: int) -> Route:
    """The :class:`Route` of the gates ``(N, K)``: each pair's slot."""
    N = gate_idx.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    exact = N * K <= _EXACT_ROUTED
    C = n_chunks if (not exact and N % n_chunks == 0) else 1
    Nl = N // C
    cap = Nl * K if exact else max(
        K, int(cfg.capacity_factor * Nl * K / E))
    # a pair's slot: its rank among its expert's pairs of the chunk, in
    # token-major order (a stable sort by expert)
    ids = gate_idx.reshape(C, Nl * K)
    order = torch.argsort(ids, dim=1, stable=True)
    sorted_ids = ids.gather(1, order)
    dev = gate_idx.device
    experts = torch.arange(E, device=dev).expand(C, E).contiguous()
    starts = torch.searchsorted(sorted_ids, experts)
    pos_sorted = (torch.arange(Nl * K, device=dev)[None]
                  - starts.gather(1, sorted_ids))
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    pos = pos.reshape(C, Nl, K)
    return Route(gate_vals, gate_idx, pos, pos < cap, cap)


def moe_ffn(p, cfg, x, *, n_chunks: int = 1):
    """x (B, S, d) -> (B, S, d); top-k routed + optional shared experts.
    Under a mesh (``DTensor`` tokens) the routed part is
    :func:`_routed_on_mesh`."""
    from torch.distributed.tensor import DTensor
    B, S, d = x.shape
    # SP: gather seq before the tokens are flattened
    x = shard(x, "batch", None, "embed")
    xt = shard(x.reshape(B * S, d), "batch", None)
    routed = _routed_on_mesh if isinstance(xt, DTensor) else _routed
    out = routed(p, cfg, xt, n_chunks).reshape(B, S, d)
    if cfg.n_shared_experts:
        out = out + mlp_swiglu(p["shared"], x)
    return out


def _routed(p, cfg, xt, n_chunks: int):
    """The routed experts' mix ``(N, d)`` of the tokens ``xt (N, d)``."""
    N, d = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    r = moe_route(p, cfg, xt, n_chunks)
    C, Nl, _ = r.pos.shape
    keepf = r.keep.to(xt.dtype)
    posc = torch.where(r.keep, r.pos, r.cap - 1)
    idx_c = r.gate_idx.reshape(C, Nl, K)
    chunk = torch.arange(C, device=xt.device)[:, None, None].expand_as(idx_c)

    # dispatch: a kept pair lands alone in its slot; a dropped one adds
    # zero to its expert's last slot
    xc = shard(xt.reshape(C, Nl, d), "batch", None, None)
    upd = xc[:, :, None, :] * keepf[..., None]           # (C, Nl, K, d)
    buf = torch.zeros((C, E, r.cap, d), dtype=xt.dtype, device=xt.device)
    buf = buf.index_put((chunk, idx_c, posc), upd, accumulate=True)
    buf = shard(buf, "batch", "experts", None, None)

    # the experts' SwiGLU, batched over E
    h = torch.einsum("cend,edf->cenf", buf, p["w_gate"].to(xt.dtype))
    u = torch.einsum("cend,edf->cenf", buf, p["w_up"].to(xt.dtype))
    ye = torch.einsum("cenf,efd->cend", F.silu(h) * u,
                      p["w_down"].to(xt.dtype))
    ye = shard(ye, "batch", "experts", None, None)

    # combine: gather each pair's slot back, mixed by its gate
    yk = ye[chunk, idx_c, posc]                          # (C, Nl, K, d)
    ys = (yk * (r.gate_vals.reshape(C, Nl, K).to(xt.dtype)
                * keepf)[..., None]).sum(dim=2)
    return ys.reshape(N, d)


def _experts(b, w_gate, w_up, w_down):
    """The experts' SwiGLU of a dispatch buffer ``(C, E, cap, d)``."""
    h = torch.einsum("cend,edf->cenf", b, w_gate.to(b.dtype))
    u = torch.einsum("cend,edf->cenf", b, w_up.to(b.dtype))
    return torch.einsum("cenf,efd->cend", F.silu(h) * u, w_down.to(b.dtype))


def _routed_on_mesh(p, cfg, xt, n_chunks: int):
    """:func:`_routed` of ``DTensor`` tokens ``xt (N, d)`` (rows over the
    batch axes), expert parallel over the axes that shard the expert
    stacks' dim 0 (``model``), every local step once a shard:

    1. the router on each rank's tokens (its weight gathered);
    2. the slots: the pairs' experts all-gathered (``N x K`` integers)
       and ranked on every rank alike, exactly as without a mesh (the
       same stable order, so the same pairs are kept), the gather the
       reference's global dispatch implies;
    3. dispatch: each rank scatters its tokens' pairs of its block of
       experts into a ``(C, E / ways, cap, d)`` buffer at their global
       slots; summed over the batch axes by a reduce-scatter along the
       slots (a slot holds one pair), so each rank computes
    4. its experts (their stacks gathered over the FSDP axes) on its
       block of slots, no expert row twice;
    5. combine: the rows all-gathered back over the batch axes, each
       rank mixes its tokens' pairs of its experts, and the partial
       mixes are summed over the expert axes (an all-reduce).
    """
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.compat import compute_local_shape_and_global_offset
    mesh = xt.device_mesh
    N, d = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    rep = (Replicate(),) * mesh.ndim
    tok = tuple(pl if pl == Shard(0) else Replicate()
                for pl in xt.placements)
    exp_ = tuple(Shard(0) if pw == Shard(0) and pt != Shard(0)
                 else Replicate()
                 for pw, pt in zip(p["w_gate"].placements, tok))
    gate_vals, gate_idx = per_shard(
        lambda x, w: _gates({"router": {"w": w}}, cfg, x),
        (xt, p["router"]["w"]), (tok, rep), (tok, tok), ((N, K), (N, K)))
    ids = gate_idx.full_tensor()
    r = _slots(cfg, None, ids, n_chunks)
    C, Nl, _ = r.pos.shape
    (n_loc, _), (t0, _) = compute_local_shape_and_global_offset(
        (N, d), mesh, tok)
    (e_loc,), (e0,) = compute_local_shape_and_global_offset(
        (E,), mesh, exp_)
    rows = torch.arange(t0, t0 + n_loc, device=xt.device)
    idx = ids[rows]                                      # (n, K)
    mine = (r.keep.reshape(N, K)[rows] & (idx >= e0)
            & (idx < e0 + e_loc))
    chunk = (rows // Nl)[:, None].expand_as(idx)
    slot = (torch.where(mine, idx - e0, 0),
            torch.where(mine, r.pos.reshape(N, K)[rows], r.cap - 1))

    def dispatch(x):
        upd = x[:, None, :] * mine.to(x.dtype)[..., None]   # (n, K, d)
        buf = torch.zeros((C, e_loc, r.cap, d), dtype=x.dtype,
                          device=x.device)
        return buf.index_put((chunk, *slot), upd, accumulate=True)

    def combine(y, g):
        yk = y[(chunk, *slot)]                               # (n, K, d)
        return (yk * (g.to(y.dtype) * mine.to(y.dtype))[..., None]).sum(
            dim=1)

    shape = (C, E, r.cap, d)
    gathered = tuple(Shard(1) if pe == Shard(0) else Replicate()
                     for pe in exp_)
    buf = per_shard(dispatch, (xt,), (tok,),
                    tuple(Partial() if pt == Shard(0) else pg
                          for pt, pg in zip(tok, gathered)), shape)
    by_slot = tuple(Shard(2) if pt == Shard(0) else pg
                    for pt, pg in zip(tok, gathered))
    ye = per_shard(_experts, (buf, p["w_gate"], p["w_up"], p["w_down"]),
                   (by_slot, exp_, exp_, exp_), by_slot, shape)
    ys = per_shard(combine, (ye, gate_vals), (gathered, tok),
                   tuple(pt if pt == Shard(0) else
                         Partial() if pe == Shard(0) else Replicate()
                         for pt, pe in zip(tok, exp_)), (N, d))
    return ys.redistribute(mesh, tok)


def moe_ffn_dense_ref(p, cfg, x):
    """Oracle: evaluate every expert densely, mask by top-k (tests only)."""
    B, S, d = x.shape
    E = cfg.n_experts
    xt = x.reshape(-1, d)
    gate_vals, gate_idx = _gates(p, cfg, xt)
    h = torch.einsum("nd,edf->enf", xt, p["w_gate"].to(xt.dtype))
    u = torch.einsum("nd,edf->enf", xt, p["w_up"].to(xt.dtype))
    ye = torch.einsum("enf,efd->end", F.silu(h) * u,
                      p["w_down"].to(xt.dtype))
    w = (F.one_hot(gate_idx, E).to(xt.dtype)
         * gate_vals[..., None].to(xt.dtype)).sum(dim=1)   # (N, E)
    ys = torch.einsum("en,end->nd", w.T, ye)
    out = ys.reshape(B, S, d)
    if cfg.n_shared_experts:
        out = out + mlp_swiglu(p["shared"], x)
    return out
