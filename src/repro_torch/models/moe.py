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

from repro_torch.parallel.sharding import shard

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
    N = xt.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    gate_vals, gate_idx = _gates(p, cfg, xt)
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
    experts = torch.arange(E, device=xt.device).expand(C, E).contiguous()
    starts = torch.searchsorted(sorted_ids, experts)
    pos_sorted = (torch.arange(Nl * K, device=xt.device)[None]
                  - starts.gather(1, sorted_ids))
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    pos = pos.reshape(C, Nl, K)
    return Route(gate_vals, gate_idx, pos, pos < cap, cap)


def moe_ffn(p, cfg, x, *, n_chunks: int = 1):
    """x (B, S, d) -> (B, S, d); top-k routed + optional shared experts."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    xt = shard(x.reshape(B * S, d), "batch", None)
    r = moe_route(p, cfg, xt, n_chunks)
    C, Nl, _ = r.pos.shape
    keepf = r.keep.to(xt.dtype)
    posc = torch.where(r.keep, r.pos, r.cap - 1)
    idx_c = r.gate_idx.reshape(C, Nl, K)
    chunk = torch.arange(C, device=x.device)[:, None, None].expand_as(idx_c)

    # dispatch: a kept pair lands alone in its slot; a dropped one adds
    # zero to its expert's last slot
    xc = shard(xt.reshape(C, Nl, d), "batch", None, None)
    upd = xc[:, :, None, :] * keepf[..., None]           # (C, Nl, K, d)
    buf = torch.zeros((C, E, r.cap, d), dtype=xt.dtype, device=x.device)
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
    out = ys.reshape(B, S, d)
    if cfg.n_shared_experts:
        out = out + mlp_swiglu(p["shared"], x)
    return out


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
