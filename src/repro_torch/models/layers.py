"""Shared neural-net building blocks: mirror of :mod:`repro.models.layers`.

Parameters are nested dicts of tensors (or the :class:`ParamTree`
modules :func:`to_module` makes of them, which index the same way), kept in the reference's layout: a dense weight is
``(d_in, d_out)`` and is applied as ``x @ w``.  Each ``*_init`` draws
float32 weights from a ``torch.Generator`` with the reference
initialiser's distribution; the two frameworks give different numbers
from one seed, so parity tests load the reference's weights
(:func:`repro_torch.convert.lm_params_from_reference`).  The
reference's ``shard(...)`` constraints are no-ops without mesh rules and
are left out until the distributed slice.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "dense_init", "dense",
    "rmsnorm_init", "rmsnorm",
    "embed_init",
    "mlp_init", "mlp_swiglu", "mlp_gelu",
    "softcap", "ParamTree", "to_module",
]


def dense_init(gen, d_in: int, d_out: int, scale=None):
    w = torch.randn((d_in, d_out), generator=gen)
    w = w / math.sqrt(d_in) if scale is None else w * scale
    return {"w": w}


def dense(p, x):
    return x @ p["w"].to(x.dtype)


def rmsnorm_init(d: int):
    return {"g": torch.zeros((d,))}  # gemma-style (1 + g)


def rmsnorm(p, x):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + 1e-6)
    return (y * (1.0 + p["g"].float())).to(x.dtype)


def embed_init(gen, vocab: int, d: int):
    return {"e": torch.randn((vocab, d), generator=gen) * 0.02}


def mlp_init(gen, d: int, d_ff: int, gated: bool):
    p = {
        "up": dense_init(gen, d, d_ff),
        "down": dense_init(gen, d_ff, d),
    }
    if gated:
        p["gate"] = dense_init(gen, d, d_ff)
    return p


def mlp_swiglu(p, x):
    h = F.silu(dense(p["gate"], x)) * dense(p["up"], x)
    return dense(p["down"], h)


def mlp_gelu(p, x):
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(dense(p["up"], x), approximate="tanh")
    return dense(p["down"], h)


def softcap(x, cap: float):
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


class ParamTree(nn.Module):
    """A dict of tensors and sub-dicts as a module, indexed like the dict:
    its tensors are parameters (frozen as built), its sub-dicts
    submodules, under the dict's keys."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))
            else:
                self.add_module(k, to_module(v))

    def __getitem__(self, key):
        return getattr(self, key)


def to_module(tree) -> nn.Module:
    """A nested dict of tensors as :class:`ParamTree` modules (lists as
    ``nn.ModuleList``), indexable exactly like the dict."""
    if isinstance(tree, (list, tuple)):
        return nn.ModuleList(to_module(t) for t in tree)
    return ParamTree(tree)
