"""Shared neural-net building blocks: mirror of :mod:`repro.models.layers`.

Parameters are nested dicts of tensors (or the :class:`ParamTree`
modules :func:`to_module` makes of them, which index the same way), kept in the reference's layout: a dense weight is
``(d_in, d_out)`` and is applied as ``x @ w``.  Each ``*_init`` draws
float32 weights from a ``torch.Generator`` with the reference
initialiser's distribution; the two frameworks give different numbers
from one seed, so parity tests load the reference's weights
(:func:`repro_torch.convert.lm_params_from_reference`).  Each
``*_init`` has the reference's ``*_spec`` twin, the matching tree of
*logical axis tuples* that :mod:`repro_torch.parallel.sharding` turns
into placements, and the reference's ``shard(...)`` annotations stand
where it has them: they return their input without mesh rules.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.core.sequence import resolve_device
from repro_torch.parallel.sharding import shard

__all__ = [
    "dense_init", "dense_spec", "dense",
    "rmsnorm_init", "rmsnorm_spec", "rmsnorm",
    "layernorm_init", "layernorm_spec", "layernorm",
    "embed_init", "embed_spec",
    "mlp_init", "mlp_spec", "mlp_swiglu", "mlp_gelu",
    "causal_conv", "softcap", "ParamTree", "to_module", "tensors_of",
    "TreeModel", "stack_trees", "stacked_spec", "named_leaves",
    "unstack_rows",
]


def dense_init(gen, d_in: int, d_out: int, scale=None):
    w = torch.randn((d_in, d_out), generator=gen)
    w = w / math.sqrt(d_in) if scale is None else w * scale
    return {"w": w}


def dense_spec(l_in, l_out):
    return {"w": (l_in, l_out)}


def dense(p, x):
    return x @ p["w"].to(x.dtype)


def rmsnorm_init(d: int):
    return {"g": torch.zeros((d,))}  # gemma-style (1 + g)


def rmsnorm_spec():
    return {"g": (None,)}


def rmsnorm(p, x):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + 1e-6)
    return (y * (1.0 + p["g"].float())).to(x.dtype)


def layernorm_init(d: int):
    return {"g": torch.ones((d,)), "b": torch.zeros((d,))}


def layernorm_spec():
    return {"g": (None,), "b": (None,)}


def layernorm(p, x):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + 1e-5)
    return (y * p["g"].float() + p["b"].float()).to(x.dtype)


def embed_init(gen, vocab: int, d: int):
    return {"e": torch.randn((vocab, d), generator=gen) * 0.02}


def embed_spec():
    return {"e": ("vocab", "embed")}


def mlp_init(gen, d: int, d_ff: int, gated: bool):
    p = {
        "up": dense_init(gen, d, d_ff),
        "down": dense_init(gen, d_ff, d),
    }
    if gated:
        p["gate"] = dense_init(gen, d, d_ff)
    return p


def mlp_spec(gated: bool):
    p = {
        "up": dense_spec("embed", "ff"),
        "down": dense_spec("ff", "embed"),
    }
    if gated:
        p["gate"] = dense_spec("embed", "ff")
    return p


def mlp_swiglu(p, x):
    # Megatron-SP: gather seq before the matmuls so the ff-sharded weights
    # are used in place
    x = shard(x, "batch", None, "embed")
    h = F.silu(dense(p["gate"], x)) * dense(p["up"], x)
    h = shard(h, "batch", None, "ff")
    return dense(p["down"], h)


def mlp_gelu(p, x):
    x = shard(x, "batch", None, "embed")
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(dense(p["up"], x), approximate="tanh")
    h = shard(h, "batch", None, "ff")
    return dense(p["down"], h)


def causal_conv(x, w):
    """Causal depthwise convolution of ``x (B, L, D)`` with ``w (W, D)``
    along axis 1, summed tap by tap as the reference sums it."""
    W, L = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, W - 1, 0))
    return sum(w[i] * pad[:, i:i + L] for i in range(W))


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


def stacked_spec(spec):
    """A logical-axis tree with a leading unsharded axis on every leaf:
    the spec of its layers stacked (:func:`stack_trees`)."""
    if isinstance(spec, dict):
        return {k: stacked_spec(v) for k, v in spec.items()}
    return (None,) + spec


def stack_trees(trees):
    """One tree of matching ``trees``, each leaf their leaves stacked on a
    new first axis (``jax.tree.map(jnp.stack)``); new tensors."""
    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def named_leaves(tree, prefix: str) -> dict:
    """``{dotted name: leaf}`` of a nested dict under ``prefix``, as a
    module holding it names its parameters."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(named_leaves(v, f"{prefix}.{k}"))
        return out
    return {prefix: tree}


def unstack_rows(stacked, prefix_of) -> dict:
    """``{prefix_of(r) + "." + name: row r}`` of a tree whose leaves are
    stacked rows, split by ``torch.unbind`` (views, whose backward stacks
    the rows' gradients in one copy)."""
    out = {}
    for name, leaf in named_leaves(stacked, "").items():
        for r, row in enumerate(torch.unbind(leaf)):
            out[f"{prefix_of(r)}{name}"] = row
    return out


def tensors_of(m) -> dict:
    """The nested dict of the tensors module ``m`` holds now, indexed as
    ``m`` is (for ``torch.utils.checkpoint``: under ``functional_call``
    the recomputation in the backward runs after the swapped-in weights
    have left the module)."""
    out = dict(m.named_parameters(recurse=False))
    out.update((k, tensors_of(c)) for k, c in m.named_children())
    return out


class TreeModel(nn.Module):
    """An LM whose parameters are the tree ``init(cfg, gen)`` draws, each
    top-level key an attribute (a tensor as a parameter, a dict or list
    as :func:`to_module` makes it), frozen as built.

    ``generator`` (a CPU ``torch.Generator``, by default seeded 0) draws
    the weights on the host, in float32 as the reference's ``init``
    does, and they are then moved to ``device``, so one seed gives the
    same weights on every device; on ``device="meta"`` nothing is drawn
    (a template for ``load_state_dict(..., assign=True)``).
    """

    def __init__(self, cfg, init, generator=None, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        if device.type == "meta":
            with device:
                tree = init(cfg, None)
        else:
            gen = generator if generator is not None else \
                torch.Generator().manual_seed(0)
            tree = init(cfg, gen)
        for key, sub in tree.items():
            if isinstance(sub, torch.Tensor):
                self.register_parameter(
                    key, nn.Parameter(sub, requires_grad=False))
            else:
                setattr(self, key, to_module(sub))
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.embed["e"].device

    def _embed(self, tokens):
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        # gather, then cast: the same values as casting the whole table
        table = self.embed["e"]
        if isinstance(table, DTensor):
            # under a mesh: the table gathered whole (FSDP's all-gather,
            # its gradient reduce-scattered back), the rows taken by
            # F.embedding, whose backward DTensor can place (indexing's
            # index_put it cannot, on the card's torch)
            x = F.embedding(tokens, shard(table, None, None)).to(dt)
        else:
            x = table[tokens].to(dt)
        if cfg.emb_scale:
            x = x * torch.sqrt(torch.tensor(float(cfg.d_model), dtype=dt))
        return x

    def _logits(self, x):
        # the final norm, then the tied embedding as the head; under a
        # mesh its FSDP shards are gathered (vocab stays over "model"),
        # not the activations' batch
        x = shard(rmsnorm(self.ln_f, x), "batch", None, "embed")
        return x @ shard(self.embed["e"], "vocab", None).to(x.dtype).T

    def params(self):
        """The parameter tree ``init`` drew, as new tensors detached from
        the module."""
        def tree(m):
            if isinstance(m, nn.ModuleList):
                return [tree(c) for c in m]
            out = {k: v.detach().clone()
                   for k, v in m.named_parameters(recurse=False)}
            out.update((k, tree(c)) for k, c in m.named_children())
            return out

        return tree(self)
