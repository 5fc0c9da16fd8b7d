"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks and local
MQA, mirror of :mod:`repro.models.rglru`.

Pattern (R, R, A): two recurrent residual blocks a local-attention
block, then a tail of ``n_layers % 3`` blocks of the pattern's head;
every temporal block is followed by a GeGLU-initialised MLP block, which
the reference applies as ``mlp_gelu`` (its ``gate`` weight is drawn and
never read).  The RG-LRU recurrence ``h_t = a_t h_{t-1} + sqrt(1 -
a_t^2) (i_t * x_t)`` runs, for train and prefill, as a doubling scan of
the reference's own combine ``(a_l a_r, b_r + a_r b_l)``: ``ceil(log2
L)`` elementwise passes over the whole sequence (eager PyTorch has no
``associative_scan``); the products associate in another order than
``jax.lax.associative_scan``'s.  Decode is one fused step from the
cached state.  The attention blocks are the port's GQA with
``window=cfg.window`` and the default RoPE base, so their RoPE runs the
fused kernel on the card.

The port keeps one entry a layer in ``layers``; the reference stacks
the ``(R, R, A)`` slots ``(reps, ...)`` under ``group0`` and keeps the
tail as ``tail{i}`` (:func:`stack_params`).  Caches hold one entry a
layer, ``{"h", "conv"}`` for a recurrent one and a ``min(window,
max_len)``-slot ring ``{"k", "v"}`` for an attention one; they are
updated in place and keep the dtype they were made with, and the
recurrent state is read in the activations' dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.parallel.sharding import shard

from .attention import gqa_attention, gqa_decode, gqa_init, gqa_spec
from .layers import (TreeModel, causal_conv, dense, dense_init, dense_spec,
                     embed_init, embed_spec, mlp_gelu, mlp_init, mlp_spec,
                     named_leaves, rmsnorm, rmsnorm_init, rmsnorm_spec,
                     stack_trees, stacked_spec, tensors_of, unstack_rows)

__all__ = ["RecurrentHybrid", "init_params", "stack_params",
           "unstack_params", "linear_scan"]

_PATTERN = ("rec", "rec", "attn")


def _kind(i: int) -> str:
    # the tail repeats the pattern's head, so layer i is slot i % 3
    return _PATTERN[i % 3]


def _temporal_spec(cfg, kind):
    if kind == "attn":
        return {"attn": gqa_spec(cfg)}
    return {
        "in_x": dense_spec("embed", "ff"),
        "in_y": dense_spec("embed", "ff"),
        "conv_w": (None, "ff"),
        "conv_b": ("ff",),
        "gate_a": dense_spec("ff", None),
        "gate_i": dense_spec("ff", None),
        "lam": ("ff",),
        "out": dense_spec("ff", "embed"),
    }


def _block_spec(cfg, kind):
    return {
        "ln1": rmsnorm_spec(),
        "temporal": _temporal_spec(cfg, kind),
        "ln2": rmsnorm_spec(),
        "mlp": mlp_spec(True),
    }


def _temporal_init(gen, cfg, kind):
    if kind == "attn":
        return {"attn": gqa_init(gen, cfg)}
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    return {
        "in_x": dense_init(gen, d, w),
        "in_y": dense_init(gen, d, w),
        "conv_w": torch.randn((cfg.conv_width, w), generator=gen) * 0.2,
        "conv_b": torch.zeros((w,)),
        "gate_a": dense_init(gen, w, w),
        "gate_i": dense_init(gen, w, w),
        "lam": torch.full((w,), 2.0),  # sigmoid(2) ~ .88 decay
        "out": dense_init(gen, w, d),
    }


def init_params(cfg, gen):
    """``{"embed", "ln_f", "layers"}``, each layer ``{"ln1", "temporal",
    "ln2", "mlp"}``, drawn from ``gen`` in the reference's order."""
    tree = {"embed": embed_init(gen, cfg.vocab, cfg.d_model),
            "ln_f": rmsnorm_init(cfg.d_model)}
    tree["layers"] = [{
        "ln1": rmsnorm_init(cfg.d_model),
        "temporal": _temporal_init(gen, cfg, _kind(i)),
        "ln2": rmsnorm_init(cfg.d_model),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, True),
    } for i in range(cfg.n_layers)]
    return tree


def stack_params(cfg, tree):
    """The reference's tree: layer ``3 r + s`` becomes repetition ``r`` of
    slot ``s`` of ``group0``, layer ``3 reps + t`` ``tail{t}``."""
    reps = cfg.n_layers // 3
    out = {k: v for k, v in tree.items() if k != "layers"}
    layers = tree["layers"]
    if reps:
        out["group0"] = [stack_trees([layers[3 * r + s] for r in range(reps)])
                         for s in range(3)]
    for t in range(cfg.n_layers % 3):
        out[f"tail{t}"] = layers[3 * reps + t]
    return out


def unstack_params(cfg, tree) -> dict:
    """``{parameter name: tensor}`` of a :class:`RecurrentHybrid` from the
    reference's tree (:func:`stack_params`)."""
    reps = cfg.n_layers // 3
    out = {}
    for key in ("embed", "ln_f"):
        out.update(named_leaves(tree[key], key))
    for s, slot in enumerate(tree.get("group0", ())):
        out.update(unstack_rows(slot, lambda r, s=s: f"layers.{3 * r + s}"))
    for t in range(cfg.n_layers % 3):
        out.update(named_leaves(tree[f"tail{t}"], f"layers.{3 * reps + t}"))
    return out


def linear_scan(a, b):
    """``h_t = a_t h_{t-1} + b_t`` from ``h_{-1} = 0`` along axis 1, as a
    doubling scan of the combine ``(a_l a_r, b_r + a_r b_l)``: after the
    pass of offset ``o`` each position holds the combine of the ``2 o``
    steps ending at it."""
    L = a.shape[1]
    for o in (1 << j for j in range(math.ceil(math.log2(L)) if L > 1
                                    else 0)):
        b = torch.cat([b[:, :o], b[:, o:] + a[:, o:] * b[:, :-o]], dim=1)
        a = torch.cat([a[:, :o], a[:, o:] * a[:, :-o]], dim=1)
    return b


def _rglru(p, xw, h0=None):
    """RG-LRU over ``xw (B, L, w)``; ``(h, h_last)``."""
    r = torch.sigmoid(dense(p["gate_a"], xw))
    i = torch.sigmoid(dense(p["gate_i"], xw))
    log_a = 8.0 * r * F.logsigmoid(p["lam"].float())  # c = 8 (Griffin)
    a = torch.exp(log_a).to(xw.dtype)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                   min=1e-12)).to(xw.dtype) * (i * xw)
    if h0 is not None:
        gated = torch.cat([gated[:, :1] + (a[:, 0] * h0)[:, None],
                           gated[:, 1:]], dim=1)
    h = linear_scan(a, gated)
    return h, h[:, -1]


class RecurrentHybrid(TreeModel):
    """RG-LRU / local-attention LM; see the module docstring and
    :class:`~repro_torch.models.layers.TreeModel` (weights, devices)."""

    def __init__(self, cfg, *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__(cfg, init_params, generator, device)
        self.lru = cfg.lru_width or cfg.d_model
        self.kinds = [_kind(i) for i in range(cfg.n_layers)]

    # -------------------------------------------------- logical axes ----

    def param_logical(self):
        """The logical axes of the reference's tree (:func:`stack_params`),
        leaf for leaf."""
        cfg = self.cfg
        spec = {"embed": embed_spec(), "ln_f": rmsnorm_spec()}
        if cfg.n_layers // 3:
            spec["group0"] = [stacked_spec(_block_spec(cfg, kind))
                              for kind in _PATTERN]
        for t in range(cfg.n_layers % 3):
            spec[f"tail{t}"] = _block_spec(cfg, _PATTERN[t])
        return spec

    def cache_logical(self):
        """The logical axes of :meth:`init_cache`'s cache, leaf for leaf."""
        rec = {"h": ("batch", "ff"), "conv": ("batch", None, "ff")}
        attn = {"k": ("batch", "seq", "kv_heads", None),
                "v": ("batch", "seq", "kv_heads", None)}
        return {"idx": (), "layers": [dict(attn if kind == "attn" else rec)
                                      for kind in self.kinds]}

    # -------------------------------------------------------- forward ----

    def _recurrent(self, p, x):
        x = shard(x, "batch", None, "embed")
        xw = shard(dense(p["in_x"], x), "batch", None, "ff")
        yw = shard(F.gelu(dense(p["in_y"], x), approximate="tanh"),
                   "batch", None, "ff")
        xw = (causal_conv(xw, p["conv_w"].to(x.dtype))
              + p["conv_b"].to(x.dtype))
        h, _ = _rglru(p, xw)
        return dense(p["out"], h * yw)

    def _block(self, p, kind, x):
        h = rmsnorm(p["ln1"], x)
        if kind == "attn":
            a, _ = gqa_attention(p["temporal"]["attn"], self.cfg, h,
                                 window=self.cfg.window)
        else:
            a = self._recurrent(p["temporal"], h)
        x = x + a
        x = x + mlp_gelu(p["mlp"], rmsnorm(p["ln2"], x))
        return shard(x, "batch", "seq", "embed")

    def forward(self, tokens, remat: bool = False):
        """tokens (B, S) int -> logits (B, S, vocab); ``remat`` recomputes
        each layer in the backward, as the reference's does."""
        x = shard(self._embed(tokens), "batch", "seq", "embed")
        for p, kind in zip(self.layers, self.kinds):
            if remat:
                x = checkpoint(self._block, tensors_of(p), kind, x,
                               use_reentrant=False)
            else:
                x = self._block(p, kind, x)
        return self._logits(x)

    # ---------------------------------------------------------- decode ----

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        """``{"idx": 0, "layers": [...]}``: a recurrent layer's ``{"h" (B,
        w), "conv" (B, conv_width - 1, w)}``, an attention layer's ring
        ``{"k", "v"}`` of ``min(window, max_len)`` slots."""
        cfg = self.cfg
        T = min(cfg.window or max_len, max_len)
        kw = dict(dtype=dtype, device=self.device)
        layers = []
        for kind in self.kinds:
            if kind == "attn":
                shape = (batch, T, cfg.n_kv_heads, cfg.head_dim)
                layers.append({"k": torch.zeros(shape, **kw),
                               "v": torch.zeros(shape, **kw)})
            else:
                layers.append({
                    "h": torch.zeros((batch, self.lru), **kw),
                    "conv": torch.zeros((batch, cfg.conv_width - 1,
                                         self.lru), **kw)})
        return {"idx": 0, "layers": layers}

    def _recurrent_step(self, p, x, state):
        """One token through a recurrent block, ``x (B, 1, d)``; the state
        is read in ``x``'s dtype and written back in place."""
        xw = dense(p["in_x"], x)
        yw = F.gelu(dense(p["in_y"], x), approximate="tanh")
        hist = torch.cat([state["conv"].to(x.dtype), xw], dim=1)
        xw = (torch.einsum("wd,bwd->bd", p["conv_w"].to(x.dtype), hist)
              [:, None] + p["conv_b"].to(x.dtype))
        h, h_last = _rglru(p, xw, h0=state["h"].to(x.dtype))
        state["conv"].copy_(hist[:, 1:])
        state["h"].copy_(h_last)
        return dense(p["out"], h * yw)

    def decode_step(self, cache, tokens):
        """tokens (B, 1) -> (logits (B, 1, vocab), cache), the cache
        updated in place; ``idx`` stays a Python int."""
        cfg = self.cfg
        idx = cache["idx"]
        x = self._embed(tokens)
        for p, c, kind in zip(self.layers, cache["layers"], self.kinds):
            h = rmsnorm(p["ln1"], x)
            if kind == "attn":
                a, c["k"], c["v"] = gqa_decode(
                    p["temporal"]["attn"], cfg, h, c["k"], c["v"], idx,
                    window=cfg.window)
            else:
                a = self._recurrent_step(p["temporal"], h, c)
            x = x + a
            x = x + mlp_gelu(p["mlp"], rmsnorm(p["ln2"], x))
        return self._logits(x), {"idx": idx + 1, "layers": cache["layers"]}
