"""Decoder-only transformer covering the dense, MoE, MLA and windowed
families (smollm, starcoder2, llama3, gemma3, chameleon, deepseek-v2,
kimi-k2): mirror of :mod:`repro.models.transformer`.

The reference stacks each repeating group of layers and scans over it;
the port keeps one entry a layer in an ``nn.ModuleList`` and loops over
them.  Per layer, from the ``ModelConfig``: ``pattern_global`` slots use
full attention (with ``rope_base_global`` where set), the other slots
sliding-window attention when ``cfg.window`` is set; ``cfg.mla`` layers
use multi-head latent attention (a latent cache ``ckv``/``kr``); layers
from ``first_dense_layers`` on use the mixture-of-experts FFN when
``cfg.n_experts`` is set, the others the dense MLP.

Parameters keep the reference's tree under ``embed``, ``ln_f``,
``lm_head`` (untied configs) and ``layers[i]`` (``ln1``, ``attn``,
``ln2``, ``mlp``), in its ``(d_in, d_out)`` layout (experts ``(E, d_in,
d_out)``), drawn from a seeded ``torch.Generator`` on the host and then
moved to ``device``, so one seed gives the same weights on every device;
on the meta device nothing is drawn.

Training keeps the reference's own tree, with each scan group's layers
stacked ``(reps, ...)`` per slot under ``group{gi}``
(:func:`stack_params`): the optimizer then sees the shapes the
reference's optimizer sees, and a checkpoint holds the reference's
leaves.  :func:`unstack_params` names its rows by this module's
parameters, for ``torch.func.functional_call``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.parallel.sharding import shard

from .attention import (gqa_attention, gqa_decode, gqa_init, gqa_spec,
                        init_mla_cache, mla_attention, mla_decode, mla_init,
                        mla_spec)
from .layers import (TreeModel, dense, dense_init, dense_spec, embed_init,
                     embed_spec, mlp_gelu, mlp_init, mlp_spec, mlp_swiglu,
                     named_leaves, rmsnorm, rmsnorm_init, rmsnorm_spec,
                     softcap, stack_trees, stacked_spec, tensors_of,
                     unstack_rows)
from .moe import moe_ffn, moe_init, moe_spec

__all__ = ["Transformer", "init_params", "stack_params", "unstack_params"]


def _layer_kinds(cfg):
    """(attn_kind, mlp_kind) per layer index."""
    kinds = []
    for i in range(cfg.n_layers):
        slot = i % cfg.pattern_period
        attn = "global" if slot in cfg.pattern_global else "local"
        if cfg.window is None:
            attn = "global"
        mlp = "dense"
        if cfg.n_experts and i >= cfg.first_dense_layers:
            mlp = "moe"
        kinds.append((attn, mlp))
    return kinds


def _groups(cfg):
    """The reference's scan groups: ``(start, count, kinds-per-slot)``.

    Groups are maximal runs where the kind pattern repeats with period
    ``cfg.pattern_period``; the reference stacks a group's weights
    ``(count // len(slots), ...)`` per slot, so global layer
    ``start + r * len(slots) + s`` is repetition ``r`` of slot ``s``.
    """
    kinds = _layer_kinds(cfg)
    P = cfg.pattern_period
    groups = []
    i = 0
    while i < len(kinds):
        slot_kinds = tuple(kinds[i:i + P])
        if len(slot_kinds) < P:
            groups.append((i, len(kinds) - i, tuple(kinds[i:])))
            break
        j = i
        while (j + P <= len(kinds)
               and tuple(kinds[j:j + P]) == slot_kinds):
            j += P
        groups.append((i, j - i, slot_kinds))
        i = j
    return groups


def init_params(cfg, gen):
    """The parameter tree ``{"embed", "ln_f", ["lm_head"], "layers"}``,
    drawn from ``gen`` (``None``: the default generator, e.g. on the meta
    device) in the order the reference's initialisers take."""
    tree = {"embed": embed_init(gen, cfg.vocab, cfg.d_model),
            "ln_f": rmsnorm_init(cfg.d_model)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab)
    tree["layers"] = [{
        "ln1": rmsnorm_init(cfg.d_model),
        "attn": mla_init(gen, cfg) if cfg.mla else gqa_init(gen, cfg),
        "ln2": rmsnorm_init(cfg.d_model),
        "mlp": (moe_init(gen, cfg) if mlp_kind == "moe" else
                mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_gated)),
    } for _, mlp_kind in _layer_kinds(cfg)]
    return tree


def stack_params(cfg, tree):
    """The reference's parameter tree from :func:`init_params`' layout:
    global layer ``start + r * len(slots) + s`` becomes repetition ``r``
    of slot ``s`` of ``group{gi}`` (new tensors)."""
    out = {k: v for k, v in tree.items() if k != "layers"}
    layers = tree["layers"]
    for gi, (start, count, slot_kinds) in enumerate(_groups(cfg)):
        P = len(slot_kinds)
        out[f"group{gi}"] = [
            stack_trees([layers[start + r * P + s] for r in range(count // P)])
            for s in range(P)]
    return out


def unstack_params(cfg, tree) -> dict:
    """``{parameter name: tensor}`` of a :class:`Transformer` from the
    reference's tree (:func:`stack_params`), the group leaves split into
    their rows by ``torch.unbind`` (views, whose backward stacks the
    rows' gradients in one copy)."""
    out = {}
    for key in ("embed", "ln_f", "lm_head"):
        if key in tree:
            out.update(named_leaves(tree[key], key))
    for gi, (start, count, slot_kinds) in enumerate(_groups(cfg)):
        P = len(slot_kinds)
        for s, slot in enumerate(tree[f"group{gi}"]):
            out.update(unstack_rows(
                slot, lambda r, s=s: f"layers.{start + r * P + s}"))
    return out


class Transformer(TreeModel):
    """Decoder-only LM; see the module docstring and
    :class:`~repro_torch.models.layers.TreeModel` (weights, devices)."""

    def __init__(self, cfg, *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__(cfg, init_params, generator, device)
        self.kinds = _layer_kinds(cfg)

    # -------------------------------------------------- logical axes ----

    def _block_spec(self, kinds):
        cfg = self.cfg
        _, mlp_kind = kinds
        return {
            "ln1": rmsnorm_spec(),
            "attn": mla_spec(cfg) if cfg.mla else gqa_spec(cfg),
            "ln2": rmsnorm_spec(),
            "mlp": (moe_spec(cfg) if mlp_kind == "moe"
                    else mlp_spec(cfg.mlp_gated)),
        }

    def param_logical(self):
        """The logical axes of the reference's tree (:func:`stack_params`),
        leaf for leaf; a group's stacked (reps) axis is never sharded."""
        cfg = self.cfg
        spec = {"embed": embed_spec(), "ln_f": rmsnorm_spec()}
        if not cfg.tie_embeddings:
            spec["lm_head"] = dense_spec("embed", "vocab")
        for gi, (_, _, slot_kinds) in enumerate(_groups(cfg)):
            spec[f"group{gi}"] = [stacked_spec(self._block_spec(kinds))
                                  for kinds in slot_kinds]
        return spec

    def cache_logical(self):
        """The logical axes of :meth:`init_cache`'s cache, leaf for leaf."""
        if self.cfg.mla:
            one = {"ckv": ("batch", "seq", None),
                   "kr": ("batch", "seq", None)}
        else:
            one = {"k": ("batch", "seq", "kv_heads", None),
                   "v": ("batch", "seq", "kv_heads", None)}
        return {"idx": (), "layers": [dict(one) for _ in self.kinds]}

    def _attn_args(self, attn_kind):
        cfg = self.cfg
        window = cfg.window if attn_kind == "local" else None
        base = (cfg.rope_base_global
                if (attn_kind == "global" and cfg.rope_base_global)
                else cfg.rope_base)
        return window, base

    def _mlp(self, p, mlp_kind, x):
        if mlp_kind == "moe":
            return moe_ffn(p["mlp"], self.cfg, x)
        return (mlp_swiglu if self.cfg.mlp_gated else mlp_gelu)(p["mlp"], x)

    def _logits(self, x):
        cfg = self.cfg
        x = rmsnorm(self.ln_f, x)
        x = shard(x, "batch", None, "embed")  # SP: gather seq for lm head
        if cfg.tie_embeddings:
            # under a mesh the table's FSDP shards are gathered (vocab
            # stays over "model"), not the activations' batch
            logits = x @ shard(self.embed["e"], "vocab", None).to(x.dtype).T
        else:
            logits = dense(self.lm_head, x)
        logits = softcap(logits, cfg.logit_softcap)
        return shard(logits, "batch", None, "vocab")

    # -------------------------------------------------------- forward ----

    def _block(self, p, kinds, x):
        attn_kind, mlp_kind = kinds
        h = rmsnorm(p["ln1"], x)
        if self.cfg.mla:
            a, _ = mla_attention(p["attn"], self.cfg, h)
        else:
            window, base = self._attn_args(attn_kind)
            a, _ = gqa_attention(p["attn"], self.cfg, h, window=window,
                                 rope_base=base)
        # seq-shard the partial attention output before the residual add
        x = x + shard(a, "batch", "seq", "embed")
        m = self._mlp(p, mlp_kind, rmsnorm(p["ln2"], x))
        x = x + shard(m, "batch", "seq", "embed")
        return shard(x, "batch", "seq", "embed")

    def forward(self, tokens, remat: bool = False):
        """tokens (B, S) int -> logits (B, S, vocab).

        ``remat``: recompute each layer's activations in the backward
        (``torch.utils.checkpoint``), as the reference's ``remat`` does
        for each repetition of its scan; the values are the same.
        """
        x = shard(self._embed(tokens), "batch", "seq", "embed")
        for p, kinds in zip(self.layers, self.kinds):
            if remat:
                x = checkpoint(self._block, tensors_of(p), kinds, x,
                               use_reentrant=False)
            else:
                x = self._block(p, kinds, x)
        return self._logits(x)

    # ---------------------------------------------------------- decode ----

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        """``{"idx": 0, "layers": [{"k", "v"}, ...]}``; sliding-window
        layers get a ``window``-slot ring buffer (see ``gqa_decode``), MLA
        layers ``{"ckv", "kr"}`` (``init_mla_cache``)."""
        cfg = self.cfg
        layers = []
        for attn_kind, _ in self.kinds:
            if cfg.mla:
                layers.append(init_mla_cache(cfg, batch, max_len,
                                             dtype=dtype, device=self.device))
                continue
            is_local = attn_kind == "local" and cfg.window is not None
            length = min(cfg.window, max_len) if is_local else max_len
            shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
            layers.append({
                "k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device)})
        return {"idx": 0, "layers": layers}

    def decode_step(self, cache, tokens):
        """tokens (B, 1) -> (logits (B, 1, vocab), new cache).

        The cache tensors are updated in place; ``idx`` stays a Python
        int, so a step never waits on the card.
        """
        idx = cache["idx"]
        x = self._embed(tokens)
        for p, c, (attn_kind, mlp_kind) in zip(self.layers, cache["layers"],
                                               self.kinds):
            h = rmsnorm(p["ln1"], x)
            if self.cfg.mla:
                a, c["ckv"], c["kr"] = mla_decode(
                    p["attn"], self.cfg, h, c["ckv"], c["kr"], idx)
            else:
                window, base = self._attn_args(attn_kind)
                a, c["k"], c["v"] = gqa_decode(
                    p["attn"], self.cfg, h, c["k"], c["v"], idx,
                    window=window, rope_base=base)
            x = x + a
            x = x + self._mlp(p, mlp_kind, rmsnorm(p["ln2"], x))
        return self._logits(x), {"idx": idx + 1, "layers": cache["layers"]}
