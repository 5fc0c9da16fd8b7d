"""Whisper-style encoder-decoder transformer backbone: mirror of
:mod:`repro.models.whisper`.

The conv/mel frontend is the reference's stub: inputs are precomputed
frame embeddings ``(B, frames, d_model)`` that feed the bidirectional
encoder, which adds sinusoidal positions.  The decoder is a causal
transformer with learned positions (``pos_dec``) and cross-attention on
the encoder's output; its norms are LayerNorms (``ln1``, ``lnx``,
``ln2``, then ``ln_enc``/``ln_dec``).  No RoPE: the paper's rotations
reach this model only through the SOAP-Givens optimizer.

Decode: :meth:`WhisperBackbone.init_cache` runs the encoder once and
caches each decoder layer's cross-attention K/V beside its causal
self-attention cache.  The parameters are the module's own, so it takes
no ``params`` (the reference's ``init_cache(params, frames, ...)``).
The port keeps one entry a layer in ``enc`` and ``dec``; the reference
stacks each ``(layers, ...)`` (:func:`stack_params`).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.parallel.sharding import shard

from .attention import (_proj_qkv, _sdpa, attn_mask, gqa_decode, gqa_init,
                        gqa_spec)
from .layers import (TreeModel, dense, dense_init, dense_spec, embed_init,
                     embed_spec, layernorm, layernorm_init, layernorm_spec,
                     mlp_gelu, mlp_init, mlp_spec, named_leaves,
                     stack_trees, stacked_spec, tensors_of, unstack_rows)

__all__ = ["WhisperBackbone", "init_params", "stack_params",
           "unstack_params", "sinusoid"]


def sinusoid(length: int, d: int, dtype, device=None):
    """The encoder's positions ``(length, d)``: sines then cosines of
    ``pos / 10000^(2 i / d)``, computed in float32."""
    pos = torch.arange(length, device=device, dtype=torch.float32)[:, None]
    i = torch.arange(d // 2, device=device, dtype=torch.float32)[None, :]
    ang = pos / torch.pow(10000.0, 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def init_params(cfg, gen):
    """``{"embed", "pos_dec", "ln_enc", "ln_dec", "enc", "dec"}``, drawn
    from ``gen`` in the reference's order (encoder, decoder, embedding,
    ``pos_dec``)."""
    d, H, Dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    enc = [{"ln1": layernorm_init(d), "attn": gqa_init(gen, cfg),
            "ln2": layernorm_init(d),
            "mlp": mlp_init(gen, d, cfg.d_ff, False)}
           for _ in range(cfg.enc_layers)]
    dec = [{"ln1": layernorm_init(d), "attn": gqa_init(gen, cfg),
            "lnx": layernorm_init(d),
            "xattn": {"wq": dense_init(gen, d, H * Dh),
                      "wk": dense_init(gen, d, H * Dh),
                      "wv": dense_init(gen, d, H * Dh),
                      "wo": dense_init(gen, H * Dh, d)},
            "ln2": layernorm_init(d),
            "mlp": mlp_init(gen, d, cfg.d_ff, False)}
           for _ in range(cfg.dec_layers)]
    return {"embed": embed_init(gen, cfg.vocab, d),
            "pos_dec": torch.randn((cfg.dec_len, d), generator=gen) * 0.01,
            "ln_enc": layernorm_init(d), "ln_dec": layernorm_init(d),
            "enc": enc, "dec": dec}


def stack_params(cfg, tree):
    """The reference's tree: ``enc`` and ``dec`` stacked ``(layers,
    ...)``."""
    out = dict(tree)
    out["enc"] = stack_trees(tree["enc"])
    out["dec"] = stack_trees(tree["dec"])
    return out


def unstack_params(cfg, tree) -> dict:
    """``{parameter name: tensor}`` of a :class:`WhisperBackbone` from the
    reference's tree (:func:`stack_params`)."""
    out = {"pos_dec": tree["pos_dec"]}
    for key in ("embed", "ln_enc", "ln_dec"):
        out.update(named_leaves(tree[key], key))
    for key in ("enc", "dec"):
        out.update(unstack_rows(tree[key], lambda r, key=key: f"{key}.{r}"))
    return out


class WhisperBackbone(TreeModel):
    """Encoder-decoder LM; see the module docstring and
    :class:`~repro_torch.models.layers.TreeModel` (weights, devices)."""

    def __init__(self, cfg, *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__(cfg, init_params, generator, device)

    # -------------------------------------------------- logical axes ----

    def param_logical(self):
        """The logical axes of the reference's tree (:func:`stack_params`),
        leaf for leaf."""
        cfg = self.cfg
        enc = {"ln1": layernorm_spec(), "attn": gqa_spec(cfg),
               "ln2": layernorm_spec(), "mlp": mlp_spec(False)}
        xattn = {"wq": dense_spec("embed", "heads"),
                 "wk": dense_spec("embed", "heads"),
                 "wv": dense_spec("embed", "heads"),
                 "wo": dense_spec("heads", "embed")}
        dec = {"ln1": layernorm_spec(), "attn": gqa_spec(cfg),
               "lnx": layernorm_spec(), "xattn": xattn,
               "ln2": layernorm_spec(), "mlp": mlp_spec(False)}
        return {"embed": embed_spec(), "pos_dec": ("seq", "embed"),
                "ln_enc": layernorm_spec(), "ln_dec": layernorm_spec(),
                "enc": stacked_spec(enc), "dec": stacked_spec(dec)}

    def cache_logical(self):
        """The logical axes of :meth:`init_cache`'s cache, leaf for leaf."""
        one = {"k": ("batch", "seq", "kv_heads", None),
               "v": ("batch", "seq", "kv_heads", None),
               "xk": ("batch", "seq", "heads", None),
               "xv": ("batch", "seq", "heads", None)}
        return {"idx": (), "layers": [dict(one)
                                      for _ in range(self.cfg.dec_layers)]}

    def _logits(self, x):
        x = layernorm(self.ln_dec, x)
        return x @ self.embed["e"].to(x.dtype).T

    # -------------------------------------------------------- encoder ----

    def _enc_block(self, p, x):
        cfg = self.cfg
        q, k, v = _proj_qkv(p["attn"], cfg, layernorm(p["ln1"], x), 0,
                            cfg.rope_base)
        # bidirectional: no mask on the dense route, causal=False on the
        # flash one
        a = _sdpa(q, k, v, None, cfg.head_dim ** -0.5, causal=False)
        x = x + dense(p["attn"]["wo"], a)
        x = x + mlp_gelu(p["mlp"], layernorm(p["ln2"], x))
        return shard(x, "batch", "seq", "embed")

    def encode(self, frames, remat: bool = False):
        """frames ``(B, S_enc, d_model)``, the stub frontend's output ->
        the encoder's output."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        x = frames.to(dt) + sinusoid(frames.shape[1], cfg.d_model, dt,
                                     frames.device)
        x = shard(x, "batch", "seq", "embed")
        for p in self.enc:
            if remat:
                x = checkpoint(self._enc_block, tensors_of(p), x,
                               use_reentrant=False)
            else:
                x = self._enc_block(p, x)
        return layernorm(self.ln_enc, x)

    # -------------------------------------------------------- decoder ----

    def _cross_kv(self, p, enc_out):
        B = enc_out.shape[0]
        H, Dh = self.cfg.n_heads, self.cfg.head_dim
        return (dense(p["xattn"]["wk"], enc_out).reshape(B, -1, H, Dh),
                dense(p["xattn"]["wv"], enc_out).reshape(B, -1, H, Dh))

    def _cross(self, p, x, xk, xv):
        B = x.shape[0]
        H, Dh = self.cfg.n_heads, self.cfg.head_dim
        q = dense(p["xattn"]["wq"], layernorm(p["lnx"], x)).reshape(
            B, -1, H, Dh)
        a = _sdpa(q, xk, xv, None, Dh ** -0.5, causal=False)
        x = x + dense(p["xattn"]["wo"], a)
        return x + mlp_gelu(p["mlp"], layernorm(p["ln2"], x))

    def _dec_block(self, p, x, enc_out):
        cfg = self.cfg
        S = x.shape[1]
        q, k, v = _proj_qkv(p["attn"], cfg, layernorm(p["ln1"], x), 0,
                            cfg.rope_base)
        a = _sdpa(q, k, v, attn_mask(S, S, device=x.device),
                  cfg.head_dim ** -0.5)
        x = x + dense(p["attn"]["wo"], a)
        x = self._cross(p, x, *self._cross_kv(p, enc_out))
        return shard(x, "batch", "seq", "embed")

    def forward(self, frames, dec_tokens, remat: bool = False):
        """Teacher-forced: frames ``(B, S_enc, d_model)`` and decoder tokens
        ``(B, S)`` -> decoder logits ``(B, S, vocab)``."""
        enc_out = self.encode(frames, remat=remat)
        S = dec_tokens.shape[1]
        x = self._embed(dec_tokens) + self.pos_dec[:S].to(enc_out.dtype)
        for p in self.dec:
            if remat:
                x = checkpoint(self._dec_block, tensors_of(p), x, enc_out,
                               use_reentrant=False)
            else:
                x = self._dec_block(p, x, enc_out)
        return self._logits(x)

    # ---------------------------------------------------------- decode ----

    def init_cache(self, frames, max_len: int, dtype=torch.bfloat16):
        """Prefill: run the encoder on ``frames`` once and keep each
        decoder layer's cross K/V ``(B, frames, H, Dh)`` beside its
        self-attention cache ``(B, max_len, Hk, Dh)``, all in ``dtype``."""
        cfg = self.cfg
        enc_out = self.encode(frames)
        B = frames.shape[0]
        shape = (B, max_len, cfg.n_kv_heads, cfg.head_dim)
        kw = dict(dtype=dtype, device=self.device)
        layers = []
        for p in self.dec:
            xk, xv = self._cross_kv(p, enc_out)
            layers.append({"k": torch.zeros(shape, **kw),
                           "v": torch.zeros(shape, **kw),
                           "xk": xk.to(dtype), "xv": xv.to(dtype)})
        return {"idx": 0, "layers": layers}

    def decode_step(self, cache, tokens):
        """tokens (B, 1) -> (logits (B, 1, vocab), cache), the
        self-attention caches written in place; ``idx`` stays a Python
        int (past ``dec_len`` the last position is reused, as the
        reference's gather clamps)."""
        cfg = self.cfg
        idx = cache["idx"]
        x = self._embed(tokens)
        x = x + self.pos_dec[min(idx, cfg.dec_len - 1)].to(x.dtype)
        for p, c in zip(self.dec, cache["layers"]):
            a, c["k"], c["v"] = gqa_decode(
                p["attn"], cfg, layernorm(p["ln1"], x), c["k"], c["v"], idx)
            x = self._cross(p, x + a, c["xk"].to(x.dtype),
                            c["xv"].to(x.dtype))
        return self._logits(x), {"idx": idx + 1, "layers": cache["layers"]}
