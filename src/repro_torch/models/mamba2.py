"""Mamba-2 (SSD, state-space duality), the attention-free LM: mirror of
:mod:`repro.models.mamba2`.

Training and prefill use the chunked SSD: the sequence is padded to
whole chunks; within a chunk the dual quadratic form computes the
token-token interactions masked by the discretized decay, and a
recurrent state ``h (B, H, N, P)`` carries across chunks (a loop over
the chunks, not the tokens).  Decode is the pure recurrence, with a
``(B, conv_width - 1, conv_dim)`` conv state and a ``(B, H, N, P)`` SSM
state a layer, updated in place and read in the activations' dtype.

One stated difference from the reference: the intra-chunk decay mask is
``exp(where(causal, seg, -inf))``, not ``where(causal, exp(seg), 0)``.
The forward is the same bit for bit; above the diagonal ``seg`` is a
positive sum of decays that overflows ``exp`` at the published chunk of
256, and the reference's backward there is ``0 * inf = NaN``.

No positional rotation reaches this model; the paper's rotations reach
it through the SOAP-Givens optimizer.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.parallel.sharding import per_shard, shard

from .layers import (TreeModel, causal_conv, dense, dense_init, dense_spec,
                     embed_init, embed_spec, named_leaves, rmsnorm,
                     rmsnorm_init, rmsnorm_spec, stack_trees, stacked_spec,
                     tensors_of, unstack_rows)

__all__ = ["Mamba2", "init_params", "stack_params", "unstack_params",
           "ssd_chunked"]


def ssd_chunked(xbar, dtA, Bm, Cm, chunk: int):
    """Chunked SSD.

    ``xbar (B, L, H, P)``: dt-scaled inputs; ``dtA (B, L, H)``: log-decay
    a step; ``Bm``/``Cm (B, L, G, N)`` with ``H = G * (H // G)``.
    Returns ``y (B, L, H, P)``.
    """
    B, L, H, P = xbar.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = chunk
    # pad to a whole number of chunks: zero rows are exact no-ops in SSD
    # (dt = 0 -> decay 1, B = 0 -> no state update, masked outputs dropped)
    L_out = L
    Lp = -(-L // Q) * Q
    if Lp != L:
        xbar = F.pad(xbar, (0, 0, 0, 0, 0, Lp - L))
        dtA = F.pad(dtA, (0, 0, 0, Lp - L))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, Lp - L))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, Lp - L))
        L = Lp
    nC = L // Q
    hg = H // G
    xb = xbar.reshape(B, nC, Q, H, P)
    dA = dtA.reshape(B, nC, Q, H)
    Bc = Bm.reshape(B, nC, Q, G, N)
    Cc = Cm.reshape(B, nC, Q, G, N)

    cum = torch.cumsum(dA, dim=2)                       # (B,nC,Q,H)
    seg = cum[:, :, :, None] - cum[:, :, None, :]       # (B,nC,Qi,Qj,H)
    ii = torch.arange(Q, device=xbar.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    # masked before the exp: the same forward, a finite backward
    Lmask = torch.exp(torch.where(causal, seg, -torch.inf))

    # intra-chunk (dual quadratic form)
    scores = torch.einsum("bcqgn,bckgn->bcqkg", Cc, Bc)  # (B,nC,Qi,Qj,G)
    scores = scores.repeat_interleave(hg, dim=-1)        # expand to H
    M = scores * Lmask
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", M, xb)

    # chunk states: S_c = sum_j exp(cum_end - cum_j) B_j x_j^T
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)       # (B,nC,Q,H)
    Bh = Bc.repeat_interleave(hg, dim=3)                 # (B,nC,Q,H,N)
    S = torch.einsum("bcqh,bcqhn,bcqhp->bchnp", decay_end, Bh, xb)

    # inter-chunk recurrence over the chunk states, h emitted BEFORE its
    # chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])            # (B,nC,H)
    h = torch.zeros((B, H, N, P), dtype=xbar.dtype, device=xbar.device)
    hprev = []
    for c in range(nC):
        hprev.append(h)
        h = chunk_decay[:, c, :, None, None] * h + S[:, c]
    hprev = torch.stack(hprev, dim=1)                    # (B,nC,H,N,P)

    # inter-chunk output: y_j += C_j exp(cum_j) h_prev
    decay_in = torch.exp(cum)                            # (B,nC,Q,H)
    Ch = Cc.repeat_interleave(hg, dim=3)                 # (B,nC,Q,H,N)
    y_inter = torch.einsum("bcqh,bcqhn,bchnp->bcqhp", decay_in, Ch, hprev)
    return (y_intra + y_inter).reshape(B, L, H, P)[:, :L_out]


def _ssd_per_shard(xbar, dtA, Bm, Cm, chunk: int):
    """:func:`ssd_chunked` of ``DTensor`` inputs (a step under a mesh) on
    each rank's local tensors: the SSD is independent across
    batch rows and across heads, a group's ``B``/``C`` shared by its
    ``H // G`` heads.  A mesh dimension that shards ``xbar``'s batch
    (dim 0) keeps it on every input.  The mesh dimensions that shard its
    heads (dim 2), ``n`` blocks in all, keep them on ``xbar`` and
    ``dtA`` where each rank's block holds whole groups' heads in the
    order ``ssd_chunked`` maps them: one group (``B``/``C`` replicated),
    or ``G`` groups split as the heads are (``n`` divides ``H`` and
    ``G``; ``B``/``C`` sharded alike).  Otherwise they, and any other
    mesh dimension, are replicated first.  The output ``(B, L, H, P)``
    keeps ``xbar``'s resulting placements."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = xbar.device_mesh
    H, G = xbar.shape[2], Bm.shape[2]
    heads = [i for i, pl in enumerate(xbar.placements) if pl == Shard(2)]
    n = math.prod(mesh.size(i) for i in heads)
    keep = H % n == 0 and (G == 1 or G % n == 0)
    px, pa, pb = [], [], []
    for i, pl in enumerate(xbar.placements):
        if pl == Shard(0):
            px.append(pl), pa.append(pl), pb.append(pl)
        elif i in heads and keep:
            px.append(pl), pa.append(pl)
            pb.append(pl if G > 1 else Replicate())
        else:
            px.append(Replicate()), pa.append(Replicate())
            pb.append(Replicate())
    return per_shard(lambda x, a, b, c: ssd_chunked(x, a, b, c, chunk),
                     (xbar, dtA, Bm, Cm), (px, pa, pb, pb), px,
                     xbar.shape)


def _ssm_update(dA, Bm, Cm, xbar, ssm):
    """One step of the SSM recurrence: ``dA (B, H)``, ``Bm``/``Cm (B, G,
    N)``, ``xbar (B, H, P)``, the state ``ssm (B, H, N, P)``; ``(y (B, H,
    P), new state)``."""
    hg = xbar.shape[1] // Bm.shape[1]
    Bh = Bm.repeat_interleave(hg, dim=1)                 # (B,H,N)
    Ch = Cm.repeat_interleave(hg, dim=1)
    ssm = dA[:, :, None, None] * ssm + Bh[..., None] * xbar[:, :, None, :]
    return torch.einsum("bhn,bhnp->bhp", Ch, ssm), ssm


def _ssm_update_per_shard(dA, Bm, Cm, xbar, ssm):
    """:func:`_ssm_update` of ``DTensor`` inputs (a decode step under a
    mesh) once a shard of the batch: the state's batch placements on
    every input (its other mesh dimensions replicated first), the heads
    whole on each rank."""
    from torch.distributed.tensor import Replicate, Shard
    pl = tuple(x if x == Shard(0) else Replicate() for x in ssm.placements)
    return per_shard(_ssm_update, (dA, Bm, Cm, xbar, ssm), (pl,) * 5,
                     (pl, pl), (xbar.shape, ssm.shape))


def _dims(cfg):
    """``(d_inner, H, G, N, P, conv_dim)``."""
    di = cfg.ssm_expand * cfg.d_model
    G, N = cfg.ssm_groups, cfg.ssm_state
    return (di, di // cfg.ssm_head_dim, G, N, cfg.ssm_head_dim,
            di + 2 * G * N)


def init_params(cfg, gen):
    """``{"embed", "ln_f", "layers"}``, drawn from ``gen`` in the
    reference's order (the blocks first, the embedding last)."""
    d = cfg.d_model
    di, H, G, N, _, conv_dim = _dims(cfg)
    layers = [{
        "norm": rmsnorm_init(d),
        "in_proj": dense_init(gen, d, 2 * di + 2 * G * N + H),
        "conv_w": torch.randn((cfg.conv_width, conv_dim),
                              generator=gen) * 0.2,
        "conv_b": torch.zeros((conv_dim,)),
        "A_log": torch.zeros((H,)),
        "D": torch.ones((H,)),
        "dt_bias": torch.zeros((H,)),
        "out_norm": rmsnorm_init(di),
        "out_proj": dense_init(gen, di, d),
    } for _ in range(cfg.n_layers)]
    return {"embed": embed_init(gen, cfg.vocab, d),
            "ln_f": rmsnorm_init(d), "layers": layers}


def stack_params(cfg, tree):
    """The reference's tree: the layers stacked ``(n_layers, ...)`` under
    ``blocks``."""
    out = {k: v for k, v in tree.items() if k != "layers"}
    out["blocks"] = stack_trees(tree["layers"])
    return out


def unstack_params(cfg, tree) -> dict:
    """``{parameter name: tensor}`` of a :class:`Mamba2` from the
    reference's tree (:func:`stack_params`)."""
    out = {}
    for key in ("embed", "ln_f"):
        out.update(named_leaves(tree[key], key))
    out.update(unstack_rows(tree["blocks"], lambda r: f"layers.{r}"))
    return out


class Mamba2(TreeModel):
    """Mamba-2 LM; see the module docstring and
    :class:`~repro_torch.models.layers.TreeModel` (weights, devices)."""

    def __init__(self, cfg, *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__(cfg, init_params, generator, device)
        (self.d_inner, self.H, self.G, self.N, self.P,
         self.conv_dim) = _dims(cfg)

    # -------------------------------------------------- logical axes ----

    def param_logical(self):
        """The logical axes of the reference's tree (:func:`stack_params`),
        leaf for leaf."""
        block = {
            "norm": rmsnorm_spec(),
            "in_proj": dense_spec("embed", "ff"),
            "conv_w": (None, "ff"),
            "conv_b": ("ff",),
            "A_log": (None,),
            "D": (None,),
            "dt_bias": (None,),
            "out_norm": rmsnorm_spec(),
            "out_proj": dense_spec("ff", "embed"),
        }
        return {"embed": embed_spec(), "ln_f": rmsnorm_spec(),
                "blocks": stacked_spec(block)}

    def cache_logical(self):
        """The logical axes of :meth:`init_cache`'s cache, leaf for leaf."""
        return {"idx": (), "layers": [
            {"conv": ("batch", None, "ff"), "ssm": ("batch", None, None,
                                                    None)}
            for _ in range(self.cfg.n_layers)]}

    def _split(self, zxbcdt):
        di, cd = self.d_inner, self.conv_dim
        return (zxbcdt[..., :di], zxbcdt[..., di:di + cd],
                zxbcdt[..., di + cd:])

    def _heads(self, xBC, lead):
        """``(x (.., H, P), B (.., G, N), C (.., G, N))`` of the conv's
        output."""
        di, GN = self.d_inner, self.G * self.N
        return (xBC[..., :di].reshape(*lead, self.H, self.P),
                xBC[..., di:di + GN].reshape(*lead, self.G, self.N),
                xBC[..., di + GN:].reshape(*lead, self.G, self.N))

    def _dt(self, p, dt):
        """``(A (H,), softplus(dt + dt_bias))`` in float32."""
        A = -torch.exp(p["A_log"].float())
        return A, F.softplus(dt.float() + p["dt_bias"].float())

    def _out(self, p, x, y, z):
        y = rmsnorm(p["out_norm"], y * F.silu(z))
        # seq-shard the projection before the residual add, as the
        # transformer's blocks do (the reference's scan carry is placed
        # ("batch", "seq", "embed"))
        return x + shard(dense(p["out_proj"], y), "batch", "seq", "embed")

    # -------------------------------------------------------- forward ----

    def _block(self, p, x):
        Bsz, L, _ = x.shape
        h = shard(rmsnorm(p["norm"], x), "batch", None, "embed")
        z, xBC, dt = self._split(dense(p["in_proj"], h))
        # temporal mixing needs the whole sequence: batch/ff sharding only
        z = shard(z, "batch", None, "ff")
        xBC = shard(xBC, "batch", None, "ff")
        xBC = F.silu(causal_conv(xBC, p["conv_w"].to(x.dtype))
                     + p["conv_b"].to(x.dtype))
        xs, Bm, Cm = self._heads(xBC, (Bsz, L))
        A, dt = self._dt(p, dt)
        dtA = (dt * A[None, None]).to(x.dtype)            # (B,L,H)
        xbar = xs * dt[..., None].to(x.dtype)
        ssd = _ssd_per_shard if isinstance(xbar, DTensor) else ssd_chunked
        y = ssd(xbar, dtA, Bm, Cm, min(self.cfg.ssm_chunk, L))
        y = y + p["D"].to(x.dtype)[None, None, :, None] * xs
        return self._out(p, x, y.reshape(Bsz, L, self.d_inner), z)

    def forward(self, tokens, remat: bool = False):
        """tokens (B, S) int -> logits (B, S, vocab); ``remat`` recomputes
        each layer in the backward, as the reference's does."""
        x = shard(self._embed(tokens), "batch", "seq", "embed")
        for p in self.layers:
            if remat:
                x = checkpoint(self._block, tensors_of(p), x,
                               use_reentrant=False)
            else:
                x = self._block(p, x)
        return self._logits(x)

    # ---------------------------------------------------------- decode ----

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        """``{"idx": 0, "layers": [{"conv" (B, conv_width - 1, conv_dim),
        "ssm" (B, H, N, P)}, ...]}``; ``max_len`` bounds nothing."""
        kw = dict(dtype=dtype, device=self.device)
        return {"idx": 0, "layers": [{
            "conv": torch.zeros((batch, self.cfg.conv_width - 1,
                                 self.conv_dim), **kw),
            "ssm": torch.zeros((batch, self.H, self.N, self.P), **kw),
        } for _ in range(self.cfg.n_layers)]}

    def _step(self, p, x, state):
        Bsz = x.shape[0]
        z, xBC, dt = self._split(dense(p["in_proj"], rmsnorm(p["norm"], x)))
        hist = torch.cat([state["conv"].to(x.dtype), xBC], dim=1)
        conv = torch.einsum("wd,bwd->bd", p["conv_w"].to(x.dtype), hist)
        xBC = F.silu(conv[:, None] + p["conv_b"].to(x.dtype))
        xs, Bm, Cm = self._heads(xBC, (Bsz,))
        A, dts = self._dt(p, dt[:, 0])
        dA = torch.exp(dts * A[None]).to(x.dtype)           # (B,H)
        xbar = xs * dts[..., None].to(x.dtype)
        step = (_ssm_update_per_shard if isinstance(xbar, DTensor)
                else _ssm_update)
        y, ssm = step(dA, Bm, Cm, xbar, state["ssm"].to(x.dtype))
        y = y + p["D"].to(x.dtype)[None, :, None] * xs
        state["conv"].copy_(hist[:, 1:])
        state["ssm"].copy_(ssm)
        return self._out(p, x, y.reshape(Bsz, 1, self.d_inner), z)

    def decode_step(self, cache, tokens):
        """tokens (B, 1) -> (logits (B, 1, vocab), cache), the cache
        updated in place; ``idx`` stays a Python int."""
        x = self._embed(tokens)
        for p, c in zip(self.layers, cache["layers"]):
            x = self._step(p, x, c)
        return self._logits(x), {"idx": cache["idx"] + 1,
                                 "layers": cache["layers"]}
