"""GQA attention with RoPE, sliding windows and KV caches.

Mirror of the GQA half of :mod:`repro.models.attention` (multi-head
latent attention waits for the MoE/MLA slice).  The attention math is
plain PyTorch, in the reference's einsum order, with the softmax in
float32; ``F.scaled_dot_product_attention`` is not used, since its
accumulation order differs from the reference's.  RoPE goes through
the fused kernel (:func:`repro_torch.kernels.rope.ops.apply_rope`): one
launch for q and k together on the card, the plain reference on the
CPU.  Its cos/sin tables are row slices of one table a ``(head_dim,
base, dtype, device)`` (:func:`rope_rows`), so a decode step builds none
after its first.  Both full-sequence (train/prefill) and single-token
cached (decode) paths are provided.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.rope.ops import apply_rope, rope_tables

from .layers import dense, dense_init, rmsnorm, rmsnorm_init, softcap

__all__ = ["gqa_init", "gqa_attention", "gqa_decode", "attn_mask",
           "rope_rows"]

_FLASH_CHUNK = 512
_MASKED = -1e30
_ROPE_ROWS = 256  # positions of a RoPE table when it is first built
# (head_dim, base, dtype, device) -> (cos, sin) over positions 0 .. L-1;
# values of a pure function of the key, so sharing them between models
# and calls changes no result
_ROPE = {}


def gqa_init(gen, cfg):
    d, H, Hk, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, d, H * Dh),
        "wk": dense_init(gen, d, Hk * Dh),
        "wv": dense_init(gen, d, Hk * Dh),
        "wo": dense_init(gen, H * Dh, d),
    }
    if cfg.qk_norm:
        p["qn"] = rmsnorm_init(Dh)
        p["kn"] = rmsnorm_init(Dh)
    return p


def attn_mask(q_len: int, kv_len: int, window: Optional[int] = None,
              causal: bool = True, q_offset: int = 0, device=None):
    """(q_len, kv_len) boolean mask; ``q_offset`` = absolute pos of query 0."""
    qpos = torch.arange(q_len, device=device)[:, None] + q_offset
    kpos = torch.arange(kv_len, device=device)[None, :]
    m = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        m &= kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m


def rope_rows(start: int, count: int, head_dim: int, base: float, dtype,
              device):
    """cos/sin tables ``(count, head_dim // 2)`` of positions ``start ..
    start + count - 1``: contiguous row slices of one table a ``(head_dim,
    base, dtype, device)``, built by ``rope_tables`` over positions ``0 ..
    L - 1`` and built again at double the size when a position past ``L``
    is asked for.  ``rope_tables`` is elementwise in the position, so the
    rows equal tables built for those positions alone, bit for bit
    (``tests/test_torch_rope.py``)."""
    key = (head_dim, float(base), dtype, device)
    tabs = _ROPE.get(key)
    end = start + count
    if tabs is None or tabs[0].shape[0] < end:
        size = _ROPE_ROWS if tabs is None else tabs[0].shape[0]
        while size < end:
            size *= 2
        # built as normal tensors even while serving (inference_mode), so
        # a train step that takes the cached rows later can save them
        with torch.inference_mode(False):
            tabs = rope_tables(torch.arange(size, device=device), head_dim,
                               base, dtype=dtype)
        _ROPE[key] = tabs
    return tabs[0][start:end], tabs[1][start:end]


def _proj_qkv(p, cfg, x, start: int, base: float):
    B, S, d = x.shape
    H, Hk, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = dense(p["wq"], x).reshape(B, S, H, Dh)
    k = dense(p["wk"], x).reshape(B, S, Hk, Dh)
    v = dense(p["wv"], x).reshape(B, S, Hk, Dh)
    if cfg.qk_norm:
        q = rmsnorm(p["qn"], q)
        k = rmsnorm(p["kn"], k)
    if cfg.pos_type == "rope":
        cos, sin = rope_rows(start, S, Dh, base, q.dtype, x.device)
        q, k = apply_rope(q, k, cos, sin)
    return q, k, v


def _sdpa_dense(qg, k, v, mask, scale, cap):
    logits = torch.einsum("bshgd,bthd->bhgst", qg, k) * scale
    logits = softcap(logits, cap)
    if mask is not None:
        logits = torch.where(mask[None, None, None], logits, _MASKED)
    w = torch.softmax(logits.float(), dim=-1).to(qg.dtype)
    return torch.einsum("bhgst,bthd->bshgd", w, v)


def _sdpa_flash(qg, k, v, scale, cap, *, causal, window, q_offset):
    """Chunked online-softmax attention (flash-style, plain PyTorch).

    Never materialises the (S, T) score matrix or the (S, T) mask: walks
    key/value chunks with a running (max, denominator, accumulator) and
    rebuilds each chunk's causal/window mask from positions.
    """
    B, S, Hk, G, Dh = qg.shape
    T = k.shape[1]
    C = _FLASH_CHUNK
    nC = T // C
    dev = qg.device
    kc = k.reshape(B, nC, C, Hk, Dh).permute(1, 0, 2, 3, 4)
    vc = v.reshape(B, nC, C, Hk, Dh).permute(1, 0, 2, 3, 4)
    qpos = torch.arange(S, device=dev) + q_offset

    m_run = torch.full((B, Hk, G, S), -torch.inf, dtype=torch.float32,
                       device=dev)
    d_run = torch.zeros((B, Hk, G, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hk, G, S, Dh), dtype=qg.dtype, device=dev)
    for cidx in range(nC):
        kb, vb = kc[cidx], vc[cidx]
        s = torch.einsum("bshgd,bthd->bhgst", qg, kb) * scale
        s = softcap(s, cap).float()
        kpos = cidx * C + torch.arange(C, device=dev)
        mb = torch.ones((S, C), dtype=torch.bool, device=dev)
        if causal:
            mb &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mb &= kpos[None, :] > qpos[:, None] - window
        s = torch.where(mb[None, None, None], s, _MASKED)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        pr = torch.exp(s - m_new[..., None])
        d_run = d_run * alpha + pr.sum(dim=-1)
        acc = acc * alpha.to(acc.dtype)[..., None] + torch.einsum(
            "bhgst,bthd->bhgsd", pr.to(qg.dtype), vb).to(acc.dtype)
        m_run = m_new
    o = acc / torch.clamp(d_run, min=1e-30)[..., None].to(qg.dtype)
    return o.permute(0, 3, 1, 2, 4)  # (B,S,Hk,G,Dh)


def _sdpa(q, k, v, mask, scale, cap=0.0, *, causal=True, window=None,
          q_offset=0):
    """q (B,S,H,D), k/v (B,T,Hk,D) with H = G*Hk.

    A long query routes to the chunked flash path, which derives its
    masks from ``causal``/``window``/``q_offset`` (``mask`` is ignored
    there and may be None); a short one (decode) takes the dense path
    with the explicit ``mask``.
    """
    B, S, H, Dh = q.shape
    T, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    qg = q.reshape(B, S, Hk, G, Dh)
    if S >= 64 and T >= 2 * _FLASH_CHUNK and T % _FLASH_CHUNK == 0:
        o = _sdpa_flash(qg, k, v, scale, cap, causal=causal,
                        window=window, q_offset=q_offset)
    else:
        o = _sdpa_dense(qg, k, v, mask, scale, cap)
    return o.reshape(B, S, H * Dh)


def gqa_attention(p, cfg, x, *, window=None, rope_base=None, q_offset=0):
    """Full-sequence causal attention (train / prefill)."""
    S = x.shape[1]
    q, k, v = _proj_qkv(p, cfg, x, q_offset, rope_base or cfg.rope_base)
    mask = (attn_mask(S, S, window=window, device=x.device)
            if S < _FLASH_CHUNK else None)
    o = _sdpa(q, k, v, mask, cfg.head_dim ** -0.5, causal=True,
              window=window)
    return dense(p["wo"], o), (k, v)


def gqa_decode(p, cfg, x, k_cache, v_cache, idx: int, *, window=None,
               rope_base=None):
    """Single-token decode: x (B, 1, d); cache (B, T, Hk, Dh).

    ``idx`` is the position as a Python int, so no step waits on the
    card.  The new key and value are written into the caches in place
    (the reference returns updated copies); the caches are returned
    too.  A *window-sized* cache (``T <= window``, allocated by
    ``init_cache`` for sliding-window layers) is a ring buffer: slot
    ``idx % T`` is overwritten, and since softmax is
    permutation-invariant and RoPE phases are baked into cached keys at
    write time, nothing is reordered.  As the reference's
    ``dynamic_update_slice`` does, a slot past the end of a full-length
    cache is clamped to the last one.
    """
    T = k_cache.shape[1]
    q, k, v = _proj_qkv(p, cfg, x, idx, rope_base or cfg.rope_base)
    ring = window is not None and T <= window
    slot = idx % T if ring else min(idx, T - 1)
    k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
    kpos = torch.arange(T, device=x.device)
    mask = kpos <= idx  # once idx >= T every ring slot is valid
    if window is not None and not ring:
        mask &= kpos > idx - window
    o = _sdpa(q, k_cache.to(q.dtype), v_cache.to(q.dtype), mask[None, :],
              cfg.head_dim ** -0.5)
    return dense(p["wo"], o), k_cache, v_cache
