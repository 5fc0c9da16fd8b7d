"""GQA and MLA attention with RoPE, sliding windows and KV caches.

Mirror of :mod:`repro.models.attention`.  The attention math is
plain PyTorch, in the reference's einsum order, with the softmax in
float32; ``F.scaled_dot_product_attention`` is not used, since its
accumulation order differs from the reference's.  RoPE goes through
the fused kernel (:func:`repro_torch.kernels.rope.ops.apply_rope`): one
launch for q and k together on the card, the plain reference on the
CPU.  Its cos/sin tables are row slices of one table a ``(head_dim,
base, dtype, device)`` (:func:`rope_rows`), so a decode step builds none
after its first.  Both full-sequence (train/prefill) and single-token
cached (decode) paths are provided.

Multi-head latent attention (DeepSeek-V2) caches a compressed latent
``c_kv`` and one shared RoPE key head a token, and attends in the
absorbed form (``q_nope`` folded into the latent space by ``wk_b``).
Its decoupled RoPE part goes through the same fused kernel: the query
heads' ``qk_rope_dim`` tail and the one key head in one launch
(``Hk = 1``), each copied out of its projection first, since the kernel
takes contiguous operands.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.rope.ops import apply_rope, rope_tables
from repro_torch.parallel.sharding import gather_last_unless, shard

from .layers import (dense, dense_init, dense_spec, rmsnorm, rmsnorm_init,
                     rmsnorm_spec, softcap)

__all__ = ["gqa_init", "gqa_spec", "gqa_attention", "gqa_decode",
           "attn_mask", "rope_rows", "mla_init", "mla_spec",
           "mla_attention", "init_mla_cache", "mla_decode"]

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


def gqa_spec(cfg):
    p = {
        "wq": dense_spec("embed", "heads"),
        "wk": dense_spec("embed", "kv_heads"),
        "wv": dense_spec("embed", "kv_heads"),
        "wo": dense_spec("heads", "embed"),
    }
    if cfg.qk_norm:
        p["qn"] = rmsnorm_spec()
        p["kn"] = rmsnorm_spec()
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


def _split_heads(y, H: int, Dh: int):
    """``(B, S, H * Dh) -> (B, S, H, Dh)``.  A ``DTensor`` whose last dim
    is split into shards that do not divide ``H`` (SmolLM's 9 heads over a
    16-wide ``model`` axis) has that dim gathered first: ``DTensor``
    cannot unflatten it."""
    return gather_last_unless(y, H).reshape(*y.shape[:-1], H, Dh)


def _proj_qkv(p, cfg, x, start: int, base: float):
    B, S, d = x.shape
    H, Hk, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = shard(x, "batch", None, "embed")  # SP: gather seq at matmul entry
    q = _split_heads(dense(p["wq"], x), H, Dh)
    k = _split_heads(dense(p["wk"], x), Hk, Dh)
    v = _split_heads(dense(p["wv"], x), Hk, Dh)
    if cfg.qk_norm:
        q = rmsnorm(p["qn"], q)
        k = rmsnorm(p["kn"], k)
    # Megatron-SP convention: sequence is sharded BETWEEN blocks only;
    # inside attention the activations shard over batch x heads.  The
    # reference constrains q/k/v after RoPE; here before it, so the RoPE
    # kernel runs once a shard on whole sequences and heads
    q = shard(q, "batch", None, "heads", None)
    k = shard(k, "batch", None, "kv_heads", None)
    v = shard(v, "batch", None, "kv_heads", None)
    if cfg.pos_type == "rope":
        cos, sin = rope_rows(start, S, Dh, base, q.dtype, x.device)
        q, k = apply_rope(q, k, cos, sin)
    return q, k, v


def _chunked(S: int, T: int) -> bool:
    """Whether attention takes the chunked (flash) route: a long query
    over a long cache of whole chunks; the dense route otherwise."""
    return S >= 64 and T >= 2 * _FLASH_CHUNK and T % _FLASH_CHUNK == 0


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
    with the explicit ``mask``.  ``DTensor`` q, k, v (a step under a
    mesh) attend once a shard (:func:`_sdpa_per_shard`).
    """
    from torch.distributed.tensor import DTensor
    if isinstance(q, DTensor):
        return _sdpa_per_shard(q, k, v, mask, scale, cap, causal=causal,
                               window=window, q_offset=q_offset)
    B, S, H, Dh = q.shape
    T, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    qg = q.reshape(B, S, Hk, G, Dh)
    if _chunked(S, T):
        o = _sdpa_flash(qg, k, v, scale, cap, causal=causal,
                        window=window, q_offset=q_offset)
    else:
        o = _sdpa_dense(qg, k, v, mask, scale, cap)
    return o.reshape(B, S, H * Dh)


def _sdpa_per_shard(q, k, v, mask, scale, cap, **route):
    """:func:`_sdpa` of ``DTensor`` q ``(B, S, H, D)`` and k, v ``(B, T,
    Hk, D)`` on each rank's local tensors: attention is independent
    across batch rows and heads, so a rank's rows and its contiguous
    block of query heads need only its block of key heads.  A mesh
    dimension on which q, k and v do not share a batch (dim 0) or heads
    (dim 2) shard is replicated first.  The output ``(B, S, H * D)``
    keeps those placements (its last dim holds the heads)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = q.device_mesh
    pl = tuple(a if a == b == c and isinstance(a, Shard) and a.dim in (0, 2)
               else Replicate()
               for a, b, c in zip(q.placements, k.placements, v.placements))
    q, k, v = (x if tuple(x.placements) == pl else x.redistribute(mesh, pl)
               for x in (q, k, v))
    o = _sdpa(q.to_local(), k.to_local(), v.to_local(), mask, scale, cap,
              **route)
    B, S, H, Dh = q.shape
    return DTensor.from_local(o, mesh, pl, run_check=False,
                              shape=(B, S, H * Dh),
                              stride=(S * H * Dh, H * Dh, 1))


def gqa_attention(p, cfg, x, *, window=None, rope_base=None, q_offset=0):
    """Full-sequence causal attention (train / prefill)."""
    S = x.shape[1]
    q, k, v = _proj_qkv(p, cfg, x, q_offset, rope_base or cfg.rope_base)
    # the dense route needs the mask at every length (the reference's
    # builds it only below 512 tokens: ROADMAP Queue 3)
    mask = (None if _chunked(S, S) else
            attn_mask(S, S, window=window, device=x.device))
    o = _sdpa(q, k, v, mask, cfg.head_dim ** -0.5, causal=True,
              window=window)
    o = shard(o, "batch", None, "heads")
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


# ---------------------------------------------------------------- MLA ----

def mla_init(gen, cfg):
    """DeepSeek-style multi-head latent attention."""
    d, H = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    p = {}
    if cfg.q_lora:
        p["wq_a"] = dense_init(gen, d, cfg.q_lora)
        p["q_norm"] = rmsnorm_init(cfg.q_lora)
        p["wq_b"] = dense_init(gen, cfg.q_lora, H * (dn + dr))
    else:
        p["wq"] = dense_init(gen, d, H * (dn + dr))
    p["wkv_a"] = dense_init(gen, d, cfg.kv_lora + dr)
    p["kv_norm"] = rmsnorm_init(cfg.kv_lora)
    p["wkv_b"] = dense_init(gen, cfg.kv_lora, H * (dn + dv))
    p["wo"] = dense_init(gen, H * dv, d)
    return p


def mla_spec(cfg):
    p = {}
    if cfg.q_lora:
        p["wq_a"] = dense_spec("embed", None)
        p["q_norm"] = rmsnorm_spec()
        p["wq_b"] = dense_spec(None, "heads")
    else:
        p["wq"] = dense_spec("embed", "heads")
    p["wkv_a"] = dense_spec("embed", None)
    p["kv_norm"] = rmsnorm_spec()
    p["wkv_b"] = dense_spec(None, "heads")
    p["wo"] = dense_spec("heads", "embed")
    return p


def _mla_qkv(p, cfg, x, start: int):
    """``(q_nope (B,S,H,dn), q_rope (B,S,H,dr), c_kv (B,S,L), k_rope
    (B,S,dr))`` of positions ``start .. start + S - 1``."""
    B, S, _ = x.shape
    H, L = cfg.n_heads, cfg.kv_lora
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    x = shard(x, "batch", None, "embed")  # SP: gather seq at matmul entry
    if cfg.q_lora:
        q = dense(p["wq_b"], rmsnorm(p["q_norm"], dense(p["wq_a"], x)))
    else:
        q = dense(p["wq"], x)
    q = q.reshape(B, S, H, dn + dr)
    kv = dense(p["wkv_a"], x)
    c_kv = rmsnorm(p["kv_norm"], kv[..., :L])
    cos, sin = rope_rows(start, S, dr, cfg.rope_base, q.dtype, x.device)
    # one launch for the query heads' rope tails and the shared key head
    q_rope, k_rope = apply_rope(q[..., dn:].contiguous(),
                                kv[:, :, None, L:].contiguous(), cos, sin)
    q_nope = shard(q[..., :dn], "batch", None, "heads", None)
    q_rope = shard(q_rope, "batch", None, "heads", None)
    c_kv = shard(c_kv, "batch", None, None)
    return q_nope, q_rope, c_kv, k_rope[:, :, 0]


def _mla_flash(q_lat, q_rope, c_kv, k_rope, scale, q_offset):
    """Chunked online softmax over the latent cache (causal); the
    accumulator lives in the ``kv_lora`` latent space.  ``(B,S,H,L)``."""
    B, S, H, L = q_lat.shape
    T = c_kv.shape[1]
    C = _FLASH_CHUNK
    dev = q_lat.device
    ckv_c = c_kv.reshape(B, T // C, C, L)
    kr_c = k_rope.reshape(B, T // C, C, -1)
    qpos = torch.arange(S, device=dev) + q_offset
    m_run = torch.full((B, H, S), -torch.inf, dtype=torch.float32,
                       device=dev)
    d_run = torch.zeros((B, H, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, S, L), dtype=q_lat.dtype, device=dev)
    for cidx in range(T // C):
        ckb, krb = ckv_c[:, cidx], kr_c[:, cidx]
        s = (torch.einsum("bshl,btl->bhst", q_lat, ckb)
             + torch.einsum("bshd,btd->bhst", q_rope, krb)) * scale
        s = s.float()
        kpos = cidx * C + torch.arange(C, device=dev)
        mb = kpos[None, :] <= qpos[:, None]
        s = torch.where(mb[None, None], s, _MASKED)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        pch = torch.exp(s - m_new[..., None])
        d_run = d_run * alpha + pch.sum(dim=-1)
        acc = acc * alpha.to(acc.dtype)[..., None] + torch.einsum(
            "bhst,btl->bhsl", pch.to(q_lat.dtype), ckb).to(acc.dtype)
        m_run = m_new
    o = acc / torch.clamp(d_run, min=1e-30)[..., None].to(acc.dtype)
    return o.permute(0, 2, 1, 3)


def _mla_attend(p, cfg, q_nope, q_rope, c_kv, k_rope, mask, *,
                q_offset=0):
    """Latent attention: scores from the compressed cache ``(c_kv,
    k_rope)``; a long query with a long cache takes the chunked route,
    the rest the dense one with ``mask``."""
    B, S, H, dn = q_nope.shape
    T = c_kv.shape[1]
    dv, L = cfg.v_head_dim, cfg.kv_lora
    wkv_b = p["wkv_b"]["w"].reshape(L, H, dn + dv)
    wk_b, wv_b = wkv_b[..., :dn], wkv_b[..., dn:]
    # fold k's up-projection into q (absorbed form): q~ = q_nope @ wk_b^T
    q_lat = torch.einsum("bshd,lhd->bshl", q_nope, wk_b.to(q_nope.dtype))
    scale = (dn + cfg.qk_rope_dim) ** -0.5
    if _chunked(S, T):
        o_lat = _mla_flash(q_lat, q_rope, c_kv, k_rope, scale, q_offset)
    else:
        logits = (torch.einsum("bshl,btl->bhst", q_lat, c_kv)
                  + torch.einsum("bshd,btd->bhst", q_rope, k_rope)) * scale
        if mask is not None:
            logits = torch.where(mask[None, None], logits, _MASKED)
        w = torch.softmax(logits.float(), dim=-1).to(q_nope.dtype)
        o_lat = torch.einsum("bhst,btl->bshl", w, c_kv)
    o = torch.einsum("bshl,lhd->bshd", o_lat, wv_b.to(o_lat.dtype))
    return dense(p["wo"], o.reshape(B, S, H * dv))


def mla_attention(p, cfg, x, *, q_offset=0):
    """Full-sequence causal latent attention (train / prefill); returns
    the output and the layer's ``(c_kv, k_rope)``."""
    S = x.shape[1]
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, q_offset)
    mask = None if _chunked(S, S) else attn_mask(S, S, device=x.device)
    out = _mla_attend(p, cfg, q_nope, q_rope, c_kv, k_rope, mask,
                      q_offset=q_offset)
    return out, (c_kv, k_rope)


def init_mla_cache(cfg, batch: int, max_len: int, *, dtype=torch.bfloat16,
                   device=None):
    """One layer's latent cache ``{"ckv": (B, T, kv_lora), "kr": (B, T,
    qk_rope_dim)}`` (the reference stacks the layers and adds ``idx``)."""
    return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora), dtype=dtype,
                               device=device),
            "kr": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                              dtype=dtype, device=device)}


def mla_decode(p, cfg, x, ckv_cache, kr_cache, idx: int):
    """Single-token decode: x (B, 1, d); the caches are written at slot
    ``idx`` in place (clamped to the last slot, as ``gqa_decode``) and
    returned."""
    T = ckv_cache.shape[1]
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, idx)
    slot = min(idx, T - 1)
    ckv_cache[:, slot] = c_kv[:, 0].to(ckv_cache.dtype)
    kr_cache[:, slot] = k_rope[:, 0].to(kr_cache.dtype)
    mask = (torch.arange(T, device=x.device) <= idx)[None, :]
    out = _mla_attend(p, cfg, q_nope, q_rope, ckv_cache.to(x.dtype),
                      kr_cache.to(x.dtype), mask)
    return out, ckv_cache, kr_cache
