"""Port parity of the LM substrates: layers, GQA attention, Transformer.

The same numpy-seeded inputs and the reference's own weights (carried
across with ``repro_torch.convert.lm_params_from_reference``) go through
the reference's JAX functions and the port's, in float32, held to
``atol 5e-5, rtol 1e-4``: the matmuls and the softmax sum in another
order on the two sides.  ``Transformer.forward`` is compared on the
reduced configs of three dense architectures (SwiGLU, the plain GELU MLP
with its own RoPE base, and gemma3's sliding windows, qk-norm, global
RoPE base and embedding scale) and of the two MoE ones (deepseek's
multi-head latent attention, kimi's GQA, each with a dense first layer
and mixture-of-experts layers after it), and on a 2-layer config at
``S = T = 1024``, where attention takes the chunked flash route.  Within
the port, token-by-token decoding equals the full forward.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.models import attention as j_attn
from repro.models import build_model as j_build_model
from repro.models import layers as j_layers
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.kernels.rope import kernel as rope_k
from repro_torch.models import attention as attn
from repro_torch.models import build_model, layers
from repro_torch.models.transformer import Transformer, _groups
from repro_torch.models.zoo import reference_shapes, unstack_params

TOL = dict(atol=5e-5, rtol=1e-4)
FORWARD_ARCHS = ["smollm-135m", "starcoder2-3b", "gemma3-4b",
                 "deepseek-v2-lite-16b", "kimi-k2-1t-a32b"]
B, S = 2, 20


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               **TOL)


def _tokens(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


@pytest.fixture(scope="module")
def references():
    """Reference weights and forward logits of each compared model,
    built once for the module."""
    out = {}
    for arch in FORWARD_ARCHS:
        cfg = j_get_config(arch).reduced()
        model = j_build_model(cfg)
        params = _np_tree(model.init(jax.random.key(1)))
        toks = _tokens(cfg.vocab, B, S, 7)
        logits = model.forward(params, jnp.asarray(toks), remat=False)
        out[arch] = (params, toks, np.asarray(logits))
    flash = dataclasses.replace(j_get_config("smollm-135m").reduced(),
                                n_layers=2)
    model = j_build_model(flash)
    params = _np_tree(model.init(jax.random.key(5)))
    toks = _tokens(flash.vocab, 1, 1024, 8)
    out["flash"] = (params, toks, np.asarray(
        model.forward(params, jnp.asarray(toks), remat=False)))
    return out


# ------------------------------------------------------------- configs ----

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    assert ARCHS == J_ARCHS
    cfg, ref = get_config(arch), j_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(ref.reduced())


# -------------------------------------------------------------- layers ----

def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("name", ["dense", "rmsnorm", "mlp_swiglu",
                                  "mlp_gelu", "softcap"])
def test_layers_vs_reference(name):
    x = _x((2, 5, 16))
    d_ff = 24
    if name == "dense":
        p = {"w": _x((16, 12), 1)}
    elif name == "rmsnorm":
        p = {"g": _x((16,), 1)}
    elif name == "softcap":
        p = None
        x = 40.0 * x
    else:
        p = {"up": {"w": _x((16, d_ff), 1)}, "down": {"w": _x((d_ff, 16), 2)}}
        if name == "mlp_swiglu":
            p["gate"] = {"w": _x((16, d_ff), 3)}
    if name == "softcap":
        _close(layers.softcap(torch.from_numpy(x), 30.0),
               j_layers.softcap(jnp.asarray(x), 30.0))
        t = torch.from_numpy(x)
        assert layers.softcap(t, 0.0) is t
        return
    fp, fj = getattr(layers, name), getattr(j_layers, name)
    _close(fp(_t_tree(p), torch.from_numpy(x)),
           fj(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))


def test_init_helpers_follow_the_reference_shapes_and_scales():
    gen = torch.Generator().manual_seed(0)
    w = layers.dense_init(gen, 400, 300)["w"]
    assert w.shape == (400, 300) and abs(float(w.std()) - 0.05) < 2e-3
    e = layers.embed_init(gen, 1000, 64)["e"]
    assert e.shape == (1000, 64) and abs(float(e.std()) - 0.02) < 1e-3
    assert torch.equal(layers.rmsnorm_init(8)["g"], torch.zeros(8))
    mlp = layers.mlp_init(gen, 8, 16, gated=False)
    assert set(mlp) == {"up", "down"}
    assert set(layers.mlp_init(gen, 8, 16, gated=True)) == {"up", "down",
                                                           "gate"}


# ----------------------------------------------------------- attention ----

@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("q_offset", [0, 5])
def test_attn_mask_vs_reference(window, q_offset):
    m = attn.attn_mask(6, 11, window=window, q_offset=q_offset)
    r = j_attn.attn_mask(6, 11, window=window, q_offset=q_offset)
    assert np.array_equal(m.numpy(), np.asarray(r))


def _attn_case(arch, seed):
    jcfg = j_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    p = _np_tree(j_attn.gqa_init(jax.random.key(seed), jcfg))
    if jcfg.qk_norm:  # non-trivial norm gains
        p["qn"]["g"] = _x(p["qn"]["g"].shape, seed + 1)
        p["kn"]["g"] = _x(p["kn"]["g"].shape, seed + 2)
    return jcfg, cfg, p


@pytest.mark.parametrize("arch,window,base", [
    ("smollm-135m", None, None), ("gemma3-4b", 4, None),
    ("gemma3-4b", None, 1e6)])
def test_gqa_attention_vs_reference(arch, window, base):
    jcfg, cfg, p = _attn_case(arch, 3)
    x = _x((2, 12, cfg.d_model), 4)
    out, (k, v) = attn.gqa_attention(_t_tree(p), cfg, torch.from_numpy(x),
                                     window=window, rope_base=base)
    rout, (rk, rv) = j_attn.gqa_attention(
        jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x), window=window,
        rope_base=base)
    _close(out, rout)
    _close(k, rk)
    _close(v, rv)


@pytest.mark.parametrize("arch,window,T", [
    ("smollm-135m", None, 10), ("gemma3-4b", 4, 10), ("gemma3-4b", 16, 8)])
def test_gqa_decode_vs_reference(arch, window, T):
    """Full-length and ring-buffer caches (``T <= window``), positions
    before and past the cache length."""
    jcfg, cfg, p = _attn_case(arch, 6)
    Hk, Dh = cfg.n_kv_heads, cfg.head_dim
    kc, vc = _x((2, T, Hk, Dh), 7), _x((2, T, Hk, Dh), 8)
    for idx in (3, T - 1, T + 5):
        if window is None and idx >= T:
            continue
        x = _x((2, 1, cfg.d_model), idx)
        out, k2, v2 = attn.gqa_decode(
            _t_tree(p), cfg, torch.from_numpy(x), torch.from_numpy(kc.copy()),
            torch.from_numpy(vc.copy()), idx, window=window)
        rout, rk, rv = j_attn.gqa_decode(
            jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x),
            jnp.asarray(kc), jnp.asarray(vc), jnp.int32(idx), window=window)
        _close(out, rout)
        _close(k2, rk)
        _close(v2, rv)


@pytest.mark.parametrize("window", [None, 300])
def test_flash_sdpa_vs_reference(window):
    S_, T, Hk, G, Dh = 128, 1024, 2, 2, 8
    q = _x((1, S_, Hk * G, Dh), 1)
    k, v = _x((1, T, Hk, Dh), 2), _x((1, T, Hk, Dh), 3)
    args = dict(causal=True, window=window, q_offset=T - S_)
    out = attn._sdpa(*map(torch.from_numpy, (q, k, v)), None, Dh ** -0.5,
                     **args)
    ref = j_attn._sdpa(*map(jnp.asarray, (q, k, v)), None, Dh ** -0.5,
                       **args)
    _close(out, ref)


# --------------------------------------------------------- transformer ----

@pytest.mark.parametrize("arch", FORWARD_ARCHS)
def test_forward_vs_reference(arch, references):
    params, toks, ref = references[arch]
    model = lm_params_from_reference(params, get_config(arch).reduced(),
                                     device="cpu")
    before = rope_k.LAUNCHES
    with torch.no_grad():
        out = model(torch.from_numpy(toks))
    assert rope_k.LAUNCHES == before
    assert out.shape == ref.shape
    _close(out, ref)


def test_flash_route_forward_vs_reference(references):
    params, toks, ref = references["flash"]
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                              n_layers=2)
    model = lm_params_from_reference(params, cfg, device="cpu")
    with torch.no_grad():
        _close(model(torch.from_numpy(toks)), ref)


@pytest.mark.parametrize("arch", FORWARD_ARCHS)
def test_decode_matches_forward(arch):
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(2))
    toks = torch.from_numpy(_tokens(cfg.vocab, B, S, 3))
    with torch.no_grad():
        full = model(toks)
        cache = model.init_cache(B, S, dtype=torch.float32)
        outs = []
        for t in range(S):
            lg, cache = model.decode_step(cache, toks[:, t:t + 1])
            outs.append(lg)
    assert cache["idx"] == S
    if cfg.window:  # local layers hold a window-sized ring buffer
        lens = {c["k"].shape[1] for c in cache["layers"]}
        assert lens == {cfg.window, S}
    if cfg.mla:  # the latent cache: c_kv and the shared rope key
        assert all(c["ckv"].shape == (B, S, cfg.kv_lora)
                   and c["kr"].shape == (B, S, cfg.qk_rope_dim)
                   for c in cache["layers"])
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               **TOL)


@pytest.mark.parametrize("arch,n_layers", [("smollm-135m", None),
                                           ("gemma3-4b", None),
                                           ("gemma3-4b", 8)])
def test_lm_params_from_reference_round_trip(arch, n_layers):
    """Every port weight is its reference slice bit for bit: global layer
    ``start + r * P + s`` is repetition ``r`` of slot ``s``."""
    jcfg = j_get_config(arch).reduced()
    if n_layers:  # a whole period of 6 and a tail group of 2
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, n_layers=jcfg.n_layers)
    params = _np_tree(j_build_model(jcfg).init(jax.random.key(9)))
    model = lm_params_from_reference(params, cfg, device="cpu")
    state = model.state_dict()
    assert np.array_equal(state["embed.e"].numpy(), params["embed"]["e"])
    assert np.array_equal(state["ln_f.g"].numpy(), params["ln_f"]["g"])
    seen = set()
    for gi, (start, count, slot_kinds) in enumerate(_groups(cfg)):
        P = len(slot_kinds)
        for r in range(count // P):
            for s_ in range(P):
                i = start + r * P + s_
                seen.add(i)
                slot = params[f"group{gi}"][s_]
                for name, leaf in (("attn.wq.w", slot["attn"]["wq"]["w"]),
                                   ("attn.wo.w", slot["attn"]["wo"]["w"]),
                                   ("mlp.down.w", slot["mlp"]["down"]["w"]),
                                   ("ln2.g", slot["ln2"]["g"])):
                    assert np.array_equal(
                        state[f"layers.{i}.{name}"].numpy(), leaf[r])
    assert seen == set(range(cfg.n_layers))
    # one port tensor per reference leaf and repetition, nothing else
    n_ref = sum(len(jax.tree.leaves(params[key]))
                for key in ("embed", "ln_f", "lm_head") if key in params)
    for gi, (_, count, slot_kinds) in enumerate(_groups(cfg)):
        n_ref += (len(jax.tree.leaves(params[f"group{gi}"]))
                  * (count // len(slot_kinds)))
    assert len(state) == n_ref
    # the weights sit in the reference's (d_in, d_out) layout
    assert state["layers.0.attn.wq.w"].shape == (cfg.d_model,
                                                 cfg.n_heads * cfg.head_dim)


def test_weights_come_from_the_seed_on_every_device():
    cfg = get_config("smollm-135m").reduced()
    a = Transformer(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(4))
    b = Transformer(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(4))
    c = Transformer(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(5))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["embed.e"], sc["embed.e"])
    assert not any(p.requires_grad for p in a.parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_every_family_builds(arch):
    """Every config at full width on the meta device (no weight drawn):
    the family's class, one parameter a row of the reference's tree."""
    cfg = get_config(arch)
    model = build_model(cfg, device="meta")
    want = {"ssm": "Mamba2", "hybrid": "RecurrentHybrid",
            "audio": "WhisperBackbone"}.get(cfg.family, "Transformer")
    assert type(model).__name__ == want
    assert model.device.type == "meta"
    state = model.state_dict()
    rows = unstack_params(cfg, reference_shapes(cfg))
    assert set(rows) == set(state)
    assert all(rows[k].shape == state[k].shape for k in state)


def test_the_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal is what a host without a card sees")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_config("smollm-135m").reduced())
