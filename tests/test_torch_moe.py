"""Port parity of the MoE family: mixture-of-experts FFNs and multi-head
latent attention (DeepSeek-V2-Lite, Kimi-K2).

The reference's weights and the same numpy-seeded inputs go through the
reference's JAX functions and the port's, in float32, held to ``atol
5e-5, rtol 1e-4`` (the products sum in another order on the two sides):

* ``moe_ffn`` on the exact route (``N * K <= 4096``), after the routed
  experts (``gate_idx``) are found equal to the reference's top-k; on the
  capacity route (``B * S = 2100``, ``K = 2``) with a router biased so
  that one expert overflows, at ``n_chunks`` 1 and 2: the pairs the port
  keeps are those the reference keeps, read off the reference's output
  (each token's output is one of the four sums of its two experts'
  gated outputs); and against ``moe_ffn_dense_ref`` wherever nothing is
  dropped.
* ``mla_attention`` on the dense route, with and without ``q_lora``;
  ``mla_decode``; the chunked route through a 2-layer reduced deepseek at
  ``S = T = 1024``.
* ``lm_params_from_reference`` carries the MoE and MLA trees bit for
  bit and draws no weight; parameter counts from shapes alone.
* The train step's loss and gradients (with and without remat, and at
  4 x 1024 tokens, where routing takes the capacity route and MLA the
  chunked one).

Those marked ``gpu`` hold MLA on the card to its plain version (the
kernel's RoPE against ``apply_rope_ref``) bit for bit and one MoE layer
at DeepSeek-V2-Lite's width on the card to the host's; they decide
inside the test whether a card is present.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as j_attn
from repro.models import build_model as j_build_model
from repro.models import moe as j_moe
from repro.optim import AdamW as JAdamW
from repro.train.step import _loss_fn as j_loss_fn
from repro_torch.compat import ieee_float32
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference, \
    train_state_from_reference
from repro_torch.kernels.rope import kernel as rope_k
from repro_torch.kernels.rope.ops import apply_rope_ref
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models.transformer import _groups
from repro_torch.models.zoo import reference_shapes
from repro_torch.train.step import _value_and_grad
from repro_torch.tree import flatten_with_paths, leaves, map_tree

TOL = dict(atol=5e-5, rtol=1e-4)
DS, KIMI = "deepseek-v2-lite-16b", "kimi-k2-1t-a32b"


def _np_tree(tree):
    return jax.tree.map(np.array, tree)  # writable copies


def _t_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _j_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               **TOL)


def _cfgs(arch, **kw):
    return (dataclasses.replace(j_get_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


# ---------------------------------------------------------------- MoE ----

def _moe_case(arch, seed, bias=0.0):
    """Reference MoE weights; ``bias`` shifts expert 0's router column so
    that it is routed to far more than its share (the inputs lean the
    same way)."""
    jcfg, cfg = _cfgs(arch)
    p = _np_tree(j_moe.moe_init(jax.random.key(seed), jcfg))
    p["router"]["w"][:, 0] += bias
    return jcfg, cfg, p


def _ref_gates(p, x, K):
    """The reference's routing, ``(gate_vals, gate_idx)``: its float32
    router, softmax and ``lax.top_k`` (the first lines of its
    ``moe_ffn``)."""
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xt @ jnp.asarray(p["router"]["w"]), axis=-1)
    vals, idx = jax.lax.top_k(probs, K)
    return np.asarray(vals / vals.sum(-1, keepdims=True)), np.asarray(idx)


def _swiglu64(x, gate, up, down):
    """SwiGLU in float64 on every token: ``(N, d)``."""
    xt = x.reshape(-1, x.shape[-1]).astype(np.float64)
    h, u = xt @ gate.astype(np.float64), xt @ up.astype(np.float64)
    return (h / (1.0 + np.exp(-h)) * u) @ down.astype(np.float64)


def _kept_by_output(p, x, y, vals, idx):
    """Which of each token's two routed pairs the output ``y`` holds:
    the one of the four keep patterns whose gated sum (float64) is
    nearest ``y``, which must be within 1e-4 and far from the next."""
    E = p["w_gate"].shape[0]
    outs = np.stack([_swiglu64(x, p["w_gate"][e], p["w_up"][e],
                               p["w_down"][e]) for e in range(E)])
    sh = p["shared"]
    n = np.arange(idx.shape[0])
    routed = y.reshape(idx.shape[0], -1).astype(np.float64) - _swiglu64(
        x, sh["gate"]["w"], sh["up"]["w"], sh["down"]["w"])
    terms = [vals[:, k, None] * outs[idx[:, k], n] for k in range(2)]
    pats = [(a, b) for a in (0, 1) for b in (0, 1)]
    errs = np.stack([np.abs(routed - a * terms[0] - b * terms[1]).max(-1)
                     for a, b in pats])                         # (4, N)
    best = errs.argmin(0)
    ranked = np.sort(errs, axis=0)
    assert ranked[0].max() < 1e-4 and (ranked[1] > 100 * ranked[0]).all()
    return np.array(pats, bool)[best]


@pytest.mark.parametrize("arch", [DS, KIMI])
def test_moe_ffn_exact_route_vs_reference(arch):
    jcfg, cfg, p = _moe_case(arch, 3)
    x = _x((2, 9, cfg.d_model), 4)
    vals, idx = _ref_gates(p, x, cfg.top_k)
    route = moe.moe_route(_t_tree(p), cfg, torch.from_numpy(x).reshape(
        -1, cfg.d_model))
    assert np.array_equal(route.gate_idx.numpy(), idx)
    np.testing.assert_allclose(route.gate_vals.numpy(), vals, **TOL)
    assert route.cap == 18 * cfg.top_k and bool(route.keep.all())
    _close(moe.moe_ffn(_t_tree(p), cfg, torch.from_numpy(x)),
           j_moe.moe_ffn(_j_tree(p), jcfg, jnp.asarray(x)))


@pytest.mark.parametrize("n_chunks", [1, 2])
def test_moe_ffn_capacity_route_drops_what_the_reference_drops(n_chunks):
    """``N * K = 4200 > 4096``: capacity ``int(1.25 * Nl * K / E)`` a
    chunk, and expert 0, favoured by the router, overflows it."""
    jcfg, cfg, p = _moe_case(DS, 5, bias=0.08)
    x = _x((1, 2100, cfg.d_model), 6) + 0.3
    vals, idx = _ref_gates(p, x, cfg.top_k)
    xt = torch.from_numpy(x)
    route = moe.moe_route(_t_tree(p), cfg, xt.reshape(-1, cfg.d_model),
                          n_chunks)
    assert np.array_equal(route.gate_idx.numpy(), idx)
    Nl = 2100 // n_chunks
    assert route.pos.shape == (n_chunks, Nl, 2)
    assert route.cap == int(cfg.capacity_factor * Nl * 2 / cfg.n_experts)
    ref = np.asarray(j_moe.moe_ffn(_j_tree(p), jcfg, jnp.asarray(x),
                                   n_chunks=n_chunks))
    keep = route.keep.reshape(-1, 2).numpy()
    assert 0 < (~keep).sum() and (~keep[idx != 0]).sum() == 0
    assert np.array_equal(keep, _kept_by_output(p, x, ref, vals, idx))
    _close(moe.moe_ffn(_t_tree(p), cfg, xt, n_chunks=n_chunks), ref)


@pytest.mark.parametrize("arch,shape", [(DS, (2, 9)), (KIMI, (1, 2100))])
def test_moe_ffn_equals_the_dense_oracle_when_nothing_drops(arch, shape):
    """The exact route, and the capacity route with unbiased routing
    (no expert past its capacity); the port's oracle is the reference's
    too."""
    jcfg, cfg, p = _moe_case(arch, 7)
    x = torch.from_numpy(_x(shape + (cfg.d_model,), 8))
    route = moe.moe_route(_t_tree(p), cfg, x.reshape(-1, cfg.d_model))
    assert bool(route.keep.all())
    want = moe.moe_ffn_dense_ref(_t_tree(p), cfg, x)
    np.testing.assert_allclose(moe.moe_ffn(_t_tree(p), cfg, x).numpy(),
                               want.numpy(), **TOL)
    _close(want, j_moe.moe_ffn_dense_ref(_j_tree(p), jcfg,
                                         jnp.asarray(x.numpy())))


def test_moe_init_follows_the_reference_shapes_and_scales():
    cfg = dataclasses.replace(get_config(DS).reduced(), d_model=256,
                              d_ff_expert=64)
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    jp = jax.eval_shape(lambda k: j_moe.moe_init(k, cfg), jax.random.key(0))
    assert jax.tree.map(lambda s: tuple(s.shape), jp) == jax.tree.map(
        lambda t: tuple(t.shape), p)
    assert abs(float(p["router"]["w"].std()) - 0.02) < 2e-3
    assert abs(float(p["w_gate"].std()) - 256 ** -0.5) < 2e-3
    assert abs(float(p["w_down"].std()) - 64 ** -0.5) < 4e-3


# ---------------------------------------------------------------- MLA ----

def _mla_case(q_lora, seed):
    jcfg, cfg = _cfgs(DS, q_lora=q_lora)
    p = _np_tree(j_attn.mla_init(jax.random.key(seed), jcfg))
    for name in ("kv_norm", "q_norm"):  # non-trivial norm gains
        if name in p:
            p[name]["g"] = _x(p[name]["g"].shape, seed + 1)
    return jcfg, cfg, p


@pytest.mark.parametrize("q_lora", [0, 8])
def test_mla_attention_vs_reference(q_lora):
    jcfg, cfg, p = _mla_case(q_lora, 3)
    x = _x((2, 12, cfg.d_model), 4)
    before = rope_k.LAUNCHES
    out, (ckv, kr) = attn.mla_attention(_t_tree(p), cfg, torch.from_numpy(x))
    assert rope_k.LAUNCHES == before  # the CPU path launches nothing
    rout, (rckv, rkr) = j_attn.mla_attention(_j_tree(p), jcfg, jnp.asarray(x))
    assert kr.shape == (2, 12, cfg.qk_rope_dim)
    _close(out, rout)
    _close(ckv, rckv)
    _close(kr, rkr)


@pytest.mark.parametrize("q_lora", [0, 8])
def test_mla_decode_vs_reference(q_lora):
    jcfg, cfg, p = _mla_case(q_lora, 6)
    T = 10
    ckv = _x((2, T, cfg.kv_lora), 7)
    kr = _x((2, T, cfg.qk_rope_dim), 8)
    for idx in (3, T - 1):
        x = _x((2, 1, cfg.d_model), idx)
        out, c2, k2 = attn.mla_decode(
            _t_tree(p), cfg, torch.from_numpy(x), torch.from_numpy(ckv.copy()),
            torch.from_numpy(kr.copy()), idx)
        rout, rc, rk = j_attn.mla_decode(
            _j_tree(p), jcfg, jnp.asarray(x), jnp.asarray(ckv),
            jnp.asarray(kr), jnp.int32(idx))
        _close(out, rout)
        _close(c2, rc)
        _close(k2, rk)


def test_mla_chunked_route_forward_vs_reference():
    """A 2-layer reduced deepseek (one dense layer, one MoE) at ``S = T =
    1024``: attention takes the chunked route, routing the exact one."""
    jcfg, cfg = _cfgs(DS, n_layers=2)
    model = j_build_model(jcfg)
    params = _np_tree(model.init(jax.random.key(5)))
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (1, 1024))
    ref = model.forward(params, jnp.asarray(toks), remat=False)
    port = lm_params_from_reference(params, cfg, device="cpu")
    with torch.no_grad():
        _close(port(torch.from_numpy(toks)), ref)


@pytest.mark.parametrize("kind", ["gqa", "mla"])
def test_a_long_prompt_off_the_chunked_route_stays_causal(kind):
    """600 tokens take the dense route (600 is no whole number of 512-token
    chunks): the port masks it, so the first position's output does not
    move with the last token.  The reference builds no mask past 511
    tokens there and attends both ways (ROADMAP Queue 3)."""
    arch = DS if kind == "mla" else "smollm-135m"
    cfg = get_config(arch).reduced()
    gen = torch.Generator().manual_seed(0)
    p = (attn.mla_init if kind == "mla" else attn.gqa_init)(gen, cfg)
    run = attn.mla_attention if kind == "mla" else attn.gqa_attention
    x = torch.from_numpy(_x((1, 600, cfg.d_model), 1))
    y = x.clone()
    y[:, -1] += 1.0
    a, b = run(p, cfg, x)[0], run(p, cfg, y)[0]
    assert torch.equal(a[:, :-1], b[:, :-1])
    assert not torch.equal(a[:, -1], b[:, -1])


# ------------------------------------------------- weights and shapes ----

@pytest.mark.parametrize("arch", [DS, KIMI])
def test_lm_params_from_reference_carries_the_moe_tree(arch):
    """Every reference leaf, the experts' ``(reps, E, ...)`` stacks too, is
    the port's weight bit for bit; the template draws nothing from the
    default generator."""
    jcfg, cfg = _cfgs(arch)
    params = _np_tree(j_build_model(jcfg).init(jax.random.key(9)))
    state = torch.get_rng_state()
    model = lm_params_from_reference(params, cfg, device="cpu")
    assert torch.equal(torch.get_rng_state(), state)
    got = {}
    for name, t in model.state_dict().items():
        got[name] = t.numpy()
    ref = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
           jax.tree_util.tree_flatten_with_path(params)[0]}
    assert "['group1'][0]['mlp']['w_gate']" in ref
    assert ref["['group1'][0]['mlp']['w_gate']"].shape == (
        3, cfg.n_experts, cfg.d_model, cfg.d_ff_expert)
    groups = _groups(cfg)
    assert [(start, count) for start, count, _ in groups] == [(0, 1), (1, 3)]
    n = 0
    for path, leaf in ref.items():
        keys = [k.strip("'") for k in path[1:-1].split("][")]
        if keys[0].startswith("group"):
            gi, s_ = int(keys[0][5:]), int(keys[1])
            start, _, slots = groups[gi]
            for r in range(leaf.shape[0]):
                layer = start + r * len(slots) + s_
                name = f"layers.{layer}." + ".".join(keys[2:])
                assert np.array_equal(got[name], leaf[r]), name
                n += 1
        else:
            assert np.array_equal(got[".".join(keys)], leaf), path
            n += 1
    assert n == len(got)
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("arch,target", [
    (DS, 1.57e10), (KIMI, 1.03e12), ("mamba2-370m", 3.7e8),
    ("recurrentgemma-9b", 9.4e9), ("whisper-large-v3", 1.54e9)])
def test_param_counts_match_published(arch, target):
    """From shapes alone, as ``tests/test_models.py`` counts the
    reference's."""
    n = sum(t.numel() for t in leaves(reference_shapes(get_config(arch))))
    assert abs(n - target) / target < 0.08, (arch, n, target)


# ------------------------------------------------------ the train step ----

@pytest.fixture(scope="module")
def train_ref():
    """A 2-layer reduced deepseek's reference weights, and its loss and
    gradients at 2 x 16 and at 4 x 1024 tokens."""
    jcfg, cfg = _cfgs(DS, n_layers=2)
    model = j_build_model(jcfg)
    params = _np_tree(model.init(jax.random.key(0)))
    out = {}
    for b, s in ((2, 16), (4, 1024)):
        toks = np.random.default_rng(s).integers(
            0, cfg.vocab, (b, s + 1)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        (_, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p: j_loss_fn(model, jcfg, p, batch, remat=False),
            has_aux=True))(params)
        out[b, s] = (batch, float(metrics["loss"]), grads)
    return cfg, params, out


@pytest.mark.parametrize("tokens,remat", [((2, 16), False), ((2, 16), True),
                                          ((4, 1024), False)])
def test_train_step_loss_and_gradients_match_reference(train_ref, tokens,
                                                       remat):
    cfg, params, ref = train_ref
    batch, loss, grads = ref[tokens]
    model, tree, _ = train_state_from_reference(
        params, _np_tree(JAdamW().init(params)), cfg, device="cpu")
    metrics, got = _value_and_grad(model, cfg, tree, batch, remat)
    assert abs(float(metrics["loss"]) - loss) <= 1e-5 * loss
    want = [(jax.tree_util.keystr(k), np.asarray(v)) for k, v in
            jax.tree_util.tree_flatten_with_path(grads)[0]]
    port = flatten_with_paths(got)
    assert [p for p, _ in want] == [p for p, _ in port]
    for (path, a), (_, b) in zip(want, port):
        rel = np.linalg.norm(a - b.numpy()) / max(np.linalg.norm(a), 1e-30)
        assert rel <= 1e-4, path
        if path.endswith(("['wq']['w']", "['wkv_a']['w']", "['w_gate']")):
            assert np.abs(b.numpy()).max() > 0, path


# -------------------------------------------------------------- card ----

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_on_the_card_equals_its_plain_version(monkeypatch, dtype):
    """DeepSeek-V2-Lite's MLA widths: prefill and decode with the RoPE
    kernel (one launch a call) equal the same calls with its plain
    version, bit for bit."""
    dev = _cuda()
    cfg = get_config(DS)
    p = attn.mla_init(torch.Generator().manual_seed(0), cfg)
    p = map_tree(lambda t: t.to(dev), p)
    x = torch.from_numpy(_x((2, 12, cfg.d_model), 1)).to(dev, dtype)
    xd = torch.from_numpy(_x((2, 1, cfg.d_model), 2)).to(dev, dtype)

    def run():
        ckv = torch.zeros((2, 16, cfg.kv_lora), device=dev, dtype=dtype)
        kr = torch.zeros((2, 16, cfg.qk_rope_dim), device=dev, dtype=dtype)
        out, _ = attn.mla_attention(p, cfg, x)
        dec, ckv, kr = attn.mla_decode(p, cfg, xd, ckv, kr, 5)
        return out, dec, ckv, kr

    before = rope_k.LAUNCHES
    got = run()
    torch.cuda.synchronize()
    assert rope_k.LAUNCHES == before + 2
    monkeypatch.setattr(attn, "apply_rope", lambda q, k, c, s: (
        apply_rope_ref(q, c, s), apply_rope_ref(k, c, s)))
    want = run()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
def test_moe_layer_on_the_card_equals_the_host():
    """One MoE layer at DeepSeek-V2-Lite's width, float32 with TF32 off:
    the same experts routed and the output within the tolerance."""
    dev = _cuda()
    cfg = get_config(DS)
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(_x((8, 1, cfg.d_model), 3))
    with ieee_float32():
        pc = map_tree(lambda t: t.to(dev), p)
        card = moe.moe_ffn(pc, cfg, x.to(dev))
        r_card = moe.moe_route(pc, cfg, x.to(dev).reshape(8, -1))
    host = moe.moe_ffn(p, cfg, x)
    r_host = moe.moe_route(p, cfg, x.reshape(8, -1))
    assert torch.equal(r_card.gate_idx.cpu(), r_host.gate_idx)
    np.testing.assert_allclose(card.cpu().numpy(), host.numpy(), **TOL)
