"""Port parity of the recurrent LM families: the RG-LRU hybrid
(RecurrentGemma-9B) and Mamba-2 (Mamba2-370M).

The reference's weights (carried across with
``repro_torch.convert.lm_params_from_reference``) and the same
numpy-seeded inputs go through the reference's JAX functions and the
port's, in float32, held to ``atol 5e-5, rtol 1e-4`` (the matmuls sum in
another order on the two sides), at reduced widths: the forward of each
family (RecurrentGemma also at 5 layers, one ``(R, R, A)`` repetition
and a 2-block recurrent tail), decode sequences step by step (past the
reduced window of 16, so the attention ring wraps), the RG-LRU's
doubling scan against ``jax.lax.associative_scan``, the chunked SSD at
a ragged length, the weight conversion, the train step, ``ServeEngine``
and the serving launcher.

Two stated differences are shown.  At the published chunk of 256 the
reference's SSD gradient is NaN (``0 * inf`` from its decay mask) where
the port's is finite, with the same forward.  A bfloat16 model's decode
step over a float32 cache raises in the reference (its layer scan's
carry turns float32); the port reads the state in the activations'
dtype, so a float32 cache gives the bfloat16 cache's logits bit for bit.

The test marked ``gpu`` decodes each family on the card against the
host; it decides inside the test whether a card is present.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.models import mamba2 as j_mamba2
from repro.optim import AdamW as JAdamW
from repro.serve import ServeEngine as JServeEngine
from repro.train.step import _loss_fn as j_loss_fn
from repro_torch.compat import ieee_float32
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference, \
    train_state_from_reference
from repro_torch.kernels.rope import kernel as rope_k
from repro_torch.launch import serve as launcher
from repro_torch.models import mamba2, rglru
from repro_torch.models.zoo import build_model, stack_params, \
    unstack_params
from repro_torch.serve import ServeEngine
from repro_torch.train.step import _value_and_grad
from repro_torch.tree import flatten_with_paths

TOL = dict(atol=5e-5, rtol=1e-4)
RG, MAMBA = "recurrentgemma-9b", "mamba2-370m"
# (arch, n_layers): reduced() keeps 3 RecurrentGemma layers (no tail);
# 5 layers are one (R, R, A) repetition and the config's 2-block tail
CASES = {"rg": (RG, None), "rg5": (RG, 5), "mamba": (MAMBA, None)}
B, S = 2, 20
DECODE_S = 24   # past the reduced window of 16: the ring wraps


def _cfgs(name):
    arch, n_layers = CASES[name]
    jcfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    if n_layers:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return jcfg, cfg


def _np_tree(tree):
    return jax.tree.map(np.array, tree)  # writable copies


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tokens(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **(tol or TOL))


@pytest.fixture(scope="module")
def references():
    """Each case's reference weights, forward logits and decode logits
    step by step, built once for the module."""
    out = {}
    for i, name in enumerate(CASES):
        jcfg, _ = _cfgs(name)
        model = j_build_model(jcfg)
        params = _np_tree(model.init(jax.random.key(1 + i)))
        toks = _tokens(jcfg.vocab, B, DECODE_S, 7 + i)
        fwd = model.forward(params, jnp.asarray(toks[:, :S]), remat=False)
        cache = model.init_cache(B, DECODE_S, dtype=jnp.float32)
        step = jax.jit(model.decode_step)
        steps = []
        for t in range(DECODE_S):
            lg, cache = step(params, cache, jnp.asarray(toks[:, t:t + 1]))
            steps.append(np.asarray(lg))
        out[name] = (params, toks, np.asarray(fwd), steps)
    return out


# ------------------------------------------------------------ forward ----

@pytest.mark.parametrize("name", list(CASES))
def test_forward_vs_reference(name, references):
    params, toks, ref, _ = references[name]
    model = lm_params_from_reference(params, _cfgs(name)[1], device="cpu")
    before = rope_k.LAUNCHES
    with torch.no_grad():
        out = model(torch.from_numpy(toks[:, :S]))
    assert rope_k.LAUNCHES == before  # the plain version on the host
    assert out.shape == ref.shape
    _close(out, ref)


@pytest.mark.parametrize("name", list(CASES))
def test_decode_vs_reference(name, references):
    """Step by step from an empty cache, the ring of the attention
    layers wrapping after 16 steps."""
    params, toks, _, steps = references[name]
    cfg = _cfgs(name)[1]
    model = lm_params_from_reference(params, cfg, device="cpu")
    cache = model.init_cache(B, DECODE_S, dtype=torch.float32)
    with torch.no_grad():
        for t in range(DECODE_S):
            lg, cache = model.decode_step(cache,
                                          torch.from_numpy(toks[:, t:t + 1]))
            _close(lg, steps[t])
    assert cache["idx"] == DECODE_S
    if cfg.family == "hybrid":
        rings = {c["k"].shape[1] for c in cache["layers"] if "k" in c}
        assert rings == {cfg.window} and cfg.window < DECODE_S


@pytest.mark.parametrize("name", ["rg", "mamba"])
def test_decode_matches_forward(name):
    """Within the port, from seeded weights."""
    cfg = _cfgs(name)[1]
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(3))
    toks = torch.from_numpy(_tokens(cfg.vocab, B, S, 4))
    with torch.no_grad():
        full = model(toks)
        cache = model.init_cache(B, S, dtype=torch.float32)
        outs = []
        for t in range(S):
            lg, cache = model.decode_step(cache, toks[:, t:t + 1])
            outs.append(lg)
    _close(torch.cat(outs, 1), full.numpy())


@pytest.mark.parametrize("arch", [RG, MAMBA])
def test_cache_dtypes_after_a_bf16_step(arch):
    """A bfloat16 model: with a bfloat16 cache every leaf stays bfloat16,
    as the reference's step returns them, and the logits agree to
    bfloat16's precision; with a float32 cache (where the reference's
    step raises) the port's leaves stay float32 and its logits are the
    bfloat16 cache's bit for bit."""
    jcfg = dataclasses.replace(j_get_config(arch).reduced(),
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    model = j_build_model(jcfg)
    params = _np_tree(model.init(jax.random.key(4)))
    toks = _tokens(cfg.vocab, B, 3, 5)
    jc = model.init_cache(B, 8, dtype=jnp.bfloat16)
    ref = []
    for t in range(3):
        lg, jc = model.decode_step(params, jc, jnp.asarray(toks[:, t:t + 1]))
        ref.append(lg)
    want = {str(leaf.dtype) for leaf in jax.tree.leaves(jc)} - {"int32"}
    assert want == {"bfloat16"}
    with pytest.raises(TypeError, match="carry"):
        model.decode_step(params, model.init_cache(B, 8, dtype=jnp.float32),
                          jnp.asarray(toks[:, :1]))

    port = lm_params_from_reference(params, cfg, device="cpu")
    logits = {}
    for dt in (torch.bfloat16, torch.float32):
        cache = port.init_cache(B, 8, dtype=dt)
        logits[dt] = []
        with torch.no_grad():
            for t in range(3):
                lg, cache = port.decode_step(
                    cache, torch.from_numpy(toks[:, t:t + 1]))
                logits[dt].append(lg)
        got = {leaf.dtype for c in cache["layers"] for leaf in c.values()}
        assert got == {dt}
    for a, b, r in zip(logits[torch.bfloat16], logits[torch.float32], ref):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
        # a few bf16 roundings of the activations apart
        _close(a, np.asarray(r, np.float32), atol=0.05, rtol=0.05)


# ----------------------------------------------------- RG-LRU and SSD ----

@pytest.mark.parametrize("L", [1, 7, 64, 1000])
def test_rglru_scan_vs_associative_scan(L):
    """The doubling scan against the reference's combine under
    ``jax.lax.associative_scan``; the decays are the RG-LRU's range
    (0, 1).  The products associate in another order: within ``TOL``."""
    rng = np.random.default_rng(L)
    a = rng.uniform(0.5, 1.0, (2, L, 16)).astype(np.float32)
    b = rng.standard_normal((2, L, 16)).astype(np.float32)

    def comb(left, right):
        al, bl = left
        ar, br = right
        return al * ar, br + ar * bl

    _, ref = jax.lax.associative_scan(comb, (jnp.asarray(a), jnp.asarray(b)),
                                      axis=1)
    _close(rglru.linear_scan(torch.from_numpy(a), torch.from_numpy(b)), ref)


def _ssd_inputs(L, H=4, G=2, N=8, P=4, dtA=None, seed=0):
    rng = np.random.default_rng(seed)
    xbar = rng.standard_normal((2, L, H, P)).astype(np.float32)
    if dtA is None:
        dtA = -rng.uniform(0.0, 0.5, (2, L, H)).astype(np.float32)
    else:
        dtA = np.full((2, L, H), dtA, np.float32)
    Bm = rng.standard_normal((2, L, G, N)).astype(np.float32)
    Cm = rng.standard_normal((2, L, G, N)).astype(np.float32)
    return xbar, dtA, Bm, Cm


@pytest.mark.parametrize("L,chunk", [(19, 8), (8, 8), (5, 8)])
def test_ssd_chunked_vs_reference(L, chunk):
    """Padded to whole chunks where ``L`` is not a whole number of them."""
    args = _ssd_inputs(L, seed=L)
    got = mamba2.ssd_chunked(*map(torch.from_numpy, args), chunk)
    _close(got, j_mamba2._ssd_chunked(*map(jnp.asarray, args), chunk))


def test_ssd_gradient_at_the_published_chunk():
    """``ssm_chunk = 256``, ``S = 256``, float32, the initial ``dt =
    softplus(0)`` with ``A = -1``: above the diagonal the decay sums reach
    ~176 and ``exp`` overflows.  The forwards agree within ``TOL``; the
    port's gradient is finite, the reference's is not."""
    args = _ssd_inputs(256, dtA=-0.6931)
    w = _x((2, 256, 4, 4), 9)

    def j_loss(dtA, xbar):
        y = j_mamba2._ssd_chunked(xbar, dtA, jnp.asarray(args[2]),
                                  jnp.asarray(args[3]), 256)
        return jnp.sum(y * w)

    j_grads = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(args[1]),
                                               jnp.asarray(args[0]))
    assert not all(bool(jnp.isfinite(g).all()) for g in j_grads)

    xbar, dtA = (torch.from_numpy(a).requires_grad_(True)
                 for a in (args[0], args[1]))
    y = mamba2.ssd_chunked(xbar, dtA, torch.from_numpy(args[2]),
                           torch.from_numpy(args[3]), 256)
    _close(y, j_mamba2._ssd_chunked(*map(jnp.asarray, args), 256))
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum(),
                                (dtA, xbar))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_train_step_is_finite_at_the_published_chunk():
    """Reduced Mamba2 with ``ssm_chunk = 256`` over 256 tokens: every
    gradient of the train step is finite."""
    cfg = dataclasses.replace(get_config(MAMBA).reduced(), ssm_chunk=256,
                              n_layers=2)
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    toks = _tokens(cfg.vocab, 1, 257, 3)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    metrics, grads = _value_and_grad(
        model, cfg, stack_params(cfg, model.params()), batch, False)
    assert np.isfinite(float(metrics["loss"]))
    assert all(bool(torch.isfinite(g).all())
               for _, g in flatten_with_paths(grads))


# --------------------------------------------------------- conversion ----

@pytest.mark.parametrize("name", list(CASES))
def test_lm_params_from_reference_round_trip(name, references):
    """Every reference leaf reaches the port bit for bit, one port
    tensor a leaf and row; ``stack_params(unstack_params(.))`` is the
    identity."""
    params = references[name][0]
    cfg = _cfgs(name)[1]
    model = lm_params_from_reference(params, cfg, device="cpu")
    state = model.state_dict()
    ref = [(p, np.asarray(v)) for p, v in flatten_with_paths(
        jax.tree.map(np.asarray, params))]
    got = flatten_with_paths(stack_params(cfg, model.params()))
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(ref, got):
        assert np.array_equal(a, b.numpy()), path
    assert len(state) == sum(v.shape[0] if p.startswith(
        ("['group0']", "['blocks']")) else 1 for p, v in ref)
    back = unstack_params(cfg, stack_params(cfg, model.params()))
    assert set(back) == set(state)
    assert all(torch.equal(back[k], state[k]) for k in state)
    assert not any(p.requires_grad for p in model.parameters())


def test_weights_come_from_the_seed():
    cfg = get_config(MAMBA).reduced()
    a, b = (build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(4))
            for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))


# ---------------------------------------------------------- the train ----

@pytest.fixture(scope="module")
def train_refs(references):
    """The reference's loss and gradients of a 2 x 24 batch, a case."""
    out = {}
    for name in ("rg5", "mamba"):
        params = references[name][0]
        jcfg, _ = _cfgs(name)
        toks = _tokens(jcfg.vocab, 2, 25, 11).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        model = j_build_model(jcfg)
        (_, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p: j_loss_fn(model, jcfg, p, batch, remat=False),
            has_aux=True))(params)
        out[name] = (batch, float(metrics["loss"]), grads)
    return out


@pytest.mark.parametrize("name", ["rg5", "mamba"])
@pytest.mark.parametrize("remat", [False, True])
def test_train_step_loss_and_gradients_match_reference(name, remat,
                                                       references,
                                                       train_refs):
    """The weights the hybrid's MLPs never read (``gate``) get zero
    gradients on both sides."""
    params = references[name][0]
    cfg = _cfgs(name)[1]
    batch, loss, grads = train_refs[name]
    model, tree, _ = train_state_from_reference(
        params, _np_tree(JAdamW().init(params)), cfg, device="cpu")
    got_m, got = _value_and_grad(model, cfg, tree, batch, remat)
    assert abs(float(got_m["loss"]) - loss) <= 1e-5 * loss
    want = [(jax.tree_util.keystr(k), np.asarray(v)) for k, v in
            jax.tree_util.tree_flatten_with_path(grads)[0]]
    port = flatten_with_paths(got)
    assert [p for p, _ in want] == [p for p, _ in port]
    for (path, a), (_, b) in zip(want, port):
        rel = np.linalg.norm(a - b.numpy()) / max(np.linalg.norm(a), 1e-30)
        assert rel <= 1e-4, path


# ------------------------------------------------------------ serving ----

PROMPTS = [[1, 2, 3], [7, 8], [9], [4, 5, 6, 7, 8]]


@pytest.mark.parametrize("name", ["rg", "mamba"])
def test_serve_engine_vs_reference(name, references):
    """Tokens equal and every step's logits within ``TOL``; 20 steps, so
    the hybrid's ring of 16 wraps."""
    params = references[name][0]
    jcfg, cfg = _cfgs(name)
    jeng = JServeEngine(j_build_model(jcfg), jcfg,
                        jax.tree.map(jnp.asarray, params), batch=4,
                        max_len=32)
    eng = ServeEngine(lm_params_from_reference(params, cfg, device="cpu"),
                      cfg, batch=4, max_len=32)
    logs = []
    for e in (jeng, eng):
        log, step = [], e._step

        def recorded(*args, _step=step, _log=log):
            logits, cache = _step(*args)
            _log.append(np.asarray(logits, np.float32))
            return logits, cache

        e._step = recorded
        logs.append((e.generate(PROMPTS, max_new=16), log))
    (ref_toks, ref_log), (toks, log) = logs
    assert toks == ref_toks and len(log) == len(ref_log) == 4 + 16
    for a, b in zip(log, ref_log):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("arch", [MAMBA, RG])
def test_launcher_lm_mode(capsys, arch):
    launcher.main(["--arch", arch, "--reduced", "--device", "cpu",
                   "--batch", "2", "--max-new", "3"])
    out = capsys.readouterr().out
    assert out.count("prompt ") == 2
    assert "6 tokens in" in out and "decode steps on cpu" in out


# --------------------------------------------------------------- card ----

@pytest.mark.gpu
@pytest.mark.parametrize("arch", [RG, MAMBA])
def test_decode_on_the_card_equals_the_host(arch):
    """Reduced float32 models, TF32 off: the card's decode steps (RoPE
    through the kernel, one launch an attention layer a step) within
    ``TOL`` of the host's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = get_config(arch).reduced()
    host = build_model(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(6))
    card = lm_params_from_reference(stack_params(cfg, host.params()), cfg,
                                    device="cuda")
    toks = torch.from_numpy(_tokens(cfg.vocab, B, DECODE_S, 8))
    with ieee_float32():
        caches = {m: m.init_cache(B, DECODE_S, dtype=torch.float32)
                  for m in (card, host)}
        attn = sum(k == "attn" for k in getattr(card, "kinds", []))
        for t in range(DECODE_S):
            before = rope_k.LAUNCHES
            with torch.no_grad():
                got, _ = card.decode_step(caches[card],
                                          toks[:, t:t + 1].cuda())
                torch.cuda.synchronize()
                assert rope_k.LAUNCHES - before == attn
                want, _ = host.decode_step(caches[host], toks[:, t:t + 1])
            _close(got.cpu(), want.numpy())
