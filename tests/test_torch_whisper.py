"""Port parity of the encoder-decoder family (Whisper-large-v3).

The reference's weights (carried across with
``repro_torch.convert.lm_params_from_reference``) and the same
numpy-seeded stub frames and decoder tokens go through the reference's
JAX functions and the port's, in float32, held to ``atol 5e-5, rtol
1e-4`` (the matmuls sum in another order), at the reduced width: the
teacher-forced forward; the bidirectional encoder at 300 and 1500
frames (attention's dense route, which must then carry no mask) and at
1024 (the chunked flash route, ``causal=False``); ``init_cache`` with
``decode_step`` against the reference's forward and against its own
decode; the cache's dtypes after a bfloat16 step; the weight
conversion; the train step with frames; and the serving launcher's
refusal of the family (its cache is made from frames).

The test marked ``gpu`` decodes on the card against the host; it
decides inside the test whether a card is present.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.optim import AdamW as JAdamW
from repro.train.step import _loss_fn as j_loss_fn
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference, \
    train_state_from_reference
from repro_torch.launch import serve as launcher
from repro_torch.models import attention, whisper
from repro_torch.models.zoo import build_model, stack_params, \
    unstack_params
from repro_torch.train.step import _value_and_grad
from repro_torch.tree import flatten_with_paths

TOL = dict(atol=5e-5, rtol=1e-4)
ARCH = "whisper-large-v3"
B, FRAMES, S = 2, 10, 12   # reduced dec_len is 16


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
def ref():
    """The reference's weights, inputs, forward logits and decode logits
    step by step, built once for the module."""
    jcfg = j_get_config(ARCH).reduced()
    model = j_build_model(jcfg)
    params = _np_tree(model.init(jax.random.key(1)))
    frames = _x((B, FRAMES, jcfg.d_model), 2)
    toks = _tokens(jcfg.vocab, B, S, 3)
    fwd = model.forward(params, jnp.asarray(frames), jnp.asarray(toks),
                        remat=False)
    cache = model.init_cache(params, jnp.asarray(frames), S)
    step = jax.jit(model.decode_step)
    steps = []
    for t in range(S):
        lg, cache = step(params, cache, jnp.asarray(toks[:, t:t + 1]))
        steps.append(np.asarray(lg))
    return dict(model=model, params=params, frames=frames, toks=toks,
                fwd=np.asarray(fwd), steps=steps)


def _port(ref):
    return lm_params_from_reference(ref["params"],
                                    get_config(ARCH).reduced(), device="cpu")


def test_forward_vs_reference(ref):
    with torch.no_grad():
        out = _port(ref)(torch.from_numpy(ref["frames"]),
                         torch.from_numpy(ref["toks"]))
    assert out.shape == ref["fwd"].shape
    _close(out, ref["fwd"])


def test_sinusoid_vs_reference():
    from repro.models.whisper import _sinusoid
    _close(whisper.sinusoid(1500, 64, torch.float32),
           _sinusoid(1500, 64, jnp.float32))


@pytest.mark.parametrize("frames,route", [(300, "dense"), (1500, "dense"),
                                          (1024, "flash")])
def test_encoder_on_both_attention_routes(frames, route, ref):
    """Bidirectional on either route: 1500 frames (Whisper's 30 s) are
    not whole chunks of 512, so they take the dense route."""
    assert attention._chunked(frames, frames) == (route == "flash")
    x = _x((1, frames, 64), frames)
    with torch.no_grad():
        got = _port(ref).encode(torch.from_numpy(x))
    _close(got, ref["model"].encode(ref["params"], jnp.asarray(x),
                                    remat=False))


def test_decode_vs_reference(ref):
    """``init_cache(frames, max_len)`` then ``decode_step``, step by step:
    against the reference's decode and its teacher-forced forward."""
    model = _port(ref)
    cache = model.init_cache(torch.from_numpy(ref["frames"]), S,
                             dtype=torch.float32)
    outs = []
    with torch.no_grad():
        for t in range(S):
            lg, cache = model.decode_step(
                cache, torch.from_numpy(ref["toks"][:, t:t + 1]))
            _close(lg, ref["steps"][t])
            outs.append(lg)
    assert cache["idx"] == S
    assert cache["layers"][0]["xk"].shape == (B, FRAMES, 4, 16)
    _close(torch.cat(outs, 1), ref["fwd"])


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
def test_cache_dtypes_after_a_bf16_step(cache_dtype):
    """A bfloat16 model: every cache leaf keeps the dtype the reference's
    step returns it in (the cache's own), and the logits agree to
    bfloat16's precision."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    jcfg = dataclasses.replace(j_get_config(ARCH).reduced(),
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="bfloat16")
    model = j_build_model(jcfg)
    params = _np_tree(model.init(jax.random.key(4)))
    frames = _x((B, FRAMES, cfg.d_model), 5)
    toks = _tokens(cfg.vocab, B, 2, 6)
    jc = model.init_cache(params, jnp.asarray(frames), 8,
                          dtype=jdt[cache_dtype])
    port = lm_params_from_reference(params, cfg, device="cpu")
    with torch.no_grad():
        pc = port.init_cache(torch.from_numpy(frames), 8, dtype=cache_dtype)
        for t in range(2):
            want, jc = model.decode_step(params, jc,
                                         jnp.asarray(toks[:, t:t + 1]))
            got, pc = port.decode_step(pc, torch.from_numpy(toks[:, t:t + 1]))
            assert got.dtype == torch.bfloat16
            _close(got, np.asarray(want, np.float32), atol=0.05, rtol=0.05)
    for key in ("k", "v", "xk", "xv"):
        assert str(jc[key].dtype) == str(cache_dtype).split(".")[-1]
        assert {c[key].dtype for c in pc["layers"]} == {cache_dtype}


def test_lm_params_from_reference_round_trip(ref):
    """Every reference leaf reaches the port bit for bit (``enc`` and
    ``dec`` rows, ``pos_dec``, the LayerNorms); ``stack_params(
    unstack_params(.))`` is the identity."""
    params = ref["params"]
    cfg = get_config(ARCH).reduced()
    model = _port(ref)
    want = [(p, np.asarray(v)) for p, v in flatten_with_paths(params)]
    got = flatten_with_paths(stack_params(cfg, model.params()))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(want, got):
        assert np.array_equal(a, b.numpy()), path
    state = model.state_dict()
    assert np.array_equal(state["dec.1.xattn.wk.w"].numpy(),
                          params["dec"]["xattn"]["wk"]["w"][1])
    assert np.array_equal(state["pos_dec"].numpy(), params["pos_dec"])
    back = unstack_params(cfg, stack_params(cfg, model.params()))
    assert set(back) == set(state)
    assert all(torch.equal(back[k], state[k]) for k in state)


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_loss_and_gradients_match_reference(remat, ref):
    """The batch holds ``frames``, ``dec_tokens`` and ``labels``, as the
    reference's train step takes them."""
    jcfg, cfg = j_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    toks = _tokens(cfg.vocab, B, 13, 7).astype(np.int32)
    batch = {"frames": _x((B, 24, cfg.d_model), 8),
             "dec_tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (_, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: j_loss_fn(ref["model"], jcfg, p, batch, remat=False),
        has_aux=True))(ref["params"])
    model, tree, _ = train_state_from_reference(
        ref["params"], _np_tree(JAdamW().init(ref["params"])), cfg,
        device="cpu")
    got_m, got = _value_and_grad(model, cfg, tree, batch, remat)
    loss = float(metrics["loss"])
    assert abs(float(got_m["loss"]) - loss) <= 1e-5 * loss
    want = [(jax.tree_util.keystr(k), np.asarray(v)) for k, v in
            jax.tree_util.tree_flatten_with_path(grads)[0]]
    port = flatten_with_paths(got)
    assert [p for p, _ in want] == [p for p, _ in port]
    for (path, a), (_, b) in zip(want, port):
        rel = np.linalg.norm(a - b.numpy()) / max(np.linalg.norm(a), 1e-30)
        assert rel <= 1e-4, path
        assert np.abs(b.numpy()).max() > 0, path


def test_launcher_refuses_the_audio_family():
    with pytest.raises(ValueError, match="frames"):
        launcher.main(["--arch", ARCH, "--reduced", "--device", "cpu"])


@pytest.mark.gpu
def test_decode_on_the_card_equals_the_host():
    """The reduced float32 model, TF32 off: the encoder prefill and the
    decode steps on the card within ``TOL`` of the host's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = get_config(ARCH).reduced()
    host = build_model(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(6))
    card = lm_params_from_reference(stack_params(cfg, host.params()), cfg,
                                    device="cuda")
    frames = torch.from_numpy(_x((B, FRAMES, cfg.d_model), 9))
    toks = torch.from_numpy(_tokens(cfg.vocab, B, S, 10))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            cc = card.init_cache(frames.cuda(), S, dtype=torch.float32)
            hc = host.init_cache(frames, S, dtype=torch.float32)
            for t in range(S):
                got, cc = card.decode_step(cc, toks[:, t:t + 1].cuda())
                want, hc = host.decode_step(hc, toks[:, t:t + 1])
                _close(got.cpu(), want.numpy())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
