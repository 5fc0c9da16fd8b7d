"""Port parity of the training slice against the reference.

``repro_torch.{data, optim, train, ckpt}``, ``launch.train`` and
``convert.train_state_from_reference`` are held to ``repro.{data, optim,
train, ckpt}`` on the CPU:

* ``make_batch``/``SyntheticLM``: bit for bit (``np.array_equal``).
* The optimizers in isolation, fed the same numpy parameters and
  gradients for 5 updates: ``AdamW`` (also quantized) and
  ``warmup_cosine`` within 1e-6 relative (float32).  ``SoapGivens``
  with the Jacobi solver at covariance sides below 64 in float32 (in
  float32 the port's Jacobi follows another trajectory from n ~ 64,
  ROADMAP Queue 3): parameters within 1e-5, states within 1e-3 (the
  recorded pivots agree to ~1e-4 at these sides after 4 cycles,
  ``tests/test_torch_jacobi.py``, and the rotated Adam moments inherit
  it).  The reference's optimizer computes in float32 whatever its
  input, so at side 128 the float64 check holds the refresh itself
  (``SoapGivens.refresh`` against the reference's ``jacobi_eigh`` and
  ``jacobi_apply_basis``, as its update calls them) to 1e-7 (8.6e-9
  measured: the float64 trajectories part by ~1e-11 a cycle at n = 64).  The QR
  solver at 8 x 8 (``tests/test_eig.py``'s shape): 1e-6, states 1e-5.
  The covariances are full rank where a refresh reads them: a
  degenerate eigenspace has no defined basis.
* Which parameters ``SoapGivens`` preconditions: the reference's choice,
  on ``TINY``, on SmolLM-135M reduced (its stacked norms are) and at
  full width (none), on the reduced MoE configs and DeepSeek-V2-Lite at
  full width (the MoE layers' stacked ``kv_norm``), from shapes alone.
* The ``TINY`` train step (``tests/test_substrates.py``'s config,
  float32, the reference's weights): loss within 1e-5 relative, each
  gradient leaf within 1e-4 relative Frobenius, and the parameters
  after one step of ``adamw`` and ``soap_givens`` with ``grad_accum`` 1
  and 4, elementwise within ``rtol 1e-5`` and 5% of the learning rate:
  Adam's first step ``g / (|g| + eps)`` turns the gradients' last-bit
  differences into up to ~2% of a step where ``|g|`` is near ``eps``.
* A run resumed from a checkpoint the reference's ``TrainLoop`` wrote:
  the losses of 3 steps within 1e-5 of the reference's own resumed run.

Then the 9 tests of ``tests/test_substrates.py`` but the serving one
(``tests/test_torch_lm_serve.py`` covers serving), the 2 of
``tests/test_system.py`` and the 2 SOAP tests of ``tests/test_eig.py``,
with the reference's bars; the jit refusal becomes "the QR solver runs
eagerly", since the port's update is always eager.
"""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.ckpt import CheckpointManager as JCheckpointManager
from repro.configs import get_config as j_get_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.core import jacobi_apply_basis as j_basis
from repro.core import jacobi_eigh as j_eigh
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.data import make_batch as j_make_batch
from repro.models import build_model as j_build_model
from repro.optim import AdamW as JAdamW
from repro.optim import SoapGivens as JSoapGivens
from repro.optim import quantize_q8 as j_quantize_q8
from repro.optim import warmup_cosine as j_warmup_cosine
from repro.train import TrainLoop as JTrainLoop
from repro.train import make_prefill_fn as j_make_prefill_fn
from repro.train import make_serve_step as j_make_serve_step
from repro.train import make_train_step as j_make_train_step
from repro.train.step import _loss_fn as j_loss_fn
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import train_state_from_reference
from repro_torch.data import DataConfig, SyntheticLM, make_batch
from repro_torch.kernels.rope import kernel as rope_k
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models.zoo import (reference_shapes, stack_params,
                                    unstack_params)
from repro_torch.optim import (AdamW, SoapGivens, dequantize_q8,
                               quantize_q8, warmup_cosine)
from repro_torch.train import (StragglerMonitor, TrainLoop, make_prefill_fn,
                               make_serve_step, make_train_step)
from repro_torch.train.step import _value_and_grad
from repro_torch.tree import flatten_with_paths, leaves, map_tree

TINY_KW = dict(name="tiny", family="dense", n_layers=2, d_model=64,
               n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
               dtype="float32")
TINY = ModelConfig(**TINY_KW)
J_TINY = JModelConfig(**TINY_KW)
LR = 3e-3
OPTIMIZERS = {"adamw": (lambda: JAdamW(lr=LR), lambda: AdamW(lr=LR)),
              "soap_givens": (lambda: JSoapGivens(lr=LR),
                              lambda: SoapGivens(lr=LR))}
# the isolated optimizers' tree: two eligible matrices, a vector, a
# 3-D leaf (never eligible) and an 8 x 8
SHAPES = {"a": (16, 24), "b": [{"c": (300,)}, (32, 20)], "d": (8, 8),
          "e": (3, 10, 6)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return map_tree(lambda a: torch.from_numpy(np.array(a, copy=True)),
                    tree)


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _pairs(ref_tree, port_tree):
    """``[(path, reference leaf, port leaf)]``: the two trees flatten in
    the same order under the same paths."""
    ref = [(jax.tree_util.keystr(k), v) for k, v in
           jax.tree_util.tree_flatten_with_path(ref_tree)[0]]
    port = flatten_with_paths(port_tree)
    assert [p for p, _ in ref] == [p for p, _ in port]
    return [(p, np.asarray(a), b.detach().numpy())
            for (p, a), (_, b) in zip(ref, port)]


def _batch(vocab, b, s, seed):
    toks = np.random.default_rng(seed).integers(
        0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# ---------------------------------------------------------------- data ----

@pytest.mark.parametrize("seed,vocab,seq,batch,step,start,count", [
    (0, 128, 16, 8, 3, 0, None), (0, 128, 16, 8, 3, 4, 4),
    (5, 256, 33, 3, 0, 0, None), (11, 49152, 64, 2, 17, 1, 1)])
def test_make_batch_equals_reference(seed, vocab, seq, batch, step, start,
                                     count):
    want = j_make_batch(JDataConfig(vocab, seq, batch, seed), step,
                        start=start, count=count)
    got = make_batch(DataConfig(vocab, seq, batch, seed), step,
                     start=start, count=count)
    for key in ("tokens", "labels"):
        assert got[key].dtype == want[key].dtype
        assert np.array_equal(got[key], want[key])


def test_synthetic_lm_equals_reference_with_restart_and_hosts():
    j_it = JSyntheticLM(JDataConfig(64, 8, 4), host_index=1, host_count=2,
                        start_step=2)
    it = SyntheticLM(DataConfig(64, 8, 4), host_index=1, host_count=2,
                     start_step=2)
    for _ in range(3):
        want, got = next(j_it), next(it)
        assert np.array_equal(got["tokens"], want["tokens"])
        assert np.array_equal(got["labels"], want["labels"])
    assert it.step == j_it.step == 5


# ----------------------------------------------- optimizers in isolation ----

def _tree(rng, scale=1.0):
    return map_tree(lambda s: (rng.standard_normal(s) * scale).astype(
        np.float32), SHAPES, is_leaf=lambda s: isinstance(s, tuple))


def _run_both(j_opt, opt, updates=5):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    grads = [_tree(rng, 0.1) for _ in range(updates)]
    jp, pp = jax.tree.map(jnp.asarray, p0), _t(p0)
    js, ps = j_opt.init(jp), opt.init(pp)
    j_update = jax.jit(j_opt.update)  # as the reference's train step runs
    for g in grads:
        jp, js, _ = j_update(jax.tree.map(jnp.asarray, g), js, jp)
        pp, ps, _ = opt.update(_t(g), ps, pp)
    return (jp, js), (pp, ps)


@pytest.mark.parametrize("kind", ["adamw", "adamw_noclip", "adamw_q8"])
def test_adamw_matches_reference(kind):
    kw = dict(lr=1e-2, clip_norm=None) if kind == "adamw_noclip" else dict(
        quantized=kind == "adamw_q8")
    j_sched, sched = j_warmup_cosine(1e-2, 2, 10), warmup_cosine(1e-2, 2, 10)
    if kind != "adamw_noclip":
        j_opt, opt = JAdamW(lr=j_sched, **kw), AdamW(lr=sched, **kw)
    else:
        j_opt, opt = JAdamW(**kw), AdamW(**kw)
    (jp, js), (pp, ps) = _run_both(j_opt, opt)
    for path, a, b in _pairs(jp, pp):
        assert _rel(a, b) <= 1e-6, path
    assert int(ps["step"]) == int(js["step"]) == 5
    for side in ("m", "v"):
        for path, a, b in _pairs(js[side], ps[side]):
            if kind == "adamw_q8" and path.endswith(".q"):
                assert b.dtype == np.int8 and a.shape == b.shape
                continue
            assert _rel(a, b) <= 1e-6, (side, path)


def test_quantize_q8_equals_reference():
    rng = np.random.default_rng(1)
    for shape in [(), (7,), (300,), (13, 57), (2, 3, 513)]:
        x = np.asarray(rng.standard_normal(shape) * 10, np.float32)
        want = j_quantize_q8(jnp.asarray(x))
        got = quantize_q8(torch.from_numpy(x))
        assert np.array_equal(got.q.numpy(), np.asarray(want.q))
        assert np.array_equal(got.scale.numpy(), np.asarray(want.scale))


def test_warmup_cosine_matches_reference():
    for args in [(1.0, 10, 100), (3e-3, 21, 200, 0.05), (0.1, 0, 5)]:
        f, jf = warmup_cosine(*args), j_warmup_cosine(*args)
        for s in [0, 1, 2, 9, 10, 11, 50, 99, 100, 250]:
            want = float(jf(jnp.asarray(s)))
            got = f(s)
            assert got.dtype == torch.float32
            assert abs(float(got) - want) <= 1e-6 * abs(want), (args, s)


def test_soap_jacobi_matches_reference_below_side_64():
    """Refreshes at steps 2 and 4, from full-rank covariances."""
    sched = (j_warmup_cosine(1e-2, 2, 10), warmup_cosine(1e-2, 2, 10))
    (jp, js), (pp, ps) = _run_both(JSoapGivens(lr=sched[0], update_freq=2),
                                   SoapGivens(lr=sched[1], update_freq=2))
    for path, a, b in _pairs(jp, pp):
        assert _rel(a, b) <= 1e-5, path
    pairs = _pairs(js["per"], ps["per"])
    assert {p for p, _, _ in pairs if p.endswith("['QL']")} == {
        "['a']['QL']", "['b'][1]['QL']", "['d']['QL']"}
    for path, a, b in pairs:
        assert _rel(a, b) <= 1e-3, path
    for path, _, q in pairs:
        if path.endswith(("['QL']", "['QR']")):
            assert np.abs(q.T @ q - np.eye(len(q))).max() <= 1e-5, path


def test_soap_refresh_matches_reference_at_side_128_in_float64():
    rng = np.random.default_rng(3)
    L = np.eye(128) * 1e-6
    R = np.eye(128) * 1e-6
    for _ in range(3):
        g = rng.standard_normal((128, 128)) * 0.1
        L = 0.95 * L + 0.05 * (g @ g.T)
        R = 0.95 * R + 0.05 * (g.T @ g)
    with compat.enable_x64():
        want = [np.asarray(j_basis(j_eigh(jnp.asarray(M), cycles=4),
                                   method="auto")) for M in (L, R)]
    got = SoapGivens().refresh(torch.from_numpy(L), torch.from_numpy(R))
    for w, q in zip(want, got):
        assert q.dtype == torch.float64
        assert np.abs(q.numpy() - w).max() <= 1e-7


def test_soap_qr_matches_reference_at_8x8():
    rng = np.random.default_rng(4)
    p0 = np.zeros((8, 8), np.float32)
    grads = [(rng.standard_normal((8, 8)) * 0.1).astype(np.float32)
             for _ in range(5)]
    j_opt = JSoapGivens(lr=0.1, update_freq=2, solver="qr")
    opt = SoapGivens(lr=0.1, update_freq=2, solver="qr")
    jp, pp = {"w": jnp.asarray(p0)}, {"w": torch.from_numpy(p0)}
    js, ps = j_opt.init(jp), opt.init(pp)
    for g in grads:
        jp, js, _ = j_opt.update({"w": jnp.asarray(g)}, js, jp)
        pp, ps, _ = opt.update({"w": torch.from_numpy(g)}, ps, pp)
    assert _rel(jp["w"], pp["w"].numpy()) <= 1e-6
    for path, a, b in _pairs(js["per"], ps["per"]):
        assert _rel(a, b) <= 1e-5, path


@pytest.mark.parametrize("arch", ["tiny", "smollm-135m-reduced",
                                  "smollm-135m", "gemma3-4b-reduced",
                                  "deepseek-v2-lite-16b-reduced",
                                  "kimi-k2-1t-a32b-reduced",
                                  "deepseek-v2-lite-16b",
                                  "mamba2-370m-reduced",
                                  "recurrentgemma-9b-reduced",
                                  "whisper-large-v3-reduced"])
def test_soap_preconditions_what_the_reference_preconditions(arch):
    """From shapes alone (meta tensors; ``jax.eval_shape``): no weights
    are built.  At full width the embedding ``(49152, 576)`` is past
    ``max_dim`` and the stacked leaves are 3-D or past it: nothing."""
    name = arch.replace("-reduced", "")
    if name == "tiny":
        cfg, j_cfg = TINY, J_TINY
    else:
        cfg, j_cfg = get_config(name), j_get_config(name)
        if arch.endswith("-reduced"):
            cfg, j_cfg = cfg.reduced(), j_cfg.reduced()
    j_model = j_build_model(j_cfg)
    shapes = jax.eval_shape(j_model.init, jax.random.key(0))
    j_state = jax.eval_shape(JSoapGivens().init, shapes)
    want = sorted(jax.tree_util.keystr(k)[:-len("['L']")] for k, _ in
                  jax.tree_util.tree_flatten_with_path(j_state["per"])[0]
                  if jax.tree_util.keystr(k).endswith("['L']"))
    meta = reference_shapes(cfg)
    assert [p for p, _ in flatten_with_paths(meta)] == [
        jax.tree_util.keystr(k) for k, _ in
        jax.tree_util.tree_flatten_with_path(shapes)[0]]
    assert [tuple(t.shape) for t in leaves(meta)] == [
        tuple(s.shape) for s in jax.tree.leaves(shapes)]
    got = sorted(p[:-len("['L']")] for p, _ in
                 flatten_with_paths(SoapGivens().init(meta)["per"])
                 if p.endswith("['L']"))
    assert got == want
    if arch == "smollm-135m":
        assert got == []
    if arch == "deepseek-v2-lite-16b":  # the 26 MoE layers' (26, 512)
        assert got == ["['group1'][0]['attn']['kv_norm']['g']"]
    if arch == "smollm-135m-reduced":
        assert "['embed']['e']" in got
        assert "['group0'][0]['ln1']['g']" in got
        assert not any("['w']" in p for p in got)
    if arch.startswith(("deepseek", "kimi")):
        # the experts' stacks are 4-D, the router's 3-D: never eligible
        assert not any("['mlp']['w_" in p or "router" in p for p in got)


# ----------------------------------------------------- the train step ----

@pytest.fixture(scope="module")
def tiny():
    """The reference's TINY weights, one batch, its loss, gradients and
    one step of each optimizer at ``grad_accum`` 1 and 4."""
    model = j_build_model(J_TINY)
    params = _np(model.init(jax.random.key(0)))
    batch = _batch(256, 4, 16, 0)
    (total, metrics), grads = jax.value_and_grad(
        lambda p: j_loss_fn(model, J_TINY, p, batch, remat=False),
        has_aux=True)(params)
    steps = {}
    for name, (j_opt, _) in OPTIMIZERS.items():
        opt = j_opt()
        for ga in (1, 4):
            step = jax.jit(j_make_train_step(model, J_TINY, opt,
                                             remat=False, grad_accum=ga))
            p1, _, m1 = step(params, opt.init(params), batch)
            steps[name, ga] = (_np(p1), float(m1["loss"]))
    return dict(params=params, batch=batch, loss=float(metrics["loss"]),
                grads=_np(grads), steps=steps)


def _port(tiny_ref, opt=None):
    j_state = JAdamW().init(tiny_ref["params"]) if opt is None \
        else OPTIMIZERS[opt][0]().init(tiny_ref["params"])
    return train_state_from_reference(tiny_ref["params"], _np(j_state),
                                      TINY, device="cpu")


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_loss_and_gradients_match_reference(tiny, remat):
    model, params, _ = _port(tiny)
    metrics, grads = _value_and_grad(model, TINY, params, tiny["batch"],
                                     remat)
    assert abs(float(metrics["loss"]) - tiny["loss"]) <= 1e-5 * tiny["loss"]
    pairs = _pairs(tiny["grads"], grads)
    assert len(pairs) == 11
    for path, a, b in pairs:
        assert b.dtype == np.float32
        assert _rel(a, b) <= 1e-4, path
        if "['wq']" in path or "['wk']" in path:
            assert np.abs(b).max() > 0, path


def test_remat_recomputes_with_the_given_weights(tiny):
    """``remat`` recomputes each layer in the backward with the weights
    the step was given, not with the module's own: gradients of the
    trained tree by a model holding the untrained weights, with and
    without ``remat``."""
    trained, _ = tiny["steps"]["adamw", 1]
    model, _, _ = _port(tiny)
    _, t_params, _ = train_state_from_reference(
        trained, _np(JAdamW().init(trained)), TINY, device="cpu")
    _, plain = _value_and_grad(model, TINY, t_params, tiny["batch"], False)
    _, remat = _value_and_grad(model, TINY, t_params, tiny["batch"], True)
    for (path, a), (_, b) in zip(flatten_with_paths(plain),
                                 flatten_with_paths(remat)):
        assert _rel(a.numpy(), b.numpy()) <= 1e-6, path


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
@pytest.mark.parametrize("grad_accum", [1, 4])
def test_train_step_params_match_reference(tiny, opt, grad_accum):
    model, params, state = _port(tiny, opt)
    step = make_train_step(model, TINY, OPTIMIZERS[opt][1](), remat=False,
                           grad_accum=grad_accum)
    p1, s1, m1 = step(params, state, tiny["batch"])
    want_p, want_loss = tiny["steps"][opt, grad_accum]
    assert abs(float(m1["loss"]) - want_loss) <= 1e-5 * want_loss
    assert int(s1["step"]) == 1
    for path, a, b in _pairs(want_p, p1):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=0.05 * LR,
                                   err_msg=path)
    # the update is out of place: the inputs are as they were
    for path, a, b in _pairs(tiny["params"], params):
        assert np.array_equal(a, b), path


def test_serving_trained_params_matches_reference(tiny):
    """``make_prefill_fn``/``make_serve_step`` serve the tree they are
    given, as the reference's do: the weights after one AdamW step
    against the reference's ``prefill``/``serve_step`` on the same tree,
    by a model that holds the untrained weights (whose own logits
    differ)."""
    trained, _ = tiny["steps"]["adamw", 1]
    model, params, _ = _port(tiny)
    _, t_params, _ = train_state_from_reference(
        trained, _np(JAdamW().init(trained)), TINY, device="cpu")
    j_model = j_build_model(J_TINY)
    toks = _batch(256, 2, 6, 7)["tokens"]
    want = np.asarray(j_make_prefill_fn(j_model, J_TINY)(trained, toks))
    prefill = make_prefill_fn(model, TINY)
    got = prefill(t_params, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=1e-4)
    own = prefill(params, torch.from_numpy(toks).long())
    assert not np.allclose(own.numpy(), want, atol=5e-5, rtol=1e-4)
    j_step = j_make_serve_step(j_model, J_TINY)
    step = make_serve_step(model, TINY)
    j_cache = j_model.init_cache(2, 6, dtype=jnp.float32)
    cache = model.init_cache(2, 6, dtype=torch.float32)
    for t in range(toks.shape[1]):
        w, j_cache = j_step(trained, j_cache, toks[:, t:t + 1])
        g, cache = step(t_params, cache,
                        torch.from_numpy(toks[:, t:t + 1]).long())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5,
                                   rtol=1e-4, err_msg=f"step {t}")


def test_parameters_take_gradients_through_the_rope_function():
    """A module trained directly: its leaves are frozen as built (serving
    never builds a graph) and ``requires_grad_(True)`` makes every one
    take a gradient, q and k leaving RoPE through its autograd function
    (on the card the kernel's wrapper once returned them detached)."""
    model = build_model(TINY, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    assert not any(p.requires_grad for p in model.parameters())
    model.requires_grad_(True)
    toks = torch.from_numpy(_batch(256, 2, 8, 1)["tokens"]).long()
    before = rope_k.LAUNCHES
    model(toks).float().square().mean().backward()
    assert rope_k.LAUNCHES == before  # the plain version on the host
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.abs().max() > 0, name
    q = torch.randn(1, 4, 4, 16, requires_grad=True)
    out, _ = rope_k.rope(q, torch.randn(1, 4, 2, 16), *torch.ones(
        2, 4, 8).unbind())
    assert type(out.grad_fn).__name__ == "_RopeBackward"
    with torch.no_grad():
        out, _ = rope_k.rope(q, torch.randn(1, 4, 2, 16), *torch.ones(
            2, 4, 8).unbind())
    assert out.grad_fn is None


def test_stack_and_unstack_are_inverse():
    model = build_model(TINY, device="cpu",
                        generator=torch.Generator().manual_seed(3))
    tree = stack_params(TINY, model.params())
    flat = unstack_params(TINY, tree)
    state = model.state_dict()
    assert set(flat) == set(state)
    assert all(torch.equal(flat[k], state[k]) for k in state)


# ---------------------------------------- resume from a reference run ----

def test_resume_from_a_reference_checkpoint(tmp_path):
    j_model = j_build_model(J_TINY)
    params = j_model.init(jax.random.key(0))
    j_opt = JAdamW(lr=3e-3)
    step = jax.jit(j_make_train_step(j_model, J_TINY, j_opt, remat=False))
    dcfg = JDataConfig(vocab=256, seq_len=16, global_batch=4)
    d = str(tmp_path)
    JTrainLoop(train_step=step, params=params, opt_state=j_opt.init(params),
               data_iter=JSyntheticLM(dcfg), ckpt_dir=d, ckpt_every=5).run(10)
    j2 = JTrainLoop(train_step=step, params=params,
                    opt_state=j_opt.init(params),
                    data_iter=JSyntheticLM(dcfg), ckpt_dir=d)
    assert j2.maybe_restore() == 10
    want = j2.run(3)["loss"]

    mgr = CheckpointManager(d)
    assert mgr.latest_step() == 13
    tree = mgr.restore(10, device="cpu")
    model, p, s = train_state_from_reference(tree["params"], tree["opt"],
                                             TINY, device="cpu")
    assert int(s["step"]) == 10
    loop = TrainLoop(train_step=make_train_step(model, TINY, AdamW(lr=3e-3),
                                                remat=False),
                     params=p, opt_state=s, device="cpu",
                     data_iter=SyntheticLM(DataConfig(256, 16, 4),
                                           start_step=10))
    got = loop.run(3)["loss"]
    for a, b in zip(got, want):
        assert abs(a - b) <= 1e-5 * abs(b), (got, want)
    # and the reference reads the port's checkpoint
    port_dir = tmp_path / "port"
    CheckpointManager(str(port_dir)).save(
        3, {"params": loop.params, "opt": loop.opt_state}, blocking=True)
    back = JCheckpointManager(str(port_dir)).restore(
        3, {"params": params, "opt": j_opt.init(params)})
    for path, a, b in _pairs(back, {"params": loop.params,
                                    "opt": loop.opt_state}):
        assert np.array_equal(a, b), path


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-v2-lite-16b",
                                  "kimi-k2-1t-a32b", "mamba2-370m",
                                  "recurrentgemma-9b"])
def test_launcher_trains_on_the_host(capsys, arch):
    hist = launch_train.main(["--arch", arch, "--reduced",
                              "--steps", "3", "--batch", "2", "--seq",
                              "16", "--device", "cpu"])
    assert len(hist["loss"]) == 3 and np.isfinite(hist["loss"]).all()
    assert "final loss" in capsys.readouterr().out


# ---------------------- mirrors of tests/test_substrates.py (9 of 10) ----

def test_data_determinism_and_host_slicing():
    cfg = DataConfig(vocab=128, seq_len=16, global_batch=8)
    b1 = make_batch(cfg, step=3)
    b2 = make_batch(cfg, step=3)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    h0 = make_batch(cfg, step=3, start=0, count=4)
    h1 = make_batch(cfg, step=3, start=4, count=4)
    np.testing.assert_array_equal(
        np.concatenate([h0["tokens"], h1["tokens"]]), b1["tokens"])
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])


def test_data_iterator_restart():
    cfg = DataConfig(vocab=64, seq_len=8, global_batch=4)
    it = SyntheticLM(cfg)
    batches = [next(it) for _ in range(5)]
    it2 = SyntheticLM(cfg, start_step=3)
    np.testing.assert_array_equal(next(it2)["tokens"],
                                  batches[3]["tokens"])


def test_q8_roundtrip_error():
    rng = np.random.default_rng(0)
    for shape in [(7,), (300,), (13, 57)]:
        x = torch.from_numpy((rng.standard_normal(shape) * 10).astype(
            np.float32))
        y = dequantize_q8(quantize_q8(x), x.shape)
        err = (y - x).abs().numpy()
        bound = float(x.abs().max()) / 127 + 1e-6
        assert err.max() <= bound * 1.01


@pytest.mark.parametrize("make", [
    lambda: AdamW(lr=0.1), lambda: AdamW(lr=0.1, quantized=True),
    lambda: SoapGivens(lr=0.1, update_freq=3, jacobi_cycles=3)],
    ids=["adamw", "adamw_q8", "soap_givens"])
def test_optimizers_minimize_quadratic(make):
    opt = make()
    target = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 8)).astype(np.float32))
    params = {"w": torch.zeros((8, 8))}
    st = opt.init(params)
    for _ in range(60):
        g = {"w": 2 * (params["w"] - target)}
        params, st, _ = opt.update(g, st, params)
    loss = float(torch.sum(torch.square(params["w"] - target)))
    assert loss < 0.1 * float(torch.sum(torch.square(target)))


def test_warmup_cosine_schedule():
    f = warmup_cosine(1.0, warmup=10, total=100)
    assert float(f(0)) == 0.0
    assert abs(float(f(torch.tensor(10))) - 1.0) < 1e-6
    assert float(f(100)) <= 0.11


def test_ckpt_roundtrip_and_retention():
    tree = {"a": torch.arange(5), "b": {"c": torch.ones((2, 3))},
            "q": quantize_q8(torch.linspace(-1, 1, 300))}
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2)
        for s in (1, 2, 3):
            mgr.save(s, tree)
        mgr.wait()
        assert mgr.all_steps() == [2, 3]  # retention
        out = mgr.restore(3, tree, device="cpu")
        for a, b in zip(leaves(tree), leaves(out)):
            assert torch.equal(a, b)
        assert isinstance(out["q"], type(tree["q"]))


def test_ckpt_atomicity_tmp_never_visible():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(7, {"x": torch.zeros((1000, 100))}, blocking=True)
        assert mgr.latest_step() == 7
        assert not any(n.endswith(".tmp") for n in os.listdir(d))


def test_train_resume_bitwise():
    model = build_model(TINY, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    params = stack_params(TINY, model.params())
    opt = AdamW(lr=3e-3)
    step = make_train_step(model, TINY, opt, remat=False)
    dcfg = DataConfig(vocab=256, seq_len=16, global_batch=4)
    with tempfile.TemporaryDirectory() as d:
        l1 = TrainLoop(train_step=step, params=params,
                       opt_state=opt.init(params),
                       data_iter=SyntheticLM(dcfg), ckpt_dir=d,
                       ckpt_every=5, device="cpu")
        l1.run(10)
        l2 = TrainLoop(train_step=step, params=params,
                       opt_state=opt.init(params),
                       data_iter=SyntheticLM(dcfg), ckpt_dir=d, device="cpu")
        start = l2.maybe_restore()
        assert start == 10
        h2 = l2.run(3)
        l3 = TrainLoop(train_step=step, params=params,
                       opt_state=opt.init(params),
                       data_iter=SyntheticLM(dcfg), device="cpu")
        h3 = l3.run(13)
        assert abs(h2["loss"][-1] - h3["loss"][-1]) < 1e-6


def test_straggler_monitor_flags_slow_step():
    mon = StragglerMonitor(threshold=3.0)
    events = []
    mon.on_straggler = lambda s, dt, med: events.append((s, dt, med))
    for i in range(20):
        mon.record(i, 0.1)
    assert mon.record(20, 1.0)  # 10x median
    assert mon.flagged == 1 and events


def test_ckpt_snapshot_is_taken_before_the_writer_starts(monkeypatch):
    """An update in place right after ``save`` returns must not reach the
    checkpoint: ``save`` copies host tensors (``.cpu()`` of one is the
    tensor itself)."""
    import threading
    gate = threading.Event()
    real = threading.Thread

    class Held(real):
        def run(self):
            gate.wait(10)
            super().run()

    monkeypatch.setattr(threading, "Thread", Held)
    x = torch.zeros(4)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(1, {"x": x})
        x.add_(1.0)
        gate.set()
        mgr.wait()
        assert torch.equal(mgr.restore(1, device="cpu")["x"],
                           torch.zeros(4))


# ------------------------------ mirrors of tests/test_system.py (2 of 2) ----

def test_e2e_loss_decreases():
    cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                      head_dim=16, dtype="float32")
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    params = stack_params(cfg, model.params())
    opt = AdamW(lr=3e-3)
    step = make_train_step(model, cfg, opt, remat=False)
    loop = TrainLoop(train_step=step, params=params,
                     opt_state=opt.init(params), device="cpu",
                     data_iter=SyntheticLM(DataConfig(vocab=256, seq_len=32,
                                                      global_batch=8)))
    hist = loop.run(50)
    assert hist["loss"][-1] < hist["loss"][0] * 0.75, hist["loss"][::10]


def test_grad_accum_matches_full_batch():
    cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                      n_heads=2, n_kv_heads=2, d_ff=64, vocab=64,
                      head_dim=16, dtype="float32")
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    params = stack_params(cfg, model.params())
    opt = AdamW(lr=1e-3, clip_norm=None, weight_decay=0.0)
    s1 = make_train_step(model, cfg, opt, remat=False)
    s4 = make_train_step(model, cfg, opt, remat=False, grad_accum=4)
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, 64, (8, 16)),
             "labels": rng.integers(0, 64, (8, 16))}
    p1, _, _ = s1(params, opt.init(params), batch)
    p4, _, _ = s4(params, opt.init(params), batch)
    err = max(float((a - b).abs().max())
              for a, b in zip(leaves(p1), leaves(p4)))
    assert err < 5e-6, err


# ------------------ mirrors of the SOAP tests of tests/test_eig.py (2) ----

def test_soap_qr_solver_minimizes_quadratic():
    opt = SoapGivens(lr=0.1, update_freq=3, solver="qr")
    target = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 8)).astype(np.float32))
    params = {"w": torch.zeros((8, 8))}
    st = opt.init(params)
    for _ in range(60):
        g = {"w": 2 * (params["w"] - target)}
        params, st, _ = opt.update(g, st, params)
    loss = float(torch.sum(torch.square(params["w"] - target)))
    assert loss < 0.1 * float(torch.sum(torch.square(target)))


def test_soap_qr_solver_runs_eagerly():
    """The reference refuses ``solver="qr"`` under ``jit``; the port's
    update is eager, so a refresh at every step runs and gives an
    orthogonal basis."""
    opt = SoapGivens(lr=0.1, update_freq=1, solver="qr")
    params = {"w": torch.zeros((8, 8))}
    st = opt.init(params)
    params, st, _ = opt.update({"w": torch.ones((8, 8))}, st, params)
    QL = st["per"]["w"]["QL"]
    assert torch.isfinite(params["w"]).all()
    assert float((QL.T @ QL - torch.eye(8)).abs().max()) <= 1e-5
    assert not torch.equal(QL, torch.eye(8))


def test_training_after_serving_in_one_process(monkeypatch):
    """RoPE tables first built while serving (under ``inference_mode``)
    and cached are taken by a train step afterwards: the cache holds
    tensors autograd may save."""
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "_ROPE", {})
    model = build_model(TINY, device="cpu",
                        generator=torch.Generator().manual_seed(2))
    toks = _batch(256, 2, 8, 5)
    with torch.inference_mode():
        model(torch.from_numpy(toks["tokens"]).long())
    assert attention._ROPE
    params = stack_params(TINY, model.params())
    metrics, grads = _value_and_grad(model, TINY, params, toks, False)
    assert np.isfinite(float(metrics["loss"]))
    assert all(float(g.abs().max()) > 0 for path, g in
               flatten_with_paths(grads) if "['wq']" in path)
