"""Port parity of RotationSequence / SequencePlan against the reference.

Composition (``from_waves``, ``.T``, ``@``, slicing, ``pad_to``,
``k_live``, ``with_signs``) and :func:`repro_torch.convert.
sequence_from_reference` move data only and must match the reference
bit for bit.  Planned application and its gradient are held against the
reference's ``seq.plan(like=A, method=...).apply(A)`` and ``jax.grad``
to the float32 bound of ``test_torch_core`` (XLA on the CPU contracts
the plane form into fused multiply-adds).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RotationSequence as JSeq
from repro_torch import RotationSequence, SequencePlan
from repro_torch.convert import sequence_from_reference
from repro_torch.core import apply_rotation_sequence
from repro_torch.core.ref import rot_sequence_numpy

# port method -> the reference backend it mirrors
PAIRS = {"unoptimized": "unoptimized", "wavefront": "wavefront",
         "blocked": "blocked", "accumulated": "accumulated",
         "cuda_wave": "pallas_wave", "cuda_mxu": "pallas_mxu"}


def _waves(n, k, seed, signs=False, dtype=np.float32):
    rng = np.random.default_rng(seed)
    th = rng.uniform(0.0, 2.0 * np.pi, (n - 1, k))
    C, S = np.cos(th).astype(dtype), np.sin(th).astype(dtype)
    G = None
    if signs:
        G = np.where(rng.random((n - 1, k)) < 0.5, 1.0, -1.0).astype(dtype)
    return C, S, G


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _pair(n, k, seed, signs=False, reflect=False):
    C, S, G = _waves(n, k, seed, signs)
    return (RotationSequence(_t(C), _t(S), _t(G), reflect),
            JSeq(_j(C), _j(S), _j(G), reflect))


def _same(tseq, jseq):
    """Waves, sign, flags and live bound equal bit for bit."""
    np.testing.assert_array_equal(tseq.cos.numpy(), np.asarray(jseq.cos))
    np.testing.assert_array_equal(tseq.sin.numpy(), np.asarray(jseq.sin))
    assert (tseq.sign is None) == (jseq.sign is None)
    if tseq.sign is not None:
        np.testing.assert_array_equal(tseq.sign.numpy(),
                                      np.asarray(jseq.sign))
    assert tseq.reflect == jseq.reflect
    assert tseq.k_live == jseq.k_live


@pytest.mark.parametrize("normalize", ["auto", True, False])
def test_from_waves_bitwise(normalize, n=13, k=6):
    C, S, G = _waves(n, k, 1, signs=True)
    C[0, 0], S[0, 0] = 0.0, 0.0          # no direction: repaired to identity
    C[1, :] *= np.float32(1.01)          # drifted well past 64 ulp
    C[2, 1] = np.nextafter(C[2, 1], np.float32(2))  # inside the bound
    t = RotationSequence.from_waves(C, S, G, normalize=normalize,
                                    device="cpu")
    j = JSeq.from_waves(C, S, G, normalize=normalize)
    # normalize=True: the port's float32 hypot is jnp.hypot's algorithm,
    # with its fused 1 + r^2, so the divided pairs agree bit for bit too
    _same(t, j)
    if normalize != False:  # noqa: E712 (the literal option)
        assert t.cos[0, 0] == 1.0 and t.sin[0, 0] == 0.0
    with pytest.raises(ValueError):
        RotationSequence.from_waves(C, S[:, :2], device="cpu")
    with pytest.raises(ValueError):
        RotationSequence.from_waves(C[0], S[0], device="cpu")


@pytest.mark.parametrize("signs,reflect", [(False, False), (False, True),
                                           (True, False)])
def test_composition_bitwise(signs, reflect, n=11, k=5):
    t, j = _pair(n, k, 2, signs, reflect)
    t2, j2 = _pair(n, 3, 3)
    _same(t.T, j.T)
    _same(t.T.T, j.T.T)
    _same(t @ t2, j @ j2)
    _same(t2 @ t, j2 @ j)
    _same(t[1:4], j[1:4])
    _same(t.pad_to(9), j.pad_to(9))
    _same(t.pad_to(9).T, j.pad_to(9).T)
    _same(t.with_signs(), j.with_signs())
    assert t.pad_to(k) is t
    with pytest.raises(ValueError):
        t.pad_to(k - 1)
    with pytest.raises(TypeError):
        t[0]


def test_identity_and_k_live():
    t = RotationSequence.identity(7, 4, device="cpu")
    _same(t, JSeq.identity(7, 4))
    assert t.k_live == 0 and t.T.k_live == 0
    s, _ = _pair(7, 3, 4)
    assert (s.pad_to(8).k_live, s.T.k_live) == (18, 18)
    assert (t @ s).k_live is None and (t @ t).k_live == 0


def test_from_pairs_and_identity():
    """Mirror of ``tests/test_sequence.py::test_from_pairs_and_identity``."""
    waves = [(np.array([0.6, 1.0]), np.array([0.8, 0.0])),
             (np.array([1.0, 0.0]), np.array([0.0, 1.0]))]
    seq = RotationSequence.from_pairs(waves, device="cpu")
    assert seq.shape == (2, 2) and seq.sign is None
    ident = RotationSequence.identity(5, 3, device="cpu")
    A = torch.from_numpy(
        np.random.default_rng(1).standard_normal((4, 5)).astype(np.float32))
    assert torch.equal(ident.apply(A, method="blocked"), A)
    with pytest.raises(ValueError, match="at least one wave"):
        RotationSequence.from_pairs([])


@pytest.mark.parametrize("reflect", [False, True])
def test_from_pairs_bitwise(reflect, n=9, k=4):
    """Per-wave columns, some with signs and some ``None``, stack as the
    reference stacks them (a missing sign column is a rotation, or a
    reflector under ``reflect=True``); tensors stay on their device."""
    C, S, G = _waves(n, k, 7, signs=True)
    waves = [(C[:, p], S[:, p]) if p % 2 else (C[:, p], S[:, p], G[:, p])
             for p in range(k)]
    t = RotationSequence.from_pairs(waves, reflect=reflect, device="cpu")
    _same(t, JSeq.from_pairs(waves, reflect=reflect))
    plain = RotationSequence.from_pairs(
        [(torch.from_numpy(C[:, p]), torch.from_numpy(S[:, p]), None)
         for p in range(k)])
    _same(plain, JSeq.from_pairs([(C[:, p], S[:, p]) for p in range(k)]))
    with pytest.raises(ValueError, match="inconsistent"):
        RotationSequence.from_pairs([(C[:, 0], S[:, 0]),
                                     (C[:-1, 1], S[:-1, 1])], device="cpu")


@pytest.mark.parametrize("signs,reflect", [(False, False), (True, False),
                                           (False, True)])
def test_sequence_from_reference_bitwise(signs, reflect, n=10, k=4):
    _, j = _pair(n, k, 5, signs, reflect)
    j = j.pad_to(6)
    _same(sequence_from_reference(j.to_dict(), device="cpu"), j)
    d = {"cos": np.asarray(j.cos), "sin": np.asarray(j.sin),
         "sign": None if j.sign is None else np.asarray(j.sign),
         "reflect": j.reflect, "k_live": j.k_live}
    _same(sequence_from_reference(d, device="cpu"), j)
    with pytest.raises(ValueError, match="dtype"):
        sequence_from_reference(dict(d, dtype="bfloat16"), device="cpu")


def _cases(methods):
    """(method, family) pairs; Alg 1.2/1.3 take no per-entry signs."""
    return [(meth, fam) for meth in methods
            for fam in ("rotation", "reflector", "mixed")
            if not (fam == "mixed" and meth in ("unoptimized", "wavefront"))]


@pytest.mark.parametrize("method,family", _cases(PAIRS))
def test_plan_apply_vs_reference(method, family, m=9, n=21, k=7):
    t, j = _pair(n, k, 6, family == "mixed", family == "reflector")
    A = np.random.default_rng(7).standard_normal((m, n)).astype(np.float32)
    kw = {} if method in ("unoptimized", "wavefront") else dict(n_b=8, k_b=4)
    jkw = dict(kw, m_blk=8) if PAIRS[method].startswith("pallas") else kw
    plan = t.plan(like=_t(A), method=method, **kw)
    assert isinstance(plan, SequencePlan) and plan.method == method
    out = plan.apply(_t(A))
    ref = j.plan(like=_j(A), method=PAIRS[method], **jkw).apply(_j(A))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=5e-5 * k, rtol=5e-5)
    np.testing.assert_array_equal(plan.apply_direct(_t(A)).numpy(),
                                  out.numpy())
    assert torch.equal(plan.rebind(t).apply(_t(A)), out)


@pytest.mark.parametrize("m,n,k,signs", [(9, 21, 7, False), (40, 64, 30, True),
                                         (3, 2, 1, False)])
def test_auto_plan_matches_reference_choice(m, n, k, signs):
    t, j = _pair(n, k, 8, signs)
    A = np.random.default_rng(9).standard_normal((m, n)).astype(np.float32)
    plan = t.plan(like=_t(A))
    jplan = j.plan(like=_j(A))
    assert plan.method == jplan.method
    assert dict(plan.kwargs) == {key: val for key, val in jplan.kwargs
                                 if key != "m_blk"}
    np.testing.assert_allclose(plan.apply(_t(A)).numpy(),
                               np.asarray(jplan.apply(_j(A))),
                               atol=5e-5 * k, rtol=5e-5)


@pytest.mark.parametrize("method,family", _cases(
    ["wavefront", "blocked", "cuda_wave", "cuda_mxu"]))
def test_gradient_vs_jax_grad(method, family, m=6, n=15, k=5):
    t, j = _pair(n, k, 10, family == "mixed", family == "reflector")
    rng = np.random.default_rng(11)
    A = rng.standard_normal((m, n)).astype(np.float32)
    W = rng.standard_normal((m, n)).astype(np.float32)
    kw = {} if method == "wavefront" else dict(n_b=8, k_b=4)
    jmethod = "blocked" if method.startswith("cuda") else method
    At = _t(A).requires_grad_(True)
    (g,) = torch.autograd.grad(
        (t.plan(like=At, method=method, **kw).apply(At) * _t(W)).sum(), At)
    jplan = j.plan(like=_j(A), method=jmethod, **kw)
    jg = jax.grad(lambda X: (jplan.apply(X) * _j(W)).sum())(_j(A))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg),
                               atol=5e-5 * (n + k), rtol=5e-5)
    # Q is orthogonal: applying the plan to the gradient returns W
    back = t.plan(like=g, method=method, **kw).apply(g)
    np.testing.assert_allclose(back.numpy(), W, atol=5e-5 * (n + k))


def test_empty_sequence_is_identity():
    A = torch.randn(5, 1)
    for seq in (RotationSequence.identity(1, 3, device="cpu"),
                RotationSequence(torch.ones(4, 0), torch.zeros(4, 0))):
        B = A if seq.n == 1 else torch.randn(5, seq.n)
        for method in ("auto", *PAIRS):
            plan = seq.plan(like=B, method=method)
            assert plan.method == "identity"
            assert plan.apply(B) is B
    with pytest.raises(ValueError, match="unknown method"):
        RotationSequence.identity(3, 0, device="cpu").plan(method="nope")


def test_plan_checks_target_and_signs():
    t, _ = _pair(9, 3, 12, signs=True)
    with pytest.raises(ValueError, match="signs"):
        t.plan(method="wavefront")
    plan = t.plan(like=torch.zeros(4, 9), method="blocked")
    with pytest.raises(ValueError, match="n=9"):
        plan.apply(torch.zeros(4, 8))
    plain, _ = _pair(9, 3, 13)
    wave = plain.plan(like=torch.zeros(4, 9), method="wavefront")
    with pytest.raises(ValueError, match="signs"):
        wave.rebind(t)
    with pytest.raises(ValueError, match="shape"):
        wave.rebind(plain[0:2])


def test_apply_rotation_sequence_matches_oracle(m=7, n=12, k=4):
    C, S, G = _waves(n, k, 14, signs=True)
    A = np.random.default_rng(15).standard_normal((m, n)).astype(np.float32)
    ref = rot_sequence_numpy(A, C, S, G=G)
    for method in ("blocked", "accumulated", "cuda_wave", "auto"):
        out = apply_rotation_sequence(_t(A), _t(C), _t(S), G=_t(G),
                                      method=method)
        np.testing.assert_allclose(out.double().numpy(), ref,
                                   atol=5e-5 * k, rtol=5e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_auto_plans_half_precision_on_cpu(dtype, m=5, n=9, k=4):
    """``seq.plan(like=A).apply(A)`` plans a plain backend for bfloat16
    and float16 targets, as the reference does, and returns the target's
    dtype within the reference's half-precision tolerance of its result
    (``tests/test_kernels.py``: 5e-2, times ``k`` absolute)."""
    C, S, _ = _waves(n, k, 12)
    A = np.random.default_rng(13).standard_normal((m, n)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    t = RotationSequence(_t(C).to(tdt), _t(S).to(tdt))
    j = JSeq(jnp.asarray(C, jdt), jnp.asarray(S, jdt))
    plan = t.plan(like=_t(A).to(tdt))
    out = plan.apply(_t(A).to(tdt))
    jplan = j.plan(like=jnp.asarray(A, jdt))
    ref = jplan.apply(jnp.asarray(A, jdt))
    assert out.dtype == tdt and plan.method == jplan.method == "blocked"
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=5e-2 * k, rtol=5e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_reflector_sign_grid_bit_parity(dtype, m=9, n=17, k=5):
    """The port's ``blocked`` gives a scalar-reflector sequence and its
    ``+1`` sign grid the same bits, in each dtype the reference checks
    (``tests/test_rotseq_core.py``)."""
    C, S, _ = _waves(n, k, 3)
    A = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (m, n))).to(dtype)
    refl = RotationSequence(_t(C).to(dtype), _t(S).to(dtype), None, True)
    grid = refl.with_signs()
    assert grid.sign is not None
    out_scalar = refl.plan(like=A, method="blocked", n_b=8, k_b=4).apply(A)
    out_grid = grid.plan(like=A, method="blocked", n_b=8, k_b=4).apply(A)
    assert out_scalar.dtype == dtype
    assert torch.equal(out_scalar, out_grid)
