"""Port parity of ``repro_torch.core.jacobi`` against ``repro.core.jacobi``.

The sign grid ``G`` depends only on wave parity and equals the
reference's exactly.  ``C``, ``S`` and the eigenvalues come out of a
loop of plane updates that XLA contracts into fused multiply-adds in
the reference's jitted ``fori_loop`` and the port does not, so they are
held to a tolerance: float32 ``1e-4`` at n <= 33 (measured on the CPU:
max 3.3e-5 on ``C``/``S``, 7.2e-6 on the eigenvalues, 9.1e-6 on ``V``
at n = 33), float64 ``1e-10`` (measured max 1.4e-11 at n = 64).  The
round-robin trajectory amplifies the difference wave by wave: in
float32 at n = 64 the two recordings part (``C`` by 1e-3 from wave 69
on) and converge to different permutations, whose sorted eigenvalues
still agree.  The 4 tests of ``tests/test_jacobi.py`` are mirrored with
the same oracle bars.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # optional dep: deterministic seeded fallback
    from _hypothesis_fallback import given, settings, strategies as st

from repro import compat
from repro.core import jacobi_apply_basis as j_basis
from repro.core import jacobi_eigh as j_eigh
from repro_torch.core import (JacobiResult, jacobi_apply_basis,
                              jacobi_eigh)

TOL = {np.float32: 1e-4, np.float64: 1e-10}


def _sym(n, seed, dtype=np.float32):
    X = np.random.default_rng(seed).standard_normal((n, n)).astype(dtype)
    return (X + X.T) / 2


@pytest.mark.parametrize("n,dtype", [(4, np.float32), (16, np.float32),
                                     (33, np.float32), (16, np.float64),
                                     (64, np.float64)])
def test_recording_matches_reference(n, dtype):
    H = _sym(n, n, dtype)
    res = jacobi_eigh(torch.from_numpy(H), cycles=8)
    with compat.enable_x64(dtype == np.float64):
        ref = j_eigh(jnp.asarray(H), cycles=8)
        ref = JacobiResult(*(np.asarray(x) for x in ref))
        V_ref = np.asarray(j_basis(j_eigh(jnp.asarray(H), cycles=8),
                                   method="blocked"))
    assert res.cos.dtype == torch.from_numpy(H).dtype
    assert res.cos.shape == (n - 1, 8 * n)
    np.testing.assert_array_equal(res.sign.numpy(), ref.sign)
    for name in ("cos", "sin", "eigenvalues"):
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   getattr(ref, name), rtol=0,
                                   atol=TOL[dtype], err_msg=name)
    V = jacobi_apply_basis(res, method="blocked")
    np.testing.assert_allclose(V.numpy(), V_ref, rtol=0, atol=TOL[dtype])


def test_sorted_eigenvalues_agree_past_divergence():
    """Float32 at n = 64: the recordings part, the spectra do not."""
    n = 64
    H = _sym(n, n)
    res = jacobi_eigh(torch.from_numpy(H), cycles=8)
    ref = np.asarray(j_eigh(jnp.asarray(H), cycles=8).eigenvalues)
    np.testing.assert_allclose(np.sort(res.eigenvalues.numpy()),
                               np.sort(ref), rtol=0, atol=1e-4 * n)


def test_pivot_signs_follow_parity():
    res = jacobi_eigh(torch.from_numpy(_sym(7, 3)), cycles=1)
    j = np.arange(6)[:, None]
    p = np.arange(7)[None, :]
    want = np.where(j % 2 == p % 2, 1.0, -1.0)
    np.testing.assert_array_equal(res.sign.numpy(), want)
    seq = res.rotation_sequence()
    assert seq.sign is res.sign and seq.device.type == "cpu"


# ------------------------------------ mirrors of tests/test_jacobi.py ----

@pytest.mark.parametrize("n", [4, 16, 33])
@pytest.mark.parametrize("method", ["blocked", "accumulated"])
def test_eigh_and_basis(n, method):
    rng = np.random.default_rng(n)
    X = rng.standard_normal((n, n)).astype(np.float32)
    H = (X + X.T) / 2
    res = jacobi_eigh(torch.from_numpy(H), cycles=8)
    ev = np.sort(res.eigenvalues.numpy())
    ref = np.sort(np.linalg.eigvalsh(H.astype(np.float64)))
    np.testing.assert_allclose(ev, ref, atol=1e-4 * n)
    V = jacobi_apply_basis(res, method=method).numpy()
    np.testing.assert_allclose(V.T @ V, np.eye(n), atol=1e-5 * n)
    np.testing.assert_allclose(
        V.T @ H @ V, np.diag(res.eigenvalues.numpy()), atol=2e-4 * n)


def test_apply_basis_auto_dispatch():
    """Default method='auto' routes through the registry and matches the
    explicitly dispatched blocked-family result (the sign-carrying
    sequence restricts auto to backends that take signs)."""
    n = 16
    rng = np.random.default_rng(2)
    X = rng.standard_normal((n, n)).astype(np.float32)
    H = (X + X.T) / 2
    res = jacobi_eigh(torch.from_numpy(H), cycles=8)
    V_auto = jacobi_apply_basis(res).numpy()  # method="auto" default
    V_named = jacobi_apply_basis(res, method="blocked").numpy()
    np.testing.assert_allclose(V_auto, V_named, atol=1e-6)
    np.testing.assert_allclose(V_auto.T @ V_auto, np.eye(n), atol=1e-5 * n)


def test_delayed_sequence_application():
    """G @ V without forming V: the paper's 'delayed sequence' use."""
    n = 12
    rng = np.random.default_rng(1)
    X = rng.standard_normal((n, n)).astype(np.float32)
    H = (X + X.T) / 2
    res = jacobi_eigh(torch.from_numpy(H), cycles=8)
    V = jacobi_apply_basis(res).numpy()
    G = rng.standard_normal((5, n)).astype(np.float32)
    GV = jacobi_apply_basis(res, torch.from_numpy(G)).numpy()
    np.testing.assert_allclose(GV, G @ V, atol=1e-4)


@settings(max_examples=10, deadline=None)
@given(n=st.integers(3, 24), seed=st.integers(0, 2**31 - 1))
def test_property_offdiag_shrinks(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, n)).astype(np.float32)
    H = (X + X.T) / 2
    res = jacobi_eigh(torch.from_numpy(H), cycles=8)
    off0 = np.linalg.norm(H - np.diag(np.diag(H)))
    assert float(res.off_norm) < max(1e-3, 1e-3 * off0)
