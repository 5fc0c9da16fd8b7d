"""Port parity of ``repro_torch.eig`` against the reference ``repro.eig``.

The four recorders (``tridiagonalize``, ``tridiag_qr``, ``bidiagonalize``,
``bidiag_qr``) run the same float64 numpy operations in the same order
as the reference, so every output (waves, values, ``sweeps``,
``converged``) is held equal under ``np.array_equal``.  ``eigh_givens``
and ``svd_givens`` take their values from those recorders, so their
eigenvalues and singular values equal the reference's cast values
exactly; their vectors are flushed through each package's own planned
appliers and are held to the reference's within 1e-4 in float32
(measured on the CPU: max 4.8e-7) and 1e-10 in float64 (max 8.3e-16).

The solver and buffer tests of ``tests/test_eig.py`` (lines 33-271) are
mirrored against the port with the same oracle bars; its plan-cache
tests are mirrored in ``tests/test_torch_autotune.py`` (with the
solvers' ``autotune=True``), and its SOAP tests wait for the SOAP
consumer (ROADMAP Queue 1 item 11).  Tests marked ``gpu`` hold
delayed flushes to eager application on the card, bit for bit on the
rotation family, and run ``eigh_givens`` at n = 256 there.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro import eig as jeig
from repro_torch import RotationSequence
from repro_torch.core import apply_rotation_sequence, random_sequence
from repro_torch.core.ref import rot_sequence_numpy
from repro_torch.eig import (DelayedRotationBuffer, bidiag_qr, bidiagonalize,
                             eigh_givens, svd_givens, tridiag_qr,
                             tridiagonalize)
from repro_torch.kernels.rotseq import kernel as wave_k
from repro_torch.kernels.rotseq_batched import kernel as batched_k
from repro_torch.kernels.rotseq_mxu import kernel as mxu_k

VEC_TOL = {np.float32: 1e-4, np.float64: 1e-10}


def _sym(n, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, n)).astype(dtype)
    return (X + X.T) / 2


def _t(x):
    return torch.from_numpy(np.array(x))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_same(port, ref):
    """NamedTuples of arrays and scalars equal field by field."""
    assert port._fields == ref._fields
    for name, a, b in zip(port._fields, port, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)


# ------------------------------------------- recorders: bit for bit ----

@pytest.mark.parametrize("n", [2, 5, 33, 64])
def test_tridiag_recorders_equal_reference(n):
    H = _sym(n, seed=n, dtype=np.float64)
    tri = tridiagonalize(H)
    _assert_same(tri, jeig.tridiagonalize(H))
    qr = tridiag_qr(tri.diag, tri.offdiag)
    ref = jeig.tridiag_qr(tri.diag, tri.offdiag)
    _assert_same(qr, ref)
    assert qr.sweeps == ref.sweeps and qr.converged == ref.converged
    # a tensor input is read on the host in float64, the same recording
    _assert_same(tridiagonalize(_t(H)), tri)
    # a truncated budget records the same partial run
    _assert_same(tridiag_qr(tri.diag, tri.offdiag, max_sweeps=2),
                 jeig.tridiag_qr(tri.diag, tri.offdiag, max_sweeps=2))


@pytest.mark.parametrize("shape", [(14, 9), (33, 33), (5, 2)])
def test_bidiag_recorders_equal_reference(shape):
    A = np.random.default_rng(6).standard_normal(shape)
    bd = bidiagonalize(A)
    _assert_same(bd, jeig.bidiagonalize(A))
    qr = bidiag_qr(bd.diag, bd.superdiag)
    ref = jeig.bidiag_qr(bd.diag, bd.superdiag)
    _assert_same(qr, ref)
    assert qr.sweeps == ref.sweeps and qr.converged == ref.converged
    with pytest.raises(ValueError, match="m >= n"):
        bidiagonalize(A.T if shape[0] > shape[1] else np.ones((2, 3)))


def test_tridiag_sequence_placement():
    tri = tridiagonalize(_sym(6, seed=1, dtype=np.float64))
    seq = tri.sequence(device="cpu")
    assert seq.dtype == torch.float64 and seq.device.type == "cpu"
    np.testing.assert_array_equal(seq.cos.numpy(), tri.cos)
    assert tri.sequence(torch.float32, "cpu").dtype == torch.float32
    if torch.cuda.is_available():
        assert tri.sequence().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tri.sequence()


# ------------------------------------- solvers against the reference ----

@pytest.mark.parametrize("n", [4, 33, 64])
def test_eigh_matches_reference_f32(n):
    H = _sym(n, seed=n + 1)
    w, V = eigh_givens(_t(H))
    jw, jV = jeig.eigh_givens(jnp.asarray(H))
    assert w.dtype == V.dtype == torch.float32
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_allclose(V.numpy(), np.asarray(jV), rtol=0,
                               atol=VEC_TOL[np.float32])


def test_eigh_matches_reference_f64():
    H = _sym(48, seed=11, dtype=np.float64)
    w, V = eigh_givens(_t(H))
    with compat.enable_x64():
        jw, jV = jeig.eigh_givens(jnp.asarray(H))
        jw, jV = np.asarray(jw), np.asarray(jV)
    assert w.dtype == V.dtype == torch.float64
    np.testing.assert_array_equal(w.numpy(), jw)
    np.testing.assert_allclose(V.numpy(), jV, rtol=0,
                               atol=VEC_TOL[np.float64])


@pytest.mark.parametrize("shape", [(48, 32), (32, 48), (40, 40), (33, 20)])
def test_svd_matches_reference_f32(shape):
    A = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32)
    U, s, Vt = svd_givens(_t(A))
    jU, js, jVt = jeig.svd_givens(jnp.asarray(A))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    for got, want in ((U, jU), (Vt, jVt)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=VEC_TOL[np.float32])


def test_svd_matches_reference_f64():
    A = np.random.default_rng(2).standard_normal((40, 28))
    U, s, Vt = svd_givens(_t(A))
    with compat.enable_x64():
        ref = [np.asarray(x) for x in jeig.svd_givens(jnp.asarray(A))]
    np.testing.assert_array_equal(s.numpy(), ref[1])
    np.testing.assert_allclose(U.numpy(), ref[0], rtol=0,
                               atol=VEC_TOL[np.float64])
    np.testing.assert_allclose(Vt.numpy(), ref[2], rtol=0,
                               atol=VEC_TOL[np.float64])


# --------------------------- mirrors of tests/test_eig.py, lines 33-271 ----

@pytest.mark.parametrize("n", [2, 5, 33, 64])
def test_tridiagonalize_records_similarity(n):
    """Replaying the recorded staircase waves reproduces Q: Q^T H Q = T."""
    H = _sym(n, seed=n, dtype=np.float64)
    tri = tridiagonalize(H)
    Q = rot_sequence_numpy(np.eye(n), tri.cos, tri.sin)
    np.testing.assert_allclose(Q.T @ Q, np.eye(n), atol=1e-12 * n)
    T = Q.T @ H @ Q
    band = np.abs(np.subtract.outer(np.arange(n), np.arange(n))) > 1
    scale = np.abs(H).max()
    if band.any():
        assert np.abs(T[band]).max() <= 1e-12 * n * scale
    np.testing.assert_allclose(np.diagonal(T), tri.diag,
                               atol=1e-12 * n * scale)
    np.testing.assert_allclose(np.diagonal(T, 1), tri.offdiag,
                               atol=1e-12 * n * scale)


def test_tridiag_qr_eigenvalues_and_sequence():
    """QR waves diagonalize T both as scalars and as a replayed sequence."""
    n = 24
    H = _sym(n, seed=3, dtype=np.float64)
    tri = tridiagonalize(H)
    qr = tridiag_qr(tri.diag, tri.offdiag)
    assert qr.converged
    ref = np.sort(np.linalg.eigvalsh(H))
    np.testing.assert_allclose(np.sort(qr.eigenvalues), ref,
                               atol=1e-12 * n * np.abs(ref).max())
    T = np.diag(tri.diag) + np.diag(tri.offdiag, 1) + np.diag(tri.offdiag, -1)
    U = rot_sequence_numpy(np.eye(n), qr.cos, qr.sin)
    np.testing.assert_allclose(U.T @ T @ U, np.diag(qr.eigenvalues),
                               atol=1e-11 * n * np.abs(ref).max())


@pytest.mark.parametrize("n", [4, 33, 64])
def test_eigh_qr_oracle_f32(n):
    H = _sym(n, seed=n + 1)
    w, V = eigh_givens(H, method="qr", device="cpu")
    ref = np.sort(np.linalg.eigvalsh(H.astype(np.float64)))
    scale = np.abs(ref).max()
    assert np.abs(w.numpy() - ref).max() <= 1e-4 * scale
    Vn = V.double().numpy()
    np.testing.assert_allclose(Vn.T @ Vn, np.eye(n), atol=1e-4)
    resid = np.abs(Vn.T @ H @ Vn - np.diag(w.double().numpy())).max()
    assert resid <= 1e-4 * n * scale


def test_eigh_qr_oracle_f32_n256():
    """Acceptance bar: n=256 float32 within 1e-4 relative of the oracle."""
    n = 256
    H = _sym(n, seed=7)
    w, V = eigh_givens(_t(H), method="qr")
    ref = np.sort(np.linalg.eigvalsh(H.astype(np.float64)))
    scale = np.abs(ref).max()
    assert np.abs(w.numpy() - ref).max() <= 1e-4 * scale
    Vn = V.double().numpy()
    assert np.abs(Vn.T @ Vn - np.eye(n)).max() <= 1e-4
    resid = np.abs(Vn.T @ H @ Vn - np.diag(w.double().numpy())).max()
    assert resid <= 1e-4 * scale * np.sqrt(n)


def test_eigh_qr_oracle_f64():
    """Acceptance bar: float64 within 1e-10 relative (no x64 switch in
    torch: a float64 input stays float64)."""
    n = 48
    H = _sym(n, seed=11, dtype=np.float64)
    w, V = eigh_givens(H, method="qr", device="cpu")
    assert w.dtype == torch.float64 and V.dtype == torch.float64
    ref = np.sort(np.linalg.eigvalsh(H))
    scale = np.abs(ref).max()
    assert np.abs(w.numpy() - ref).max() <= 1e-10 * scale
    Vn = V.numpy()
    assert np.abs(Vn.T @ Vn - np.eye(n)).max() <= 1e-10
    resid = np.abs(Vn.T @ H @ Vn - np.diag(w.numpy())).max()
    assert resid <= 1e-10 * scale


def test_eigh_jacobi_wrapper_matches_oracle():
    n = 16
    H = _sym(n, seed=5)
    w, V = eigh_givens(_t(H), method="jacobi", cycles=8)
    ref = np.sort(np.linalg.eigvalsh(H.astype(np.float64)))
    np.testing.assert_allclose(w.numpy(), ref, atol=1e-4 * n)
    assert np.all(np.diff(w.numpy()) >= -1e-6)  # sorted ascending
    Vn = V.double().numpy()
    np.testing.assert_allclose(Vn.T @ Vn, np.eye(n), atol=1e-5 * n)


def test_eigh_methods_agree():
    H = _t(_sym(12, seed=9))
    wq, _ = eigh_givens(H, method="qr")
    wj, _ = eigh_givens(H, method="jacobi")
    np.testing.assert_allclose(wq.numpy(), wj.numpy(), atol=2e-3)


def test_eigh_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown eigh method"):
        eigh_givens(torch.eye(4), method="householder")


@pytest.mark.parametrize("shape", [(48, 32), (32, 48), (40, 40), (33, 20)])
def test_svd_oracle_f32(shape):
    rng = np.random.default_rng(sum(shape))
    A = rng.standard_normal(shape).astype(np.float32)
    U, s, Vt = svd_givens(A, device="cpu")
    k = min(shape)
    assert tuple(U.shape) == (shape[0], k) and tuple(Vt.shape) == (k, shape[1])
    sr = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    scale = sr.max()
    assert np.abs(s.numpy() - sr).max() <= 1e-4 * scale
    sn = s.numpy()
    assert np.all(sn >= 0) and np.all(np.diff(sn) <= 1e-6)  # descending
    Un, Vn = U.double().numpy(), Vt.double().numpy()
    np.testing.assert_allclose(Un.T @ Un, np.eye(k), atol=1e-4)
    np.testing.assert_allclose(Vn @ Vn.T, np.eye(k), atol=1e-4)
    rec = np.abs(Un @ np.diag(s.double().numpy()) @ Vn - A).max()
    assert rec <= 1e-4 * scale


def test_svd_oracle_f64():
    rng = np.random.default_rng(2)
    A = rng.standard_normal((40, 28))
    U, s, Vt = svd_givens(A, device="cpu")
    sr = np.linalg.svd(A, compute_uv=False)
    scale = sr.max()
    assert np.abs(s.numpy() - sr).max() <= 1e-10 * scale
    rec = np.abs(U.numpy() @ np.diag(s.numpy()) @ Vt.numpy() - A).max()
    assert rec <= 1e-10 * scale


def test_svd_full_matrices():
    rng = np.random.default_rng(4)
    A = _t(rng.standard_normal((12, 7)).astype(np.float32))
    U, s, Vt = svd_givens(A, full_matrices=True)
    assert tuple(U.shape) == (12, 12)
    Un = U.double().numpy()
    np.testing.assert_allclose(Un.T @ Un, np.eye(12), atol=1e-4)


def test_svd_exactly_zero_diagonal_entries():
    """Zero columns/rows must not stall the implicit sweep (the d[lo]==0
    nudge)."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # unconverged would warn -> fail
        A = torch.tensor([[0.0, 1.0], [0.0, 1.0]])
        U, s, Vt = svd_givens(A)
        np.testing.assert_allclose(s.numpy(), [np.sqrt(2.0), 0.0],
                                   atol=1e-6)
        rec = U.double().numpy() @ np.diag(s.double().numpy()) \
            @ Vt.double().numpy()
        np.testing.assert_allclose(rec, A.numpy(), atol=1e-6)
        rng = np.random.default_rng(0)
        B = rng.standard_normal((6, 4)).astype(np.float32)
        B[:, 2] = 0.0
        _, s2, _ = svd_givens(_t(B))
        sr = np.linalg.svd(B.astype(np.float64), compute_uv=False)
        np.testing.assert_allclose(s2.numpy(), sr, atol=1e-5)


def test_truncated_sweep_budget_warns():
    H = _t(_sym(12, seed=13))
    with pytest.warns(RuntimeWarning, match="sweep budget"):
        eigh_givens(H, method="qr", max_sweeps=2)


def test_bidiagonalize_records_factors():
    """Replayed left/right recordings reproduce U^T A V = B exactly."""
    rng = np.random.default_rng(6)
    m, n = 14, 9
    A = rng.standard_normal((m, n))
    bd = bidiagonalize(A)
    U = rot_sequence_numpy(np.eye(m), bd.cos_left, bd.sin_left)
    V = rot_sequence_numpy(np.eye(n), bd.cos_right, bd.sin_right)
    B = U.T @ A @ V
    ref = np.zeros((m, n))
    ref[:n, :n] = np.diag(bd.diag) + np.diag(bd.superdiag, 1)
    np.testing.assert_allclose(B, ref, atol=1e-12 * (m + n))


def test_bidiag_qr_diagonalizes():
    rng = np.random.default_rng(8)
    n = 12
    A = rng.standard_normal((n, n))
    bd = bidiagonalize(A)
    qr = bidiag_qr(bd.diag, bd.superdiag)
    assert qr.converged
    B = np.diag(bd.diag) + np.diag(bd.superdiag, 1)
    L = rot_sequence_numpy(np.eye(n), qr.cos_left, qr.sin_left)
    R = rot_sequence_numpy(np.eye(n), qr.cos_right, qr.sin_right)
    np.testing.assert_allclose(L.T @ B @ R, np.diag(qr.values),
                               atol=1e-11 * n * np.abs(bd.diag).max())


@pytest.mark.parametrize("method", ["unoptimized", "wavefront", "blocked",
                                    "accumulated"])
def test_delayed_flush_equivalent_bitwise(method):
    """Delayed (k_delay-batched) application == eager, bit for bit.

    k_delay is a multiple of the band depth k_b, so chunked calls hit
    the same band boundaries as one whole-sequence call; identity
    padding of the final partial flush is an exact no-op.  The waves go
    in through the deprecated raw-array ``push_sequence``, as the
    reference test pushes them.
    """
    rng = np.random.default_rng(0)
    n, K = 24, 40  # 40 = 2.5 flushes: exercises the padded partial flush
    M = _t(rng.standard_normal((10, n)).astype(np.float32))
    seq = random_sequence(n, K, generator=_gen(0), device="cpu")
    buf = DelayedRotationBuffer(M, k_delay=16, method=method)
    with pytest.warns(DeprecationWarning, match="RotationSequence"):
        buf.push_sequence(seq.cos.numpy(), seq.sin.numpy())
    delayed = buf.value
    assert buf.flushes == 3 and buf.waves_pushed == K
    eager = apply_rotation_sequence(M, seq.cos, seq.sin, method=method)
    assert torch.equal(delayed, eager)


def test_delayed_flush_auto_matches_oracle():
    rng = np.random.default_rng(1)
    n, K = 17, 23
    M = _t(rng.standard_normal((8, n)).astype(np.float32))
    seq = random_sequence(n, K, generator=_gen(2), device="cpu")
    buf = DelayedRotationBuffer(M, k_delay=8, method="auto")
    buf.push_sequence(seq)
    ref = rot_sequence_numpy(M.numpy(), seq.cos.numpy(), seq.sin.numpy())
    np.testing.assert_allclose(buf.value.double().numpy(), ref,
                               atol=5e-5, rtol=1e-4)


def test_delayed_buffer_validates_wave_shape():
    buf = DelayedRotationBuffer(torch.eye(5), k_delay=4)
    with pytest.raises(ValueError, match="planes"):
        buf.push(np.ones(7), np.zeros(7))


# ------------------------------------------------- the delayed buffer ----

def test_delayed_buffer_plans_once_and_counts():
    """One frozen plan per (k, signs) flush shape, rebound afterwards;
    ``stats`` counts flushes, waves pushed and waves per flush."""
    n, K = 12, 21
    seq = random_sequence(n, K, generator=_gen(3), device="cpu")
    sign = torch.where(torch.rand((n - 1, 5), generator=_gen(4)) < 0.5,
                       1.0, -1.0)
    signed = RotationSequence(seq.cos[:, :5], seq.sin[:, :5], sign)
    buf = DelayedRotationBuffer(torch.eye(n), k_delay=8)
    buf.push_sequence(seq)
    assert buf.pending == 5 and buf.flushes == 2
    buf.flush()
    buf.push_sequence(signed).flush()
    assert buf.stats == {"flushes": 4, "waves_pushed": K + 5,
                         "waves_per_flush": [8, 8, 5, 5]}
    # the padded partial flush reused the unsigned plan; signs got their own
    assert sorted(buf._plans) == [(8, False), (8, True)]
    want = rot_sequence_numpy(np.eye(n), seq.cos.numpy(), seq.sin.numpy())
    want = rot_sequence_numpy(want, signed.cos.numpy(), signed.sin.numpy(),
                              G=sign.numpy())
    np.testing.assert_allclose(buf.value.double().numpy(), want, atol=1e-5)


@pytest.mark.parametrize("method", ["blocked", "accumulated"])
def test_batched_accumulator_equals_each_slice(method):
    """A (b, m, n) accumulator flushes all bases with one batched
    application; each slice equals the 2D buffer's result (bit for bit
    on the rotation family, within 1e-5 on the accumulated family)."""
    rng = np.random.default_rng(5)
    n, K, b = 16, 37, 3
    M = _t(rng.standard_normal((b, 6, n)).astype(np.float32))
    seq = random_sequence(n, K, generator=_gen(6), device="cpu")
    buf = DelayedRotationBuffer(M, k_delay=16, method=method)
    out = buf.push_sequence(seq).value
    assert tuple(out.shape) == (b, 6, n) and buf.flushes == 3
    for i in range(b):
        one = DelayedRotationBuffer(M[i], k_delay=16, method=method)
        want = one.push_sequence(seq).value
        if method == "blocked":
            assert torch.equal(out[i], want)
        else:
            assert float((out[i] - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("signed", [False, True])
def test_push_sequence_slices_equal_wave_by_wave(signed):
    """push_sequence queues k_delay-wide slices: the same flushes, the
    same waves per flush and the same bits as pushing every wave alone,
    also after a single wave has left the pending flush part full."""
    rng = np.random.default_rng(23)
    n, k = 10, 45
    th = rng.uniform(0, 2 * np.pi, (n - 1, k))
    G = np.where(rng.random((n - 1, k)) < 0.5, 1.0, -1.0) if signed else None
    seq = RotationSequence(torch.from_numpy(np.cos(th)),
                           torch.from_numpy(np.sin(th)),
                           None if G is None else torch.from_numpy(G))
    M = torch.from_numpy(rng.standard_normal((7, n)))
    one = DelayedRotationBuffer(M, k_delay=8, method="blocked")
    whole = DelayedRotationBuffer(M, k_delay=8, method="blocked")
    for buf in (one, whole):
        buf.push(np.cos(th[:, 0]), np.sin(th[:, 0]),
                 None if G is None else G[:, 0])
    for p in range(k):
        one.push(np.cos(th[:, p]), np.sin(th[:, p]),
                 None if G is None else G[:, p])
    whole.push_sequence(seq)
    assert whole.pending == one.pending == (k + 1) % 8
    assert whole.stats["waves_per_flush"] == one.stats["waves_per_flush"]
    assert torch.equal(whole.value, one.value)
    assert whole.stats == one.stats


def test_unported_options_raise(tmp_path):
    """A ``mesh`` that is not a ``DeviceMesh`` and a ``row_axes`` the mesh
    does not name are refused at construction (one gloo rank here)."""
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh
    with pytest.raises(TypeError, match="DeviceMesh"):
        DelayedRotationBuffer(torch.eye(4), mesh=object())
    tdist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
        world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        with pytest.raises(ValueError, match="no dimension 'model'"):
            DelayedRotationBuffer(torch.eye(4), mesh=mesh,
                                  row_axes=("model",))
    finally:
        tdist.destroy_process_group()
    with pytest.raises(ValueError, match="accumulator"):
        DelayedRotationBuffer(torch.zeros(4))


def test_array_inputs_go_to_the_card():
    """An array without ``device=`` goes to the card, and raises where
    there is none; a tensor stays where it is."""
    H = _sym(6, seed=2)
    if torch.cuda.is_available():
        assert eigh_givens(H).eigenvectors.device.type == "cuda"
    else:
        for call in (lambda: eigh_givens(H), lambda: svd_givens(H),
                     lambda: eigh_givens(H, method="jacobi"),
                     lambda: DelayedRotationBuffer(np.eye(6))):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    w, V = eigh_givens(_t(H))
    assert w.device.type == V.device.type == "cpu"


# ------------------------------------------------------------ the card ----

@pytest.mark.gpu
@pytest.mark.parametrize("method,tiles,kernel", [
    ("cuda_wave", {}, wave_k), ("cuda_mxu", dict(n_b=64, k_b=16), mxu_k),
    ("cuda_batched", {}, batched_k)])
def test_delayed_equals_eager_on_card(method, tiles, kernel):
    """k_delay = 32, a multiple of each kernel's band (16), so delayed
    flushes equal one eager application bit for bit (``torch.equal``:
    ±0 compare equal, a padded plane may turn +0 into -0); a batched
    accumulator's slices equal the 2D result too."""
    dev = _cuda()
    n, K = 300, 101
    M = torch.randn((40, n), generator=_gen(7)).to(dev)
    seq = random_sequence(n, K, generator=_gen(8), device=dev)
    before = kernel.LAUNCHES
    buf = DelayedRotationBuffer(M, k_delay=32, method=method, **tiles)
    delayed = buf.push_sequence(seq).value
    torch.cuda.synchronize()
    assert kernel.LAUNCHES > before and buf.flushes == 4
    eager = apply_rotation_sequence(M, seq.cos, seq.sin, method=method,
                                    **tiles)
    assert torch.equal(delayed, eager)
    stack = DelayedRotationBuffer(torch.stack([M, 2 * M]), k_delay=32,
                                  method=method, **tiles)
    out = stack.push_sequence(seq).value
    twice = apply_rotation_sequence(2 * M, seq.cos, seq.sin, method=method,
                                    **tiles)
    for got, want in ((out[0], delayed), (out[1], twice)):
        if method == "cuda_mxu":
            assert float((got - want).norm() / want.norm()) <= 1e-5
        else:
            assert torch.equal(got, want)


@pytest.mark.gpu
def test_eigh_givens_on_card_n256():
    """n = 256 float32 on the card, the reference's oracle bars, with at
    least one hand-written kernel launched by the flushes."""
    dev = _cuda()
    n = 256
    H = _sym(n, seed=7)
    before = wave_k.LAUNCHES + mxu_k.LAUNCHES + batched_k.LAUNCHES
    w, V = eigh_givens(H)
    torch.cuda.synchronize()
    assert w.device == V.device and V.device.type == dev.type
    assert wave_k.LAUNCHES + mxu_k.LAUNCHES + batched_k.LAUNCHES > before
    ref = np.sort(np.linalg.eigvalsh(H.astype(np.float64)))
    scale = np.abs(ref).max()
    assert np.abs(w.cpu().numpy() - ref).max() <= 1e-4 * scale
    Vn = V.cpu().double().numpy()
    assert np.abs(Vn.T @ Vn - np.eye(n)).max() <= 1e-4
    resid = np.abs(Vn.T @ H @ Vn - np.diag(w.cpu().double().numpy())).max()
    assert resid <= 1e-4 * scale * np.sqrt(n)
