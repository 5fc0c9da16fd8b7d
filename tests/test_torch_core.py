"""Port parity: plane form, Alg 1.2/1.3 and blocking against the reference.

The same numpy inputs go through ``repro.core`` (JAX, CPU) and
``repro_torch.core`` (PyTorch, CPU).  Within the port the rotation-family
paths agree bit for bit with each other and with a float32 numpy loop,
because every product and sum is rounded on its own.  Against the JAX
package they agree only to a tolerance: XLA on the CPU contracts the
plane form into fused multiply-adds (measured; ROADMAP "Port
conventions"), so bounds are ``atol = 5e-5 * max(1, k)``,
``rtol = 5e-5`` in float32 and ``1e-12 * max(1, k)`` in float64.
Data movement (shear-packing, band inputs) is compared bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.core import blocked as jblocked
from repro.core import ref as jref
from repro.core import rotations as jrot
from repro_torch.core import blocked as tblocked
from repro_torch.core import ref as tref
from repro_torch.core import rotations as trot

SHAPES = [(4, 6, 2), (16, 33, 7), (9, 14, 9), (7, 9, 20), (3, 2, 1)]
FAMILIES = ["rotation", "reflector", "mixed"]


def _inputs(m, n, k, family, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)).astype(dtype)
    th = rng.uniform(0.0, 2.0 * np.pi, (n - 1, k))
    C, S = np.cos(th).astype(dtype), np.sin(th).astype(dtype)
    G = None
    if family == "mixed":
        G = np.where(rng.random((n - 1, k)) < 0.5, 1.0, -1.0).astype(dtype)
    return A, C, S, G, family == "reflector"


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _f32_loop(A, C, S, G):
    """Alg 1.2 in numpy float32: one rounding per product and sum."""
    A = A.copy()
    for p in range(C.shape[1]):
        for j in range(C.shape[0]):
            x, y = A[:, j].copy(), A[:, j + 1].copy()
            A[:, j], A[:, j + 1] = trot.plane_update(x, y, C[j, p], S[j, p],
                                                     G[j, p])
    return A


def _sign(C, reflect, G):
    if G is not None:
        return G
    return np.full(C.shape, 1.0 if reflect else -1.0, C.dtype)


def test_plane_update_matches_reference_bitwise():
    rng = np.random.default_rng(0)
    x, y, c, s = (rng.standard_normal(257).astype(np.float32)
                  for _ in range(4))
    g = np.where(rng.random(257) < 0.5, 1.0, -1.0).astype(np.float32)
    tx, ty = trot.plane_update(*(_t(v) for v in (x, y, c, s, g)))
    nx, ny = trot.plane_update(x, y, c, s, g)
    jx, jy = jrot.plane_update(*(_j(v) for v in (x, y, c, s, g)))
    for a, b, d in ((tx, nx, jx), (ty, ny, jy)):
        np.testing.assert_array_equal(a.numpy(), b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(d))


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_plain_paths_bitwise_and_vs_reference(m, n, k, family):
    A, C, S, G, refl = _inputs(m, n, k, family, m * n + k)
    loop = _f32_loop(A, C, S, _sign(C, refl, G))
    outs = {
        "unoptimized": tref.rot_sequence_unoptimized(
            _t(A), _t(C), _t(S), reflect=refl, G=_t(G)),
        "wavefront": tref.rot_sequence_wavefront(
            _t(A), _t(C), _t(S), reflect=refl, G=_t(G)),
        "blocked": tblocked.rot_sequence_blocked(
            _t(A), _t(C), _t(S), n_b=8, k_b=4, reflect=refl, G=_t(G)),
    }
    for name, out in outs.items():
        np.testing.assert_array_equal(out.numpy(), loop, err_msg=name)
    oracle = jref.rot_sequence_numpy(A, C, S, reflect=refl, G=G)
    np.testing.assert_array_equal(
        tref.rot_sequence_numpy(A, C, S, reflect=refl, G=G), oracle)
    ref_j = jref.rot_sequence_unoptimized(_j(A), _j(C), _j(S), reflect=refl,
                                          G=_j(G))
    for out in outs.values():
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_j),
                                   atol=5e-5 * max(1, k), rtol=5e-5)
        np.testing.assert_allclose(out.double().numpy(), oracle,
                                   atol=5e-5 * max(1, k), rtol=5e-5)


@pytest.mark.parametrize("family", FAMILIES)
def test_float64_paths_vs_reference(family, m=11, n=19, k=6):
    A, C, S, G, refl = _inputs(m, n, k, family, 5, np.float64)
    oracle = jref.rot_sequence_numpy(A, C, S, reflect=refl, G=G)
    with compat.enable_x64():
        ref_j = np.asarray(jblocked.rot_sequence_blocked(
            _j(A), _j(C), _j(S), n_b=8, k_b=4, reflect=refl, G=_j(G)))
    for out in (tref.rot_sequence_wavefront(_t(A), _t(C), _t(S),
                                            reflect=refl, G=_t(G)),
                tblocked.rot_sequence_blocked(_t(A), _t(C), _t(S), n_b=8,
                                              k_b=4, reflect=refl, G=_t(G))):
        assert out.dtype == torch.float64
        np.testing.assert_allclose(out.numpy(), ref_j,
                                   atol=1e-12 * max(1, k), rtol=1e-12)
        np.testing.assert_allclose(out.numpy(), oracle,
                                   atol=1e-12 * max(1, k), rtol=1e-12)


@pytest.mark.parametrize("n_b,k_b", [(8, 4), (4, 2), (16, 16), (3, 7)])
def test_wavefront_equals_sequential_loop(n_b, k_b, m=6, n=23, k=13):
    A, C, S, G, _ = _inputs(m, n, k, "mixed", n_b * k_b)
    seq = tref.rot_sequence_unoptimized(_t(A), _t(C), _t(S), G=_t(G))
    wave = tref.rot_sequence_wavefront(_t(A), _t(C), _t(S), G=_t(G))
    blk = tblocked.rot_sequence_blocked(_t(A), _t(C), _t(S), n_b=n_b,
                                        k_b=k_b, G=_t(G))
    assert torch.equal(wave, seq)
    assert torch.equal(blk, seq)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("p0,k_b,n_b", [(0, 4, 8), (4, 4, 8), (3, 5, 3),
                                        (0, 16, 64)])
def test_pack_sheared_bitwise(family, p0, k_b, n_b, n=21, k=9):
    _, C, S, G, refl = _inputs(2, n, k, family, p0 + k_b)
    T = tblocked.num_tiles(n, n_b, k_b)
    assert T == jblocked.num_tiles(n, n_b, k_b)
    got = tblocked.pack_sheared(_t(C), _t(S), p0, k_b, n_b, T,
                                reflect=refl, G=_t(G))
    want = jblocked.pack_sheared(_j(C), _j(S), p0, k_b, n_b, T,
                                 reflect=refl, G=_j(G))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_band_inputs_and_band_match_reference(m=5, n=18, k=4, n_b=8, k_b=4):
    A, C, S, G, _ = _inputs(m, n, k, "mixed", 3)
    T = tblocked.num_tiles(n, n_b, k_b)
    init, fresh = tblocked.band_inputs(_t(A).t(), k_b, n_b, T)
    carry0, fresh_j = jblocked._band_inputs(_j(A), k_b, n_b, T)
    np.testing.assert_array_equal(init.t().numpy(), np.asarray(carry0))
    np.testing.assert_array_equal(fresh.t().numpy(), np.asarray(fresh_j))
    tiles_t = tblocked.pack_sheared(_t(C), _t(S), 0, k_b, n_b, T, G=_t(G))
    tiles_j = jblocked.pack_sheared(_j(C), _j(S), 0, k_b, n_b, T, G=_j(G))
    band_t = tblocked.apply_band(_t(A), *tiles_t)
    band_j = jblocked.apply_band(_j(A), *tiles_j)
    np.testing.assert_allclose(band_t.numpy(), np.asarray(band_j),
                               atol=5e-5 * k, rtol=5e-5)
    # the per-tile plain form and the band sweep are the same planes
    X = torch.cat([init, fresh[:n_b]], 0).t()
    tile = tblocked.apply_tile(X, *(x[0] for x in tiles_t))
    np.testing.assert_array_equal(
        tile[:, :n_b].t().numpy(),
        tblocked.sweep_band(init, fresh, *tiles_t)[:n_b].numpy())


@pytest.mark.parametrize("pad", [0, 3, 17])
def test_identity_padding_is_exact(pad, m=7, n=12, k=5):
    A, C, S, G, _ = _inputs(m, n, k, "mixed", pad)
    Cp = np.concatenate([C, np.ones((n - 1, pad), np.float32)], 1)
    Sp = np.concatenate([S, np.zeros((n - 1, pad), np.float32)], 1)
    Gp = np.concatenate([G, -np.ones((n - 1, pad), np.float32)], 1)
    base = tref.rot_sequence_wavefront(_t(A), _t(C), _t(S), G=_t(G))
    for fn in (tref.rot_sequence_wavefront, tref.rot_sequence_unoptimized):
        np.testing.assert_array_equal(
            fn(_t(A), _t(Cp), _t(Sp), G=_t(Gp)).numpy(), base.numpy())
    np.testing.assert_array_equal(
        tblocked.rot_sequence_blocked(_t(A), _t(Cp), _t(Sp), n_b=4, k_b=3,
                                      G=_t(Gp)).numpy(), base.numpy())


def test_norm_preservation_and_dense(m=8, n=15, k=6):
    A, C, S, _, _ = _inputs(m, n, k, "rotation", 11, np.float64)
    seq = trot.RotationSequence(_t(C), _t(S))
    Q = trot.sequence_to_dense(seq)
    np.testing.assert_allclose(Q.T @ Q, np.eye(n), atol=1e-12)
    out = tref.rot_sequence_wavefront(_t(A), _t(C), _t(S)).numpy()
    np.testing.assert_allclose(out, A @ Q, atol=1e-12)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1),
                               np.linalg.norm(A, axis=1), rtol=1e-12)
    with compat.enable_x64():
        jseq = jrot.RotationSequence(_j(C), _j(S))
        np.testing.assert_allclose(jrot.sequence_to_dense(jseq), Q,
                                   atol=1e-12)


def test_givens_zeroes_and_identity():
    a = torch.tensor([3.0, 0.0, -1.0], dtype=torch.float64)
    b = torch.tensor([4.0, 0.0, 2.0], dtype=torch.float64)
    c, s = trot.givens(a, b)
    jc, js = jrot.givens(_j(a.numpy()), _j(b.numpy()))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-7)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7)
    np.testing.assert_allclose((-s * a + c * b).numpy(), 0.0, atol=1e-15)
    assert c[1] == 1.0 and s[1] == 0.0
