"""Port parity of the two kernel modules against the reference kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; that is
held against the reference Pallas kernel (run in interpret mode, the
reference's own CPU default) to a float32 tolerance, since XLA on the
CPU contracts the plane form into fused multiply-adds.  Within the port
the wavefront path equals the plain blocked path bit for bit.

Tests marked ``gpu`` hold each CUDA kernel against its plain version on
the card: bit for bit for the wavefront kernel, to a relative Frobenius
error of 1e-5 for the accumulated one (its sums run in another order).
They decide inside the test whether a card is present.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.accumulate import accumulate_tile_factors as j_accumulate
from repro.core.blocked import pack_sheared as j_pack
from repro.kernels.rotseq.ops import rot_sequence_wave as j_wave
from repro.kernels.rotseq_mxu.ops import rot_sequence_mxu as j_mxu
from repro_torch.core.accumulate import (accumulate_tile_factors,
                                         rot_sequence_accumulated)
from repro_torch.core.blocked import (band_inputs, num_tiles, pack_sheared,
                                      rot_sequence_blocked)
from repro_torch.kernels import limits
from repro_torch.kernels.rotseq import kernel as wave_k
from repro_torch.kernels.rotseq.ops import rot_sequence_wave
from repro_torch.kernels.rotseq.ref import rotseq_wave_ref
from repro_torch.kernels.rotseq_mxu import kernel as mxu_k
from repro_torch.kernels.rotseq_mxu.ops import rot_sequence_mxu
from repro_torch.kernels.rotseq_mxu.ref import rotseq_mxu_ref

# (m, n, k, n_b, k_b, m_blk), after tests/test_kernels.py
SHAPES = [(4, 6, 2, 4, 2, 8), (16, 33, 7, 8, 3, 8), (9, 14, 9, 8, 8, 16),
          (8, 20, 3, 64, 16, 256)]
MXU_TOL = 1e-5


def _inputs(m, n, k, seed, signs=False):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)).astype(np.float32)
    th = rng.uniform(0.0, 2.0 * np.pi, (n - 1, k))
    C, S = np.cos(th).astype(np.float32), np.sin(th).astype(np.float32)
    G = None
    if signs:
        G = np.where(rng.random((n - 1, k)) < 0.5, 1.0,
                     -1.0).astype(np.float32)
    return A, C, S, G


def _t(x, device="cpu"):
    return None if x is None else torch.from_numpy(np.array(x)).to(device)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("signs", [False, True])
@pytest.mark.parametrize("m,n,k,n_b,k_b,m_blk", SHAPES)
def test_wave_ops_vs_reference_kernel(m, n, k, n_b, k_b, m_blk, signs):
    A, C, S, G = _inputs(m, n, k, m * n + k, signs)
    before = wave_k.LAUNCHES
    out = rot_sequence_wave(_t(A), _t(C), _t(S), n_b=n_b, k_b=k_b, G=_t(G))
    assert wave_k.LAUNCHES == before  # the CPU path launches nothing
    ref = j_wave(_j(A), _j(C), _j(S), n_b=n_b, k_b=k_b, m_blk=m_blk,
                 G=_j(G))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=5e-5 * max(1, k), rtol=5e-5)
    plain = rot_sequence_blocked(_t(A), _t(C), _t(S), n_b=n_b, k_b=k_b,
                                 G=_t(G))
    assert torch.equal(out, plain)


@pytest.mark.parametrize("signs", [False, True])
@pytest.mark.parametrize("m,n,k,n_b,k_b,m_blk", SHAPES)
def test_mxu_ops_vs_reference_kernel(m, n, k, n_b, k_b, m_blk, signs):
    A, C, S, G = _inputs(m, n, k, m + n * k, signs)
    before = mxu_k.LAUNCHES
    out = rot_sequence_mxu(_t(A), _t(C), _t(S), n_b=n_b, k_b=k_b, G=_t(G))
    assert mxu_k.LAUNCHES == before
    ref = j_mxu(_j(A), _j(C), _j(S), n_b=n_b, k_b=k_b, m_blk=m_blk,
                G=_j(G))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=5e-5 * max(1, k), rtol=5e-5)
    plain = rot_sequence_accumulated(_t(A), _t(C), _t(S), n_b=n_b, k_b=k_b,
                                     G=_t(G))
    assert torch.equal(out, plain)


@pytest.mark.parametrize("reflect,signs", [(False, False), (True, False),
                                           (False, True)])
@pytest.mark.parametrize("n_b,k_b", [(8, 4), (16, 16), (5, 9)])
def test_accumulate_tile_factors_vs_reference(n_b, k_b, reflect, signs,
                                              n=30, k=11):
    _, C, S, G = _inputs(2, n, k, n_b * k_b, signs)
    T = num_tiles(n, n_b, k_b)
    tiles = pack_sheared(_t(C), _t(S), 0, k_b, n_b, T, reflect=reflect,
                         G=_t(G))
    Q = accumulate_tile_factors(*tiles)
    Qj = j_accumulate(*j_pack(_j(C), _j(S), 0, k_b, n_b, T,
                              reflect=reflect, G=_j(G)))
    assert Q.shape == (T, n_b + k_b, n_b + k_b)
    np.testing.assert_allclose(Q.numpy(), np.asarray(Qj),
                               atol=5e-5 * k_b, rtol=5e-5)
    # each factor is orthogonal
    eye = torch.eye(n_b + k_b).expand_as(Q)
    torch.testing.assert_close(Q.transpose(1, 2) @ Q, eye, atol=1e-5,
                               rtol=0)


def test_wrappers_take_plain_version_only_on_cpu():
    A, C, S, G = _inputs(6, 20, 5, 1, signs=True)
    n_b, k_b = 8, 4
    T = num_tiles(20, n_b, k_b)
    tiles = pack_sheared(_t(C), _t(S), 0, k_b, n_b, T, G=_t(G))
    init, fresh = band_inputs(_t(A).t().contiguous(), k_b, n_b, T)
    packed = [_t(x).t().contiguous() for x in (A, C, S, G)]
    assert torch.equal(wave_k.rotseq_wave(*packed, k_b=k_b),
                       rotseq_wave_ref(*packed, k_b=k_b))
    Q = accumulate_tile_factors(*tiles)
    init_n, fresh_n = init.t().contiguous(), fresh.t().contiguous()
    assert torch.equal(mxu_k.rotseq_mxu(fresh_n, Q, init_n),
                       rotseq_mxu_ref(fresh_n, Q, init_n))
    # any other device is refused, never run through the plain version
    with pytest.raises(ValueError, match="cuda or cpu"):
        wave_k.rotseq_wave(*(x.to("meta") for x in packed))
    with pytest.raises(ValueError, match="cuda or cpu"):
        mxu_k.rotseq_mxu(fresh_n.to("meta"), Q.to("meta"),
                         init_n.to("meta"))


@pytest.mark.gpu
@pytest.mark.parametrize("k_b", limits.WAVE_BANDS)
@pytest.mark.parametrize("signs", [False, True])
@pytest.mark.parametrize("m,n,k", [(300, 257, 37), (129, 40, 5),
                                   (1024, 1024, 32), (200, 300, 49)])
def test_wave_kernel_equals_plain_on_card(m, n, k, signs, k_b):
    """One launch applies every band, at each band the kernel is built
    for, bit for bit with the blocked plain version at that band."""
    dev = _cuda()
    A, C, S, G = _inputs(m, n, k, m + k, signs)
    before = wave_k.LAUNCHES
    out = rot_sequence_wave(_t(A, dev), _t(C, dev), _t(S, dev),
                            G=_t(G, dev), k_b=k_b)
    torch.cuda.synchronize()
    assert wave_k.LAUNCHES - before == 1
    plain = rot_sequence_blocked(_t(A, dev), _t(C, dev), _t(S, dev),
                                 k_b=k_b, G=_t(G, dev))
    assert torch.equal(out, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k,n_b,k_b", [(300, 257, 37, 128, 128),
                                           (129, 40, 5, 8, 4),
                                           (70, 300, 20, 64, 16)])
def test_mxu_kernel_matches_plain_on_card(m, n, k, n_b, k_b):
    dev = _cuda()
    A, C, S, G = _inputs(m, n, k, m * k, signs=True)
    before = mxu_k.LAUNCHES
    out = rot_sequence_mxu(_t(A, dev), _t(C, dev), _t(S, dev), n_b=n_b,
                           k_b=k_b, G=_t(G, dev))
    torch.cuda.synchronize()
    assert mxu_k.LAUNCHES - before == -(-k // k_b)
    plain = rot_sequence_accumulated(_t(A, dev), _t(C, dev), _t(S, dev),
                                     n_b=n_b, k_b=k_b, G=_t(G, dev))
    rel = float((out - plain).norm() / plain.norm())
    assert rel <= MXU_TOL


@pytest.mark.gpu
def test_kernels_refuse_what_they_cannot_run():
    dev = _cuda()
    A, C, S, _ = _inputs(16, 20, 4, 2)
    with pytest.raises(TypeError, match="float32"):
        rot_sequence_wave(_t(A, dev).double(), _t(C, dev).double(),
                          _t(S, dev).double())
    with pytest.raises(TypeError, match="float32"):
        rot_sequence_mxu(_t(A, dev).double(), _t(C, dev).double(),
                         _t(S, dev).double())
    # the wavefront kernel takes the bands it is built for and no tiles
    with pytest.raises(ValueError, match="compiled for"):
        rot_sequence_wave(_t(A, dev), _t(C, dev), _t(S, dev), k_b=8)
    with pytest.raises(ValueError, match="no column tiles"):
        rot_sequence_wave(_t(A, dev), _t(C, dev), _t(S, dev), n_b=64)
    A, C, S, _ = _inputs(16, 300, 4, 3)
    with pytest.raises(ValueError, match="width"):
        rot_sequence_mxu(_t(A, dev), _t(C, dev), _t(S, dev), n_b=200,
                         k_b=100)
