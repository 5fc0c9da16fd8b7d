"""The three rotation kernels in bfloat16 and float16, on the card.

Every test here is marked ``gpu`` and decides inside the test whether a
card is present, so on a host without one they skip.  The wavefront and
fused kernels are held to their plain versions bit for bit in each half
type, special values included as bit views (and the fused kernel to
per-request ``cuda_wave``); the tensor-core
tier of the accumulated kernel is held to the float64 application of the
same rounded inputs: its largest error at most 1.25 times that of its
plain version (float32 products of each tile, rounded once) and within
the reference's ``7e-2·k``.  The CPU side of the same paths is
``tests/test_torch_half.py``.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_half_card.py
"""
import pytest
import torch

from repro_torch import RotationSequence, random_sequence
from repro_torch.core.blocked import num_tiles, rot_sequence_blocked
from repro_torch.core.ref import sign_grid
from repro_torch.kernels.rotseq import kernel as wave_k
from repro_torch.kernels.rotseq.ops import rot_sequence_wave
from repro_torch.kernels.rotseq.ref import rotseq_wave_ref
from repro_torch.kernels.rotseq_batched import kernel as batched_k
from repro_torch.kernels.rotseq_batched.ops import wave_windows
from repro_torch.kernels.rotseq_batched.ref import rotseq_batched_ref
from repro_torch.kernels.rotseq_mxu import kernel as mxu_k
from repro_torch.kernels.rotseq_mxu.ops import (band_factors,
                                                band_inputs_natural,
                                                rot_sequence_mxu)
from repro_torch.kernels.rotseq_mxu.ref import rotseq_mxu_ref

pytestmark = pytest.mark.gpu

HALF = [torch.bfloat16, torch.float16]
# the reference's bar for its accumulated kernel (tests/test_kernels.py)
MXU_TOL = 7e-2
# the tensor cores' error against the float64 application, at most this
# times the plain version's
MXU_RATIO = 1.25


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _problem(m, n, k, seed, dtype, dev, signs=False):
    gen = torch.Generator().manual_seed(seed)
    A = torch.randn((m, n), generator=gen).to(dev, dtype)
    seq = random_sequence(n, k, generator=gen, device=dev, dtype=dtype)
    G = None
    if signs:
        G = torch.where(torch.rand((n - 1, k), generator=gen) < 0.5, 1.0,
                        -1.0).to(dev, dtype)
    return A, seq.cos, seq.sin, G


def _packed(A, C, S, G):
    return (A.t().contiguous(),
            *(x.t().contiguous() for x in (C, S, sign_grid(C, False, G))))


@pytest.mark.parametrize("k_b", [16, 4])
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("m,n,k,signs", [(3000, 1000, 37, True),
                                         (40, 64, 7, True),
                                         (512, 700, 200, False)])
def test_wave_half_bitwise_on_the_card(dtype, m, n, k, signs, k_b):
    """At each compiled band (16; 4, a second pass past 48 waves)."""
    dev = _cuda()
    A, C, S, G = _problem(m, n, k, m + n + k, dtype, dev, signs)
    args = _packed(A, C, S, G)
    before = wave_k.LAUNCHES
    out = wave_k.rotseq_wave(*args, k_b=k_b)
    assert wave_k.LAUNCHES == before + 1
    assert out.dtype == dtype
    assert torch.equal(out, rotseq_wave_ref(*args, k_b=k_b))
    assert torch.equal(rot_sequence_wave(A, C, S, G=G, k_b=k_b),
                       rot_sequence_blocked(A, C, S, G=G, k_b=k_b))


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("staircase", [False, True])
def test_batched_half_bitwise_on_the_card(dtype, staircase):
    dev = _cuda()
    gen = torch.Generator().manual_seed(7)
    b, m, n, k_pad = 6, 256, 300, 64
    ks = torch.randint(33, k_pad + 1, (b,), generator=gen).tolist()
    seqs = [random_sequence(n, k, generator=gen, device=dev,
                            dtype=dtype).pad_to(k_pad) for k in ks]
    if staircase:
        seqs = [s.T for s in seqs]
    A = torch.randn((b, m, n), generator=gen).to(dev, dtype)
    C = torch.stack([s.cos for s in seqs])
    S = torch.stack([s.sin for s in seqs])
    G = sign_grid(C, False, None if seqs[0].sign is None else
                  torch.stack([s.sign for s in seqs]))
    starts, counts = wave_windows(C, S, G)
    args = (A.transpose(1, 2).contiguous(),
            *(x.transpose(1, 2).contiguous() for x in (C, S, G)),
            starts, counts)
    out, planes = batched_k.rotseq_batched(*args)
    want, want_planes = rotseq_batched_ref(*args)
    assert torch.equal(out, want) and torch.equal(planes, want_planes)
    per = torch.stack([s.plan(like=A[i], method="cuda_wave").apply(A[i])
                       for i, s in enumerate(seqs)])
    assert torch.equal(out.transpose(1, 2), per)


# per type: a NaN payload no arithmetic makes, a value whose plane
# results overflow the type, one whose products land in its subnormals
SPECIAL = {torch.bfloat16: (0x7FC1, 3.0e38, 3.0e-39),
           torch.float16: (0x7E01, 6.0e4, 3.0e-5)}


def _bits(x):
    return x.contiguous().view(torch.int16)


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("m", [256, 253])
@pytest.mark.parametrize("staircase", [False, True])
def test_batched_half_special_values_bitwise_on_the_card(dtype, m,
                                                         staircase):
    """NaN with a payload, +-inf, -0.0, values whose plane results
    overflow the type and ones whose products are subnormal, a row each,
    in and outside the hulls (edge planes the identity in every wave):
    the kernel's bits equal its plain version's, and outside the hulls
    they are the input's; ``m = 256`` stages columns in 16-byte pieces,
    ``m = 253`` by plain loads."""
    dev = _cuda()
    gen = torch.Generator().manual_seed(13)
    b, n, k_pad, edge = 4, 300, 48, 6
    seqs = []
    for k in (20, 33, 41, 48):
        s = random_sequence(n, k, generator=gen, device=dev, dtype=dtype)
        C, S = s.cos.clone(), s.sin.clone()
        C[:edge], S[:edge] = 1.0, 0.0
        C[n - 1 - edge:], S[n - 1 - edge:] = 1.0, 0.0
        s = RotationSequence(C, S).pad_to(k_pad)
        seqs.append(s.T if staircase else s)
    nan, big, tiny = SPECIAL[dtype]
    X = torch.randn((b, m, n), generator=gen)
    cols = torch.randperm(n, generator=gen)[:5]
    X[:, 1::8, cols] = float("inf")
    X[:, 2::8, cols] = float("-inf")
    X[:, 3::8, :] = -0.0
    X[:, 4::8, :] = big * torch.sign(X[:, 4::8, :])
    X[:, 5::8, :] = tiny * torch.sign(X[:, 5::8, :])
    A = X.to(dev, dtype)
    _bits(A)[:, 0::8, cols.to(dev)] = nan - 0x10000 * (nan > 0x7FFF)
    C = torch.stack([s.cos for s in seqs])
    S = torch.stack([s.sin for s in seqs])
    G = sign_grid(C, False, None)
    starts, counts = wave_windows(C, S, G)
    args = (A.transpose(1, 2).contiguous(),
            *(x.transpose(1, 2).contiguous() for x in (C, S, G)),
            starts, counts)
    before = batched_k.LAUNCHES
    out, planes = batched_k.rotseq_batched(*args)
    assert batched_k.LAUNCHES == before + 1
    want, want_planes = rotseq_batched_ref(*args)
    assert torch.equal(_bits(out), _bits(want))
    assert torch.equal(planes, want_planes)
    outside = list(range(edge)) + list(range(n - edge, n))
    assert torch.equal(_bits(out[:, outside]), _bits(args[0][:, outside]))
    inner = out[:, edge:n - edge].float()
    assert torch.isnan(inner).any()
    assert ((inner != 0) & (inner.abs() < torch.finfo(dtype).tiny)).any()


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("m", [1024, 1021])
def test_wave_half_special_values_bitwise_on_the_card(dtype, m):
    """NaN with a payload, +-inf, -0.0, values whose plane results
    overflow the type and ones whose products are subnormal, a row each,
    edge planes the identity in every wave, 200 waves (two passes of 12
    bands): the wavefront kernel's bits equal its plain version's;
    ``m = 1024`` stages warp 0's columns in 16-byte pieces, ``m = 1021``
    by plain loads."""
    dev = _cuda()
    gen = torch.Generator().manual_seed(17)
    n, k, edge = 600, 200, 6
    s = random_sequence(n, k, generator=gen, device=dev, dtype=dtype)
    C, S = s.cos.clone(), s.sin.clone()
    C[:edge], S[:edge] = 1.0, 0.0
    C[n - 1 - edge:], S[n - 1 - edge:] = 1.0, 0.0
    nan, big, tiny = SPECIAL[dtype]
    X = torch.randn((m, n), generator=gen)
    cols = torch.randperm(n, generator=gen)[:5]
    X[1::8, cols] = float("inf")
    X[2::8, cols] = float("-inf")
    X[3::8, :] = -0.0
    X[4::8, :] = big * torch.sign(X[4::8, :])
    X[5::8, :] = tiny * torch.sign(X[5::8, :])
    A = X.to(dev, dtype)
    _bits(A)[0::8, cols.to(dev)] = nan - 0x10000 * (nan > 0x7FFF)
    args = _packed(A, C, S, None)
    before = wave_k.LAUNCHES
    out = wave_k.rotseq_wave(*args)
    assert wave_k.LAUNCHES == before + 1
    assert torch.equal(_bits(out), _bits(rotseq_wave_ref(*args)))
    got = out.float()
    assert torch.isnan(got).any()
    assert ((got != 0) & (got.abs() < torch.finfo(dtype).tiny)).any()
    assert ((got == 0) & torch.signbit(got)).any()


def _mxu_plain(A, C, S, n_b, k_b):
    """The accumulated application through the kernel's plain version:
    the same factors, each band by ``rotseq_mxu_ref``."""
    m, n = A.shape
    T = num_tiles(n, n_b, k_b)
    for p0 in range(0, C.shape[1], k_b):
        Q = band_factors(C, S, p0, k_b, n_b, T, dtype=A.dtype)
        fresh, init = band_inputs_natural(A, k_b, n_b, T)
        A = rotseq_mxu_ref(fresh, Q, init)[:, k_b - 1:k_b - 1 + n]
    return A.contiguous()


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("n_b,k_b", [(128, 128), (64, 64), (8, 8), (13, 7),
                                     (200, 56)])
@pytest.mark.parametrize("m", [1000, 1, 63, 65])
def test_mxu_half_within_tolerance_on_the_card(dtype, n_b, k_b, m):
    """Ragged widths (``w`` not a multiple of 16, ``w = 256``) and rows
    (``m`` not a multiple of the kernel's 64) included."""
    dev = _cuda()
    n, k = 1100, 150
    A, C, S, _ = _problem(m, n, k, 11, dtype, dev)
    before = mxu_k.LAUNCHES
    out = rot_sequence_mxu(A, C, S, n_b=n_b, k_b=k_b)
    bands = -(-k // k_b)
    assert mxu_k.LAUNCHES == before + bands and out.dtype == dtype
    plain = _mxu_plain(A, C, S, n_b, k_b)
    oracle = rot_sequence_blocked(A.double(), C.double(), S.double())
    err = (out.double() - oracle).abs().max().item()
    err_plain = (plain.double() - oracle).abs().max().item()
    assert bool(torch.isfinite(out).all())
    assert err <= MXU_RATIO * err_plain, (err, err_plain)
    assert torch.allclose(out.double(), oracle, atol=MXU_TOL * k,
                          rtol=MXU_TOL)


@pytest.mark.parametrize("dtype", HALF)
def test_half_plans_run_the_kernels_on_the_card(dtype):
    """``auto`` on a half target plans a kernel, and a half bucket is one
    fused launch."""
    from repro_torch.serve import RotationService
    dev = _cuda()
    A, C, S, _ = _problem(1024, 1024, 64, 3, dtype, dev)
    plan = RotationSequence(C, S).plan(like=A)
    assert plan.method.startswith("cuda_"), plan.method
    gen = torch.Generator().manual_seed(5)
    reqs = [(random_sequence(128, k, generator=gen, device=dev,
                             dtype=dtype),
             torch.randn((64, 128), generator=gen).to(dev, dtype))
            for k in (20, 31, 17, 26)]
    svc = RotationService(slots=4, store=False, method="cuda_batched")
    before = batched_k.LAUNCHES
    outs = svc.apply_many(reqs)
    torch.cuda.synchronize()
    assert batched_k.LAUNCHES == before + 1
    for out, (seq, X) in zip(outs, reqs):
        assert torch.equal(out, rot_sequence_blocked(X, seq.cos, seq.sin))
