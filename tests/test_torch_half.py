"""The three rotation kernels in bfloat16 and float16, on the CPU.

The reference's Pallas kernels take their operand's dtype: the wavefront
and fused kernels round ``c``, ``s`` and ``g`` to it inside the body and
keep their carries in it, and the accumulated kernel forms ``dot(x, Q_t,
preferred_element_type=float32).astype(x.dtype)``.  Their tests hold
them in bfloat16 within ``5e-2·k`` (wavefront) and ``7e-2·k``
(accumulated) of the float64 oracle (``tests/test_kernels.py``), and the
fused kernel bit for bit to ``blocked`` (``tests/test_rotseq_batched.py``).

Here each port wrapper runs its plain version (the CPU path) in
bfloat16 and float16.  It is held to the reference's op in interpret
mode at the reference's tolerances (XLA on the CPU may keep excess
precision where eager PyTorch rounds each operation, so not bit for bit),
and both are held to the float64 oracle.  Within the port the wavefront
and fused paths equal ``blocked`` in that dtype bit for bit, and equal a
sequential loop that computes each product and sum in float32 and rounds
it to the half type: the arithmetic the CUDA kernels spell.  The
reference's interpret mode runs float16 as well as bfloat16, so both
dtypes are held to it.

The half tier of the accumulated kernel (``csrc/rotseq_mxu_half.cu``)
cannot run here; :func:`_emulate_mxu_half` walks its shared-memory
layout, its TMA boxes and stores through the swizzle, and the operands
its wgmma descriptors read, in numpy, reading the source's constants,
and is held to the plain version.  The wrappers'
dispatch by dtype is checked with the library's entry lookup mocked.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ref import rot_sequence_numpy
from repro.core.sequence import RotationSequence as JSeq
from repro.kernels.rotseq.ops import rot_sequence_wave as j_wave
from repro.kernels.rotseq_batched.ops import rot_sequence_batched as j_batched
from repro.kernels.rotseq_mxu.ops import rot_sequence_mxu as j_mxu
from repro.serve import RotationService as JService
from repro_torch import RotationSequence
from repro_torch.core import registry
from repro_torch.core.blocked import num_tiles, rot_sequence_blocked
from repro_torch.core.ref import sign_grid
from repro_torch.kernels import _build, limits
from repro_torch.kernels.rotseq import kernel as wave_k
from repro_torch.kernels.rotseq.ops import rot_sequence_wave
from repro_torch.kernels.rotseq_batched import kernel as batched_k
from repro_torch.kernels.rotseq_batched.ops import rot_sequence_batched
from repro_torch.kernels.rotseq_mxu import kernel as mxu_k
from repro_torch.kernels.rotseq_mxu.ops import (band_factors,
                                                band_inputs_natural,
                                                rot_sequence_mxu)
from repro_torch.kernels.rotseq_mxu.ref import rotseq_mxu_ref
from repro_torch.serve import RotationService

# (name, torch dtype, jax dtype)
HALF = [("bfloat16", torch.bfloat16, jnp.bfloat16),
        ("float16", torch.float16, jnp.float16)]
# the reference's bfloat16 bars (tests/test_kernels.py): atol = tol·k
WAVE_TOL = 5e-2
MXU_TOL = 7e-2
# (m, n, k, n_b, k_b, m_blk), after tests/test_kernels.py
SHAPES = [(16, 33, 7, 8, 3, 8), (9, 14, 9, 8, 8, 16),
          (8, 20, 3, 64, 16, 256)]


@pytest.fixture(autouse=True)
def _clean():
    registry.clear_plan_cache()
    yield
    registry.clear_plan_cache()


def _inputs(m, n, k, seed, tdt, jdt, signs=False):
    """Seeded numpy inputs rounded to the half type: the port's tensors
    and the reference's arrays, the same values (checked)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)).astype(np.float32)
    th = rng.uniform(0.0, 2.0 * np.pi, (n - 1, k))
    C, S = np.cos(th).astype(np.float32), np.sin(th).astype(np.float32)
    G = (np.where(rng.random((n - 1, k)) < 0.5, 1.0, -1.0).astype(np.float32)
         if signs else None)
    t = [None if x is None else torch.from_numpy(x).to(tdt)
         for x in (A, C, S, G)]
    j = [None if x is None else jnp.asarray(x).astype(jdt)
         for x in (A, C, S, G)]
    for a, b in zip(t, j):
        if a is not None:
            assert np.array_equal(a.float().numpy(), np.asarray(b, np.float32))
    return t, j


def _oracle(A, C, S, G=None):
    """The reference's float64 oracle on the (rounded) inputs."""
    return rot_sequence_numpy(
        A.double().numpy(), C.double().numpy(), S.double().numpy(),
        G=None if G is None else G.double().numpy())


def _close(got, want, tol, k):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               atol=tol * max(1, k), rtol=tol)


def _rounded_loop(A, C, S, G, dtype):
    """Sequential wave-major order, every product and sum taken in
    float32 and rounded to ``dtype`` before the next one uses it."""
    def r(v):
        return v.to(dtype).float()
    X = A.float().clone()
    Cf, Sf = C.float(), S.float()
    Gf = sign_grid(C, False, G).float()
    n1, k = C.shape
    for p in range(k):
        for j in range(n1):
            x, y = X[:, j].clone(), X[:, j + 1].clone()
            c, s, g = Cf[j, p], Sf[j, p], Gf[j, p]
            X[:, j] = r(r(c * x) + r(s * y))
            X[:, j + 1] = r(g * r(r(s * x) - r(c * y)))
    return X.to(dtype)


# ------------------------------------------------------- the wavefront ----

@pytest.mark.parametrize("name,tdt,jdt", HALF)
@pytest.mark.parametrize("m,n,k,n_b,k_b,m_blk", SHAPES)
def test_wave_half_vs_reference_and_oracle(m, n, k, n_b, k_b, m_blk, name,
                                           tdt, jdt):
    signs = n == 14
    (A, C, S, G), (jA, jC, jS, jG) = _inputs(m, n, k, m * n + k, tdt, jdt,
                                             signs)
    before = wave_k.LAUNCHES
    out = rot_sequence_wave(A, C, S, n_b=n_b, k_b=k_b, G=G)
    assert wave_k.LAUNCHES == before and out.dtype == tdt
    ref = j_wave(jA, jC, jS, n_b=n_b, k_b=k_b, m_blk=m_blk, G=jG)
    assert ref.dtype == jdt
    oracle = _oracle(A, C, S, G)
    _close(out.float(), np.asarray(ref, np.float32), WAVE_TOL, k)
    _close(out.float(), oracle, WAVE_TOL, k)
    _close(np.asarray(ref, np.float32), oracle, WAVE_TOL, k)
    # bit for bit: blocked in the half type, and the rounded loop
    assert torch.equal(out, rot_sequence_blocked(A, C, S, n_b=n_b, k_b=k_b,
                                                 G=G))
    assert torch.equal(out, _rounded_loop(A, C, S, G, tdt))


# ----------------------------------------------------------- the fused ----

@pytest.mark.parametrize("name,tdt,jdt", HALF)
@pytest.mark.parametrize("staircase", [False, True])
def test_batched_half_vs_reference_and_blocked(name, tdt, jdt, staircase):
    b, m, n, k, k_pad = 3, 12, 20, 6, 8
    seqs, targets, jC, jS, jA = [], [], [], [], []
    for i in range(b):
        (A, C, S, _), (a, c, s, _) = _inputs(m, n, k, 40 + i, tdt, jdt)
        seq = RotationSequence(C, S).pad_to(k_pad)
        jseq = JSeq(c, s).pad_to(k_pad)
        if staircase:
            seq, jseq = seq.T, jseq.T
        seqs.append(seq)
        targets.append(A)
        jA.append(a)
        jC.append(jseq.cos)
        jS.append(jseq.sin)
    A = torch.stack(targets)
    C = torch.stack([s.cos for s in seqs])
    S = torch.stack([s.sin for s in seqs])
    G = (torch.stack([s.with_signs().sign for s in seqs]) if staircase
         else None)
    jG = None if G is None else jnp.asarray(G.float().numpy()).astype(jdt)
    out, planes = rot_sequence_batched(A, C, S, G=G, return_planes=True)
    assert out.dtype == tdt
    ref, jplanes = j_batched(jnp.stack(jA), jnp.stack(jC), jnp.stack(jS),
                             G=jG, return_planes=True)
    assert np.array_equal(planes[:, 0].numpy(), np.asarray(jplanes)[:, 0])
    K = C.shape[-1]
    _close(out.float(), np.asarray(ref, np.float32), WAVE_TOL, K)
    for i, seq in enumerate(seqs):
        g = None if G is None else G[i]
        _close(out[i].float(), _oracle(A[i], seq.cos, seq.sin, g),
               WAVE_TOL, K)
        # bit for bit to blocked and to the wavefront's plain path
        assert torch.equal(out[i], rot_sequence_blocked(
            A[i], seq.cos, seq.sin, G=g))
        assert torch.equal(out[i], rot_sequence_wave(A[i], seq.cos, seq.sin,
                                                     G=g))


# ----------------------------------------------------- the accumulated ----

@pytest.mark.parametrize("name,tdt,jdt", HALF)
@pytest.mark.parametrize("m,n,k,n_b,k_b,m_blk", SHAPES)
def test_mxu_half_vs_reference_and_oracle(m, n, k, n_b, k_b, m_blk, name,
                                          tdt, jdt):
    (A, C, S, _), (jA, jC, jS, _) = _inputs(m, n, k, m + n * k, tdt, jdt)
    out = rot_sequence_mxu(A, C, S, n_b=n_b, k_b=k_b)
    assert out.dtype == tdt
    ref = j_mxu(jA, jC, jS, n_b=n_b, k_b=k_b, m_blk=m_blk)
    oracle = _oracle(A, C, S)
    _close(out.float(), np.asarray(ref, np.float32), MXU_TOL, k)
    _close(out.float(), oracle, MXU_TOL, k)
    _close(np.asarray(ref, np.float32), oracle, MXU_TOL, k)


@pytest.mark.parametrize("name,tdt,jdt", HALF)
def test_mxu_half_plain_version_rounds_each_tile_once(name, tdt, jdt):
    """The plain version of one half band: per tile the float32 product
    of the half operands, rounded to the half type once."""
    (A, C, S, _), _ = _inputs(10, 40, 9, 5, tdt, jdt)
    n_b, k_b, T = 8, 4, 6
    Q = band_factors(C, S, 0, k_b, n_b, T, dtype=tdt)
    assert Q.dtype == tdt
    fresh, init = band_inputs_natural(A, k_b, n_b, T)
    O = rotseq_mxu_ref(fresh, Q, init)
    carry = init
    for t in range(T):
        X = torch.cat([carry, fresh[:, t * n_b:(t + 1) * n_b]], 1).double()
        Y = (X @ Q[t].double()).float().to(tdt)
        assert torch.equal(O[:, t * n_b:(t + 1) * n_b], Y[:, :n_b])
        carry = Y[:, n_b:]


# ------------------------------------- a float32 sequence, half target ----

@pytest.mark.parametrize("name,tdt,jdt", HALF)
@pytest.mark.parametrize("route", ["wave", "batched", "mxu"])
def test_float32_sequence_on_half_target_equals_cast_first(name, tdt, jdt,
                                                           route):
    """The wrappers round ``c``, ``s`` and ``g`` to the target's dtype
    before use, as the reference's bodies do."""
    (A, _, _, _), _ = _inputs(11, 24, 10, 9, tdt, jdt)
    rng = np.random.default_rng(10)
    th = rng.uniform(0.0, 2.0 * np.pi, (23, 10))
    C = torch.from_numpy(np.cos(th).astype(np.float32))
    S = torch.from_numpy(np.sin(th).astype(np.float32))
    G = torch.from_numpy(np.where(rng.random((23, 10)) < 0.5, 1.0,
                                  -1.0).astype(np.float32))
    fn = {"wave": rot_sequence_wave, "batched": rot_sequence_batched,
          "mxu": lambda *a, **kw: rot_sequence_mxu(*a, n_b=8, k_b=4, **kw)
          }[route]
    got = fn(A, C, S, G=G)
    want = fn(A, C.to(tdt), S.to(tdt), G=G.to(tdt))
    assert got.dtype == tdt and torch.equal(got, want)


# --------------------------------------------------------- the service ----

@pytest.mark.parametrize("name,tdt,jdt", HALF)
def test_half_bucket_vs_reference_service(name, tdt, jdt):
    """A half bucket through ``RotationService`` against the reference's
    service on the same requests; its fused route equals its default one
    bit for bit."""
    reqs, jreqs = [], []
    for i, k in enumerate((5, 8, 3, 7, 6)):
        (A, C, S, _), (a, c, s, _) = _inputs(12, 16, k, 60 + i, tdt, jdt)
        reqs.append((RotationSequence(C, S), A))
        jreqs.append((JSeq(c, s), a))
    jouts = JService(slots=4, store=False).apply_many(jreqs)
    outs = RotationService(slots=4, store=False).apply_many(reqs)
    fused = RotationService(slots=4, store=False,
                            method="cuda_batched").apply_many(reqs)
    for out, f, jout, (seq, A) in zip(outs, fused, jouts, reqs):
        assert out.dtype == tdt and f.dtype == tdt
        _close(out.float(), np.asarray(jout, np.float32), WAVE_TOL, seq.k)
        _close(out.float(), _oracle(A, seq.cos, seq.sin), WAVE_TOL, seq.k)
        assert torch.equal(out, f)


# ---------------------------------------------------------- the planner ----

@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_half_paper_shape_plans_a_kernel_on_the_card(dtype):
    p = registry.Problem(m=3840, n=3840, k=180, dtype=dtype, platform="cuda")
    names = {s.name for s in registry.eligible_backends(p)}
    assert {"cuda_wave", "cuda_mxu", "cuda_batched"} <= names
    plan = registry.select_plan(3840, 3840, 180, dtype=dtype,
                                platform="cuda")
    assert plan.method.startswith("cuda_"), plan
    bucket = registry.select_plan(1024, 1024, 64, dtype=dtype,
                                  platform="cuda", batch=16,
                                  shared_sequence=False)
    assert bucket.method.startswith("cuda_"), bucket
    p64 = registry.Problem(m=3840, n=3840, k=180, dtype="float64",
                           platform="cuda")
    assert not any(s.name.startswith("cuda_")
                   for s in registry.eligible_backends(p64))


def test_half_mxu_sweep_priced_at_the_tensor_core_rate():
    """The half tier's sweep at the paper shape costs less than the
    float32 tier's measured slab fit, and more than its flops at the
    tensor cores' dense rate."""
    from repro_torch.core.registry import Plan, cost_cuda_mxu
    from repro_torch.hw import PLATFORMS
    plan = Plan("cuda_mxu", n_b=128, k_b=128)
    f32, bf16 = (cost_cuda_mxu(registry.Problem(
        m=3840, n=3840, k=180, dtype=dt, platform="cuda"), plan)
        for dt in ("float32", "bfloat16"))
    flops = 2.0 * 3840 * 256 * 256 * 31 * 2
    assert flops / PLATFORMS["cuda"].tc_bf16_flops < bf16 < f32


# planner problems on the card: (m, n, k, batch, shared, live planes,
# devices): the paper shape, the paper sweep's ends, a 1024 x 1024 target,
# the eig flush, the serving bucket and its seq.T staircases, a SOAP
# refresh's side, one shard of four
PRICED = [(3840, 3840, 180, 1, True, None, 1), (240, 240, 180, 1, True,
                                                 None, 1),
          (1024, 1024, 64, 1, True, None, 1),
          (1024, 1024, 32, 1, True, None, 1),
          (1024, 1024, 64, 16, False, None, 1),
          (1024, 1024, 1086, 16, False, 1023 * 64, 1),
          (3840, 3840, 180, 8, True, None, 1), (4, 4, 64, 1, True, None, 1),
          (3840, 3840, 180, 1, True, None, 4)]


def _picks(dtype):
    registry.clear_plan_cache()
    return [registry.select_plan(m, n, k, dtype=dtype, platform="cuda",
                                 batch=b, shared_sequence=sh,
                                 live_planes=live, sharded=d > 1,
                                 devices=d)
            for m, n, k, b, sh, live, d in PRICED]


def test_float32_picks_unchanged_by_the_half_plane_rates(monkeypatch):
    """``cuda_batched``'s half plane rates price only half problems: with
    them set far off every float32 pick is the same, and the float32
    rate is still the main path's measurement (6.62 ms at the paper
    shape)."""
    before = _picks("float32")
    for dtype in ("bfloat16", "float16"):
        monkeypatch.setitem(registry._BATCHED_PLANE_SECONDS, dtype, 1.0)
    assert _picks("float32") == before
    assert registry._BATCHED_PLANE_SECONDS["float32"] == \
        6.62e-3 / (3839 * 180)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_half_factor_build_priced_at_its_dtype_rate(dtype, monkeypatch):
    """A half problem prices ``cuda_mxu``'s factor build (one half
    ``rotseq_batched`` launch a band) and ``cuda_batched`` at its own
    dtype's plane rate, not float32's; the measured half rates are
    slower than float32's (a half plane rounds seven times)."""
    from repro_torch.core.registry import (Plan, _row_chain_seconds,
                                           _tile_grid, cost_cuda_batched,
                                           cost_cuda_mxu)
    rates = registry._BATCHED_PLANE_SECONDS
    assert rates[dtype] > rates["float32"]
    p = registry.Problem(m=3840, n=3840, k=180, dtype=dtype,
                         platform="cuda")
    mxu = Plan("cuda_mxu", n_b=128, k_b=128)
    bands, tiles, w = _tile_grid(p, 128, 128)
    costs = {}
    for rate in (1e-6, 2e-6):
        monkeypatch.setitem(rates, dtype, rate)
        costs[rate] = (cost_cuda_mxu(p, mxu),
                       cost_cuda_batched(p, Plan("cuda_batched")))
    step = bands * (_row_chain_seconds(128 * 128, tiles * w, 2e-6)
                    - _row_chain_seconds(128 * 128, tiles * w, 1e-6))
    assert costs[2e-6][0] - costs[1e-6][0] == pytest.approx(step)
    assert costs[2e-6][1] == pytest.approx(2 * costs[1e-6][1])
    monkeypatch.setitem(rates, "float32", 1.0)
    assert (cost_cuda_mxu(p, mxu),
            cost_cuda_batched(p, Plan("cuda_batched"))) == costs[2e-6]


# --------------------------------------------- the wrappers' dispatch ----

class _OnCuda:
    """A CPU tensor that reports a CUDA device, so the wrappers take
    their kernel branch without a card."""
    device = torch.device("cuda", 0)

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


class _Looked(Exception):
    pass


class _Library:
    """Stands in for the kernel library: records the entry asked for."""

    def __init__(self):
        self.asked = []

    def __getattr__(self, name):
        self.asked.append(name)
        raise _Looked(name)


def _wrapper_call(kind, dtype):
    if kind == "wave":
        z = torch.zeros
        args = (z((6, 4), dtype=dtype),
                *(z((2, 5), dtype=dtype) for _ in range(3)))
        return lambda: wave_k.rotseq_wave(*map(_OnCuda, args))
    if kind == "batched":
        args = (torch.zeros((2, 6, 4), dtype=dtype),
                *(torch.zeros((1, 2, 5), dtype=dtype) for _ in range(3)),
                torch.zeros((1, 2), dtype=torch.int32),
                torch.ones((1, 2), dtype=torch.int32))
        return lambda: batched_k.rotseq_batched(*map(_OnCuda, args))
    args = (torch.zeros((4, 8), dtype=dtype),
            torch.zeros((2, 8, 8), dtype=dtype),
            torch.zeros((4, 4), dtype=dtype))
    return lambda: mxu_k.rotseq_mxu(*map(_OnCuda, args))


_MODULE = {"wave": wave_k, "batched": batched_k, "mxu": mxu_k}
_ENTRY = {"wave": "rotseq_wave", "batched": "rotseq_batched",
          "mxu": "rotseq_mxu"}


@pytest.mark.parametrize("kind", ["wave", "batched", "mxu"])
@pytest.mark.parametrize("dtype,suffix", [(torch.float32, "f32"),
                                          (torch.bfloat16, "bf16"),
                                          (torch.float16, "f16"),
                                          (torch.float64, None)])
def test_wrappers_look_up_their_entry_by_dtype(monkeypatch, kind, dtype,
                                               suffix):
    """A CUDA operand reaches the library entry of its dtype; a dtype
    with no entry raises before any lookup, and nothing falls back."""
    lib = _Library()
    monkeypatch.setattr(_build, "load", lambda: lib)
    module = _MODULE[kind]
    monkeypatch.setattr(module, "_FN", {})
    before = module.LAUNCHES
    call = _wrapper_call(kind, dtype)
    if suffix is None:
        with pytest.raises(TypeError, match="float64"):
            call()
        assert lib.asked == []
    else:
        with pytest.raises(_Looked):
            call()
        assert lib.asked == [f"{_ENTRY[kind]}_{suffix}"]
        assert module.ENTRY[dtype] == lib.asked[0]
    assert module.LAUNCHES == before


def test_every_entry_is_exported_by_a_source():
    """Each wrapper's entries are ``extern "C"`` functions of the sources
    the build compiles."""
    text = "".join(p.read_text() for p in _build._sources())
    for module in _MODULE.values():
        for name in module.ENTRY.values():
            assert re.search(rf'extern "C" int {name}\(', text), name


# ------------------------------------ the half accumulated kernel, emulated

CU = (pathlib.Path(limits.__file__).parents[1] / "csrc"
      / "rotseq_mxu_half.cu").read_text()


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", CU).group(1))


ROWS, CHUNK, STAGES, CLUSTER, VEC, GROUPS = (
    _constant(c) for c in ("kRows", "kChunk", "kStages", "kCluster", "kVec",
                           "kGroups"))
XCHUNK = ROWS * CHUNK * 2   # bytes of one chunk of X


def _sw_addr(addr):
    """The card's 128-byte swizzle of a shared-memory byte address (TMA's
    ``SWIZZLE_128B`` writes and wgmma's swizzled descriptors read through
    it): the 16-byte piece XORed with the address's 128-byte row mod 8."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _swz(r, c):
    """The source's ``swz``: byte offset of (row ``r``, column ``c``) in a
    run of swizzled chunks, as the kernel's own stores compute it."""
    return ((c >> 6) * XCHUNK + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4)
            + ((c & 7) << 1))


def _tma(smem, dst, src, coords, box):
    """A 3D TMA box load into the byte address ``dst`` (a multiple of
    1024): ``src`` (d2, d1, d0) numpy, ``coords``/``box`` innermost first;
    elements past ``src``'s extents read as zeros; rows of ``box[0]``
    elements (128 bytes) in order, swizzled."""
    b0, b1, b2 = box
    c0, c1, c2 = coords
    tile = np.zeros((b2, b1, b0), np.float32)
    part = src[c2:c2 + b2, c1:c1 + b1, c0:c0 + b0]
    tile[:part.shape[0], :part.shape[1], :part.shape[2]] = part
    rows = np.arange(b2 * b1)[:, None]
    cols = np.arange(b0)[None, :]
    smem[_sw_addr(dst + rows * 128 + cols * 2) // 2] = tile.reshape(-1, b0)


def _operand(smem, addr, rows):
    """What a wgmma descriptor at byte ``addr`` (a chunk base plus 32
    bytes a k16 step) reads: ``rows`` x 16 K-major, 128 bytes a row."""
    r = np.arange(rows)[:, None]
    k = np.arange(16)[None, :]
    return smem[_sw_addr(addr + r * 128 + k * 2) // 2].astype(np.float64)


def _emulate_mxu_half(fresh, Q, init, dtype):
    """``rotseq_mxu_half_kernel`` in numpy, one block at a time: the
    wrapper's ``Q^T`` (the fresh rows' columns from ``kq``, ``k_b``
    rounded up to ``kVec``, zeros between and to ``ldq``); each block's
    shared memory as
    the source lays it out (the ring of ``kStages`` chunks of ``WP`` rows,
    then the two X buffers of ``WP/64 + 1`` chunks, ``[carry | fresh]``),
    zeroed, with the initial carry stored through ``swz``; per tile the
    producer's loads (fresh by a TMA box of the ``(M, T, n_b)`` view where
    ``n_b`` is a multiple of ``kVec``, else element by element through
    ``swz``; each chunk of ``Q_t^T`` as ``kCluster`` multicast boxes of
    ``WP / kCluster`` rows of the one map of ``Q^T``, the fresh rows read
    from ``kq`` on, the carry's from 0, against X's zero columns past
    ``k_b``); each
    warpgroup's k16 steps, fresh chunks then carry chunks, read through
    the descriptors and summed in float32 (each step's products exactly,
    in float64, then rounded to float32), every step of every chunk (past
    the segment's depth both operands are zeros); ``Y_t`` rounded to
    ``dtype`` once, its carry columns stored through ``swz`` into the
    other X buffer (whole 8-column blocks where ``n_b`` is a multiple of
    8) and its first ``n_b`` columns of rows below ``M`` to ``out``."""
    M, k_b = init.shape
    T, w, _ = Q.shape
    n_b = w - k_b
    WP = limits.mxu_width(w)
    N = WP // GROUPS
    kq = limits.round_up(k_b, VEC)   # the fresh rows' first column
    ldq = limits.round_up(kq + n_b, VEC)
    qt = np.zeros((T, w, ldq), np.float32)
    QT = Q.transpose(1, 2).float().numpy()
    qt[..., :k_b], qt[..., kq:kq + n_b] = QT[..., :k_b], QT[..., k_b:]
    f, i0 = fresh.float().numpy(), init.float().numpy()
    U = T * n_b
    vec = n_b % VEC == 0
    kc, kf = -(-k_b // CHUNK), -(-n_b // CHUNK)
    # carry columns stored: whole 8-column blocks where n_b allows (their
    # columns past w are +0), else exactly k_b
    kw = limits.round_up(k_b, 8) if n_b % 8 == 0 else k_b
    qbytes = WP * CHUNK * 2
    xbytes = (WP // CHUNK + 1) * XCHUNK
    ring, xbuf = 0, STAGES * qbytes
    assert xbuf % 1024 == 0 and xbytes % 1024 == 0
    out = np.full((M, U), np.nan, np.float32)
    rnd = (lambda v: torch.from_numpy(np.asarray(v, np.float32))
           .to(dtype).float().numpy())
    blocks = -(-M // ROWS)
    blocks = -(-blocks // CLUSTER) * CLUSTER
    for blk in range(blocks):
        row0 = blk * ROWS
        smem = np.zeros((xbuf + 2 * xbytes) // 2, np.float32)
        live = max(0, min(ROWS, M - row0))
        r_live, c_k = np.meshgrid(np.arange(live), np.arange(k_b),
                                  indexing="ij")
        smem[(xbuf + _swz(r_live, c_k)) // 2] = i0[row0:row0 + live]
        pos = 0   # ring position
        for t in range(T):
            xb = xbuf + (t & 1) * xbytes
            xf = xb + kc * XCHUNK
            if vec:
                view = f.reshape(M, T, n_b)
                for j in range(kf):
                    _tma(smem, xf + j * XCHUNK, view, (j * CHUNK, t, row0),
                         (CHUNK, 1, ROWS))
            else:
                r_f, c_f = np.meshgrid(np.arange(live), np.arange(n_b),
                                       indexing="ij")
                smem[(xf + _swz(r_f, c_f)) // 2] = \
                    f[row0:row0 + live, t * n_b:(t + 1) * n_b]
            acc = np.zeros((ROWS, WP), np.float32)
            for j in range(kf + kc):   # fresh rows first, then the carry's
                fr = j < kf
                slot = ring + (pos % STAGES) * qbytes
                pos += 1
                k0 = kq + j * CHUNK if fr else (j - kf) * CHUNK
                share = WP // CLUSTER
                for rank in range(CLUSTER):   # the producers' multicasts
                    _tma(smem, slot + rank * share * 128, qt,
                         (k0, rank * share, t), (CHUNK, share, 1))
                x0 = xf + j * XCHUNK if fr else xb + (j - kf) * XCHUNK
                for n0 in range(0, WP, N):   # each warpgroup's k16 steps
                    for k in range(CHUNK // 16):
                        a = _operand(smem, x0 + 32 * k, ROWS)
                        b = _operand(smem, slot + n0 * 128 + 32 * k, N)
                        acc[:, n0:n0 + N] = (acc[:, n0:n0 + N]
                                             + a @ b.T).astype(np.float32)
            Y = rnd(acc)
            if t + 1 < T:   # the carry, through swz, to the other buffer
                xn = xbuf + ((t + 1) & 1) * xbytes
                r_c, c_c = np.meshgrid(np.arange(ROWS), np.arange(kw),
                                       indexing="ij")
                smem[(xn + _swz(r_c, c_c)) // 2] = Y[:, n_b:n_b + kw]
            out[row0:row0 + live, t * n_b:(t + 1) * n_b] = Y[:live, :n_b]
    return torch.from_numpy(out).to(dtype)


@pytest.mark.parametrize("name,tdt,jdt", HALF)
@pytest.mark.parametrize("m,n,k,n_b,k_b", [(40, 30, 8, 8, 8),
                                           (33, 50, 6, 10, 6),
                                           (32, 100, 64, 64, 64),
                                           (65, 120, 20, 13, 7),
                                           (100, 420, 60, 200, 56),
                                           (130, 600, 3, 255, 1)])
def test_mxu_half_kernel_emulated_vs_plain(m, n, k, n_b, k_b, name, tdt,
                                           jdt):
    """The emulated half kernel on one band equals the plain version up
    to the order of its float32 sums: at most one unit in the last place
    of the half type apart."""
    (A, C, S, _), _ = _inputs(m, n, k, 3 * m + n, tdt, jdt)
    T = num_tiles(n, n_b, k_b)
    Q = band_factors(C, S, 0, k_b, n_b, T, dtype=tdt)
    fresh, init = band_inputs_natural(A, k_b, n_b, T)
    got = _emulate_mxu_half(fresh, Q, init, tdt)
    want = rotseq_mxu_ref(fresh, Q, init)
    assert bool(torch.isfinite(got).all())
    ulp = torch.finfo(tdt).eps
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=ulp, atol=ulp)
