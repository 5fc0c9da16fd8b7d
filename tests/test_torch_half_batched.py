"""The half-precision body of the fused batched kernel, emulated on the CPU.

``csrc/rotseq_batched.cu`` in bfloat16 and float16 keeps its register
window in float32, every value in it exactly representable in the half
type: a column is widened once when it enters from the staged tile
(``Store<T>::w``) and narrowed once, exactly and keeping every bit, when
it is stored (``Store<T>::n``).  Planes ``i`` and ``i + 1`` of a step
touch disjoint columns (``plane_pair``; both in ``csrc/half_store.cuh``,
which the wavefront kernel shares), so each of their seven roundings is
one paired instruction: the four products (float32) by one packed
conversion each (``Store<T>::p2``), the sum, the difference and g's
product of two half values by one native paired op each (``__hadd2``,
``__hsub2``, ``__hmul2``), which rounds the exact result once.
:func:`_emulate` walks that body step for step in numpy, the
conversions as their bit arithmetic (to nearest even; a NaN to
``0x7FFF``) and the native ops as float64's exact result rounded once,
and is held bit for bit to the plain version ``rotseq_batched_ref``,
which rounds every float32 op.  The conversions' bit arithmetic
(``tests/_torch_half_bits.py``) is held to ``torch.Tensor.to`` and the
native ops to eager PyTorch's ops over every pair of a structured set of
half values.

NaN bits: a NaN that an operation makes has its platform's bits.  On the
card the conversions give ``0x7FFF`` in both half types
(``cvt.rn.bf16x2.f32``, ``cvt.rn.f16x2.f32``, and eager PyTorch's
``__float2bfloat16``/``__float2half_rn`` alike), which the emulation
gives; on this host eager PyTorch gives ``0x7FC0`` or ``0xFFFF`` in
bfloat16 (by its vector path) and, in float16, a signed ``0x7E00`` or the
payload of the NaN it started from.  So at a NaN of the plain version in
a column a live plane touched the emulation must give ``0x7FFF``, and
everywhere else every bit must be equal, a NaN's payload too.  On the
card the kernel is held to the plain version with every bit
(``tests/test_torch_half_card.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch import RotationSequence
from repro_torch.core.ref import sign_grid
from repro_torch.kernels.rotseq_batched.ops import wave_windows
from repro_torch.kernels.rotseq_batched.ref import rotseq_batched_ref

from _torch_half_bits import (BF16, CARD_NAN, F16, HALF, SPECIAL, U32, bits,
                              lanes, native, pack, plane_pair)


def _emulate(AT, C, S, G, starts, counts, kb, half):
    """``csrc/rotseq_batched.cu``'s half path step for step, over all rows
    of a request at once.

    The band/chunk/window schedule of the float32 path
    (``tests/test_torch_batched.py::_emulate_band_schedule``), with the
    window in float32: a column widened by ``w`` as it enters, narrowed
    by ``n`` as it is stored; the planes of a step taken in pairs
    ``(i, i+1)`` by ``plane_pair`` (``csrc/half_store.cuh``); ``c``/``s``
    widened by ``f`` when they are staged and ``g`` staged as
    its raw bits, a dead plane's values stale (NaN here) and its results
    dropped by the select.  The first band to run copies the columns it
    does not touch as bits."""
    at = bits(AT)
    c, s, g = (bits(x) for x in (C, S, G))
    b, n, m = at.shape
    bs, K, J = c.shape
    W = 2 * kb
    CS = min(W, 128 // kb)
    out = np.full_like(at, 0x7BCD)          # a column left unwritten shows
    stale = np.float32(np.nan)
    zero = np.zeros(m, np.float32)
    for ib in range(b):
        r = ib if bs > 1 else 0
        src, dst = at[ib], out[ib]
        first = True
        for b0 in range(0, K, kb):
            hulls = [(i, int(starts[r, b0 + i]), int(counts[r, b0 + i]))
                     for i in range(min(kb, K - b0))]
            hulls = [h for h in hulls if h[2] > 0]
            if not hulls:
                continue
            tlo = min(lo + 2 * i for i, lo, _ in hulls)
            thi = max(lo + cnt + 2 * i for i, lo, cnt in hulls)
            clo = min(lo for _, lo, _ in hulls)
            chi = max(lo + cnt for _, lo, cnt in hulls)

            def inside(col):
                return clo <= col <= chi

            if first:
                for col in range(n):
                    if not inside(col):
                        dst[col] = src[col]
            frm = src if first else dst
            first = False

            def load(col):
                return half.w(frm[col]) if inside(col) else zero

            def stage(tc):
                panel = [[None] * CS for _ in range(kb)]
                for i in range(kb):
                    for u in range(CS):
                        p, j = b0 + i, tc + u - 2 * i
                        live = (p < K and 0 <= j < J
                                and starts[r, p] <= j
                                < starts[r, p] + counts[r, p])
                        panel[i][u] = ((half.f(c[r, p, j:j + 1])[0],
                                        half.f(s[r, p, j:j + 1])[0],
                                        g[r, p, j], True) if live else
                                       (stale, stale, np.uint16(CARD_NAN),
                                        False))
                return panel, [load(tc + 1 + u) for u in range(CS)]

            t0 = tlo // CS * CS
            t1 = -(-thi // CS) * CS
            win = [zero] * W
            for q in range(W - 1):
                win[(q + 2) % W] = load(t0 - W + 2 + q)
            for tc in range(t0, t1, CS):
                panel, cols = stage(tc)
                for u in range(CS):
                    t = tc + u
                    win[(u + 1) % W] = cols[u]
                    for i in range(0, kb, 2):
                        (c0, s0, g0, l0), (c1, s1, g1, l1) = (
                            panel[i][u], panel[i + 1][u])
                        ix0, iy0 = (u - 2 * i) % W, (u - 2 * i + 1) % W
                        ix1, iy1 = (u - 2 * i - 2) % W, (u - 2 * i - 1) % W
                        xn, yn = plane_pair(
                            (c0, s0, g0), (c1, s1, g1), win[ix0], win[iy0],
                            win[ix1], win[iy1], half)
                        if l0:
                            win[ix0], win[iy0] = xn[0], yn[0]
                        if l1:
                            win[ix1], win[iy1] = xn[1], yn[1]
                    if inside(t - W + 2):
                        dst[t - W + 2] = half.n(win[(u + 2) % W])
                win = [win[(q + CS) % W] for q in range(W)]
            for q in range(W - 1):
                if inside(t1 - W + 2 + q):
                    dst[t1 - W + 2 + q] = half.n(win[(q + 2) % W])
        if first:
            dst[:] = src
    return torch.from_numpy(out.view(np.int16)).view(half.dtype)


def _assert_bits(got, want, args, half):
    """Every bit equal, but at a NaN of the plain version in a column
    that a live plane touched (a NaN its arithmetic made, with the host's
    bits): there the emulation gives the card's ``0x7FFF``.  Returns
    where that was."""
    AT, starts, counts = args[0], args[4], args[5]
    g, w = bits(got), bits(want)
    col = torch.arange(AT.shape[1])
    hit = ((col >= starts[..., None]) & (col <= (starts + counts)[..., None])
           & (counts[..., None] > 0)).any(dim=1)         # (bs, n)
    touched = hit.expand(AT.shape[0], -1).numpy()[..., None]
    made = half.nan(w) & touched
    assert np.array_equal(g[~made], w[~made]), (
        np.argwhere((g != w) & ~made)[:5])
    assert (g[made] == CARD_NAN).all()
    return made


def _waves(n, k, seed):
    rng = np.random.default_rng(seed)
    th = rng.uniform(0.0, 2.0 * np.pi, (n - 1, k))
    return np.cos(th).astype(np.float32), np.sin(th).astype(np.float32)


def _seq(n, k, seed, kind, dtype):
    C, S = _waves(n, k, seed)
    G = None
    if kind in ("signed", "scaled"):
        rng = np.random.default_rng(seed + 1)
        G = np.where(rng.random(C.shape) < 0.5, 1.0, -1.0)
        if kind == "scaled":
            G = G * rng.choice([0.75, 1.5, 3.0], C.shape)
        G = torch.from_numpy(G.astype(np.float32)).to(dtype)
    return RotationSequence(torch.from_numpy(C).to(dtype),
                            torch.from_numpy(S).to(dtype), G,
                            kind == "reflect")


# "scaled": signs of magnitude other than 1, so that the rounding of the
# difference before its product with g is seen (with g = +-1 it is not)
CASES = ["per_request", "shared", "signed", "reflect", "padded",
         "staircase", "padded_reflect", "scaled"]


def _case(case, dtype, b=3, m=5, n=14, k=5):
    """Sequences of one bucket, shared (one) or one a request, as
    ``tests/test_torch_batched.py`` builds them."""
    if case == "shared":
        return [_seq(n, k, 10, "plain", dtype)]
    seqs = []
    for i in range(b):
        kind = {"signed": "signed" if i != 1 else "plain",
                "scaled": "scaled", "reflect": "reflect",
                "padded_reflect": "reflect"}.get(case, "plain")
        seq = _seq(n, k if "padded" not in case else 2 + i, 20 + i, kind,
                   dtype)
        if "padded" in case:
            seq = seq.pad_to(k + 2)
        if case == "staircase":
            seq = seq.T
        seqs.append(seq)
    return seqs


def _packed(A, seqs):
    C = torch.stack([s.cos for s in seqs])
    S = torch.stack([s.sin for s in seqs])
    G = torch.stack([sign_grid(s.cos, s.reflect, s.sign) for s in seqs])
    starts, counts = wave_windows(C, S, G)
    return (A.transpose(1, 2).contiguous(),
            *(x.transpose(1, 2).contiguous() for x in (C, S, G)),
            starts, counts)


@pytest.mark.parametrize("name", sorted(HALF))
@pytest.mark.parametrize("kb", [2, 4, 16])
@pytest.mark.parametrize("case", CASES)
def test_half_body_emulation_equals_plain_version(case, kb, name):
    """The float32 window of half-exact values and the paired roundings
    give the plain version's result bit for bit: shared and per-request
    panels, signs, reflectors, padded and ``seq.T`` staircase grids, and
    a wave count that is no multiple of ``kb``."""
    half = HALF[name]
    seqs = _case(case, half.dtype)
    rng = np.random.default_rng(16)
    A = torch.from_numpy(rng.standard_normal(
        (3, 5, 14)).astype(np.float32)).to(half.dtype)
    args = _packed(A, seqs)
    assert args[1].shape[1] % kb != 0       # a remainder band
    got = _emulate(*args, kb, half)
    want, _ = rotseq_batched_ref(*args)
    made = _assert_bits(got, want, args, half)
    assert not made.any()


# column ranges of the special-value case (n = 24): waves alternate
# between the hulls [2, 8) and [14, 20), which reach columns 2..8 and
# 14..20; every band holds both, so columns 9..13 lie inside every band's
# span of columns (loaded and stored) but in no hull, and 0, 1 and 21..23
# outside every span
LEFT, RIGHT, GAP, OUTSIDE = (2, 8), (14, 20), range(9, 14), (0, 1, 21, 22, 23)


def _special_case(name, dtype, b=2, m=8, n=24, k=6):
    """Per-request waves alternating between two hulls, and targets with,
    a row each (a NaN spreads along its row): NaN with two payloads,
    overflowing values, subnormal-making ones, +inf, -inf, all -0.0, and
    -0.0 beside +0.0; in the hulls, the gap between them and outside."""
    seqs = []
    for r in range(b):
        C, S = _waves(n, k, 300 + r)
        for p in range(k):
            lo, hi = LEFT if (p + r) % 2 == 0 else RIGHT
            C[:lo, p], S[:lo, p] = 1.0, 0.0
            C[hi:, p], S[hi:, p] = 1.0, 0.0
        seqs.append(RotationSequence(torch.from_numpy(C).to(dtype),
                                     torch.from_numpy(S).to(dtype)))
    sp = SPECIAL[name]
    rng = np.random.default_rng(17)
    A = rng.standard_normal((b, m, n)).astype(np.float32)
    A[:, 2, :] = sp["big"] * np.sign(A[:, 2, :])
    A[:, 3, :] = sp["tiny"] * np.sign(A[:, 3, :])
    A[:, 6, :] = -0.0
    A[:, 7, :] = np.where(np.arange(n) % 3 == 0, 0.0, -0.0)
    A = torch.from_numpy(A).to(dtype)
    bits = A.view(torch.int16)
    for col in (3, 10, 15, 22):               # in a hull, the gap, outside
        for row, nan in enumerate(sp["nans"]):
            bits[:, row, col] = nan - 0x10000 * (nan > 0x7FFF)
        A[:, 4, col] = float("inf")
        A[:, 5, col] = float("-inf")
    return seqs, A


@pytest.mark.parametrize("name", sorted(HALF))
@pytest.mark.parametrize("kb", [2, 4, 16])
def test_half_body_special_values(kb, name):
    """NaN with payloads, +-inf, -0.0, results that overflow the type and
    products that land in its subnormals, inside the hulls, in the gap
    between them (which the window loads and stores untouched) and
    outside: the emulation equals the plain version, and outside the
    hulls every input bit comes back."""
    half = HALF[name]
    seqs, A = _special_case(name, half.dtype)
    args = _packed(A, seqs)
    with np.errstate(all="ignore"):
        got = _emulate(*args, kb, half)
    want, _ = rotseq_batched_ref(*args)
    made = _assert_bits(got, want, args, half)
    g, a = bits(got), bits(args[0])
    for col in (*GAP, *OUTSIDE):
        assert np.array_equal(g[:, col], a[:, col]), col
    hull = np.r_[LEFT[0]:LEFT[1] + 1, RIGHT[0]:RIGHT[1] + 1]
    inner = bits(want)[:, hull]
    exp = inner & (0x7F80 if name == "bfloat16" else 0x7C00)
    mant = inner & (0x7F if name == "bfloat16" else 0x3FF)
    assert made[:, hull].any()                       # NaN from arithmetic
    assert ((exp == exp.max()) & (mant == 0)).any()  # inf from overflow
    assert ((exp == 0) & (mant != 0)).any()          # subnormal results
    assert (inner == 0x8000).any()                   # -0.0


def _torch_round(v, dtype):
    return bits(torch.from_numpy(np.ascontiguousarray(v, np.float32))
                 .to(dtype))


def _hold_pairs(v, half):
    """``p2`` over consecutive pairs of ``v`` against ``Tensor.to``, bit
    for bit (a NaN gives ``0x7FFF`` here, the card's, any NaN there), and
    ``w2`` widening the pair to the same values."""
    want = _torch_round(v, half.dtype)
    u = half.p2(v[0::2], v[1::2])
    lo, hi = lanes(u)
    got = np.empty_like(want)
    got[0::2], got[1::2] = lo, hi
    nan = np.isnan(v)
    assert np.array_equal(got[~nan], want[~nan])
    assert (got[nan] == CARD_NAN).all() and half.nan(want[nan]).all()
    wl, wh = half.w2(u)
    assert np.array_equal(half.n(wl), lo) and np.array_equal(half.n(wh), hi)


def test_bf16_pair_rounding_equals_torch():
    """Every bfloat16 upper half with the low halves ``0x0000``,
    ``0x7FFF``, ``0x8000`` (the tie), ``0x8001`` and ``0xFFFF``: exact,
    just below, on and above the midpoint, and just below the next
    value, across zeros, subnormals, normals, overflow, inf and NaN."""
    upper = np.arange(0x10000, dtype=U32) << U32(16)
    lows = np.array([0x0000, 0x7FFF, 0x8000, 0x8001, 0xFFFF], U32)
    v = (upper[:, None] | lows[None, :]).ravel().view(np.float32)
    _hold_pairs(v, BF16)


def test_f16_pair_rounding_equals_torch():
    """float16 across its normal, subnormal and overflow ranges: every
    float16 value widened, with the float32 bits below its last place at
    0, just below, on and above the midpoint, and just below the next
    value; a dense sweep of float32 values through the subnormal range
    and every subnormal midpoint; the edge of overflow (65504 .. 65536)
    and beyond."""
    h = np.arange(0x10000, dtype=np.uint16)
    h = h[~F16.nan(h)]
    widened = F16.f(h).view(U32)
    lows = np.array([0x0000, 0x0FFF, 0x1000, 0x1001, 0x1FFF], U32)
    finite = np.isfinite(F16.f(h))
    near = (widened[finite][:, None] + lows[None, :]).ravel()
    sub = np.arange(0x32800000, 0x38800000, 97, dtype=U32)
    mids = ((np.arange(1024) + 0.5) * 2.0 ** -24).astype(np.float32)
    mids = np.concatenate([mids, -mids, np.nextafter(mids, 0),
                           np.nextafter(mids, 1)])
    edge = np.array([65504, 65519, 65519.996, 65520, 65520.004, 65535,
                     65536, 1e5, 3.4e38, np.inf, -np.inf, np.nan, 0.0,
                     -0.0], np.float32)
    v = np.concatenate([near.view(np.float32), sub.view(np.float32), mids,
                        edge, -edge])
    if v.size % 2:
        v = v[:-1]
    _hold_pairs(v, F16)


@pytest.mark.parametrize("name", sorted(HALF))
def test_window_round_trip_keeps_every_bit(name):
    """``n(w(h)) == h`` for every bit pattern of the type, NaN payloads
    and -0.0 included, and ``w`` is exact where ``h`` is a number."""
    half = HALF[name]
    h = np.arange(0x10000, dtype=np.uint16)
    assert np.array_equal(half.n(half.w(h)), h)
    num = ~half.nan(h)
    want = torch.from_numpy(h.view(np.int16)).view(half.dtype).float()
    assert np.array_equal(half.w(h)[num].view(U32),
                          want.numpy()[num].view(U32))


def _values(half):
    """A structured set of half values: every 61st bit pattern, every
    third subnormal of each sign, and the edges (zeros, the least
    normal, the largest finite, one and its neighbour, inf, NaN)."""
    top = 0x7F7F if half is BF16 else 0x7BFF
    least = 0x0080 if half is BF16 else 0x0400
    one = 0x3F80 if half is BF16 else 0x3C00
    inf = 0x7F80 if half is BF16 else 0x7C00
    edges = np.array([0, least, least - 1, top, top - 1, one, one + 1,
                      one - 1, inf, inf | 0x41], np.uint16)
    v = np.concatenate([np.arange(0, 0x10000, 61),
                        np.arange(1, least, 3), edges]).astype(np.uint16)
    v = np.unique(np.concatenate([v, v | 0x8000]))
    return v if v.size % 2 == 0 else v[:-1]


@pytest.mark.parametrize("name", sorted(HALF))
@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_native_paired_ops_equal_eager_rounding(op, name):
    """A native paired op (``__hadd2``, ``__hsub2``, ``__hmul2``) rounds
    the exact result to the half type once; eager PyTorch rounds its
    float32 result.  They agree bit for bit over every pair of a
    structured set of half values (subnormals, overflow, ties, inf):
    float32 holds a half product exactly or, in bfloat16, below half the
    least subnormal, and its 24 bits are at least 2p + 2 for a sum.  A
    NaN gives ``0x7FFF`` here (the card's), any NaN there."""
    half = HALF[name]
    fn = {"add": np.add, "sub": np.subtract, "mul": np.multiply}[op]
    v = _values(half)
    a, b = np.repeat(v, v.size), np.tile(v, v.size)
    with np.errstate(all="ignore"):
        u = native(fn, pack(a[0::2], a[1::2]), pack(b[0::2], b[1::2]),
                   half)
    got = np.empty_like(a)
    got[0::2], got[1::2] = lanes(u)
    ta, tb = (torch.from_numpy(x.view(np.int16)).view(half.dtype)
              for x in (a, b))
    want = bits({"add": torch.add, "sub": torch.sub,
                  "mul": torch.mul}[op](ta, tb))
    nan = half.nan(want)
    assert np.array_equal(got[~nan], want[~nan])
    assert (got[nan] == CARD_NAN).all()
