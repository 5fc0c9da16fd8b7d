"""The half types' roundings as bit arithmetic, for the CPU walks of the
band kernels' half bodies.

``csrc/half_store.cuh`` holds ``Store<T>``, ``plane_pair`` and
``plane_pair_native`` for the two band kernels (``csrc/rotseq_batched.cu``, ``csrc/rotseq_wave.cu``); its
numpy counterparts live here, shared by ``tests/test_torch_half_batched.py``
and ``tests/test_torch_wave.py``: the packed conversions (to nearest even,
a NaN to the card's ``0x7FFF``), the window's widening and narrowing (every
bit kept), and the native paired ops as float64's exact result rounded
once.
"""
import numpy as np
import torch

CARD_NAN = 0x7FFF
U32 = np.uint32


def bits(x: torch.Tensor) -> np.ndarray:
    """A half tensor's bits as ``uint16``."""
    return x.contiguous().view(torch.int16).numpy().view(np.uint16)


def _f32_bits(v) -> np.ndarray:
    return np.ascontiguousarray(v, np.float32).view(U32).astype(np.int64)


def round_bf16(v) -> np.ndarray:
    """float32 -> bfloat16 bits, to nearest even, a NaN to ``0x7FFF``."""
    u = _f32_bits(v)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) & 0xFFFF
    nan = (u & 0x7FFFFFFF) > 0x7F800000
    return np.where(nan, CARD_NAN, r).astype(np.uint16)


def round_f16(v) -> np.ndarray:
    """float32 -> float16 bits, to nearest even, a NaN to ``0x7FFF``."""
    u = _f32_bits(v)
    sign = (u >> 16) & 0x8000
    a = u & 0x7FFFFFFF
    # a normal result: the exponent rebiased, 13 bits rounded off; past
    # the largest finite value (and for inf) it is inf
    h = (a - 0x38000000) >> 13
    rem = a & 0x1FFF
    h = h + ((rem > 0x1000) | ((rem == 0x1000) & (h & 1)))
    h = np.minimum(h, 0x7C00)
    # below 2^-14 a subnormal: the significand shifted down and rounded
    e = a >> 23
    sig = (a & 0x7FFFFF) | 0x800000
    sh = np.clip(126 - e, 1, 40)
    q = sig >> sh
    low = sig & ((np.int64(1) << sh) - 1)
    mid = np.int64(1) << (sh - 1)
    q = q + ((low > mid) | ((low == mid) & (q & 1)))
    h = np.where(a < 0x38800000, np.where(e == 0, 0, q), h)
    nan = a > 0x7F800000
    return np.where(nan, CARD_NAN, sign | h).astype(np.uint16)


def round_once(v, p, emin, top):
    """Exact float64 values rounded once to a binary format of ``p``
    significant bits, least normal exponent ``emin`` and largest finite
    value ``top``: to nearest even, past ``top`` to inf (float64 ops only,
    independent of the bit arithmetic above)."""
    v = np.asarray(v, np.float64)
    out = v.copy()
    fin = np.isfinite(v) & (v != 0)
    _, e = np.frexp(v[fin])
    q = np.maximum(e - 1, emin) - (p - 1)            # the last place
    r = np.ldexp(np.rint(np.ldexp(v[fin], -q)), q)
    out[fin] = np.where(np.abs(r) > top, np.copysign(np.inf, r), r)
    return out


def pack(lo, hi):
    return lo.astype(U32) | (hi.astype(U32) << U32(16))


def lanes(u):
    return ((u & U32(0xFFFF)).astype(np.uint16),
            (u >> U32(16)).astype(np.uint16))


class BF16:
    """``Store<__nv_bfloat16>``: widenings and narrowing are shifts."""
    dtype = torch.bfloat16
    P, EMIN, TOP = 8, -126, 3.3895313892515355e38
    ONE = 0x3F80                       # the bits of 1 (-1: | 0x8000)

    @staticmethod
    def f(bits):
        return (bits.astype(U32) << U32(16)).view(np.float32)

    w = f

    @staticmethod
    def n(v):
        return (np.asarray(v, np.float32).view(U32) >> U32(16)).astype(
            np.uint16)

    @staticmethod
    def nan(bits):
        return (bits & 0x7FFF) > 0x7F80

    @staticmethod
    def p2(a, b):
        """``cvt.rn.bf16x2.f32``: ``a`` to the low half, ``b`` high."""
        return pack(round_bf16(a), round_bf16(b))

    @staticmethod
    def w2(u):
        """The low half shifted up, the high half masked."""
        return ((u << U32(16)).view(np.float32),
                (u & U32(0xFFFF0000)).view(np.float32))

    @staticmethod
    def encode(v):
        return (np.asarray(v, np.float32).view(U32) >> U32(16)).astype(
            np.uint16)

    @staticmethod
    def pair(a, b):
        """Two T-exact float32 values paired: their upper halves (a byte
        permute)."""
        return pack(BF16.n(a), BF16.n(b))


class F16:
    """``Store<__half>``: ``w``/``n`` keep a NaN's sign and payload."""
    dtype = torch.float16
    P, EMIN, TOP = 11, -14, 65504.0
    ONE = 0x3C00

    @staticmethod
    def f(bits):
        return bits.view(np.float16).astype(np.float32)

    @staticmethod
    def w(bits):
        h = bits.astype(U32)
        nan = ((h & U32(0x7FFF)) > U32(0x7C00))
        kept = (((h & U32(0x8000)) << U32(16)) | U32(0x7F800000)
                | ((h & U32(0x3FF)) << U32(13)))
        return np.where(nan, kept, F16.f(bits).view(U32)).astype(
            U32).view(np.float32)

    @staticmethod
    def n(v):
        u = np.asarray(v, np.float32).view(U32)
        nan = (u & U32(0x7FFFFFFF)) > U32(0x7F800000)
        kept = (((u >> U32(16)) & U32(0x8000)) | U32(0x7C00)
                | ((u >> U32(13)) & U32(0x3FF)))
        return np.where(nan, kept, round_f16(v)).astype(np.uint16)

    @staticmethod
    def nan(bits):
        return (bits & 0x7FFF) > 0x7C00

    @staticmethod
    def p2(a, b):
        """``cvt.rn.f16x2.f32``: ``a`` to the low half, ``b`` high."""
        return pack(round_f16(a), round_f16(b))

    @staticmethod
    def w2(u):
        """``__half22float2``: both halves widened."""
        lo, hi = lanes(u)
        return F16.f(lo), F16.f(hi)

    @staticmethod
    def encode(v):
        return np.asarray(v, np.float64).astype(np.float16).view(np.uint16)

    @staticmethod
    def pair(a, b):
        """Two T-exact float32 values paired by ``cvt.rn.f16x2.f32``
        (exact; a NaN to ``0x7FFF``)."""
        return F16.p2(a, b)


def native(op, a, b, half):
    """A native paired op on two packed pairs (``__hadd2``: ``np.add``,
    ``__hsub2``, ``__hmul2``): each lane's exact result (float64 holds a
    sum, difference or product of two half values exactly) rounded to
    the half type once, a NaN to ``0x7FFF``."""
    out = []
    for la, lb in zip(lanes(a), lanes(b)):
        v = op(half.f(la).astype(np.float64), half.f(lb).astype(np.float64))
        bits = half.encode(round_once(v, half.P, half.EMIN, half.TOP))
        out.append(np.where(np.isnan(v), CARD_NAN, bits).astype(np.uint16))
    return pack(*out)


HALF = {"bfloat16": BF16, "float16": F16}

# per type: NaN payloads no platform's arithmetic makes, a value whose
# plane results overflow the type, one whose products are subnormal
SPECIAL = {
    "bfloat16": dict(nans=(0x7FC1, 0xFFA5), big=3.0e38, tiny=3.0e-39),
    "float16": dict(nans=(0x7E01, 0xFD55), big=6.0e4, tiny=3.0e-5),
}


def plane_pair(q0, q1, x0, y0, x1, y1, half):
    """``half_store.cuh::plane_pair`` over arrays of rows: planes ``q0 =
    (c0, s0, g0)`` on ``(x0, y0)`` and ``q1`` on ``(x1, y1)``, ``c``/``s``
    float32 (widened), ``g`` its raw bits, every ``x``, ``y`` half-exact
    float32.  The four products in float32, each pair rounded by one
    packed conversion ``p2``; the sum, the difference and g's product by
    one :func:`native` paired op each; the two results widened by ``w2``.
    Returns ``(xn, yn)``, each ``(plane 0, plane 1)``."""
    (c0, s0, g0), (c1, s1, g1) = q0, q1
    cx = half.p2(c0 * x0, c1 * x1)
    sy = half.p2(s0 * y0, s1 * y1)
    sx = half.p2(s0 * x0, s1 * x1)
    cy = half.p2(c0 * y0, c1 * y1)
    g = pack(np.full(x0.shape, g0, np.uint16),
              np.full(x0.shape, g1, np.uint16))
    xn = half.w2(native(np.add, cx, sy, half))
    d = native(np.subtract, sx, cy, half)
    yn = half.w2(native(np.multiply, g, d, half))
    return xn, yn


def plane_pair_native(q0, q1, x0, y0, x1, y1, half):
    """``half_store.cuh::plane_pair_native``: :func:`plane_pair` with
    ``c``/``s`` staged as raw bits like ``g`` and every product one
    :func:`native` paired multiply of the raw ``c`` or ``s`` pair and the
    window values paired by ``half.pair``."""
    (c0, s0, g0), (c1, s1, g1) = q0, q1

    def raw(a, b):
        return pack(np.full(x0.shape, a, np.uint16),
                    np.full(x0.shape, b, np.uint16))

    c, s, g = raw(c0, c1), raw(s0, s1), raw(g0, g1)
    x, y = half.pair(x0, x1), half.pair(y0, y1)
    cx = native(np.multiply, c, x, half)
    sy = native(np.multiply, s, y, half)
    sx = native(np.multiply, s, x, half)
    cy = native(np.multiply, c, y, half)
    xn = half.w2(native(np.add, cx, sy, half))
    d = native(np.subtract, sx, cy, half)
    yn = half.w2(native(np.multiply, g, d, half))
    return xn, yn
