"""The wavefront kernel's band pipeline, walked on the CPU.

``csrc/rotseq_wave.cu`` runs the bands of one group of rows on several
warps at once, each a fixed lag behind the one before, handing columns
on through rings in shared memory.  No CUDA code runs here, so
:func:`_emulate_pipeline` walks the same schedule in numpy float32
(iterations, barriers, chunks, window slots, staging slots, rings and
passes) and the tests hold its result bit for bit to the plain version,
the blocked sweep at the kernel's ``k_b``.  Every ring slot carries the
(band, column) it holds and the iteration that wrote it, so a read that
comes before its write, or after the slot was written again, fails; the
staged panels likewise carry their chunk and when they were written.

In bfloat16 and float16 the walk follows the kernel's half body
(``csrc/half_store.cuh``): the rings hold the half type's bits, the
register window float32 values that are exact in it (a column widened
by ``w`` as it comes in, narrowed by ``n`` as it is handed on or
stored), planes ``i`` and ``i + 1`` of a step rounded together, every
product too as a native paired op (``plane_pair_native``: float64's
exact result rounded once, a NaN to the card's ``0x7FFF``; float16's
window values paired by a packed conversion as bit arithmetic), and the
panel values written to their slot, as raw bits, after the chunk's
planes (``tests/_torch_half_bits.py``).  Every column is
touched by a plane, so a NaN of the plain version is one its arithmetic
made, with the host's bits (``tests/test_torch_half_batched.py``): there
the walk must give ``0x7FFF``, and everywhere else every bit must equal
the plain version's.  On the card the kernel is held to its plain
version with every bit (``tests/test_torch_half_card.py``).
"""
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.core.rotations import plane_update
from repro_torch.kernels import _build, limits
from repro_torch.kernels.rotseq import kernel as wave_k
from repro_torch.kernels.rotseq.ops import rot_sequence_wave
from repro_torch.kernels.rotseq.ref import rotseq_wave_ref

from _torch_half_bits import (CARD_NAN, HALF, SPECIAL, bits, native,
                              pack, plane_pair, plane_pair_native,
                              round_once)

CU = (pathlib.Path(limits.__file__).parents[1] / "csrc"
      / "rotseq_wave.cu").read_text()


def _shape(kb):
    """``(W, CS, L)``: the window, steps a chunk and the lag in chunks,
    as the kernel derives them from its band ``kb``."""
    W = 2 * kb
    CS = min(W, 128 // kb)
    return W, CS, -(-(W - 1) // CS) + 1


class RingError(AssertionError):
    """A ring or staging slot did not hold what its reader expects."""


def _emulate_pipeline(AT, Cw, Sw, Gw, kb, warps, lag=None, ring=32,
                      half=None, pair=plane_pair_native):
    """``rotseq_wave_kernel<kb, warps>`` over all rows at once.

    One pass a group of ``warps`` bands; in the pass's iteration ``s``
    warp ``w`` runs its chunk ``s - lag * w`` after staging the next
    one's plane values (and, warp 0, its columns) in phase A; a barrier
    separates phase A from phase B and one iteration from the next, so
    ring writes of phase B become visible at the end of the iteration.

    ``half`` (``BF16``, ``F16``): the half body on bit arrays (``uint16``
    operand and panels, the result likewise); the panel values land in
    their slot, as raw bits, after phase B (``put``), planes go in pairs
    by ``pair``.
    Warp 0's columns land in phase A either way (cp.async, or plain
    loads where the operand's columns are not 16-byte aligned).
    """
    n, m = AT.shape
    K, J = Cw.shape
    W, CS, L = _shape(kb)
    L = L if lag is None else lag
    R = ring
    bands = -(-K // kb)
    NC = -(-(n + W - 2) // CS)
    zero = np.zeros(m, np.float32)
    if half is None:
        widen = narrow = (lambda v: v)
        out = np.full_like(AT, np.nan)
    else:
        widen, narrow = half.w, half.n
        out = np.full_like(AT, 0x7BCD)      # a column left unwritten shows
    written = np.full(n, -1)                  # the pass that wrote a column

    def plane(i, p, j):
        """A plane's staged {c, s, g}; the identity outside the grid."""
        inside = p < K and 0 <= j < J
        if half is None:
            return ((Cw[p, j], Sw[p, j], Gw[p, j]) if inside else
                    (np.float32(1), np.float32(0),
                     np.float32(1 if j < -i else -1)))
        if inside:
            return Cw[p, j], Sw[p, j], Gw[p, j]
        return (np.uint16(half.ONE), np.uint16(0),
                np.uint16(half.ONE | (0 if j < -i else 0x8000)))

    for pss, q0 in enumerate(range(0, bands, warps)):
        last = min(warps, bands - q0) - 1
        frm = AT if pss == 0 else out
        rings = [[None] * R for _ in range(warps)]
        panels = [[None] * 3 for _ in range(warps)]
        wins = [None] * warps

        def take(w, col, band, s):
            slot = rings[w][col % R]
            want = (("mem", pss) if w == 0 else ("band", band - 1), col)
            if slot is None or slot[:2] != want or slot[2] >= s:
                raise RingError(f"warp {w} at iteration {s} wants column "
                                f"{col} of {want[0]}, slot holds {slot}")
            return widen(slot[3])

        for s in range(-1, NC + L * last):
            # phase A: stage chunk kw + 1
            puts = []
            for w in range(last + 1):
                kn = s - L * w + 1
                if not 0 <= kn < NC:
                    continue
                tc, band = kn * CS, q0 + w
                vals = {(i, u): plane(i, band * kb + i, tc + u - 2 * i)
                        for i in range(kb) for u in range(CS)}
                if half is None:
                    panels[w][kn % 3] = (kn, s - 0.5, vals)
                else:
                    puts.append((w, kn, vals))
                if w == 0:
                    for col in range(0 if kn == 0 else tc + 1,
                                     min(tc + CS, n - 1) + 1):
                        if written[col] != pss - 1:
                            raise RingError(f"pass {pss} reads column {col} "
                                            f"of pass {written[col]}")
                        # phase A precedes phase B of the same iteration
                        rings[0][col % R] = (("mem", pss), col, s - 0.5,
                                             frm[col].copy())
            # barrier; phase B: run chunk kw
            pending = []
            for w in range(last + 1):
                kw = s - L * w
                if not 0 <= kw < NC:
                    continue
                tc, band = kw * CS, q0 + w
                tag, at, vals = panels[w][kw % 3]
                if tag != kw or at >= s:
                    raise RingError(f"warp {w} at iteration {s} wants the "
                                    f"panel of chunk {kw}, slot holds chunk "
                                    f"{tag} of iteration {at}")
                if kw == 0:
                    wins[w] = [zero] * W
                    wins[w][0] = take(w, 0, band, s)
                win = wins[w]
                for u in range(CS):
                    t = tc + u
                    win[(u + 1) % W] = (take(w, t + 1, band, s) if t + 1 < n
                                        else zero)
                    if half is None:
                        for i in range(kb):
                            xi, yi = (u - 2 * i) % W, (u - 2 * i + 1) % W
                            win[xi], win[yi] = plane_update(win[xi], win[yi],
                                                            *vals[i, u])
                    else:
                        for i in range(0, kb, 2):
                            ix0, iy0 = (u - 2 * i) % W, (u - 2 * i + 1) % W
                            ix1, iy1 = (u - 2 * i - 2) % W, (u - 2 * i - 1) % W
                            xn, yn = pair(vals[i, u], vals[i + 1, u],
                                          win[ix0], win[iy0], win[ix1],
                                          win[iy1], half)
                            win[ix0], win[iy0] = xn[0], yn[0]
                            win[ix1], win[iy1] = xn[1], yn[1]
                    co = t - W + 2
                    if w == last and 0 <= co < n:
                        out[co] = narrow(win[(u + 2) % W])
                        written[co] = pss
                    elif w < last and co >= 0:
                        pending.append((w + 1, co, band,
                                        narrow(win[(u + 2) % W])))
                wins[w] = [win[(q + CS) % W] for q in range(W)]
            for w1, co, band, f in pending:
                rings[w1][co % R] = (("band", band), co, s, f)
            # half precision: put, after the chunk's planes
            for w, kn, vals in puts:
                panels[w][kn % 3] = (kn, s, vals)
    assert (written == (bands - 1) // warps).all()
    return out


def _case(m, n, k, seed, signs=False, zeros=False):
    """Packed ``(AT, Cw, Sw, Gw)``.  ``zeros``: a target of signed zeros
    under planes with ``c = 1, s = 0`` and random signs, so that the
    result's bits depend on every plane's zero signs, the pad planes'
    at the edges included (random waves would wash them out)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)).astype(np.float32)
    th = rng.uniform(0.0, 2.0 * np.pi, (n - 1, k))
    C, S = np.cos(th).astype(np.float32), np.sin(th).astype(np.float32)
    G = (np.where(rng.random((n - 1, k)) < 0.5, 1.0, -1.0) if signs
         else -np.ones((n - 1, k))).astype(np.float32)
    if zeros:
        A = np.where(rng.random((m, n)) < 0.5, 0.0, -0.0).astype(np.float32)
        C, S = np.ones_like(C), np.zeros_like(S)
    return (np.ascontiguousarray(A.T), *(np.ascontiguousarray(x.T)
                                          for x in (C, S, G)))


def _plain(args, kb):
    return rotseq_wave_ref(*(torch.from_numpy(x) for x in args),
                           k_b=kb).numpy()


@pytest.mark.parametrize("kb", [4, 16])
@pytest.mark.parametrize("warps", [1, 2, 4, 12])
@pytest.mark.parametrize("m,n,k,signs,zeros", [(5, 12, 37, False, False),
                                               (7, 45, 37, True, False),
                                               (6, 12, 5, True, True)])
def test_pipeline_emulation_equals_plain_version(m, n, k, signs, zeros, kb,
                                                 warps):
    """1, 2, 4 and 12 (the kernel's) warps a row group; 37 waves, so the last band is
    padded with identity waves and the last pass may leave warps idle
    (5 waves, too, on the signed zeros);
    ``n = 12`` is shorter than the pipeline's depth ``L * CS`` (40 steps
    at ``kb = 16``, 16 at ``kb = 4``); a target of signed zeros keeps the
    bits the blocked sweep gives it, so the planes outside the grid act
    as the blocked sweep's pad planes do."""
    W, CS, L = _shape(kb)
    if n == 12:
        assert n < L * CS
    assert k % kb != 0
    args = _case(m, n, k, 100 * m + k, signs, zeros)
    got = _emulate_pipeline(*args, kb, warps)
    want = _plain(args, kb)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("kb", [4, 16])
def test_pipeline_emulation_fails_with_a_lag_one_chunk_short(kb):
    """The lag is the least that works: one chunk less and a warp takes a
    column in at the iteration that hands it on (before the barrier that
    would publish it), which the ring's tags catch."""
    args = _case(6, 45, 37, 9)
    _, _, L = _shape(kb)
    _emulate_pipeline(*args, kb, 4, lag=L)
    with pytest.raises(RingError, match="wants column"):
        _emulate_pipeline(*args, kb, 4, lag=L - 1)


def test_pipeline_emulation_fails_with_a_short_ring():
    """Half the kernel's ring lets warp 0's staging and the hand-offs
    overwrite columns before they are taken in."""
    args = _case(6, 45, 20, 10)
    with pytest.raises(RingError, match="wants column"):
        _emulate_pipeline(*args, 16, 2, ring=16)


def test_source_constants_match_limits():
    """The compiled band, warps a block and ring are the ones the
    wrapper, the registry and this emulation assume, and the budget in
    ``limits`` is what the launcher asks for."""
    for line in (f"constexpr int kBand = {limits.WAVE_KB};",
                 f"constexpr int kWarps = {limits.WAVE_WARPS};",
                 "constexpr int kRing = 32;"):
        assert line in CU, line
    assert limits.WAVE_ROWS == limits.WARP
    # the launcher's kWarps * (3 * kBand * CS * 16 + kRing * 32 * 4)
    assert limits.wave_smem_bytes() == limits.WAVE_WARPS * (
        3 * limits.WAVE_KB * 8 * 16 + 32 * 32 * 4)


def test_both_band_kernels_share_one_store():
    """``Store<T>`` and the half plane pair live in one header, which the
    wavefront and fused kernels include; neither defines its own."""
    csrc = pathlib.Path(limits.__file__).parents[1] / "csrc"
    header = (csrc / "half_store.cuh").read_text()
    assert "struct Store" in header and "void plane_pair" in header
    for name in ("rotseq_wave.cu", "rotseq_batched.cu"):
        text = (csrc / name).read_text()
        assert '#include "half_store.cuh"' in text, name
        assert "struct Store" not in text and "St::p2(" not in text, name


def test_an_edit_to_a_header_renames_the_library(tmp_path, monkeypatch):
    """``nvcc`` compiles the ``*.cu`` files only, but the library's name
    hashes the ``*.cuh`` headers too: an edited header is a new library
    (an unchanged tree the same one), never a stale one reused."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build._sources() == [tmp_path / "k.cu"]
    before = _build._target()
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build._target() != before
    (tmp_path / "h.cuh").write_text("// one\n")
    assert _build._target() == before


def test_one_call_applies_every_band_on_the_cpu():
    """``rot_sequence_wave`` transposes once and calls the wrapper once
    for all bands; on the CPU that runs the plain version (no launch),
    at any ``k_b`` and ``n_b``, equal to the blocked sweep."""
    AT, Cw, Sw, Gw = (torch.from_numpy(x) for x in _case(6, 30, 20, 11,
                                                         signs=True))
    A, C, S, G = AT.t(), Cw.t(), Sw.t(), Gw.t()
    before = wave_k.LAUNCHES
    for k_b, n_b in ((16, None), (4, 8), (8, 64)):
        out = rot_sequence_wave(A, C, S, k_b=k_b, n_b=n_b, G=G)
        want = rotseq_wave_ref(AT, Cw, Sw, Gw, k_b=k_b).t()
        assert torch.equal(out, want)
    assert wave_k.LAUNCHES == before


# --------------------------------------------------------------------------
# the half body (bfloat16, float16)
# --------------------------------------------------------------------------

def _to_half(args, half):
    """``_case``'s float32 arrays rounded to the half type, as bits."""
    return tuple(bits(torch.from_numpy(x).to(half.dtype)) for x in args)


def _plain_half(hargs, kb, half):
    return bits(rotseq_wave_ref(
        *(torch.from_numpy(x.view(np.int16)).view(half.dtype)
          for x in hargs), k_b=kb))


def _assert_half_bits(got, want, half):
    """Every bit equal, but at a NaN of the plain version (every column
    is touched by a plane, so it is one that arithmetic made, with the
    host's bits): there the walk gives the card's ``0x7FFF``.  Returns
    where that was."""
    made = half.nan(want)
    assert np.array_equal(got[~made], want[~made]), (
        np.argwhere((got != want) & ~made)[:5])
    assert (got[made] == CARD_NAN).all()
    return made


@pytest.mark.parametrize("name", sorted(HALF))
@pytest.mark.parametrize("kb", [4, 16])
@pytest.mark.parametrize("warps", [1, 2, 4, 12])
@pytest.mark.parametrize("m,n,k,signs,zeros", [(5, 12, 37, False, False),
                                               (7, 45, 37, True, False),
                                               (6, 12, 5, True, True)])
def test_half_pipeline_emulation_equals_plain_version(m, n, k, signs, zeros,
                                                      kb, warps, name):
    """The half body on the float32 cases: signs, signed zeros under the
    pad planes, a padded last band, ``n`` shorter than the pipeline's
    depth, idle warps in the last pass; bit for bit."""
    half = HALF[name]
    hargs = _to_half(_case(m, n, k, 100 * m + k, signs, zeros), half)
    got = _emulate_pipeline(*hargs, kb, warps, half=half)
    made = _assert_half_bits(got, _plain_half(hargs, kb, half), half)
    assert not made.any()


def _special_case(name, half, m=8, n=24, k=7, seed=21):
    """Random signed waves over targets with, a row each (a NaN spreads
    along its row): NaN with two payloads, overflowing values, subnormal-
    making ones, +inf, -inf at a few columns, all -0.0, and -0.0 beside
    +0.0.  The overflow: the first wave's plane 11 takes two big values
    (plane 10 the identity) at ``c = s = sqrt(1/2)``, so its sum is an
    inf (which the planes after it, padded ones too, may turn into NaN:
    ``0 * inf``)."""
    AT, Cw, Sw, Gw = _case(m, n, k, seed, signs=True)
    Cw[0, 10], Sw[0, 10] = 1.0, 0.0
    Cw[0, 11] = Sw[0, 11] = np.sqrt(0.5)
    A = AT.T.copy()
    sp = SPECIAL[name]
    A[2, 11:13] = sp["big"]
    A[3] = sp["tiny"] * np.sign(A[3])
    A[6] = -0.0
    A[7] = np.where(np.arange(n) % 3 == 0, 0.0, -0.0)
    cols = [3, 10, 22]
    A[4, cols] = np.inf
    A[5, cols] = -np.inf
    hA, hC, hS, hG = _to_half((np.ascontiguousarray(A), Cw, Sw, Gw), half)
    for row, nan in enumerate(sp["nans"]):
        hA[row, cols] = nan
    return np.ascontiguousarray(hA.T), hC, hS, hG


@pytest.mark.parametrize("name", sorted(HALF))
@pytest.mark.parametrize("kb,warps,k", [(4, 1, 7), (4, 2, 7), (16, 12, 7),
                                        (4, 1, 1), (16, 2, 1)])
def test_half_pipeline_special_values(kb, warps, k, name):
    """NaN with payloads, +-inf, -0.0, results that overflow the type and
    products that land in its subnormals: the walk equals the plain
    version, and the plain version holds each kind of value (-0.0 after
    one wave: more wash it out); at ``kb = 4`` on one warp in two
    passes."""
    half = HALF[name]
    hargs = _special_case(name, half, k=k)
    with np.errstate(all="ignore"):
        got = _emulate_pipeline(*hargs, kb, warps, half=half)
    want = _plain_half(hargs, kb, half)
    made = _assert_half_bits(got, want, half)
    exp = want & (0x7F80 if name == "bfloat16" else 0x7C00)
    mant = want & (0x7F if name == "bfloat16" else 0x3FF)
    kinds = {"nan": made.any(), "subnormal": ((exp == 0) & (mant != 0)).any(),
             "-0.0": (want == 0x8000).any(),
             # an inf, or the NaN a later plane's 0 * inf makes of it
             "overflow": (((exp == exp.max()) & (mant == 0)) | made)[:, 2]
             .any()}
    expected = {"nan", "subnormal", "overflow"} | ({"-0.0"} if k == 1
                                                   else set())
    assert {kind for kind, seen in kinds.items() if seen} >= expected


def _structured(half, seed):
    """Half bit patterns: every 37th, every third subnormal of each sign,
    and the edges (zeros, the least normal, the largest finite, one,
    inf, NaN with a payload), shuffled."""
    top = 0x7F7F if half.dtype == torch.bfloat16 else 0x7BFF
    least = 0x0080 if half.dtype == torch.bfloat16 else 0x0400
    inf = 0x7F80 if half.dtype == torch.bfloat16 else 0x7C00
    v = np.concatenate([np.arange(0, 0x10000, 37), np.arange(1, least, 3),
                        [0, least, top, top - 1, half.ONE, half.ONE + 1, inf,
                         inf | 0x41]]).astype(np.uint16)
    v = np.concatenate([v, v | 0x8000])
    return np.random.default_rng(seed).permutation(v)


@pytest.mark.parametrize("name", sorted(HALF))
def test_both_plane_pair_spellings_agree(name):
    """``plane_pair_native`` (every product a native paired op of two
    half values, the wavefront kernel's) gives ``plane_pair``'s results
    (float32 products rounded by packed conversions, the fused
    kernel's) bit for bit, over a structured set of window values
    (subnormals, overflow, ties, inf, NaN with payloads) under rotations,
    the identity, reflectors and signs of magnitude other than 1."""
    half = HALF[name]
    x0, y0, x1, y1 = (half.w(_structured(half, seed)) for seed in range(4))
    th = np.random.default_rng(5).uniform(0, 2 * np.pi, 6)
    cs = [(np.cos(a), np.sin(a)) for a in th] + [(1.0, 0.0), (0.0, -1.0)]
    gs = [-1.0, 1.0, 0.75, -3.0]
    for k, (c, s) in enumerate(cs):
        c0, s0, c1, s1 = (bits(torch.tensor([v]).to(half.dtype))[0]
                          for v in (c, s, cs[k - 1][1], cs[k - 1][0]))
        g0, g1 = (bits(torch.tensor([v]).to(half.dtype))[0]
                  for v in (gs[k % 4], gs[(k + 1) % 4]))
        widen = (lambda b: half.f(np.array([b], np.uint16))[0])
        with np.errstate(all="ignore"):
            want = plane_pair((widen(c0), widen(s0), g0),
                              (widen(c1), widen(s1), g1), x0, y0, x1, y1,
                              half)
            got = plane_pair_native((c0, s0, g0), (c1, s1, g1), x0, y0,
                                    x1, y1, half)
        for a, b in zip(got, want):
            for u, v in zip(a, b):
                assert np.array_equal(half.n(u), half.n(v))


def _product_unrounded(q0, q1, x0, y0, x1, y1, half):
    """``plane_pair_native`` with plane 0's ``c*x`` left unrounded: its
    sum rounds the exact product plus the rounded ``s*y`` once."""
    xn, yn = plane_pair_native(q0, q1, x0, y0, x1, y1, half)
    (c0, s0, _), (c1, s1, _) = q0, q1
    raw = pack(np.full(x0.shape, s0, np.uint16),
               np.full(x0.shape, s1, np.uint16))
    sy = half.w2(native(np.multiply, raw, half.pair(y0, y1), half))[0]
    c = half.f(np.array([c0], np.uint16))[0]
    exact = c.astype(np.float64) * x0 + sy
    x0n = half.w(half.encode(round_once(exact, half.P, half.EMIN, half.TOP)))
    return (x0n, xn[1]), yn


@pytest.mark.parametrize("name", sorted(HALF))
def test_half_emulation_fails_without_a_products_rounding(name):
    """The walk has teeth: with one product of a plane pair not rounded
    to the half type, the result is no longer the plain version's."""
    half = HALF[name]
    hargs = _to_half(_case(7, 45, 37, 737, signs=True), half)
    want = _plain_half(hargs, 16, half)
    got = _emulate_pipeline(*hargs, 16, 4, half=half,
                            pair=_product_unrounded)
    assert not np.array_equal(got, want)
