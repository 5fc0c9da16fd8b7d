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
import re

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
    """A ring or staging slot did not hold what its reader expects, or
    was written while a reader might still read it (no barrier between
    the read and the write)."""


def _emulate_pipeline(AT, Cw, Sw, Gw, kb, warps, lag=None, ring=32,
                      half=None, pair=plane_pair_native, slots=3):
    """``rotseq_wave_kernel<kb, warps>`` over all rows at once.

    One pass a group of ``warps`` bands; in the pass's iteration ``s``
    warp ``w`` runs its chunk ``s - lag * w`` after staging the next
    one's plane values (and, warp 0, its columns) in phase A, into one of
    ``slots`` panel slots; a barrier separates phase A from phase B and
    one iteration from the next, so ring writes of phase B become
    visible at the end of the iteration.  A write to a ring or panel slot
    must come a barrier after the slot's last read: in phase A two
    iterations after it (phase A of ``s`` and phase B of ``s - 1`` have
    no barrier between them), in phase B or after it one iteration
    after.  ``ring``: the columns of a warp's input ring.

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
    NS = slots
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
        panels = [[None] * NS for _ in range(warps)]
        wins = [None] * warps
        # the iteration of each slot's last read (phase B)
        ring_read = [[-10 ** 9] * R for _ in range(warps)]
        panel_read = [[-10 ** 9] * NS for _ in range(warps)]

        def write(reads, w, slot, s, phase_a):
            if reads[w][slot] > s - (2 if phase_a else 1):
                raise RingError(f"warp {w}'s slot {slot}, read at iteration "
                                f"{reads[w][slot]}, written at iteration {s} "
                                f"with no barrier between")

        def take(w, col, band, s):
            slot = rings[w][col % R]
            want = (("mem", pss) if w == 0 else ("band", band - 1), col)
            if slot is None or slot[:2] != want or slot[2] >= s:
                raise RingError(f"warp {w} at iteration {s} wants column "
                                f"{col} of {want[0]}, slot holds {slot}")
            ring_read[w][col % R] = s
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
                    write(panel_read, w, kn % NS, s, True)
                    panels[w][kn % NS] = (kn, s - 0.5, vals)
                else:
                    puts.append((w, kn, vals))
                if w == 0:
                    for col in range(0 if kn == 0 else tc + 1,
                                     min(tc + CS, n - 1) + 1):
                        if written[col] != pss - 1:
                            raise RingError(f"pass {pss} reads column {col} "
                                            f"of pass {written[col]}")
                        # phase A precedes phase B of the same iteration
                        write(ring_read, 0, col % R, s, True)
                        rings[0][col % R] = (("mem", pss), col, s - 0.5,
                                             frm[col].copy())
            # barrier; phase B: run chunk kw
            pending = []
            for w in range(last + 1):
                kw = s - L * w
                if not 0 <= kw < NC:
                    continue
                tc, band = kw * CS, q0 + w
                tag, at, vals = panels[w][kw % NS]
                panel_read[w][kw % NS] = s
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
                write(ring_read, w1, co % R, s, False)
                rings[w1][co % R] = (("band", band), co, s, f)
            # half precision: put, after the chunk's planes
            for w, kn, vals in puts:
                write(panel_read, w, kn % NS, s, False)
                panels[w][kn % NS] = (kn, s, vals)
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


def _small_const(name):
    """A ``constexpr int`` of the small band's kernel, read from the
    source."""
    m = re.search(rf"^constexpr int {name} = (\d+);", CU, re.M)
    return int(m.group(1))


def _emulate_lanes(AT, Cw, Sw, Gw, lag=None, slots=2, half=None,
                   pair=plane_pair_native):
    """``rotseq_wave_small_kernel`` over all rows at once.

    Every warp runs the same schedule on its ``R`` rows (the rows padded
    to a multiple of ``R``; a padded row stages +0 and never stores), so
    each lane ``(r, b)`` is walked as band ``b``'s vector over all rows.
    At the warp's step ``s`` lane ``b`` is at its step ``t = s - 1 - lag
    * b`` (the kernel's lag is ``W``): it takes column ``t + 1`` in (band
    0 from the column ring, every other band the value handed on at the
    step before, through ``h``), applies its ``KB`` planes at the window
    slots the kernel names by ``s`` alone, and hands column ``t - W + 2``
    on (the pass's last band stores it).  In chunks the kernel runs as
    steady (no lane outside its band) nothing is masked, so a wrong
    steady rule shows.  Every window slot, the hand-off and every staged
    plane carries what it holds (band and column, or chunk, wave and
    plane), and each read checks it: a take-in of the wrong column
    raises :class:`RingError` ("wants column").  A chunk's plane values,
    loaded into registers while the chunk before it runs, land after it
    in one of ``slots`` slots at the kernel's entry ``[step][wave i][band
    ^ 2i]``; a store must come a ``__syncwarp`` (one a chunk, at its
    start) after the slot's last read, and a read after the store.
    Before its first step a lane's window must hold +0 only.

    ``half`` (``BF16``, ``F16``): the half body on bit arrays, planes in
    pairs by ``pair`` (``plane_pair_native``); the window is float32, the
    column handed on too, narrowed where it is stored.
    """
    n, m = AT.shape
    K, J = Cw.shape
    KB = limits.WAVE_SMALL_KB
    R, NB = limits.WAVE_SMALL_ROWS, limits.WAVE_SMALL_BANDS
    W = 2 * KB
    CS = _small_const("kSmallChunk")
    WP = NB * KB
    lag = W if lag is None else lag
    mp = -(-m // R) * R
    live = np.arange(mp) < m
    bands = -(-K // KB)
    if half is None:
        widen = narrow = (lambda v: v)
        out = np.full((n, mp), np.nan, np.float32)
        src = np.zeros((n, mp), np.float32)
        zero_t = np.float32(0)
    else:
        widen, narrow = half.w, half.n
        out = np.full((n, mp), 0x7BCD, np.uint16)
        src = np.zeros((n, mp), np.uint16)
        zero_t = np.uint16(0)
    src[:, :m] = AT
    zero = np.zeros(mp, np.float32)
    written = np.full(n, -1)

    def plane(i, p, j):
        """A staged plane {c, s, g}; the identity outside the grid."""
        if p < K and 0 <= j < J:
            return Cw[p, j], Sw[p, j], Gw[p, j]
        if half is None:
            return (np.float32(1), np.float32(0),
                    np.float32(1 if j < -i else -1))
        return (np.uint16(half.ONE), np.uint16(0),
                np.uint16(half.ONE | (0 if j < -i else 0x8000)))

    for pss, q0 in enumerate(range(0, bands, NB)):
        last = min(NB, bands - q0) - 1
        frm = src if pss == 0 else out
        S = n + W - 1 + W * last
        NC = -(-S // CS)
        pring = [None] * slots
        cring = [None] * slots
        read_at = [-10 ** 9] * slots         # the chunk of a slot's last read
        win = [[zero] * W for _ in range(NB)]
        tags = [[None] * W for _ in range(NB)]
        h = [(None, zero)] * NB               # (band, column), value

        def fetch(kn):
            """Chunk ``kn``'s plane values (lane ``wv`` loads wave ``wv``
            at every step) and band 0's columns, as loaded."""
            s0 = kn * CS
            planes = {}
            # the kernel loads without a test a plane where every wave of
            # the pass is in the grid and s0 >= 2 * 32 - 1, s0 + CS <= n
            fast = (q0 * KB + WP <= K and s0 >= 2 * WP - 1
                    and s0 + CS <= n)
            for wv in range(WP):
                for u in range(CS):
                    # the kernel's s0 + u - 1 - 2 wv at its lag W
                    j = s0 + u - 1 - lag * (wv // KB) - 2 * (wv % KB)
                    assert not fast or (q0 * KB + wv < K and 0 <= j < J)
                    planes[u, wv % KB, wv // KB ^ 2 * (wv % KB)] = (
                        (kn, wv, j), plane(wv % KB, q0 * KB + wv, j))
            cols = {}
            for u in range(CS):
                col = s0 + u
                if col < n:
                    if written[col] != pss - 1:
                        raise RingError(f"pass {pss} reads column {col} of "
                                        f"pass {written[col]}")
                    vals = np.where(live, frm[col], zero_t)
                else:
                    vals = np.full(mp, zero_t)
                cols[u] = ((kn, col), vals)
            return planes, cols

        def put(kn, staged, k):
            slot = kn % slots
            if read_at[slot] >= k:
                raise RingError(f"slot {slot}, read at chunk "
                                f"{read_at[slot]}, written at chunk {k} "
                                f"with no __syncwarp between")
            pring[slot], cring[slot] = (k, staged[0]), (k, staged[1])

        put(0, fetch(0), -1)
        for k in range(NC):
            staged = fetch(k + 1) if k + 1 < NC else None
            s0 = k * CS
            slot = k % slots
            (pk, pb), (_, cb) = pring[slot], cring[slot]
            if pk >= k or cb[0][0][0] != k:
                raise RingError(f"chunk {k} reads slot {slot} of chunk "
                                f"{cb[0][0][0]} staged at chunk {pk}")
            read_at[slot] = k
            edge = not (s0 > W * (NB - 1) and s0 + CS <= n)
            for u in range(CS):
                s = s0 + u
                fin = []
                for b in range(NB):
                    t = s - 1 - lag * b
                    if b == 0:
                        (_, col), vals = cb[u]
                        tag, v = (("mem", col), widen(vals))
                    else:
                        tag, v = h[b]
                    first = edge and t == -1
                    if edge and not 0 <= t + 1 < n:
                        tag, v = None, zero
                    elif tag != (("mem", t + 1) if b == 0 else
                                 (q0 + b - 1, t + 1)):
                        raise RingError(f"band {b} at step {t} wants column "
                                        f"{t + 1}, holds {tag}")
                    w_, tg = win[b], tags[b]
                    if t < 0:
                        assert all(not np.signbit(x).any() and
                                   not x.any() for x in w_), (b, t)
                    if not first:
                        w_[u % W], tg[u % W] = v, t + 1
                    quads = []
                    for i in range(KB):
                        (ck, wv, j), vals = pb[u, i, b ^ 2 * i]
                        if (ck, wv, j) != (k, KB * b + i, t - 2 * i):
                            raise RingError(f"band {b} wave {i} at step "
                                            f"{t} read plane {(ck, wv, j)}")
                        xi, yi = (u - 1 - 2 * i) % W, (u - 2 * i) % W
                        for sl_, col in ((xi, t - 2 * i),
                                         (yi, t - 2 * i + 1)):
                            # a column left of 0 may never have come in
                            assert t < 0 or tg[sl_] == col or (
                                col < 0 and tg[sl_] is None), (b, t, i)
                        quads.append((xi, yi, vals))
                    if half is None:
                        for xi, yi, vals in quads:
                            w_[xi], w_[yi] = plane_update(w_[xi], w_[yi],
                                                          *vals)
                    else:
                        for (x0, y0, v0), (x1, y1, v1) in zip(quads[::2],
                                                               quads[1::2]):
                            xn, yn = pair(v0, v1, w_[x0], w_[y0], w_[x1],
                                          w_[y1], half)
                            w_[x0], w_[y0] = xn[0], yn[0]
                            w_[x1], w_[y1] = xn[1], yn[1]
                    if first:
                        w_[u % W], tg[u % W] = v, t + 1
                    f = w_[(u + 1) % W]
                    co = t - (W - 2)
                    fin.append(((q0 + b, co), f))
                    if b == last and 0 <= co < n:
                        out[co] = np.where(live, narrow(f), out[co])
                        written[co] = pss
                # the shuffle: band b takes band b - 1's column next step
                h = [(None, zero)] + fin[:-1]
            if staged is not None:
                put(k + 1, staged, k)
    assert (written == (bands - 1) // NB).all()
    return out[:, :m]


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


@pytest.mark.parametrize("name", [None, *sorted(HALF)])
@pytest.mark.parametrize("m,n,k,passes,last", [(9, 90, 32, 1, 7),
                                               (7, 90, 37, 2, 1),
                                               (6, 45, 49, 2, 4),
                                               (5, 90, 180, 6, 4),
                                               (10, 90, 13, 1, 3),
                                               (3, 12, 5, 1, 1)])
def test_small_band_lanes_equal_plain_version(m, n, k, passes, last, name):
    """The small band's kernel walked lane by lane, in float32 and the
    half body, bit for bit to the plain version at ``k_b = 4`` with
    signed waves, a zero's sign included: 32 waves are one whole pass of
    8 bands (an eigensolver's flush), 37 pad the last band and take a
    second pass of two, 49 and 180 several passes through ``out``, 13 and
    5 one partial pass; rows no multiple of 4; ``n = 90`` runs steady
    chunks, ``n = 45`` and 12 edge chunks only."""
    kb = limits.WAVE_SMALL_KB
    nb = limits.WAVE_SMALL_BANDS
    bands = -(-k // kb)
    assert (-(-bands // nb), (bands - 1) % nb) == (passes, last)
    assert wave_k.passes(k, kb) == passes and m % limits.WAVE_SMALL_ROWS
    args = _case(m, n, k, 300 + k, signs=True)
    if name is None:
        got = _emulate_lanes(*args)
        want = _plain(args, kb)
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
    else:
        half = HALF[name]
        hargs = _to_half(args, half)
        got = _emulate_lanes(*hargs, half=half)
        made = _assert_half_bits(got, _plain_half(hargs, kb, half), half)
        assert not made.any()


@pytest.mark.parametrize("name", [None, *sorted(HALF)])
def test_small_band_lanes_keep_signed_zeros_and_pad_planes(name):
    """On a target of signed zeros under ``c = 1, s = 0`` planes with
    random signs the bits follow every plane's zero signs, the pad
    planes' at both edges and the last band's too (a few waves: more
    wash the signs out): the walk equals the plain version at the small
    band bit for bit, with steady chunks and with edge chunks only."""
    kb = limits.WAVE_SMALL_KB
    for m, n, k in ((6, 80, 5), (6, 40, 2)):
        args = _case(m, n, k, 17 + k, signs=True, zeros=True)
        if name is None:
            got = _emulate_lanes(*args)
            want = _plain(args, kb)
            assert np.array_equal(got.view(np.int32), want.view(np.int32))
            assert np.signbit(want).any() and (~np.signbit(want)).any()
        else:
            half = HALF[name]
            hargs = _to_half(args, half)
            got = _emulate_lanes(*hargs, half=half)
            _assert_half_bits(got, _plain_half(hargs, kb, half), half)


@pytest.mark.parametrize("name", sorted(HALF))
def test_small_band_lanes_special_values(name):
    """NaN with payloads, +-inf, -0.0, results that overflow the type and
    products that land in its subnormals, through the small band's lanes
    in one partial pass and in two passes: every bit the plain
    version's at its band, the card's NaN where arithmetic made one."""
    half = HALF[name]
    for k in (7, 37):
        hargs = _special_case(name, half, k=k)
        with np.errstate(all="ignore"):
            got = _emulate_lanes(*hargs, half=half)
            want = _plain_half(hargs, limits.WAVE_SMALL_KB, half)
        assert _assert_half_bits(got, want, half).any()


def test_small_band_lanes_fail_with_a_lag_one_step_short():
    """The lag between bands is the window, ``W = 8`` steps, the least
    that hands a column on the step after it is finished: one step less
    and band 1 takes in a column band 0 has not finished (the hand-off's
    tag catches it), whatever the chunk."""
    args = _case(6, 90, 32, 9, signs=True)
    _emulate_lanes(*args, lag=2 * limits.WAVE_SMALL_KB)
    with pytest.raises(RingError, match="wants column"):
        _emulate_lanes(*args, lag=2 * limits.WAVE_SMALL_KB - 1)


@pytest.mark.parametrize("name", [None, *sorted(HALF)])
def test_small_band_lanes_fail_with_one_staging_slot(name):
    """Two staging slots a warp are the least: with one, the next chunk's
    plane values land in the slot the chunk's own steps read, with no
    ``__syncwarp`` between."""
    args = _case(5, 40, 32, 10)
    half = None if name is None else HALF[name]
    if half is not None:
        args = _to_half(args, half)
    _emulate_lanes(*args, slots=2, half=half)
    with pytest.raises(RingError, match="no __syncwarp between"):
        _emulate_lanes(*args, slots=1, half=half)


def test_small_band_fills_the_card_at_the_flush():
    """At an eigensolver's flush (``M = 1024``) the small band's kernel
    runs 256 warps of 4 rows in 128 blocks of two, at least 128 of the
    card's 132 SMs, one warp a scheduler, and a pass of its 8 bands is
    ``1030 + 7 * 8`` steps of 4 planes a lane; the default band's block
    is one row group of 32 rows (32 blocks)."""
    geo = limits.wave_small_geometry(1024)
    assert geo == {"rows_a_warp": 4, "bands_a_warp": 8, "warps": 256,
                   "blocks": 128, "warps_a_block": 2}
    assert limits.wave_small_steps(1024, 32) == 1030 + 7 * 8 + 1
    assert -(-1024 // limits.WAVE_ROWS) == 32


@pytest.mark.parametrize("name", [None, *sorted(HALF)])
@pytest.mark.parametrize("kb", [2, 4, 8, 16])
@pytest.mark.parametrize("m,n,k,zeros", [(7, 45, 37, False), (5, 12, 5, False),
                                         (6, 40, 49, False),
                                         (6, 12, 5, True)])
def test_plain_version_does_not_depend_on_the_band(m, n, k, zeros, kb, name):
    """The plain version at every compiled band and at 2 and 8 gives the
    default band's result, so a plan's band changes no value: every bit
    on finite nonzero targets under signed waves, in float32, bfloat16
    and float16.  Signed zeros are equal as values only: the identity
    planes that pad the last band (``c = 1, s = 0, g = -1``) map ``y =
    +0`` to ``-(0 * x - 0)``, whose sign follows ``x``'s, and the bands
    pad different numbers of waves (this case: 5 waves, so 11 pad waves
    at 16, 3 at 4, 1 at 2; it flips some zero at each band)."""
    args = _case(m, n, k, 100 * m + k, signs=True, zeros=zeros)
    if name is None:
        got, want = _plain(args, kb), _plain(args, limits.WAVE_KB)
    else:
        half = HALF[name]
        hargs = _to_half(args, half)
        got, want = (half.f(_plain_half(hargs, b, half))
                     for b in (kb, limits.WAVE_KB))
    assert np.array_equal(got, want)
    same_bits = np.array_equal(got.view(np.int32), want.view(np.int32))
    assert same_bits == (not zeros or kb == limits.WAVE_KB)


@pytest.mark.parametrize("name", sorted(HALF))
def test_pad_planes_spread_special_values_by_band(name):
    """Where a row holds an inf or a NaN the band shows: a pad plane's
    ``0 * inf`` or ``0 * NaN`` is a NaN in its other column, and the
    default band pads more waves than the small one.  So the small
    band's launch is held to its own plain version on special values,
    never to another band's."""
    half = HALF[name]
    hargs = _special_case(name, half, k=7)
    with np.errstate(all="ignore"):
        small = _plain_half(hargs, limits.WAVE_SMALL_KB, half)
        default = _plain_half(hargs, limits.WAVE_KB, half)
    diff = small != default
    assert diff.any()
    assert half.nan(default)[diff].all() and not half.nan(small)[diff].any()


@pytest.mark.parametrize("kb", [4, 16])
def test_staging_fails_with_fewer_slots_or_a_three_chunk_ring(kb):
    """With two panel slots a chunk's values land in a slot while the
    warp may still read the chunk before (no barrier between), and a
    ring of three chunks' columns takes column ``3 CS`` into column 0's
    slot one iteration after chunk 0 read it: the kernel's three slots
    and ``R >= 4 CS`` (32 columns at both bands) are the least that
    work."""
    args = _case(6, 80, 20, 12)
    _, CS, _ = _shape(kb)
    assert 4 * CS == 32
    _emulate_pipeline(*args, kb, 4)
    with pytest.raises(RingError, match="no barrier between"):
        _emulate_pipeline(*args, kb, 4, slots=2)
    with pytest.raises(RingError, match="no barrier between"):
        _emulate_pipeline(*args, kb, 4, ring=3 * CS)


def test_pipeline_emulation_fails_with_a_short_ring():
    """Half the kernel's ring lets warp 0's staging and the hand-offs
    overwrite columns before they are taken in."""
    args = _case(6, 45, 20, 10)
    with pytest.raises(RingError, match="wants column"):
        _emulate_pipeline(*args, 16, 2, ring=16)


def test_source_constants_match_limits():
    """The compiled bands, warps a block and ring are the ones the
    wrapper, the registry and this emulation assume, the launcher
    dispatches on every band (the small one to its own kernel, the old
    pipeline kept for the default band alone) and refuses others, and
    the budget, chunk and lag in ``limits`` are what the launchers ask
    for and the kernels walk at each band."""
    for line in (f"constexpr int kBand = {limits.WAVE_KB};",
                 f"constexpr int kSmallBand = {limits.WAVE_SMALL_KB};",
                 f"constexpr int kWarps = {limits.WAVE_WARPS};",
                 f"constexpr int kSmallRows = {limits.WAVE_SMALL_ROWS};",
                 f"constexpr int kSmallBands = {limits.WAVE_SMALL_BANDS};",
                 f"constexpr int kSmallWarps = {limits.WAVE_SMALL_WARPS};",
                 f"constexpr int kSmallChunk = {limits.WAVE_SMALL_CHUNK};",
                 "constexpr int kRing = 32;"):
        assert line in CU, line
    assert limits.WAVE_BANDS == (limits.WAVE_KB, limits.WAVE_SMALL_KB)
    for const in ("kBand", "kSmallBand"):
        assert f"if (kb == {const})" in CU, const
    assert "launch_band<kBand>" in CU and "launch_band<kSmallBand>" not in CU
    assert "return launch_small(" in CU
    assert "rotseq_wave_small_kernel<T><<<" in CU
    assert "__syncthreads" not in CU[CU.index("rotseq_wave_small_kernel("):]
    assert "return (int)cudaErrorInvalidValue;" in CU
    assert limits.WAVE_ROWS == limits.WARP
    assert limits.WAVE_SMALL_ROWS * limits.WAVE_SMALL_BANDS == limits.WARP
    # the default band's launcher: kWarps * (3 * KB * CS * 16 + kRing *
    # 32 * 4), a chunk of CS = min(2 KB, 128 / KB) = 8 steps
    assert _shape(16)[1] == 8
    # the chunk and lag the registry prices a launch's walk by
    assert (limits.wave_chunk_steps(16), limits.wave_lag(16)) == \
        _shape(16)[1:]
    assert limits.wave_smem_bytes(k_b=16) == 122_880 == limits.WAVE_WARPS * (
        3 * 16 * 8 * 16 + 32 * 32 * 4)
    assert limits.wave_smem_bytes() == limits.wave_smem_bytes(
        k_b=limits.WAVE_KB)
    assert limits.SMEM_STATIC < limits.wave_smem_bytes() \
        <= limits.SMEM_PER_BLOCK
    # the small band's static shared memory: a warp's two slots of 16
    # steps of 4 x 8 planes (a float4 each) and of 16 x 4 columns
    assert limits.wave_smem_bytes(k_b=4) == 33_792 == \
        limits.WAVE_SMALL_WARPS * 2 * 16 * (4 * 8 * 16 + 4 * 4)
    assert limits.wave_smem_bytes(k_b=4) <= limits.SMEM_STATIC


def test_wrapper_refuses_a_band_it_is_not_compiled_for():
    """The wrapper's argument check, which runs before any launch on the
    card: every compiled band passes, any other band and any ``n_b``
    raise ``ValueError`` (on the CPU the plain version takes them)."""
    for kb in limits.WAVE_BANDS:
        wave_k.check_band(kb)
    for kb in (1, 2, 8, 32):
        with pytest.raises(ValueError, match="compiled for"):
            wave_k.check_band(kb)
    with pytest.raises(ValueError, match="no column tiles"):
        wave_k.check_band(limits.WAVE_KB, n_b=64)


@pytest.mark.parametrize("k_b,K,passes", [(16, 180, 1), (16, 193, 2),
                                          (4, 32, 1), (4, 48, 2), (4, 49, 2),
                                          (4, 180, 6)])
def test_traffic_bytes_by_band(k_b, K, passes):
    """A launch reads and writes the operand once a pass: of
    ``WAVE_WARPS`` bands at 16 (192 waves), of ``WAVE_SMALL_BANDS`` at 4
    (32 waves); the panels once whatever the band."""
    n, M = 1024, 1000
    assert wave_k.passes(K, k_b) == passes
    for itemsize in (4, 2):
        assert wave_k.traffic_bytes(n, M, K, itemsize, k_b) == (
            2 * n * M * passes + 3 * K * (n - 1)) * itemsize
    assert wave_k.traffic_bytes(n, M, K) == wave_k.traffic_bytes(
        n, M, K, 4, limits.WAVE_KB)


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
