"""The wavefront kernel's band pipeline, walked on the CPU.

``csrc/rotseq_wave.cu`` runs the bands of one group of rows on several
warps at once, each a fixed lag behind the one before, handing columns
on through rings in shared memory.  No CUDA code runs here, so
:func:`_emulate_pipeline` walks the same schedule in numpy float32
(iterations, barriers, chunks, window slots, staging slots, rings and
passes) and the tests hold its result bit for bit to the plain version,
the blocked sweep at the kernel's ``k_b``.  Every ring slot carries the
(band, column) it holds and the iteration that wrote it, so a read that
comes before its write, or after the slot was written again, fails.
"""
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.core.rotations import plane_update
from repro_torch.kernels import limits
from repro_torch.kernels.rotseq import kernel as wave_k
from repro_torch.kernels.rotseq.ops import rot_sequence_wave
from repro_torch.kernels.rotseq.ref import rotseq_wave_ref

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


def _emulate_pipeline(AT, Cw, Sw, Gw, kb, warps, lag=None, ring=32):
    """``rotseq_wave_kernel<kb, warps>`` over all rows at once.

    One pass a group of ``warps`` bands; in the pass's iteration ``s``
    warp ``w`` runs its chunk ``s - lag * w`` after staging the next
    one's plane values (and, warp 0, its columns) in phase A; a barrier
    separates phase A from phase B and one iteration from the next, so
    ring writes of phase B become visible at the end of the iteration.
    """
    n, m = AT.shape
    K, J = Cw.shape
    W, CS, L = _shape(kb)
    L = L if lag is None else lag
    R = ring
    bands = -(-K // kb)
    NC = -(-(n + W - 2) // CS)
    zero = np.zeros(m, np.float32)
    out = np.full_like(AT, np.nan)
    written = np.full(n, -1)                  # the pass that wrote a column

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
            return slot[3]

        for s in range(-1, NC + L * last):
            # phase A: stage chunk kw + 1
            for w in range(last + 1):
                kn = s - L * w + 1
                if not 0 <= kn < NC:
                    continue
                tc, band = kn * CS, q0 + w
                vals = {}
                for i in range(kb):
                    for u in range(CS):
                        j, p = tc + u - 2 * i, band * kb + i
                        if p < K and 0 <= j < J:
                            vals[i, u] = (Cw[p, j], Sw[p, j], Gw[p, j])
                        else:
                            vals[i, u] = (np.float32(1), np.float32(0),
                                          np.float32(1 if j < -i else -1))
                panels[w][kn % 3] = (kn, vals)
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
                tag, vals = panels[w][kw % 3]
                assert tag == kw
                if kw == 0:
                    wins[w] = [zero] * W
                    wins[w][0] = take(w, 0, band, s)
                win = wins[w]
                for u in range(CS):
                    t = tc + u
                    win[(u + 1) % W] = (take(w, t + 1, band, s) if t + 1 < n
                                        else zero)
                    for i in range(kb):
                        xi, yi = (u - 2 * i) % W, (u - 2 * i + 1) % W
                        win[xi], win[yi] = plane_update(win[xi], win[yi],
                                                        *vals[i, u])
                    co = t - W + 2
                    if w == last and 0 <= co < n:
                        out[co] = win[(u + 2) % W]
                        written[co] = pss
                    elif w < last and co >= 0:
                        pending.append((w + 1, co, band, win[(u + 2) % W]))
                wins[w] = [win[(q + CS) % W] for q in range(W)]
            for w1, co, band, f in pending:
                rings[w1][co % R] = (("band", band), co, s, f)
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
