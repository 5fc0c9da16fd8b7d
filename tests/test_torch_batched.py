"""Port parity of the fused batched kernel module and ``apply_batched``.

On the CPU the kernel wrapper runs its plain version (the whole grid in
``j + 2p`` steps, planes outside each wave's live window skipped); that
is held against the reference's ``rotseq_batched`` (its Pallas kernel in
interpret mode, or its per-request oracle) to the float32 bound of the
other port tests, since XLA on the CPU contracts the plane form.  Within
the port the rotation family is bitwise: the fused route equals
per-request application.

Tests marked ``gpu`` hold the CUDA kernel against its plain version on
the card, bit for bit (out and plane counts), and check what it refuses.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.core import registry as jreg
from repro.core.sequence import RotationSequence as JSeq
from repro.kernels.rotseq_batched.ops import rot_sequence_batched as j_batched
from repro.kernels.rotseq_batched.ops import wave_windows as j_windows
from repro.kernels.rotseq_batched.ref import rot_sequence_batched_ref as j_ref
from repro_torch import RotationSequence, SequencePlan
from repro_torch.core import registry
from repro_torch.core.ref import sign_grid
from repro_torch.core.rotations import plane_update
from repro_torch.kernels.rotseq_batched import kernel as batched_k
from repro_torch.kernels.rotseq_batched.ops import (count_live_planes,
                                                    rot_sequence_batched,
                                                    wave_windows)
from repro_torch.kernels.rotseq_batched.ref import rotseq_batched_ref


def _tol(k):
    return dict(atol=5e-5 * max(1, k), rtol=5e-5)


def _waves(n, k, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    th = rng.uniform(0.0, 2.0 * np.pi, (n - 1, k))
    return np.cos(th).astype(dtype), np.sin(th).astype(dtype)


def _signs(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return np.where(rng.random(shape) < 0.5, 1.0, -1.0).astype(dtype)


def _seq(n, k, seed, kind="plain", dtype=np.float32):
    """A port sequence and its reference twin from the same numpy waves."""
    C, S = _waves(n, k, seed, dtype)
    G = _signs(C.shape, seed + 1, dtype) if kind == "signed" else None
    refl = kind == "reflect"
    t = RotationSequence(torch.from_numpy(C), torch.from_numpy(S),
                         None if G is None else torch.from_numpy(G), refl)
    j = JSeq(jnp.asarray(C), jnp.asarray(S),
             None if G is None else jnp.asarray(G), refl)
    return t, j


def _stack(seqs):
    C = np.stack([s.cos.numpy() for s in seqs])
    S = np.stack([s.sin.numpy() for s in seqs])
    G = None
    if any(s.sign is not None for s in seqs):
        G = np.stack([s._sign_array().numpy() for s in seqs])
    return C, S, G


def _targets(b, m, n, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((b, m, n)).astype(dtype)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (case, b, m, n, k): per-request stacks, one shared sequence, padded
# tails and seq.T staircases -- the inputs the plane skip exists for
CASES = ["per_request", "shared", "signed", "reflect", "padded",
         "staircase", "padded_reflect"]


def _case(case, b=3, m=7, n=12, k=4):
    if case == "shared":
        t, j = _seq(n, k, 10)
        return [t], [j], True
    pairs = []
    for i in range(b):
        kind = {"signed": "signed", "reflect": "reflect",
                "padded_reflect": "reflect"}.get(case, "plain")
        if case == "signed" and i == 1:
            kind = "plain"       # a plain member under a signed stack
        t, j = _seq(n, k if "padded" not in case else 2 + i, 20 + i, kind)
        if "padded" in case:
            t, j = t.pad_to(k + 2), j.pad_to(k + 2)
        if case == "staircase":
            t, j = t.T, j.T
        pairs.append((t, j))
    return [p[0] for p in pairs], [p[1] for p in pairs], False


# ------------------------------------------------------- live windows ----

@pytest.mark.parametrize("case", CASES)
def test_wave_windows_equal_reference(case):
    tseqs, _, _ = _case(case)
    C, S, G = _stack(tseqs)
    G = G if G is not None else np.full(
        C.shape, 1.0 if tseqs[0].reflect else -1.0, np.float32)
    starts, counts = wave_windows(torch.from_numpy(C), torch.from_numpy(S),
                                  torch.from_numpy(G))
    j_starts, j_counts = j_windows(jnp.asarray(C), jnp.asarray(S),
                                   jnp.asarray(G))
    assert starts.dtype == counts.dtype == torch.int32
    np.testing.assert_array_equal(starts.numpy(), np.asarray(j_starts))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))


# --------------------------------------------- the fused plain version ----

@pytest.mark.parametrize("case", CASES)
def test_fused_plain_version_vs_reference(case):
    tseqs, jseqs, shared = _case(case)
    b, m, n = 3, 7, 12
    A = _targets(b, m, n, 1)
    C, S, G = _stack(tseqs)
    refl = tseqs[0].reflect and G is None
    if shared:
        C, S = C[0], S[0]
    t = lambda x: None if x is None else torch.from_numpy(x)
    before = batched_k.LAUNCHES
    out = rot_sequence_batched(t(A), t(C), t(S), reflect=refl, G=t(G))
    assert batched_k.LAUNCHES == before      # the CPU path launches nothing
    j = lambda x: None if x is None else jnp.asarray(x)
    ref = j_ref(j(A), j(C), j(S), reflect=refl, G=j(G))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               **_tol(C.shape[-1]))
    # within the port: bitwise against each request applied alone
    per = torch.stack([
        s.plan(like=t(A[i]), method="blocked").apply(t(A[i]))
        for i, s in enumerate(tseqs * b if shared else tseqs)])
    assert torch.equal(out, per)


def test_fused_plain_version_vs_reference_kernel_f64():
    """Against the reference's Pallas kernel itself (interpret mode), at
    float64 under the reference's x64 switch."""
    tseqs, _, _ = _case("signed")
    C, S, G = _stack(tseqs)
    A = _targets(3, 7, 12, 2)
    out = rot_sequence_batched(*(torch.from_numpy(x.astype(np.float64))
                                 for x in (A, C, S)),
                               G=torch.from_numpy(G.astype(np.float64)))
    with compat.enable_x64():
        ref = j_batched(*(jnp.asarray(x, jnp.float64) for x in (A, C, S)),
                        G=jnp.asarray(G, jnp.float64), m_blk=8)
        ref = np.asarray(ref)
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-12 * C.shape[-1])


def test_plane_skip_witness():
    """The plain version applies exactly each request's live-plane hull:
    ``pad_to`` tails and staircase triangles are skipped, as the
    reference kernel's per-step counts say."""
    b, m, n = 3, 9, 16
    A = _targets(b, m, n, 3)
    padded = [_seq(n, 3, 30 + i)[0].pad_to(8) for i in range(b)]
    C, S, _ = _stack(padded)
    out, planes = rot_sequence_batched(torch.from_numpy(A),
                                       torch.from_numpy(C),
                                       torch.from_numpy(S),
                                       return_planes=True)
    j_out, j_planes = j_batched(jnp.asarray(A), jnp.asarray(C),
                                jnp.asarray(S), m_blk=8, return_planes=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **_tol(8))
    j_planes = np.asarray(j_planes)
    for i, s in enumerate(padded):
        live = count_live_planes(s)
        assert live == (n - 1) * 3 == s.k_live < (n - 1) * 8
        # every row block reports its request's live planes, as every
        # grid step of the reference kernel does (R differs by design)
        assert (planes[i] == live).all() and (j_planes[i] == live).all()

    stair = _seq(n, 3, 40)[0].T
    _, planes_t = rot_sequence_batched(torch.from_numpy(A), stair.cos,
                                       stair.sin, return_planes=True)
    assert stair.k == n + 3 - 2
    assert (planes_t == stair.k_live).all()
    assert count_live_planes(stair) == stair.k_live < (n - 1) * stair.k

    ident = RotationSequence.identity(n, 8, device="cpu")
    out_i, planes_i = rot_sequence_batched(torch.from_numpy(A), ident.cos,
                                           ident.sin, return_planes=True)
    assert (planes_i == 0).all()
    assert torch.equal(out_i, torch.from_numpy(A))


def test_skipped_planes_leave_targets_untouched():
    """A skipped plane is never visited: -0.0 and NaN in the target stay
    as they are, where a multiplied-through identity changes them."""
    n = 6
    A = torch.zeros((1, 2, n))
    A[0, 0, 3] = -0.0
    A[0, 1, 4] = float("nan")
    ident = RotationSequence.identity(n, 3, device="cpu")
    out = rot_sequence_batched(A, ident.cos, ident.sin)
    assert torch.signbit(out[0, 0, 3]) and torch.isnan(out[0, 1, 4])
    mult = ident.plan(like=A[0], method="blocked").apply(A[0])
    assert not torch.signbit(mult[0, 3])


def test_padded_reflector_planes_stay_live():
    """``c = 1, s = 0`` as a reflector is ``diag(1, -1)``, not the
    identity: the skip test keys on the sign."""
    n, k = 8, 2
    C, S = torch.ones((n - 1, k)), torch.zeros((n - 1, k))
    A = _targets(2, 4, n, 4)
    out, planes = rot_sequence_batched(torch.from_numpy(A), C, S,
                                       reflect=True, return_planes=True)
    assert (planes == (n - 1) * k).all()
    ref = j_ref(jnp.asarray(A), jnp.asarray(C.numpy()),
                jnp.asarray(S.numpy()), reflect=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **_tol(k))


def test_wrapper_takes_plain_version_only_on_cpu_and_refuses_width():
    tseqs, _, _ = _case("per_request")
    C, S, _ = _stack(tseqs)
    C, S = torch.from_numpy(C), torch.from_numpy(S)
    G = sign_grid(C, False, None)
    starts, counts = wave_windows(C, S, G)
    AT = torch.from_numpy(_targets(3, 7, 12, 5)).transpose(1, 2).contiguous()
    args = (AT, *(x.transpose(1, 2).contiguous() for x in (C, S, G)),
            starts, counts)
    got = batched_k.rotseq_batched(*args)
    want = rotseq_batched_ref(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="cuda or cpu"):
        batched_k.rotseq_batched(*(x.to("meta") for x in args))
    # the width has no cap: the row streams through memory a band at a
    # time, so the widths past the former shared-memory slab (n = 1816)
    # run and equal the reference
    for n in (1817, 2048):
        A = _targets(2, 4, n, 13)
        C, S = _waves(n, 3, 14)
        out = rot_sequence_batched(torch.from_numpy(A), torch.from_numpy(C),
                                   torch.from_numpy(S))
        ref = j_ref(jnp.asarray(A), jnp.asarray(C), jnp.asarray(S))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **_tol(3))


def test_build_keeps_its_report_beside_the_library(tmp_path, monkeypatch):
    """``_build.build()`` returns ``nvcc``'s ptxas report on every call:
    the report of a fresh build is saved beside the library and read
    back when the library is already built; a library without its
    report is built again, and an edited source names a new library."""
    import sys

    from repro_torch.kernels import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in _build.CSRC.glob("*.cu"):
        (csrc / f.name).write_bytes(f.read_bytes())
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('lib')\n"
        f"open({str(calls)!r}, 'a').write('x')\n"
        "print(\"ptxas info    : Used 40 registers, 0 bytes spill\")\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    first = _build.build()
    assert "Used 40 registers" in first and _build._target().exists()
    assert _build.build() == first and calls.read_text() == "x"
    _build._target().with_suffix(".log").unlink()
    assert _build.build() == first and calls.read_text() == "xx"
    before = _build._target()
    src = csrc / "rotseq_batched.cu"
    src.write_text(src.read_text() + "// edited\n")
    assert _build._target() != before
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(
        [before.name, before.with_suffix(".log").name])


# ------------------------------ the kernel's band schedule, emulated ----

def _emulate_band_schedule(AT, C, S, G, starts, counts, kb):
    """``csrc/rotseq_batched.cu`` step for step, over all rows at once.

    Bands of ``kb`` waves; within a band step ``t`` applies plane
    ``t - 2i`` of band wave ``i``; steps run in chunks of ``CS = min(W,
    128 // kb)`` (``W = 2 kb``) aligned to multiples of ``CS`` over the
    band's hull range; at the start of chunk ``tc`` the window holds
    column ``c`` in slot ``(c - tc) % W`` and rotates by ``CS`` slots at
    its end; step ``t`` takes column ``t + 1`` from the chunk's staged
    tile and stores column ``t - W + 2``; only the hulls' columns are
    loaded and stored; the first band to run reads ``AT`` and carries the
    columns it does not touch to ``out``; a dead plane's staged values are
    stale (NaN here) and a select drops its result.
    """
    b, n, m = AT.shape
    bs, K, J = C.shape
    W = 2 * kb
    CS = min(W, 128 // kb)
    out = torch.full_like(AT, 3.0e38)       # any column left unwritten shows
    stale = torch.tensor(float("nan"))
    for ib in range(b):
        r = ib if bs > 1 else 0
        src, dst = AT[ib], out[ib]
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
                return frm[col].clone() if inside(col) else torch.zeros(m)

            def stage(tc):
                panel = [[None] * CS for _ in range(kb)]
                for i in range(kb):
                    for u in range(CS):
                        p, j = b0 + i, tc + u - 2 * i
                        live = (p < K and 0 <= j < J
                                and starts[r, p] <= j
                                < starts[r, p] + counts[r, p])
                        panel[i][u] = ((C[r, p, j], S[r, p, j], G[r, p, j],
                                        True) if live
                                       else (stale, stale, stale, False))
                return panel, [load(tc + 1 + u) for u in range(CS)]

            t0 = tlo // CS * CS
            t1 = -(-thi // CS) * CS
            win = [torch.zeros(m)] * W
            for q in range(W - 1):
                win[(q + 2) % W] = load(t0 - W + 2 + q)
            for tc in range(t0, t1, CS):
                panel, cols = stage(tc)
                for u in range(CS):
                    t = tc + u
                    win[(u + 1) % W] = cols[u]
                    for i in range(kb):
                        c, s, g, live = panel[i][u]
                        xi, yi = (u - 2 * i) % W, (u - 2 * i + 1) % W
                        x, y = win[xi], win[yi]
                        xn, yn = plane_update(x, y, c, s, g)
                        win[xi] = xn if live else x
                        win[yi] = yn if live else y
                    if inside(t - W + 2):
                        dst[t - W + 2] = win[(u + 2) % W]
                win = [win[(q + CS) % W] for q in range(W)]
            for q in range(W - 1):
                if inside(t1 - W + 2 + q):
                    dst[t1 - W + 2 + q] = win[(q + 2) % W]
        if first:
            dst.copy_(src)
    return out


def _hull_case(b=2, m=6, n=16, k=5):
    """Per-request waves whose planes outside a window ``[lo_p, hi_p)``
    are the identity, and targets with NaN, inf and -0.0 in the columns
    outside every hull (0, 1 and n-2, n-1), which must keep their bits."""
    seqs = []
    for r in range(b):
        C, S = _waves(n, k, 140 + r)
        for p in range(k):
            lo, hi = 2 + (p + r) % 3, n - 3 - (p % 2)
            C[:lo, p], S[:lo, p] = 1.0, 0.0
            C[hi:, p], S[hi:, p] = 1.0, 0.0
        seqs.append(RotationSequence(torch.from_numpy(C),
                                     torch.from_numpy(S)))
    A = torch.from_numpy(_targets(b, m, n, 15))
    A[:, 0, 0] = float("nan")
    A[:, 1, 1] = float("inf")
    A[:, 2, n - 2] = -0.0
    A[:, 3, n - 1] = float("-inf")
    A[:, 4, 0] = -0.0
    return seqs, A


@pytest.mark.parametrize("kb", [2, 4, 16])
@pytest.mark.parametrize("case", CASES + ["hulls"])
def test_band_schedule_emulation_equals_plain_version(case, kb):
    """The kernel's band/step order, register window and hull select
    give the plain version's result bit for bit: per-request and shared
    panels, a wave count that is no multiple of ``kb`` (5, 7, 15), and
    NaN, inf and -0.0 outside the hulls left as they were."""
    if case == "hulls":
        tseqs, A = _hull_case()
        shared = False
    else:
        tseqs, _, shared = _case(case, k=5)
        A = torch.from_numpy(_targets(3, 7, 12, 16))
    C = torch.stack([s.cos for s in tseqs])
    S = torch.stack([s.sin for s in tseqs])
    G = torch.stack([sign_grid(s.cos, s.reflect, s.sign) for s in tseqs])
    starts, counts = wave_windows(C, S, G)
    args = (A.transpose(1, 2).contiguous(),
            *(x.transpose(1, 2).contiguous() for x in (C, S, G)),
            starts, counts)
    assert args[1].shape[1] % kb != 0       # a remainder band
    got = _emulate_band_schedule(*args, kb)
    want, _ = rotseq_batched_ref(*args)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if case == "hulls":
        out = got.transpose(1, 2)
        assert torch.isnan(out[:, 0, 0]).all()
        assert torch.isinf(out[:, 1, 1]).all()
        assert torch.signbit(out[:, 2, -2]).all()
        assert torch.signbit(out[:, 4, 0]).all()


# ---------------------------------------------------- apply_batched ----

ROTATION_FAMILY = [("cuda_batched", {}), ("blocked", dict(n_b=8, k_b=4)),
                   ("wavefront", {}), ("unoptimized", {}),
                   ("cuda_wave", dict(n_b=8, k_b=4))]
# per-entry signs only where the backend carries them
PER_REQUEST = [(meth, kw, kind) for meth, kw in ROTATION_FAMILY
               for kind in ("plain", "signed", "reflect")
               if kind != "signed" or meth not in ("wavefront", "unoptimized")]


@pytest.mark.parametrize("method,kw,kind", PER_REQUEST)
def test_apply_batched_bitwise_per_request(method, kw, kind):
    b, m, n, k = 4, 6, 12, 5
    A = torch.from_numpy(_targets(b, m, n, 6))
    # a signed bucket mixes signed and plain members; a reflector
    # bucket is all reflectors
    seqs = [_seq(n, k, 50 + i,
                 kind if kind == "reflect" or i % 2 == 0 else "plain")[0]
            for i in range(b)]
    rep = seqs[0].with_signs() if kind == "signed" else seqs[0]
    plan = rep.plan(like=A, method=method, **kw)
    out = plan.apply_batched(A, sequences=seqs)
    per = torch.stack([s.plan(like=A[i], method=method, **kw).apply(A[i])
                       for i, s in enumerate(seqs)])
    assert torch.equal(out, per)


@pytest.mark.parametrize("method,kw", ROTATION_FAMILY
                         + [("accumulated", dict(n_b=8, k_b=4))])
def test_apply_batched_shared_sequence(method, kw):
    b, m, n, k = 3, 5, 12, 6
    A = torch.from_numpy(_targets(b, m, n, 7))
    seq = _seq(n, k, 60)[0]
    plan = seq.plan(like=A, method=method, **kw)
    out = plan.apply_batched(A)
    per = torch.stack([plan.apply(A[i]) for i in range(b)])
    if method == "accumulated":
        torch.testing.assert_close(out, per, atol=1e-5, rtol=1e-5)
    else:
        assert torch.equal(out, per)


def test_apply_batched_accumulated_per_request_to_tolerance():
    b, m, n, k = 3, 5, 12, 6
    A = torch.from_numpy(_targets(b, m, n, 8))
    seqs = [_seq(n, k, 70 + i)[0] for i in range(b)]
    plan = seqs[0].plan(like=A, method="accumulated", n_b=8, k_b=4)
    out = plan.apply_batched(A, sequences=seqs)
    per = torch.stack([s.plan(like=A[i], method="blocked").apply(A[i])
                       for i, s in enumerate(seqs)])
    torch.testing.assert_close(out, per, atol=5e-6 * k, rtol=1e-5)


@pytest.mark.parametrize("case", ["per_request", "signed", "staircase"])
def test_apply_batched_vs_reference(case):
    tseqs, jseqs, _ = _case(case)
    b, m, n = 3, 7, 12
    A = _targets(b, m, n, 9)
    trep = tseqs[0].with_signs() if case == "signed" else tseqs[0]
    jrep = jseqs[0].with_signs() if case == "signed" else jseqs[0]
    out = trep.plan(like=torch.from_numpy(A), method="cuda_batched") \
        .apply_batched(torch.from_numpy(A), sequences=tseqs)
    ref = jrep.plan(like=jnp.asarray(A), method="rotseq_batched") \
        .apply_batched(jnp.asarray(A), sequences=jseqs)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               **_tol(tseqs[0].k))


def test_apply_batched_gradient():
    """The batched backward (every request's staircase through the same
    fused route) equals per-request gradients bit for bit in the port
    and the reference's to float32 tolerance."""
    import jax

    b, m, n, k = 4, 6, 12, 4
    A = _targets(b, m, n, 10)
    pairs = [_seq(n, k, 80 + i, "signed" if i == 0 else "plain")
             for i in range(b)]
    tseqs, jseqs = [p[0] for p in pairs], [p[1] for p in pairs]
    At = torch.from_numpy(A).requires_grad_(True)
    plan = tseqs[0].plan(like=At, method="cuda_batched")
    (g,) = torch.autograd.grad(
        (plan.apply_batched(At, sequences=tseqs) ** 2).sum(), At)
    per = []
    for i, s in enumerate(tseqs):
        x = torch.from_numpy(A[i]).requires_grad_(True)
        (gi,) = torch.autograd.grad(
            (s.plan(like=x, method="blocked").apply(x) ** 2).sum(), x)
        per.append(gi)
    assert torch.equal(g, torch.stack(per))
    jplan = jseqs[0].plan(like=jnp.asarray(A), method="rotseq_batched")
    jg = jax.grad(lambda x: (jplan.apply_batched(x, sequences=jseqs)
                             ** 2).sum())(jnp.asarray(A))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **_tol(2 * k))
    # shared sequence through the fused route, and direct autograd
    At2 = torch.from_numpy(A).requires_grad_(True)
    (gs,) = torch.autograd.grad((plan.rebind(tseqs[1].with_signs())
                                 .apply_batched(At2) ** 2).sum(), At2)
    (gd,) = torch.autograd.grad((plan.rebind(tseqs[1].with_signs())
                                 .apply_batched(At2, direct=True)
                                 ** 2).sum(), At2)
    assert torch.isfinite(gs).all()
    torch.testing.assert_close(gs, gd, atol=1e-5, rtol=1e-5)


def test_apply_batched_validation():
    seq = _seq(8, 4, 90)[0]
    A3 = torch.zeros((2, 5, 8))
    plan = seq.plan(like=A3, method="cuda_batched")
    with pytest.raises(ValueError, match=r"\(b, m, n\)"):
        plan.apply_batched(torch.zeros((5, 8)))
    with pytest.raises(ValueError, match="sequences for a batch"):
        plan.apply_batched(A3, sequences=[seq])
    with pytest.raises(ValueError, match="pad_to"):
        plan.apply_batched(A3, sequences=[seq, _seq(8, 6, 91)[0]])
    with pytest.raises(ValueError, match="sign/reflect"):
        plan.apply_batched(A3, sequences=[seq, seq.with_signs()])
    with pytest.raises(TypeError, match="RotationSequence"):
        plan.apply_batched(A3, sequences=[seq, "waves"])


# --------------------------------------------- planning and liveness ----

def test_k_live_reaches_the_plan_cache_key():
    registry.clear_plan_cache()
    seq = _seq(16, 3, 100)[0].pad_to(8)
    assert seq.k_live == 15 * 3 and seq.T.k_live == 15 * 3
    A = torch.zeros((4, 6, 16))
    seq.plan(like=A, batch=4, shared_sequence=False)
    keys = list(registry._PLAN_CACHE)
    assert keys[-1][-2:] == ("live", 15 * 3)
    assert keys[-1][6:8] == (4, False)
    dense = RotationSequence(seq.cos, seq.sin)
    dense.plan(like=A, batch=4, shared_sequence=False)
    assert len(registry._PLAN_CACHE) == 2   # liveness is its own entry
    registry.clear_plan_cache()


def test_serving_buckets_plan_the_fused_kernel_on_the_card():
    registry.clear_plan_cache()
    n, k = 1024, 64
    bucket = registry.select_plan(1024, n, k, platform="cuda", batch=16,
                                  shared_sequence=False,
                                  live_planes=(n - 1) * 40)
    stair = registry.select_plan(1024, n, n + k - 2, platform="cuda",
                                 batch=16, shared_sequence=False,
                                 live_planes=(n - 1) * k)
    demo = registry.select_plan(16, 32, 8, platform="cuda", batch=16,
                                shared_sequence=False)
    assert bucket.method == stair.method == demo.method == "cuda_batched"
    # the width sets no cap: a bucket of wide targets plans it too
    wide = registry.select_plan(1024, 3840, 64, platform="cuda", batch=16,
                                shared_sequence=False)
    assert wide.method == "cuda_batched"
    registry.clear_plan_cache()


@pytest.mark.parametrize("prob", [
    dict(m=16, n=32, k=8, batch=16, shared_sequence=False),
    dict(m=64, n=96, k=102, live_planes=95 * 8),
    dict(m=8, n=12, k=4, batch=3, signs=True)])
def test_cost_components_equal_reference_rotseq_batched(prob):
    """``cuda_batched`` is priced by the reference's ``rotseq_batched``
    formula: same flops and bytes, and on the CPU (same rates, same
    off-device penalty) the same seconds."""
    tp = registry.Problem(platform="cpu", **prob)
    jp = jreg.Problem(platform="cpu", **prob)
    got = registry.cost_components("cuda_batched", tp)
    want = jreg.cost_components("rotseq_batched", jp,
                                jreg.Plan("rotseq_batched", m_blk=8))
    for key in ("flops", "bytes", "seconds"):
        assert got[key] == want[key], key
    for part in ("setup", "stream"):
        assert got[part] == want[part], part


def test_capability_record():
    spec = registry.get_backend("cuda_batched")
    cap = spec.capability
    assert cap.batch_via == "fused" and cap.supports_signs
    assert cap.needs_kernel and not cap.supports_vmap
    assert cap.dtypes == ("float32",) and cap.platforms == ("cuda",)
    assert spec.candidates(registry.Problem(m=4, n=8, k=2))[0].kwargs() == {}
    for name in ("cuda_wave", "cuda_mxu", "blocked"):
        assert registry.get_backend(name).capability.batch_via == "flatten"


# ----------------------------------------------------- serialization ----

def test_sequence_dict_roundtrip_and_reference_dicts():
    t, j = _seq(10, 3, 110, "signed")
    t = t.pad_to(5)
    back = RotationSequence.from_dict(json.loads(json.dumps(t.to_dict())),
                                      device="cpu")
    for a, b in ((back.cos, t.cos), (back.sin, t.sin), (back.sign, t.sign)):
        assert torch.equal(a, b)
    assert back.k_live == t.k_live and back.reflect == t.reflect
    # the reference's dict carries across bit for bit, and back
    jd = json.loads(json.dumps(j.pad_to(5).to_dict()))
    from_ref = RotationSequence.from_dict(jd, device="cpu")
    assert torch.equal(from_ref.cos, t.cos) and from_ref.k_live == t.k_live
    assert t.to_dict() == jd
    with pytest.raises(ValueError, match="dtype"):
        RotationSequence.from_dict(dict(jd, dtype="bfloat16"), device="cpu")


def test_plan_dict_roundtrip_and_rejections():
    b, m, n, k = 3, 6, 16, 4
    A = torch.from_numpy(_targets(b, m, n, 11))
    seqs = [_seq(n, k, 120 + i)[0] for i in range(b)]
    plan = seqs[0].plan(like=A, method="cuda_batched")
    d = json.loads(json.dumps(plan.to_dict()))
    assert d["method"] == "cuda_batched" and "torch" in d and "jax" not in d
    again = SequencePlan.from_dict(d, seqs[0])
    assert torch.equal(again.apply_batched(A, sequences=seqs),
                       plan.apply_batched(A, sequences=seqs))
    auto = seqs[0].plan(like=A[0])
    back = SequencePlan.from_dict(json.loads(json.dumps(auto.to_dict())),
                                  seqs[0])
    assert back.method == auto.method and back.plan.source == "persisted"
    assert dict(back.kwargs) == dict(auto.kwargs)
    with pytest.raises(ValueError, match="running"):
        SequencePlan.from_dict(dict(d, torch="torch 0.0.1"), seqs[0])
    with pytest.raises(ValueError, match="wave shape"):
        SequencePlan.from_dict(d, seqs[0].pad_to(8))
    with pytest.raises(ValueError, match="sign/reflect"):
        SequencePlan.from_dict(d, seqs[0].with_signs())
    with pytest.raises(ValueError, match="dtype"):
        SequencePlan.from_dict(
            d, RotationSequence(seqs[0].cos.double(), seqs[0].sin.double()))
    with pytest.raises(ValueError, match="format"):
        SequencePlan.from_dict(dict(d, format=99), seqs[0])
    with pytest.raises(ValueError, match="unknown method"):
        SequencePlan.from_dict(dict(d, method="gone"), seqs[0])
    unsigned = dict(d, method="wavefront")
    with pytest.raises(ValueError, match="cannot carry signs"):
        SequencePlan.from_dict(dict(unsigned, signed=True),
                               seqs[0].with_signs())


# ------------------------------------------------------------ the card ----

@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES + ["hulls", 1817, 2048])
@pytest.mark.parametrize("m", [7, 300])
def test_batched_kernel_equals_plain_on_card(case, m):
    """Bit for bit, out and plane counts, over wave counts that leave a
    remainder band of 16 (6, 8, 20 and 44), rows staged one at a time
    (``m = 7``) and four at a time (``m = 300``), with NaN, inf and -0.0
    outside the hulls, and at widths 1817 and 2048, past the first
    design's shared-memory cap."""
    dev = _cuda()
    if case == "hulls":
        tseqs, A = _hull_case(b=3, m=m, n=40, k=6)
        shared = False
    elif isinstance(case, int):
        C, S = _waves(case, 20, 17)
        tseqs = [RotationSequence(torch.from_numpy(C), torch.from_numpy(S))]
        shared = True
        A = torch.from_numpy(_targets(2, m, case, 18))
    else:
        tseqs, _, shared = _case(case, b=3, m=m, n=40, k=6)
        A = torch.from_numpy(_targets(3, m, 40, 12))
    C = torch.stack([s.cos for s in tseqs]).to(dev)
    S = torch.stack([s.sin for s in tseqs]).to(dev)
    G = torch.stack([sign_grid(s.cos, s.reflect, s.sign)
                     for s in tseqs]).to(dev)
    if shared:
        C, S, G = C[:1], S[:1], G[:1]
    starts, counts = wave_windows(C, S, G)
    args = (A.to(dev).transpose(1, 2).contiguous(),
            *(x.transpose(1, 2).contiguous() for x in (C, S, G)),
            starts, counts)
    before = batched_k.LAUNCHES
    out, planes = batched_k.rotseq_batched(*args)
    torch.cuda.synchronize()
    assert batched_k.LAUNCHES - before == 1
    want, want_planes = rotseq_batched_ref(*args)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    assert torch.equal(planes, want_planes)


@pytest.mark.gpu
def test_batched_kernel_refuses_what_it_cannot_run():
    dev = _cuda()
    A = torch.zeros((2, 4, 12), device=dev)
    C, S = torch.ones((11, 3), device=dev), torch.zeros((11, 3), device=dev)
    with pytest.raises(TypeError, match="float32"):
        rot_sequence_batched(A.double(), C.double(), S.double())
    # a wide slab runs: the width has no cap
    out = rot_sequence_batched(torch.ones((1, 40, 4096), device=dev),
                               torch.ones((4095, 2), device=dev),
                               torch.zeros((4095, 2), device=dev))
    torch.cuda.synchronize()
    assert torch.equal(out, torch.ones_like(out))
