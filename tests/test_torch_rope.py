"""Port parity of the fused RoPE module against the reference.

On the CPU the port's ``apply_rope`` runs its plain version, exactly the
reference's ``apply_rope_ref`` on q and on k; it is held against the
reference's fused Pallas kernel (interpret mode) and its jnp reference,
at the shapes of ``tests/test_kernels.py::test_rope_kernel_vs_ref``:
float32 to 1e-6 (XLA on the CPU may contract ``x1*c - x2*s`` into a
fused multiply-add, and ``cos``/``sin`` differ by an ulp between the
libraries), bfloat16 to 2e-2 (XLA keeps the bf16 products in float32).

The CUDA kernel's item-to-address map (``rope.cu``: ``locate``, chunk
fastest, then head of q then k, then row) is emulated here and walked
with tagged inputs on both of its paths; the wrapper's path rule is
tested as a pure function.  The attention's cached table rows
(``models.attention.rope_rows``) are held to fresh ``rope_tables`` bit
for bit, and a decode run shows that no step after the first builds a
table.

The gradient: where q or k takes one, the wrapper goes through an
autograd function whose backward is the kernel's inverse rotation (the
same kernel with ``inverse`` set, reading ``sin`` negated), on the CPU
the plain version with ``-sin``.  It is held bit for bit to
``torch.autograd`` of the plain version in float32 and bfloat16, at the
GQA shapes and on an odd-offset view; the kernel's ``rotate`` with the
sign flip is emulated element by element (its rounding: each product
rounded to the dtype, then one subtraction or addition) and held to the
same gradient.

The tests marked ``gpu`` hold the CUDA kernel, forward and backward,
against its plain version and autograd of it on the card bit for bit in
both dtypes, on both paths; they decide inside the test whether a card
is present.
"""
import ctypes
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rope.ops import apply_rope as j_apply_rope
from repro.kernels.rope.ops import rope_tables as j_rope_tables
from repro_torch.configs import get_config
from repro_torch.kernels.rope import kernel as rope_k
from repro_torch.kernels.rope.ops import (apply_rope, apply_rope_ref,
                                          rope_tables)
from repro_torch.models import attention, build_model
from repro_torch.serve import ServeEngine

CU = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
      / "csrc" / "rope.cu").read_text()

# (B, S, Hq, Hk, D), after tests/test_kernels.py
SHAPES = [(2, 16, 4, 2, 8), (1, 256, 2, 1, 16), (3, 32, 9, 3, 64)]
DTYPES = [("float32", 1e-6), ("bfloat16", 2e-2)]


def _inputs(B, S, Hq, Hk, D):
    rng = np.random.default_rng(B * S)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hk, D)).astype(np.float32)
    return q, k


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,S,Hq,Hk,D", SHAPES)
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_apply_rope_vs_reference(B, S, Hq, Hk, D, dtype, tol):
    q, k = _inputs(B, S, Hq, Hk, D)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk = jnp.asarray(q, jdt), jnp.asarray(k, jdt)
    jc, js = j_rope_tables(jnp.arange(S), D, dtype=jdt)
    tq, tk = torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt)
    tc, ts = rope_tables(torch.arange(S), D, dtype=tdt)
    before = rope_k.LAUNCHES
    oq, ok = apply_rope(tq, tk, tc, ts)
    assert rope_k.LAUNCHES == before  # the CPU path launches nothing
    assert oq.dtype == tdt and oq.shape == tq.shape and ok.shape == tk.shape
    for use_kernel in (True, False):
        rq, rk = j_apply_rope(jq, jk, jc, js, use_kernel=use_kernel,
                              interpret=True)
        np.testing.assert_allclose(_f32(oq), _f32(rq), atol=tol)
        np.testing.assert_allclose(_f32(ok), _f32(rk), atol=tol)
    # the plain version is exactly the reference formula on each operand
    assert torch.equal(oq, apply_rope_ref(tq, tc, ts))
    assert torch.equal(ok, apply_rope_ref(tk, tc, ts))


@pytest.mark.parametrize("D", [8, 16, 64, 128, 256])
@pytest.mark.parametrize("base", [10000.0, 999999.0, 1000000.0])
def test_rope_tables_vs_reference(D, base):
    S = 256
    jc, js = j_rope_tables(jnp.arange(S), D, base)
    tc, ts = rope_tables(torch.arange(S), D, base)
    assert tc.shape == (S, D // 2) and tc.dtype == torch.float32
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    # the angles, hence the tables, follow the dtype cast
    bc, _ = rope_tables(torch.arange(S), D, base, dtype=torch.bfloat16)
    assert torch.equal(bc, tc.to(torch.bfloat16))


def test_wrapper_refusals():
    q = torch.zeros((2, 4, 3, 8))
    k = torch.zeros((2, 4, 1, 8))
    c = s = torch.zeros((4, 4))
    bad = [
        (q[0], k, c, s),                               # not 4-d
        (q, torch.zeros((2, 5, 1, 8)), c, s),          # S differs
        (q, torch.zeros((2, 4, 1, 6)), c, s),          # D differs
        (torch.zeros((2, 4, 3, 7)), torch.zeros((2, 4, 1, 7)),
         torch.zeros((4, 3)), torch.zeros((4, 3))),    # odd head_dim
        (q, k, torch.zeros((4, 3)), s),                # cos shape
        (q, k, c, torch.zeros((5, 4))),                # sin shape
    ]
    for args in bad:
        with pytest.raises(ValueError):
            rope_k.rope(*args)
    # meta tensors (the dry run) take the plain version's shapes, and
    # are refused for the same bad shapes
    meta = [t.to("meta") for t in (q, k, c, s)]
    qo, ko = rope_k.rope(*meta)
    assert (qo.device.type, qo.shape, ko.shape) == ("meta", q.shape, k.shape)
    with pytest.raises(ValueError):
        rope_k.rope(meta[0][0], *meta[1:])


# ----------------------------------------------------- the gradient ----

def _grad_case(B, S, Hq, Hk, D, dtype, offset, device="cpu"):
    """Inputs (q an ``offset``-element view into its buffer when
    ``offset``), tables and upstream gradients for one case."""
    tdt = getattr(torch, dtype)
    q, k = (torch.from_numpy(x).to(device, tdt)
            for x in _inputs(B, S, Hq, Hk, D))
    if offset:
        buf = torch.empty(q.numel() + offset, dtype=tdt, device=device)
        buf[offset:].copy_(q.reshape(-1))
        q = buf[offset:].view(q.shape)
    c, s = rope_tables(torch.arange(S, device=device), D, dtype=tdt)
    rng = np.random.default_rng(S + D)
    gq, gk = (torch.from_numpy(rng.standard_normal(t.shape).astype(
        np.float32)).to(device, tdt) for t in (q, k))
    return q, k, c, s, gq, gk


def _autograd_of_plain(q, k, c, s, gq, gk):
    q, k = q.detach().requires_grad_(True), k.detach().requires_grad_(True)
    return torch.autograd.grad(
        (apply_rope_ref(q, c, s), apply_rope_ref(k, c, s)), (q, k),
        (gq, gk))


def _through_wrapper(q, k, c, s, gq, gk):
    q, k = q.detach().requires_grad_(True), k.detach().requires_grad_(True)
    return torch.autograd.grad(apply_rope(q, k, c, s), (q, k), (gq, gk))


@pytest.mark.parametrize("B,S,Hq,Hk,D,offset", [
    (2, 16, 4, 2, 8, 0), (1, 256, 2, 1, 16, 0), (3, 32, 9, 3, 64, 0),
    (2, 16, 4, 2, 10, 0), (4, 33, 8, 2, 128, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_equals_autograd_of_the_plain_version(B, S, Hq, Hk, D,
                                                       offset, dtype):
    q, k, c, s, gq, gk = _grad_case(B, S, Hq, Hk, D, dtype, offset)
    want = _autograd_of_plain(q, k, c, s, gq, gk)
    before = rope_k.LAUNCHES
    got = _through_wrapper(q, k, c, s, gq, gk)
    assert rope_k.LAUNCHES == before  # the CPU path launches nothing
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # an output left unused contributes a zero gradient
    qq = q.detach().requires_grad_(True)
    oq, _ = apply_rope(qq, k, c, s)
    (g,) = torch.autograd.grad(oq, qq, gq)
    assert torch.equal(g, want[0])


def _rotate_emulated(x, c, s, inverse):
    """``rope.cu::rotate`` on whole head vectors, element by element as
    the kernel computes: the tables' ``s`` negated when ``inverse``, each
    product rounded to the dtype, then one float32 subtraction or
    addition rounded when stored."""
    dt = x.dtype
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c, s = c[:, None, :].float(), s[:, None, :].float()
    if inverse:
        s = -s
    rnd = lambda v: v.to(dt).float()  # noqa: E731
    a, b, d, e = rnd(x1 * c), rnd(x2 * s), rnd(x1 * s), rnd(x2 * c)
    return torch.cat([(a - b).to(dt), (d + e).to(dt)], dim=-1)


@pytest.mark.parametrize("shape", [(3, 32, 9, 3, 64), (8, 1, 16, 1, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_kernels_inverse_rotation_is_the_gradient(shape, dtype):
    """At a GQA shape and at MLA's decode shape (16 query heads' rope
    tails and one shared key head)."""
    q, k, c, s, gq, gk = _grad_case(*shape, dtype, 0)
    want = _autograd_of_plain(q, k, c, s, gq, gk)
    assert torch.equal(_rotate_emulated(gq, c, s, True), want[0])
    assert torch.equal(_rotate_emulated(gk, c, s, True), want[1])
    assert torch.equal(_rotate_emulated(q, c, s, False),
                       apply_rope_ref(q, c, s))
    # both paths read sin negated under inverse, and the entries take it
    assert CU.count("inverse ? -s[e] : s[e]") == 1
    assert CU.count("inverse ? -sn : sn") == 1
    assert CU.count("int D, int inverse, void* stream)") == 2


# ------------------------------------------- the kernel's address map ----

# (B, S, Hq, Hk, D) walked by the emulation: the decode shape of the
# served model, a prefill and a ragged one cut in S, the scalar-path head
# dim, llama's and gemma3's head dims with their head layouts cut, and
# DeepSeek-V2-Lite's MLA decode (one key head shared by 16 query heads)
MAP_SHAPES = {"decode": (8, 1, 9, 3, 64), "prefill": (2, 512, 9, 3, 64),
              "ragged": (3, 37, 9, 3, 64), "D10": (2, 16, 4, 2, 10),
              "D128": (1, 64, 16, 8, 128), "D256": (2, 32, 8, 4, 256),
              "mla_decode": (8, 1, 16, 1, 64)}


def _source_vec(elt):
    """Pairs a 16-byte chunk in ``rope.cu`` for an element size."""
    trait = {4: "F32", 2: "BF16"}[elt]
    body = CU[CU.index(f"struct {trait} {{"):]
    return int(re.search(r"constexpr int kVec = (\d+);", body).group(1))


def item_map(B, S, Hq, Hk, D, n, mutation=None):
    """The kernel's ``locate`` for every item: ``(is_q, x, tab)``, where
    an item covers ``n`` consecutive pairs (``kVec`` on the vector path,
    1 on the scalar one), ``x`` is the element offset of its first x1 in
    q or k and ``tab`` that of its first c in the tables.  ``mutation``
    breaks the map for the test that the walk catches it: "chunk_short"
    drops a head half's last item, "swap_qk" swaps q's and k's head
    counts (``Hq`` for ``Hk`` and back) in the map."""
    half = D // 2
    per = half // n - (mutation == "chunk_short")
    heads = Hq + Hk
    t = torch.arange(B * S * heads * per)
    j, u = t % per, t // per
    h, r = u % heads, u // heads
    pos = r % S
    if mutation == "swap_qk":
        is_q = h < Hk
        head = torch.where(is_q, r * Hk + h, r * Hq + (h - Hk))
    else:
        is_q = h < Hq
        head = torch.where(is_q, r * Hq + h, r * Hk + (h - Hq))
    return is_q, head * D + j * n, pos * half + j * n


def walk(B, S, Hq, Hk, D, n, mutation=None):
    """Run the map over tagged inputs, as the kernel's threads would, and
    return, for q's and k's outputs, each element's write count and the
    tags of the x1, x2 and table elements it was computed from.  A tag is
    the element's flat offset, plus ``OFF`` for k."""
    OFF = 1 << 40
    half = D // 2
    is_q, x, tab = item_map(B, S, Hq, Hk, D, n, mutation)
    lane = torch.arange(n)
    x1 = x[:, None] + lane                   # (items, n) element offsets
    tb = (tab[:, None] + lane).reshape(-1)
    src = torch.where(is_q, 0, OFF)[:, None]
    outs = {}
    for name, H, sel in (("q", Hq, is_q), ("k", Hk, ~is_q)):
        numel = B * S * H * D
        count = torch.zeros(numel, dtype=torch.int64)
        tags = torch.full((3, numel), -1, dtype=torch.int64)
        e1, s = x1[sel].reshape(-1), src[sel].expand(-1, n).reshape(-1)
        t1 = tb.reshape(-1, n)[sel].reshape(-1)
        # first half out = x1*c - x2*s, second half out = x1*s + x2*c
        for dst in (e1, e1 + half):
            ok = (dst >= 0) & (dst < numel)
            count.index_add_(0, dst[ok], torch.ones_like(dst[ok]))
            tags[0, dst[ok]] = (e1 + s)[ok]
            tags[1, dst[ok]] = (e1 + half + s)[ok]
            tags[2, dst[ok]] = t1[ok]
        outs[name] = count, tags, H
    return outs


def _expected_tags(B, S, H, D, off):
    half = D // 2
    f = torch.arange(B * S * H * D)
    i = f % D
    first = i < half
    x1 = torch.where(first, f, f - half)
    pos = (f // (H * D)) % S
    return x1 + off, x1 + half + off, pos * half + torch.where(
        first, i, i - half)


def _walk_ok(shape, n, mutation=None):
    B, S, Hq, Hk, D = shape
    for name, (count, tags, H) in walk(B, S, Hq, Hk, D, n,
                                       mutation).items():
        want = _expected_tags(B, S, H, D, 0 if name == "q" else 1 << 40)
        if not (torch.equal(count, torch.ones_like(count))
                and all(torch.equal(tags[a], want[a]) for a in range(3))):
            return False
    return True


@pytest.mark.parametrize("label", list(MAP_SHAPES))
@pytest.mark.parametrize("elt", [4, 2])
def test_item_map_writes_every_pair_once_from_its_inputs(label, elt):
    shape = MAP_SHAPES[label]
    D = shape[-1]
    n = _source_vec(elt)
    assert n == rope_k.VECTOR_BYTES // elt
    # the vector path where the head half is whole chunks, else scalar;
    # the scalar map is walked at every shape (a misaligned view)
    if rope_k.vector_path(D, elt, [0]):
        assert _walk_ok(shape, n)
        assert not _walk_ok(shape, n, "chunk_short")
        assert not _walk_ok(shape, n, "swap_qk")
    else:
        assert label == "D10"
    assert _walk_ok(shape, 1)
    assert not _walk_ok(shape, 1, "chunk_short")
    assert not _walk_ok(shape, 1, "swap_qk")


@pytest.mark.parametrize("D,elt,want", [
    (8, 4, True), (8, 2, False), (10, 4, False), (10, 2, False),
    (16, 2, True), (20, 4, False), (24, 4, True), (24, 2, False),
    (48, 2, True), (64, 4, True), (64, 2, True), (128, 2, True),
    (256, 4, True), (256, 2, True)])
def test_vector_path_rule(D, elt, want):
    assert rope_k.vector_path(D, elt, [0, 16, 4096, 512, 32, 48]) is want
    # any of the six addresses off 16 bytes takes the scalar path
    for bad in range(6):
        for miss in (elt, 8):
            addrs = [1024] * 6
            addrs[bad] += miss
            assert rope_k.vector_path(D, elt, addrs) is False


def test_misaligned_view_takes_the_scalar_path():
    """A contiguous view one element into its buffer: what the card's
    test hands the kernel."""
    for dtype in (torch.float32, torch.bfloat16):
        buf = torch.zeros(8 * 9 * 64 + 1, dtype=dtype)
        q = buf[1:].view(8, 1, 9, 64)
        assert q.is_contiguous()
        elt = q.element_size()
        assert rope_k.vector_path(64, elt, [0]) is True
        assert rope_k.vector_path(64, elt, [q.data_ptr(), 0]) is False


def test_source_rule_matches_the_wrapper():
    """``rope.cu``'s rule names the same 16 bytes and the same six
    pointers as :func:`vector_path`."""
    body = CU[CU.index("bool vector_path("):CU.index("unsigned grid_for")]
    assert "((D / 2) * elt) % 16 == 0" in body
    assert all(f"aligned16({p})" in body
               for p in ("q", "k", "cos_t", "sin_t", "qo", "ko"))
    assert "& 15u" in CU


# ------------------------------------------------- cached table rows ----

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("base", [10000.0, 1000000.0])
@pytest.mark.parametrize("D", [10, 16, 64, 128, 256])
def test_cached_rows_equal_fresh_tables(monkeypatch, dtype, base, D):
    monkeypatch.setattr(attention, "_ROPE", {})
    first = attention._ROPE_ROWS
    for start, count in ((0, 1), (5, 1), (0, 37), (first - 1, 1),
                         (first, 1), (first - 3, 9), (3 * first + 7, 1),
                         (300, first), (0, 4 * first + 1)):
        c, s = attention.rope_rows(start, count, D, base, dtype,
                                   torch.device("cpu"))
        fc, fs = rope_tables(torch.arange(start, start + count), D, base,
                             dtype=dtype)
        assert c.is_contiguous() and s.is_contiguous()
        assert c.dtype == dtype and c.shape == (count, D // 2)
        assert torch.equal(c, fc) and torch.equal(s, fs)
    (tabs,) = attention._ROPE.values()
    assert tabs[0].shape[0] == 8 * first  # doubled to cover 4*first + 1


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma3-4b",
                                  "deepseek-v2-lite-16b"])
def test_decode_builds_no_tables_after_its_first_step(monkeypatch, arch):
    """``rope_tables`` runs in the first decode step only (once a base),
    and the tokens and logits equal those of tables built afresh in every
    layer of every step."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(4))
    prompts = [[1, 2, 3], [7, 8], [9, 4, 5, 6]]
    built = []
    fresh = attention.rope_tables

    def counted(*args, **kw):
        built.append(steps[0])
        return fresh(*args, **kw)

    def run():
        eng = ServeEngine(model, cfg, batch=4, max_len=32)
        log, step = [], eng._step

        def logged(*args):
            logits, cache = step(*args)
            log.append(logits)
            steps[0] += 1
            return logits, cache

        eng._step = logged
        return eng.generate(prompts, max_new=6), log, eng.steps

    steps = [0]
    monkeypatch.setattr(attention, "_ROPE", {})
    monkeypatch.setattr(attention, "rope_tables", counted)
    outs, logits, n = run()
    assert n == 9 and built and set(built) == {0}
    assert len(built) == len({model._attn_args(kind)[1]
                              for kind, _ in model.kinds})
    # the parent's way: a table for the step's position in every layer
    monkeypatch.setattr(attention, "rope_rows", lambda start, count, D,
                        base, dtype, device: fresh(
                            torch.arange(start, start + count,
                                         device=device), D, base,
                            dtype=dtype))
    steps[0], built[:] = 0, []
    want, want_logits, _ = run()
    assert len(built) == 0  # the patched rows call the unpatched build
    assert outs == want
    assert all(torch.equal(a, b) for a, b in zip(logits, want_logits))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _kernel_rule(*tensors):
    """``rope.cu``'s own path rule for these tensors, through its C entry
    ``rope_vector_path``."""
    from repro_torch.kernels import _build
    fn = _build.load().rope_vector_path
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    q = tensors[0]
    return bool(fn(*(t.data_ptr() for t in tensors), q.shape[-1],
                   q.element_size()))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,Hq,Hk,D,offset", [
    (8, 1, 9, 3, 64, 0), (8, 1, 9, 3, 64, 1), (8, 300, 9, 3, 64, 0),
    (3, 32, 9, 3, 64, 0), (2, 16, 4, 2, 8, 0), (2, 16, 4, 2, 10, 0),
    (1, 4096, 64, 8, 128, 0), (8, 512, 8, 4, 256, 0), (4, 33, 8, 2, 128, 1),
    (2, 7, 4, 2, 256, 1), (8, 1, 16, 1, 64, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_bitwise_vs_plain_on_the_card(B, S, Hq, Hk, D, offset, dtype):
    """``offset`` 1 hands the kernel q as a contiguous view one element
    into its buffer, which takes the scalar path."""
    dev = _cuda()
    tdt = getattr(torch, dtype)
    q, k = (torch.from_numpy(x).to(dev, tdt) for x in _inputs(B, S, Hq, Hk, D))
    if offset:
        buf = torch.empty(q.numel() + offset, device=dev, dtype=tdt)
        buf[offset:].copy_(q.reshape(-1))
        q = buf[offset:].view(q.shape)
        assert q.is_contiguous() and q.data_ptr() % 16
    c, s = rope_tables(torch.arange(S, device=dev), D, dtype=tdt)
    before = rope_k.LAUNCHES
    paths = dict(rope_k.PATH_LAUNCHES)
    oq, ok = rope_k.rope(q, k, c, s)
    torch.cuda.synchronize()
    assert rope_k.LAUNCHES == before + 1
    assert torch.equal(oq, apply_rope_ref(q, c, s))
    assert torch.equal(ok, apply_rope_ref(k, c, s))
    path = "vector" if rope_k.vector_path(
        D, q.element_size(), [t.data_ptr() for t in (q, k, c, s, oq, ok)]) \
        else "scalar"
    assert path == ("vector" if _kernel_rule(q, k, c, s, oq, ok)
                    else "scalar")
    if offset or D == 10:
        assert path == "scalar"
    assert rope_k.PATH_LAUNCHES[path] == paths[path] + 1
    assert sum(rope_k.PATH_LAUNCHES.values()) == sum(paths.values()) + 1
    with pytest.raises(TypeError):
        rope_k.rope(q.half(), k.half(), c.half(), s.half())
    with pytest.raises(ValueError, match="contiguous"):
        qt = q.transpose(2, 3).contiguous().transpose(2, 3)
        rope_k.rope(qt, k, c, s)
    assert rope_k.LAUNCHES == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,Hq,Hk,D,offset", [
    (8, 1, 9, 3, 64, 0), (8, 300, 9, 3, 64, 0), (8, 300, 9, 3, 64, 1),
    (2, 16, 4, 2, 10, 0), (1, 1024, 9, 3, 64, 0), (4, 33, 8, 2, 128, 1),
    (8, 1, 16, 1, 64, 0), (4, 128, 16, 1, 64, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_backward_bitwise_vs_autograd_on_the_card(B, S, Hq, Hk, D,
                                                         offset, dtype):
    """The backward is one launch of the kernel, bit for bit autograd of
    the plain version on the card, on the path the shape names."""
    dev = _cuda()
    q, k, c, s, gq, gk = _grad_case(B, S, Hq, Hk, D, dtype, offset, dev)
    want = _autograd_of_plain(q, k, c, s, gq, gk)
    qq, kk = q.detach().requires_grad_(True), k.detach().requires_grad_(True)
    oq, ok = apply_rope(qq, kk, c, s)
    before = rope_k.LAUNCHES
    got = torch.autograd.grad((oq, ok), (qq, kk), (gq, gk))
    torch.cuda.synchronize()
    assert rope_k.LAUNCHES == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))

