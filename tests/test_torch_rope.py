"""Port parity of the fused RoPE module against the reference.

On the CPU the port's ``apply_rope`` runs its plain version, exactly the
reference's ``apply_rope_ref`` on q and on k; it is held against the
reference's fused Pallas kernel (interpret mode) and its jnp reference,
at the shapes of ``tests/test_kernels.py::test_rope_kernel_vs_ref``:
float32 to 1e-6 (XLA on the CPU may contract ``x1*c - x2*s`` into a
fused multiply-add, and ``cos``/``sin`` differ by an ulp between the
libraries), bfloat16 to 2e-2 (XLA keeps the bf16 products in float32).

The test marked ``gpu`` holds the CUDA kernel against its plain version
on the card bit for bit in both dtypes; it decides inside the test
whether a card is present.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rope.ops import apply_rope as j_apply_rope
from repro.kernels.rope.ops import rope_tables as j_rope_tables
from repro_torch.kernels.rope import kernel as rope_k
from repro_torch.kernels.rope.ops import (apply_rope, apply_rope_ref,
                                          rope_tables)

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
    meta = [t.to("meta") for t in (q, k, c, s)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        rope_k.rope(*meta)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,Hq,Hk,D", [(8, 1, 9, 3, 64), (8, 300, 9, 3, 64),
                                         (3, 32, 9, 3, 64), (2, 16, 4, 2, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_bitwise_vs_plain_on_the_card(B, S, Hq, Hk, D, dtype):
    dev = _cuda()
    tdt = getattr(torch, dtype)
    q, k = (torch.from_numpy(x).to(dev, tdt) for x in _inputs(B, S, Hq, Hk, D))
    c, s = rope_tables(torch.arange(S, device=dev), D, dtype=tdt)
    before = rope_k.LAUNCHES
    oq, ok = rope_k.rope(q, k, c, s)
    torch.cuda.synchronize()
    assert rope_k.LAUNCHES == before + 1
    assert torch.equal(oq, apply_rope_ref(q, c, s))
    assert torch.equal(ok, apply_rope_ref(k, c, s))
    with pytest.raises(TypeError):
        rope_k.rope(q.half(), k.half(), c.half(), s.half())
    with pytest.raises(ValueError, match="contiguous"):
        qt = q.transpose(2, 3).contiguous().transpose(2, 3)
        rope_k.rope(qt, k, c, s)
    assert rope_k.LAUNCHES == before + 1
