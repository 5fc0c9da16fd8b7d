"""Port parity of ``repro_torch.parallel.compression`` against the reference.

The int8 wire format (``quantize_for_allreduce`` and its inverse), the
error feedback and the wire accounting equal the reference's bit for bit
on the same numpy inputs; the low-rank code (``compress_lowrank`` on the
port's ``svd_givens``) agrees with the reference's within 1e-5 of the
input's scale.  ``compressed_psum`` runs on 2 gloo ranks
(``tests/_torch_psum_ranks.py``: ``file://`` rendezvous, 60 s group
timeouts, the ranks killed after 300 s or the first failure, as
``tests/test_torch_dist.py`` runs its ranks): each rank's result equals
the sum of the dequantized shards.  Then the 6 tests of
``tests/test_compression.py`` with the reference's bars.
"""
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel import compression as jc
from repro_torch.parallel import (compress_lowrank, decompress_lowrank,
                                  dequantize_after_allreduce,
                                  error_feedback_update,
                                  lowrank_error_feedback, lowrank_wire_bytes,
                                  quantize_for_allreduce, svd_lowrank,
                                  wire_bytes)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 2
SECONDS = 300


def _x(shape, seed, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("shape", [(777,), (256,), (33, 40), (2, 3, 5)])
def test_wire_format_equals_reference(shape):
    x = _x(shape, 1)
    jq, js = jc.quantize_for_allreduce(jnp.asarray(x))
    q, s = quantize_for_allreduce(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    y = dequantize_after_allreduce(q, s, x.shape)
    assert np.array_equal(y.numpy(), np.asarray(
        jc.dequantize_after_allreduce(jq, js, x.shape)))
    assert wire_bytes(torch.from_numpy(x)) == jc.wire_bytes(jnp.asarray(x))
    r = _x(shape, 2, 0.01)
    sent, res = error_feedback_update(torch.from_numpy(x),
                                      torch.from_numpy(r))
    j_sent, j_res = jc.error_feedback_update(jnp.asarray(x), jnp.asarray(r))
    assert np.array_equal(sent.numpy(), np.asarray(j_sent))
    assert np.array_equal(res.numpy(), np.asarray(j_res))


def test_lowrank_code_matches_reference():
    W = _x((24, 18), 3, 1.0)
    jP, jQ = jc.compress_lowrank(jnp.asarray(W), 5)
    P, Q = compress_lowrank(torch.from_numpy(W), 5)
    assert P.shape == (24, 5) and Q.shape == (5, 18)
    np.testing.assert_allclose(decompress_lowrank(P, Q).numpy(),
                               np.asarray(jP @ jQ), atol=1e-5)
    assert lowrank_wire_bytes((24, 18), 5) == jc.lowrank_wire_bytes(
        (24, 18), 5)


def test_compressed_psum_on_two_gloo_ranks(tmp_path):
    import time
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_psum_ranks import inputs
    from test_torch_dist import _wait
    env = dict(os.environ, REPRO_PLAN_CACHE="off",
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_psum_ranks.py"),
         str(r), str(WORLD), str(tmp_path / "rendezvous"), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    _wait(procs, time.monotonic() + SECONDS)
    shards = [inputs(r) for r in range(WORLD)]
    for i in range(len(shards[0])):
        want = sum(dequantize_after_allreduce(
            *quantize_for_allreduce(s[i]), s[i].shape) for s in shards)
        for r in range(WORLD):
            out = torch.load(tmp_path / f"psum{r}.pt")
            assert torch.equal(out["x"][i], shards[r][i])
            assert torch.equal(out["group"][i], want)
            assert torch.equal(out["mesh"][i], want)


# ------------------------- mirrors of tests/test_compression.py (6 of 6) ----

def test_wire_roundtrip_error_bound():
    x = torch.from_numpy(_x((777,), 0))
    q, s = quantize_for_allreduce(x)
    y = dequantize_after_allreduce(q, s, x.shape)
    err = (y - x).abs().numpy()
    assert err.max() <= float(x.abs().max()) / 127 + 1e-6


def test_wire_bytes_4x_smaller():
    x = torch.zeros((1 << 20,), dtype=torch.float32)
    assert wire_bytes(x) < x.numel() * 4 / 3.8


def test_error_feedback_converges():
    """EF compensates quantization bias: the cumulative applied update
    tracks the cumulative true gradient."""
    rng = np.random.default_rng(1)
    residual = torch.zeros((512,))
    total_true = np.zeros((512,))
    total_sent = np.zeros((512,))
    for _ in range(50):
        g = torch.from_numpy((rng.standard_normal((512,)) * 0.01).astype(
            np.float32))
        sent, residual = error_feedback_update(g, residual)
        total_true += g.numpy()
        total_sent += sent.numpy()
    drift = np.abs(total_true - total_sent).max()
    assert drift <= float(residual.abs().max()) + 1e-6


def test_lowrank_exact_on_lowrank_input():
    """A rank-r matrix round-trips through the rank-r wire format."""
    rng = np.random.default_rng(3)
    W = rng.standard_normal((24, 4)) @ rng.standard_normal((4, 18))
    W = torch.from_numpy(W.astype(np.float32))
    P, Q = compress_lowrank(W, 4)
    assert P.shape == (24, 4) and Q.shape == (4, 18)
    np.testing.assert_allclose(decompress_lowrank(P, Q).numpy(), W.numpy(),
                               atol=1e-4)
    assert lowrank_wire_bytes(tuple(W.shape), 4) < W.numel() * 4


def test_lowrank_truncation_is_best_approximation():
    """Truncated svd_givens matches numpy's optimal rank-r error."""
    rng = np.random.default_rng(5)
    W = rng.standard_normal((20, 15)).astype(np.float32)
    r = 5
    U, s, Vt = svd_lowrank(torch.from_numpy(W), r)
    approx = U.double().numpy() @ np.diag(s.double().numpy()) \
        @ Vt.double().numpy()
    sr = np.linalg.svd(W.astype(np.float64), compute_uv=False)
    err = np.linalg.norm(W - approx)
    best = np.linalg.norm(sr[r:])
    assert err <= best * (1 + 1e-3) + 1e-5


def test_lowrank_error_feedback_tracks_gradient():
    rng = np.random.default_rng(7)
    residual = torch.zeros((16, 12))
    total_true = np.zeros((16, 12))
    total_sent = np.zeros((16, 12))
    for _ in range(10):
        g = torch.from_numpy((rng.standard_normal((16, 12)) * 0.1).astype(
            np.float32))
        sent, residual = lowrank_error_feedback(g, residual, rank=3)
        total_true += g.numpy()
        total_sent += sent.numpy()
    drift = np.abs(total_true - total_sent).max()
    assert drift <= float(residual.abs().max()) + 1e-5
