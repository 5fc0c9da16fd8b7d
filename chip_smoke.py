#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py

At the paper's own workload (``m = n = 3840``, ``k = 180`` waves,
float32) it builds the CUDA kernels from ``src/repro_torch/csrc`` and
holds the wavefront and accumulated kernels against their plain PyTorch
versions on the card (the wavefront kernel bit for bit, also on the
ragged and small problems below, one launch an application; the
accumulated kernel at 128/128 and 64/64 tiles, its tile factors built by
one fused batched launch a band and held to the eager ones under ``==``;
no ptxas spill); it then runs the main path ``seq.plan(like=A).apply(A)``
with ``method="auto"`` (a pick other than ``cuda_wave`` is held to it,
bit for bit for ``cuda_batched``; ``cuda_wave`` is held bit for bit to
the blocked plain version), a ragged signed problem through both tiled
kernels and a gradient, counting the kernel launches of that run, and
times ``auto``'s pick against every rotation kernel at the paper shape,
one ``1024 x 1024`` target and a shared-sequence batch of 8 paper-shape
targets.  Then the paper's own sweep (``configs/rotseq_paper.py``:
``m = n`` in 240 .. 3840 at ``k = 180``): each rotation kernel's
``plan.apply``, ``auto``'s pick, ``torch.matmul`` and the bound a size,
every kernel held to its plain version up to 1920.  Then the serving
path at a realistic bucket: 16 requests of ``m = n = 1024`` float32
targets, each with its own sequence of 33-64 waves padded to 64.  The
fused batched kernel is held against its plain version, on the
bucket's ``seq.T`` staircases and against per-request ``cuda_wave``,
and its ptxas report must show no spills; then
``RotationService`` (with the reference's mixed demo stream of plain,
signed and reflector requests), ``apply_batched`` on the ``seq.T``
staircases, a gradient through ``apply_batched`` and ``StreamEngine``
run with the launch counts set to 0 just before and read just after.
Then the eigensolver path (``repro_torch.eig``, paper SS5.1), float32,
each part with the launch counts set to 0 just before it:
each solver run once with its stages timed inside that run:
``eigh_givens`` at ``n = 1024`` (QR, ``k_delay = 32``, ``auto``) against
float64 ``np.linalg.eigvalsh`` (eigenvalues, orthogonality, residual),
its flushes timed back to back on the device, and ``torch.linalg.eigh``
timed beside it; ``svd_givens`` of a ``(1024, 512)`` matrix against
``np.linalg.svd``; Jacobi at ``n = 512`` with the reference's residual
bar; and a batched buffer of 8 row-permuted identities fed the QR
recording, each slice held to the 2D result.  Every accumulator the
solvers flushed is held to the same recording flushed through the
pick's plain version on the card, and every part fails if the picked
kernel never launched.
Then measured autotune (``select_plan(..., autotune=True)``) at the
planner's three points, the serving bucket and the eig flush, every
kernel plan a candidate: the model's pick, each candidate's ms, the
pick, the kernels' launches and the seconds autotune took; the pick's
result held to ``cuda_wave``'s and its application within
``AUTOTUNE_SLACK`` of the fastest kernel's; no candidate skipped.  Then
the persisted store (one entry a measured key; loaded again as
``persisted``, in this process and a fresh one, with no new measurement;
a nearby shape borrows the paper shape's plan), and
``RotationService``/``DelayedRotationBuffer(autotune=True)`` against
their ``autotune=False`` results.  The plan cache points at a fresh
file for the run (``REPRO_PLAN_CACHE``), so no plan persisted before
changes a pick.
Then observability (``repro_torch.obs``, after autotune and before the
LM phases): with obs on, one application at the paper shape under
``cuda_wave``, ``cuda_mxu`` 64/64 and ``cuda_batched``, the serving
bucket through ``RotationService`` and one eig flush ``(1024, 1024,
32)``, each case's roofline ledger a backend (the model's seconds from
the port's H100 record against seconds measured between two
synchronizes: ``model_fraction``), the obs launch counters held to the
kernels' ``LAUNCHES``, obs-on outputs to obs-off ones, and no
``timing.sync`` with obs off; obs on against off back to back at one
``1024 x 1024`` target; and the launcher with ``--metrics-json`` and
``--trace`` in a child process, its ``serve.*`` counters held to the
service's ``stats`` and its trace to the spans of a served run.
Then sharded execution (``repro_torch.dist``) at one device, over a
one-rank NCCL group and a ``(1, 1)`` ``("data", "model")`` mesh: the
paper shape row-sharded under ``cuda_batched`` (one launch, bit for bit
to the replicated plan, both timed), ``auto`` (replicated, with
``seq.plan``'s pick), the serving bucket through ``apply_batched`` (one
launch) and ``RotationService(mesh=)``, an eig flush through
``DelayedRotationBuffer(mesh=)``, the column pipeline (``blocked`` at
``1024 x 1024``, ``k = 32``, bit for bit; ``accumulated`` at the paper
shape, within ``MXU_TOL``), one sharded application with obs on, and the
H100 record's sharded-or-replicated decision at eight devices.
Then the LM serving path at the full width of SmolLM-135M
(seeded random weights, bf16 activations): the fused RoPE kernel is held bit for bit
against its plain version at every shape of ``ROPE_SHAPES`` in float32
and bfloat16, each on the path (vector or scalar) it names, and timed on
the device by CUPTI beside the launch floor and on the host a wrapper
call; ``ServeEngine`` greedy-decodes 8 prompts with the RoPE launches
counted (one a layer a decode step) and the ``rope_tables`` calls
counted (none after the first step), and its decode step is profiled;
and the same float32 model decodes on the card and on the host, whose
tokens must agree.
Then the MoE family: DeepSeek-V2-Lite at full width (multi-head latent
attention, 64 routed experts top-6 and 2 shared), its depth cut to the
dense first layer and 3 MoE layers, served through ``ServeEngine`` as
SmolLM is (MLA's RoPE one kernel launch a layer a step, at the
``mla_decode`` shape the rope lines hold bit for bit; tokens/s, ms a
step, the profiled step, peak memory); its float32 twin of the dense
layer and one MoE layer decodes on the card and on the host (equal
tokens, logits within ``PARITY_RTOL``); and one float32 train step of
its ``reduced()`` config on both (loss and gradients within
``TRAIN_PARITY_TOL``).  Each parity twin reaches the card through
``convert.lm_params_from_reference``.
Then the recurrent and encoder-decoder families, served as SmolLM is:
RecurrentGemma-9B at full width, its depth cut to one (R, R, A)
repetition and the config's 2-block recurrent tail (the local
attention's RoPE one kernel launch a step at the ``griffin_decode``
shape the rope lines hold bit for bit); Mamba2-370M and Whisper-large-v3
with nothing cut and no RoPE launch, Whisper's encoder prefill on 8 x
1500 stub frames timed apart from its decode steps.  Each has a float32
twin decoding on the card and on the host (equal tokens, logits within
``PARITY_RTOL``; Whisper's on 2 x 300 frames), Mamba2's also holding its
chunked forward to step-by-step decode over two chunks of 256 and one
backward at that chunk to finite gradients; one float32 train step of
each ``reduced()`` config on both; and a few ``SoapGivens`` steps on
reduced Mamba2, whose refreshes launch the rotation kernels.
Then training (``repro_torch.{train,optim,data,ckpt,parallel}``): the
RoPE kernel's backward (one launch rotating by ``-sin``) held bit for bit
to autograd of its plain version at every ``ROPE_SHAPES`` case, timed by
CUPTI beside the forward; SmolLM-135M at full width, seeded float32
master weights and bf16 compute, 8 AdamW steps of 4 x 1024 tokens through
``TrainLoop`` (losses finite and falling, two RoPE launches a layer a
step, every ``wq``/``wk`` gradient nonzero, ms a step, tokens/s, peak
memory, one profiled step), then 4 steps of ``adamw_q8``; one float32
step's loss and gradients on the card against the host's; the
reference launcher's ``--reduced --optimizer soap_givens`` example for
20 steps, each refresh's bases held to the pick's plain version and
orthogonal, and one ``solver="qr"`` refresh; ``compress_lowrank`` of a
``(1024, 512)`` gradient at rank 32 against ``np.linalg.svd``'s optimum
and ``compressed_psum`` over a one-rank NCCL group; the full-width
params and AdamW state through ``CheckpointManager`` bit for bit and a
loop resumed at step 4 against an uninterrupted one;
``python -m repro_torch.launch.train`` in a child process; and the
full-width SmolLM-135M step under a ``(1, 1)`` ``("data", "model")``
mesh over a one-rank NCCL group (``DTensor`` parameters, optimizer state
and batches placed by ``launch.specs.sharding_trees``), held to the step
without a mesh (losses, the first step's gradients, RoPE launches), ms a
step both ways.
Then the dry run (``repro_torch.launch.dryrun``): the records of
SmolLM-135M's train step and decode step, built on the meta device,
held to the same steps run on the card under the step analysis
(argument bytes, dot flops and flops equal, the record's peak against
``max_memory_allocated``, RoPE launched), with the three roofline terms,
``roofline_fraction`` and ``mfu`` beside the measured ms a step, and the
H100 record's ``hbm_bytes`` against the card's memory.
Every phase prints one JSON line and raises on failure.  The line before
the last holds the card's name and power limit, the last ``{"ok": true,
"device": {...}}``.  Exits non-zero, with no result, when there is no
CUDA device or no ``src/repro_torch`` beside this script.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0

# H100 SXM peaks (NVIDIA data sheet): float32 off the tensor cores, HBM3
PEAK_F32 = 67e12
PEAK_BW = 3.35e12

M = N = 3840
K = 180
# the wavefront kernel takes its compiled band and no column tiles
WAVE_TILES = dict(k_b=16)
MXU_TILES = dict(n_b=128, k_b=128)
# the accumulated kernel's tiles timed at this shape; the main path's
# cuda_mxu plan takes the one whose application was fastest in this run
MXU_SWEEP = [MXU_TILES, dict(n_b=64, k_b=64)]
# each kernel's tiles at this shape (cuda_mxu's set by the rotseq_mxu
# phase)
BEST_TILES = {"cuda_wave": WAVE_TILES, "cuda_mxu": None, "cuda_batched": {}}
# the kernel each rotation backend launches
KERNEL_OF = {"cuda_wave": "rotseq_wave", "cuda_mxu": "rotseq_mxu",
             "cuda_batched": "rotseq_batched"}
MXU_TOL = 1e-5     # relative Frobenius error, kernel vs plain version
PLANNER_BATCH = 8  # shared-sequence batch of paper-shape targets
GRAD_TOL = 1e-4    # relative Frobenius error of plan.apply(grad) vs W

# the serving bucket: B requests of (MB, NB) targets, KMIN..KMAX waves
# each, padded to KB
B, MB, NB, KB = 16, 1024, 1024, 64
KMIN, KMAX = 33, 64
STREAM_REQUESTS = 64

# the LM serving path: SmolLM-135M at full width, 8 slots, 4-11 token
# prompts, 32 new tokens each; its float32 twin on the card and the host
LM_ARCH = "smollm-135m"
LM_BATCH, LM_MAX_LEN, LM_MAX_NEW = 8, 128, 32
LM_RUNS = 4   # serving runs timed; the first counts the launches
PROMPT_LEN = (4, 11)
PARITY_BATCH, PARITY_MAX_NEW = 2, 8
PARITY_RTOL = 1e-3   # per step: max|card - host| <= PARITY_RTOL * max|host|
# the MoE serving path: DeepSeek-V2-Lite at full width with its depth cut
# to the dense first layer and 3 MoE layers (all 27 are 15.7 B parameters,
# 62.8 GB of float32 masters: no room left on one card for the parity
# twin), served as the LM path is; its float32 twin keeps the dense layer
# and one MoE layer
MOE_ARCH = "deepseek-v2-lite-16b"
MOE_LAYERS, MOE_PARITY_LAYERS = 4, 2
# the recurrent and encoder-decoder families, served as the LM path is:
# RecurrentGemma-9B at full width, its depth cut to one (R, R, A)
# repetition and the config's own 2-block recurrent tail (all 38 layers
# are 9.4 B parameters, 37.6 GB of float32 masters: too long to draw on
# the host, and no room left for the parity twin); Mamba2-370M and
# Whisper-large-v3 with nothing cut, Whisper on 8 stub frame sequences
# of 1500 (its 30 s encoder length), its parity twin on 2 of 300
HYBRID_ARCH, HYBRID_LAYERS = "recurrentgemma-9b", 5
SSM_ARCH, AUDIO_ARCH = "mamba2-370m", "whisper-large-v3"
AUDIO_FRAMES, AUDIO_PARITY_FRAMES = 1500, 300
SSM_CHUNKS = (2, 512)    # B, S of the card's forward against its decode
SSM_DECODE_RTOL = 1e-3   # max|forward - decode| <= this * max|forward|
SSM_SOAP_STEPS, SSM_SOAP_FREQ = 10, 5
AUDIO_TRAIN = (1, 128, 16)   # batch, frames, decoder tokens
# the training slice: SmolLM-135M at full width, seeded f32 master weights
TRAIN_BATCH, TRAIN_SEQ = 4, 1024   # S = 1024: attention's flash path
# RoPE at the decode shape of the serving run, a prefill and a ragged
# one, the train step's q and k (forward and backward; train_phase holds
# its heads to the config), llama3-405b's heads on one 4096-token
# sequence, gemma3's head dim, a head dim the vector path cannot take,
# the decode shape as a view one element into its buffer, and MLA's
# decode (DeepSeek-V2-Lite's 16 query heads' rope tails and the one key
# head they share; moe_serving_phase holds it to the config), and
# RecurrentGemma's local attention at decode (16 query heads of 256 and
# one key head; hybrid_serving_phase holds it to the config):
# (B, S, Hq, Hk, D)
ROPE_SHAPES = {"decode": (8, 1, 9, 3, 64), "prefill": (8, 2048, 9, 3, 64),
               "ragged": (8, 300, 9, 3, 64),
               "train": (TRAIN_BATCH, TRAIN_SEQ, 9, 3, 64),
               "llama_prefill": (1, 4096, 64, 8, 128),
               "gemma3": (8, 512, 8, 4, 256), "scalar_d10": (2, 16, 4, 2, 10),
               "misaligned": (8, 1, 9, 3, 64),
               "mla_decode": (LM_BATCH, 1, 16, 1, 64),
               "griffin_decode": (LM_BATCH, 1, 16, 1, 256)}
ROPE_OFFSET = {"misaligned": 1}   # elements q starts into its buffer
# the path each shape must take on the card, in both dtypes
ROPE_PATH = {"scalar_d10": "scalar", "misaligned": "scalar"}
ROPE_HOST_CALLS = 400    # wrapper calls a round timed on the host
TRAIN_STEPS, TRAIN_TIMED, TRAIN_Q8_STEPS = 8, 6, 4
TRAIN_LR = 3e-3
TRAIN_PARITY = (1, 128)            # batch, seq of the card/host step
TRAIN_PARITY_TOL = {"loss": 1e-4, "grad": 1e-3}   # relative
MESH_STEPS = 3   # mesh_train: steps timed after a warm one, both ways
SOAP_STEPS, SOAP_FREQ = 20, 10     # the launcher's --reduced example
SOAP_BATCH, SOAP_SEQ = 8, 64
SOAP_ORTH_TOL = 1e-4
LOWRANK_SHAPE, LOWRANK_RANK = (1024, 512), 32
CKPT_BATCH, CKPT_SEQ, CKPT_AT, CKPT_STEPS = 2, 256, 4, 6

# the eigensolver path (paper SS5.1), float32: eigh_givens at the width
# of benchmarks/bench_eig.py's largest size, the SVD of a tall matrix,
# Jacobi at half the width, and a batch of 8 bases fed the QR recording
EIG_N, EIG_K_DELAY = 1024, 32
SVD_SHAPE = (1024, 512)
JACOBI_N, JACOBI_CYCLES = 512, 8
EIG_BATCH = 8
EIG_TOL = 1e-4   # the reference's oracle bars (tests/test_eig.py, n = 256)

# measured autotune: every kernel plan a candidate (cuda_wave's band,
# cuda_mxu's three tile pairs, cuda_batched), the pick at most this much
# slower than the fastest kernel's application, and a shape near the
# paper's that must borrow its measured plan
AUTOTUNE_TOP = 5
AUTOTUNE_SLACK = 1.10
# the check's own timing of each application alone: this many seconds of
# rounds a point.  A host spell slows a host-paced kernel (cuda_mxu's
# factor packing at 1024^2) more than another; 51 rounds (~75 ms at the
# eig flush) once fell inside one and ranked a 3% tie as 15%.
ALONE_SECONDS = 1.0
ALONE_MAX_ROUNDS = 2000
NEIGHBOUR = (3000, 3000, 150)
# the paper's sweep (configs/rotseq_paper.py): every size's kernels held
# to their plain versions up to this one (the main path checks 3840)
PAPER_CHECK_MAX = 1920


def emit(**row):
    print(json.dumps(row), flush=True)


def rel_err(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def max_abs(a, b) -> float:
    return float((a - b).abs().max())


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def time_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean milliseconds of ``fn`` on the card, by CUDA events."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float):
    f, b = flops / PEAK_F32 * 1e3, nbytes / PEAK_BW * 1e3
    return (f, "operations") if f >= b else (b, "bytes")


def ptxas_table(log) -> dict:
    """``{entry function: {registers, spill_stores, spill_loads}}`` from
    ``nvcc -Xptxas -v`` output."""
    table, name = {}, None
    for ln in (log or "").splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", ln)
        if m:
            name = m.group(1)
            table.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            table[name].update(spill_stores=int(m.group(1)),
                               spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            table[name]["registers"] = int(m.group(1))
    return table


def wave_instances(ptxas: dict) -> dict:
    """``{"kb16/w4": report}``: the wavefront kernel's instantiations in
    the ptxas report, by waves a band and warps a block."""
    found = {}
    for name, rep in ptxas.items():
        m = re.search(r"rotseq_wave_kernelILi(\d+)ELi(\d+)E", name)
        if m:
            found[f"kb{m.group(1)}/w{m.group(2)}"] = rep
    return found


def no_spills(regs: dict, kernel: str) -> None:
    check(bool(regs), f"no ptxas report for {kernel}")
    for key, rep in regs.items():
        check(rep.get("spill_stores", 0) == 0
              and rep.get("spill_loads", 0) == 0,
              f"{kernel} {key} spills: {rep}")


def pack_wave(A, C, S, G=None):
    """The wavefront kernel's operands for ``A``: ``(AT, Cw, Sw, Gw)``,
    packed as ``rot_sequence_wave`` packs them."""
    from repro_torch.core.ref import sign_grid
    return (A.t().contiguous(), *(x.t().contiguous()
                                  for x in (C, S, sign_grid(C, False, G))))


def wave_phase(ctx, ptxas: dict) -> dict:
    """Hold ``rotseq_wave`` bit for bit against its plain version at the
    paper shape, the ragged signed shape and the small one; check that an
    application is one launch; time it; fail on a ptxas spill."""
    import torch
    from repro_torch.kernels.limits import WAVE_KB, WAVE_WARPS
    from repro_torch.kernels.rotseq import kernel as wave_k
    from repro_torch.kernels.rotseq.ops import rot_sequence_wave
    from repro_torch.kernels.rotseq.ref import rotseq_wave_ref
    A, C, S = ctx["A"], ctx["C"], ctx["S"]
    args = pack_wave(A, C, S)
    o_k = wave_k.rotseq_wave(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    o_p = rotseq_wave_ref(*args)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    check(torch.equal(o_k, o_p), "rotseq_wave != plain version")
    # the ragged signed problem and the small one, kernel against plain
    for name in ("ragged", "small"):
        X, seq_x = ctx[name]
        a_x = pack_wave(X, seq_x.cos, seq_x.sin, seq_x.sign)
        check(torch.equal(wave_k.rotseq_wave(*a_x), rotseq_wave_ref(*a_x)),
              f"rotseq_wave != plain version on the {name} problem")
    ms = time_ms(lambda: wave_k.rotseq_wave(*args), 5)

    before = wave_k.LAUNCHES
    out_w = rot_sequence_wave(A, C, S)
    torch.cuda.synchronize()
    launches = wave_k.LAUNCHES - before
    check(launches == 1, f"rotseq_wave: {launches} launches an application")
    err_w = max_abs(out_w, o_p.t())
    err_wf = max_abs(out_w, ctx["ref"])
    check(bool(torch.isfinite(out_w).all()), "rotseq_wave: non-finite")
    check(err_w == 0.0 and err_wf == 0.0,
          f"rotseq_wave max|d| {err_w} vs blocked, {err_wf} vs wavefront")
    apply_ms = time_ms(lambda: rot_sequence_wave(A, C, S), 5)
    b_ms, b_by = bound(6.0 * M * (N - 1) * K,
                       4.0 * (2 * M * N + 3 * (N - 1) * K))
    regs = wave_instances(ptxas)
    no_spills(regs, "rotseq_wave")
    emit(phase="rotseq_wave", m=M, n=N, k=K, kb=WAVE_KB, warps=WAVE_WARPS,
         launches=launches, bitwise_vs_plain=["paper", "ragged", "small"],
         max_abs_err_vs_plain=err_w, max_abs_err_vs_wavefront=err_wf,
         ms=ms, plain_ms=plain_ms, apply_ms=apply_ms,
         matmul_ms=ctx["lib_ms"], bound_ms=b_ms, bound_by=b_by, ptxas=regs)
    return dict(
        name="rotseq_wave", route="cuda",
        source="src/repro_torch/csrc/rotseq_wave.cu",
        replaces="src/repro/kernels/rotseq/kernel.py:72",
        max_abs_err=err_w, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=ctx["lib_ms"], tiles=WAVE_TILES)


def mxu_instances(ptxas: dict) -> dict:
    """``{"wp256": report}``: the accumulated kernel's instantiations in
    the ptxas report, by padded width."""
    found = {}
    for name, rep in ptxas.items():
        m = re.search(r"rotseq_mxu_kernelILi(\d+)E", name)
        if m:
            found[f"wp{m.group(1)}"] = rep
    return found


def mxu_tiles(ctx, tiles: dict) -> dict:
    """``rotseq_mxu`` at ``tiles``: one application through the route
    (factors by one ``rotseq_batched`` launch a band, one accumulated
    launch a band) held to the eager plain path and the wavefront; the
    route's factors held to the eager ones under ``==``; the kernel held
    to its plain version on one band; times."""
    import torch
    from repro_torch.core.accumulate import (accumulate_tile_factors,
                                             rot_sequence_accumulated)
    from repro_torch.core.blocked import num_tiles, pack_sheared
    from repro_torch.kernels.rotseq_batched import kernel as batched_k
    from repro_torch.kernels.rotseq_mxu import kernel as mxu_k
    from repro_torch.kernels.rotseq_mxu.ops import (band_factors,
                                                    band_inputs_natural,
                                                    rot_sequence_mxu)
    from repro_torch.kernels.rotseq_mxu.ref import rotseq_mxu_ref
    A, C, S = ctx["A"], ctx["C"], ctx["S"]
    n_b, k_b = tiles["n_b"], tiles["k_b"]
    T = num_tiles(N, n_b, k_b)
    bands = -(-K // k_b)
    before = (mxu_k.LAUNCHES, batched_k.LAUNCHES)
    out_m = rot_sequence_mxu(A, C, S, **tiles)
    torch.cuda.synchronize()
    launches = mxu_k.LAUNCHES - before[0]
    factor_launches = batched_k.LAUNCHES - before[1]
    check(launches == bands and factor_launches == bands,
          f"rotseq_mxu at {tiles}: {launches} accumulated and "
          f"{factor_launches} factor launches for {bands} bands")
    plain_m = rot_sequence_accumulated(A, C, S, **tiles)
    check(bool(torch.isfinite(out_m).all()), "rotseq_mxu: non-finite")
    err_m = rel_err(out_m, plain_m)
    err_m_ref = rel_err(out_m, ctx["ref"])
    check(err_m <= MXU_TOL, f"rotseq_mxu rel err {err_m} > {MXU_TOL}")
    check(err_m_ref <= MXU_TOL, f"rotseq_mxu vs wavefront {err_m_ref}")
    # every band's factors through the route equal the eager ones
    for p0 in range(0, K, k_b):
        Q = band_factors(C, S, p0, k_b, n_b, T)
        check(torch.equal(Q, accumulate_tile_factors(
            *pack_sheared(C, S, p0, k_b, n_b, T))),
              f"route factors != eager factors at band {p0 // k_b}")
    band = pack_sheared(C, S, 0, k_b, n_b, T)
    Q0 = band_factors(C, S, 0, k_b, n_b, T)
    fresh, init = band_inputs_natural(A, k_b, n_b, T)
    o_k = mxu_k.rotseq_mxu(fresh, Q0, init)
    o_p = rotseq_mxu_ref(fresh, Q0, init)
    check(rel_err(o_k, o_p) <= MXU_TOL, "rotseq_mxu band vs plain version")
    ms = time_ms(lambda: [mxu_k.rotseq_mxu(fresh, Q0, init)
                          for _ in range(bands)], 10)
    plain_ms = bands * time_ms(lambda: rotseq_mxu_ref(fresh, Q0, init), 3)
    factors_ms = bands * time_ms(lambda: band_factors(C, S, 0, k_b, n_b,
                                                      T), 5)
    factors_eager_ms = bands * time_ms(
        lambda: accumulate_tile_factors(*band), 2)
    apply_ms = time_ms(lambda: rot_sequence_mxu(A, C, S, **tiles), 5)
    apply_plain_ms = time_ms(
        lambda: rot_sequence_accumulated(A, C, S, **tiles), 2)
    w = n_b + k_b
    b_ms, b_by = bound(2.0 * M * w * w * T * bands, ctx["io_bytes"])
    return dict(launches=launches, factor_launches=factor_launches,
                rel_err_vs_plain=err_m, rel_err_vs_wavefront=err_m_ref,
                max_abs_err_vs_plain=max_abs(out_m, plain_m),
                factors_equal_eager=True, ms=ms, plain_ms=plain_ms,
                factors_ms=factors_ms, factors_eager_ms=factors_eager_ms,
                apply_ms=apply_ms, apply_plain_ms=apply_plain_ms,
                bound_ms=b_ms, bound_by=b_by)


def mxu_phase(ctx, ptxas: dict) -> dict:
    """Hold ``rotseq_mxu`` and its factor route at the paper's tiles
    (128/128) and at 64/64; fail on a ptxas spill.  Returns the kernels
    line's entry (at 128/128) and the tiles whose application was
    fastest (the main path's ``cuda_mxu`` plan)."""
    rows = {f"{t['n_b']}/{t['k_b']}": mxu_tiles(ctx, t) for t in MXU_SWEEP}
    regs = mxu_instances(ptxas)
    no_spills(regs, "rotseq_mxu")
    best = min(MXU_SWEEP, key=lambda t: rows[f"{t['n_b']}/{t['k_b']}"][
        "apply_ms"])
    emit(phase="rotseq_mxu", m=M, n=N, k=K, tol=MXU_TOL, tiles=rows,
         best_tiles=best, matmul_ms=ctx["lib_ms"], ptxas=regs)
    paper = rows[f"{MXU_TILES['n_b']}/{MXU_TILES['k_b']}"]
    return dict(
        name="rotseq_mxu", route="cuda",
        source="src/repro_torch/csrc/rotseq_mxu.cu",
        replaces="src/repro/kernels/rotseq_mxu/kernel.py:52",
        max_abs_err=paper["max_abs_err_vs_plain"], ms=paper["ms"],
        plain_ms=paper["plain_ms"], bound_ms=paper["bound_ms"],
        bound_by=paper["bound_by"], library_ms=ctx["lib_ms"],
        tiles=MXU_TILES, best=best)


def planner_points(ctx, seq) -> dict:
    """The planner's points, ``{label: (sequence, target, batched)}``:
    the paper shape, one seeded ``1024 x 1024`` target at 41 waves and a
    seeded shared-sequence batch of ``PLANNER_BATCH`` paper-shape
    targets."""
    import torch
    from repro_torch import random_sequence
    dev = ctx["A"].device
    gen = torch.Generator().manual_seed(SEED + 8)
    one = torch.randn((1024, 1024), generator=gen).to(dev)
    seq_one = random_sequence(1024, 41, generator=gen, device=dev)
    batch = torch.randn((PLANNER_BATCH, M, N), generator=gen).to(dev)
    return {"paper": (seq, ctx["A"], False),
            "1024^2 k41": (seq_one, one, False),
            f"{PLANNER_BATCH}x{M}^2 shared": (seq, batch, True)}


def planner_phase(ctx, seq) -> None:
    """``auto``'s pick at the planner's points (the tile factors paid once
    for the shared batch), each against every rotation kernel's
    application on the same inputs; a pick's result is held to
    ``cuda_wave``'s (bit for bit, or within ``MXU_TOL`` for
    ``cuda_mxu``)."""
    points = planner_points(ctx, seq)
    rows = {}
    for label, (sq, X, batched) in points.items():
        auto = sq.plan(like=X)
        runs = {"auto": auto}
        for meth in KERNEL_OF:
            runs[meth] = sq.plan(like=X, method=meth, **BEST_TILES[meth])
        call = {name: (lambda pl=pl: pl.apply_batched(X) if batched
                       else pl.apply(X)) for name, pl in runs.items()}
        got, wave = call["auto"](), call["cuda_wave"]()
        if auto.method == "cuda_mxu":
            err = rel_err(got, wave)
            check(err <= MXU_TOL, f"{label}: auto cuda_mxu rel err {err}")
        else:
            err = max_abs(got, wave)
            check(err == 0.0, f"{label}: auto {auto.method} max|d| {err}")
        del got, wave
        ms = {name: time_ms(fn, 3) for name, fn in call.items()}
        best = min((m_ for m_ in ms if m_ != "auto"), key=ms.get)
        rows[label] = dict(auto=auto.method, auto_kwargs=dict(auto.kwargs),
                           err_vs_cuda_wave=err, apply_ms=ms, fastest=best,
                           auto_vs_fastest=ms["auto"] / ms[best])
    del points
    emit(phase="planner", points=rows)


def paper_sweep_phase(dev, kernels) -> dict:
    """The paper's own sweep (``configs/rotseq_paper.py``): ``m = n`` over
    ``CONFIG.sizes`` at ``k = CONFIG.k``, float32, seeded.  At each size
    ``plan.apply`` of ``cuda_wave``, of ``cuda_mxu`` at the config's tiles
    and at 64/64 and of ``cuda_batched``, ``auto``'s pick and its
    ``plan.apply``, ``torch.matmul(A, Q)`` (TF32 off) and the bound, each
    kernel's ms over it.  Up to ``PAPER_CHECK_MAX`` every kernel is held
    to its plain version: ``cuda_wave`` and ``cuda_batched`` bit for bit
    to the blocked plain version, ``cuda_mxu`` within ``MXU_TOL`` of the
    eager accumulated path (the paper shape is the main path's)."""
    import torch
    from repro_torch import random_sequence
    from repro_torch.configs.rotseq_paper import CONFIG
    from repro_torch.core.accumulate import rot_sequence_accumulated
    from repro_torch.core.blocked import rot_sequence_blocked
    from repro_torch.kernels.rotseq.ops import rot_sequence_wave
    t0 = time.perf_counter()
    k = CONFIG.k
    tiles = {"cuda_wave": WAVE_TILES,
             f"cuda_mxu {CONFIG.mxu_n_b}/{CONFIG.mxu_k_b}": dict(
                 n_b=CONFIG.mxu_n_b, k_b=CONFIG.mxu_k_b),
             "cuda_mxu 64/64": dict(n_b=64, k_b=64), "cuda_batched": {}}
    for kern in kernels.values():
        kern.LAUNCHES = 0
    rows = []
    for m in CONFIG.sizes:
        gen = torch.Generator().manual_seed(SEED + 30 + m)
        A = torch.randn((m, m), generator=gen).to(dev)
        seq = random_sequence(m, k, generator=gen, device=dev)
        C, S = seq.cos, seq.sin
        reps = max(3, min(50, 3840 // m * 3))
        plans = {label: seq.plan(like=A, method=label.split()[0], **kw)
                 for label, kw in tiles.items()}
        auto = seq.plan(like=A)
        outs = {label: pl.apply(A) for label, pl in plans.items()}
        errs = {}
        if m <= PAPER_CHECK_MAX:
            plain_w = rot_sequence_blocked(
                A, C, S, **dict(plans["cuda_wave"].kwargs))
            for label, out in outs.items():
                if label.startswith("cuda_mxu"):
                    errs[label] = rel_err(out, rot_sequence_accumulated(
                        A, C, S, **tiles[label]))
                    check(errs[label] <= MXU_TOL, f"paper sweep m={m}: "
                          f"{label} rel err {errs[label]} vs plain")
                else:
                    errs[label] = max_abs(out, plain_w)
                    check(errs[label] == 0.0, f"paper sweep m={m}: "
                          f"{label} max|d| {errs[label]} vs plain")
        for label, out in outs.items():
            check(bool(torch.isfinite(out).all()),
                  f"paper sweep m={m}: {label} non-finite")
        ms = {label: time_ms(lambda pl=pl: pl.apply(A), reps)
              for label, pl in plans.items()}
        auto_ms = time_ms(lambda: auto.apply(A), reps)
        Q = rot_sequence_wave(torch.eye(m, device=dev), C, S, **WAVE_TILES)
        mm_ms = time_ms(lambda: torch.matmul(A, Q), reps)
        b_ms, b_by = bound(6.0 * m * (m - 1) * k,
                           4.0 * (2 * m * m + 3 * (m - 1) * k))
        rows.append(dict(
            m=m, n=m, k=k, ms=ms,
            auto={"method": auto.method, "tiles": dict(auto.kwargs),
                  "ms": auto_ms},
            matmul_ms=mm_ms, bound_ms=b_ms, bound_by=b_by,
            over_bound={label: t / b_ms for label, t in ms.items()},
            checked_vs_plain=errs))
        del A, Q, outs
    launches = {name: kern.LAUNCHES for name, kern in kernels.items()}
    for name, n_launched in launches.items():
        check(n_launched > 0, f"paper sweep: {name} never launched")
    torch.cuda.empty_cache()
    out = dict(phase="paper_sweep", sizes=list(CONFIG.sizes), k=k,
               check_max=PAPER_CHECK_MAX, mxu_tol=MXU_TOL, rows=rows,
               launches=launches, seconds=time.perf_counter() - t0)
    emit(**out)
    return out


def pack_batched(A, sequences):
    """The fused kernel's operands for targets ``A`` ``(b, m, n)``, one
    sequence a target, packed as ``rot_sequence_batched`` packs them:
    ``(C, S, (AT, Cw, Sw, Gw, starts, counts))``."""
    import torch
    from repro_torch.core.ref import sign_grid
    from repro_torch.kernels.rotseq_batched.ops import wave_windows
    C = torch.stack([s.cos for s in sequences])
    S = torch.stack([s.sin for s in sequences])
    G = sign_grid(C, False, None)
    starts, counts = wave_windows(C, S, G)
    return C, S, (A.transpose(1, 2).contiguous(),
                  *(x.transpose(1, 2).contiguous() for x in (C, S, G)),
                  starts, counts)


def batched_instances(ptxas: dict) -> dict:
    """``{"kb16/t64": report}``: the fused kernel's instantiations in the
    ptxas report, by waves a band and threads a block."""
    found = {}
    for name, rep in ptxas.items():
        m = re.search(r"rotseq_batched_kernelILi(\d+)ELi(\d+)E", name)
        if m:
            found[f"kb{m.group(1)}/t{m.group(2)}"] = rep
    return found


def batched_phase(bctx, ptxas: dict) -> dict:
    """Hold ``rotseq_batched`` against its plain version and against
    per-request ``cuda_wave`` at the serving bucket, and on the bucket's
    ``seq.T`` staircases; time it; fail on a ptxas spill."""
    import torch
    from repro_torch.kernels.limits import BATCHED_M_BLK
    from repro_torch.kernels.rotseq_batched import kernel as batched_k
    from repro_torch.kernels.rotseq_batched.ops import rot_sequence_batched
    from repro_torch.kernels.rotseq_batched.ref import rotseq_batched_ref
    A, seqs, padded = bctx["A"], bctx["seqs"], bctx["padded"]

    C, S, args = pack_batched(A, padded)
    o_k, p_k = batched_k.rotseq_batched(*args)
    o_p, p_p = rotseq_batched_ref(*args)
    torch.cuda.synchronize()
    check(torch.equal(o_k, o_p), "rotseq_batched out != plain version")
    check(torch.equal(p_k, p_p), "rotseq_batched planes != plain version")
    live = [(NB - 1) * s.k for s in seqs]
    want = torch.tensor(live, dtype=torch.int32, device=A.device)[:, None]
    check(bool((p_k == want).all()),
          f"plane counts {p_k[:, 0].tolist()} != live planes {live}")
    err = max_abs(o_k, o_p)
    out = o_k.transpose(1, 2)
    per = torch.stack([s.plan(like=A[i], method="cuda_wave").apply(A[i])
                       for i, s in enumerate(seqs)])
    err_wave = max_abs(out, per)
    check(bool(torch.isfinite(out).all()), "rotseq_batched: non-finite")
    check(err_wave == 0.0, f"rotseq_batched vs per-request cuda_wave "
          f"max|d| {err_wave}")
    # the bucket as a loop of per-request cuda_wave applications
    wave_plans = [s.plan(like=A[i], method="cuda_wave")
                  for i, s in enumerate(seqs)]
    wave_loop_ms = time_ms(lambda: [pl.apply(A[i])
                                    for i, pl in enumerate(wave_plans)], 3)
    ms = time_ms(lambda: batched_k.rotseq_batched(*args), 10)
    plain_ms = time_ms(lambda: rotseq_batched_ref(*args), 1)
    # the staircases (seq.T of every request: 3.8% of the grid live)
    stairs = [s.T for s in padded]
    _, _, args_t = pack_batched(A, stairs)
    o_t, p_t = batched_k.rotseq_batched(*args_t)
    w_t, wp_t = rotseq_batched_ref(*args_t)
    torch.cuda.synchronize()
    check(torch.equal(o_t, w_t) and torch.equal(p_t, wp_t),
          "rotseq_batched staircase != plain version")
    stair_ms = time_ms(lambda: batched_k.rotseq_batched(*args_t), 10)
    stair_live = sum(s.k_live for s in stairs)
    # yardstick: one batched product with every request's Q formed
    # beforehand (not timed), TF32 off
    eye = torch.eye(NB, device=A.device).expand(B, NB, NB)
    Q = rot_sequence_batched(eye, C, S)
    lib_ms = time_ms(lambda: torch.bmm(A, Q), 10)
    lib_err = rel_err(torch.bmm(A, Q), out)
    del Q
    b_ms, b_by = bound(6.0 * MB * sum(live),
                       4.0 * (2 * B * MB * NB + 3 * B * (NB - 1) * KB))
    # the live planes' c/s/g are the panel bytes this data needs
    stair_b_ms, _ = bound(6.0 * MB * stair_live,
                          4.0 * (2 * B * MB * NB + 3 * stair_live))
    # every instantiation of the kernel in the build's ptxas report, none
    # spilling; the launched one has the wrapper's block size
    regs = batched_instances(ptxas)
    no_spills(regs, "rotseq_batched")
    (kb,) = [int(key[2:].split("/t")[0]) for key in regs
             if key.endswith(f"/t{BATCHED_M_BLK}")]
    emit(phase="rotseq_batched", b=B, m=MB, n=NB, k_pad=KB,
         k=[s.k for s in seqs], kb=kb, threads=BATCHED_M_BLK,
         max_abs_err_vs_plain=err,
         planes_equal_live=True, max_abs_err_vs_cuda_wave=err_wave,
         cuda_wave_loop_ms=wave_loop_ms,
         ms=ms, plain_ms=plain_ms, bmm_ms=lib_ms,
         bmm_rel_err=lib_err, bound_ms=b_ms, bound_by=b_by,
         staircase_waves=stairs[0].k, staircase_ms=stair_ms,
         staircase_bound_ms=stair_b_ms, staircase_bitwise_vs_plain=True,
         ptxas=regs)
    return dict(
        name="rotseq_batched", route="cuda",
        source="src/repro_torch/csrc/rotseq_batched.cu",
        replaces="src/repro/kernels/rotseq_batched/kernel.py:83",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms)


def mixed_requests(dev):
    """The reference's mixed demo stream, a third of it signed and a
    third all-reflector (partial buckets, so pad slots run too)."""
    import torch
    from repro_torch import RotationSequence
    from repro_torch.serve import synthetic_stream
    gen = torch.Generator().manual_seed(SEED + 3)
    out = []
    for i, (seq, A) in enumerate(synthetic_stream(21, seed=SEED,
                                                  device=dev)):
        # the stream cycles through the 3 shapes; vary the structure on
        # another period so every shape gets all three
        if (i // 3) % 3 == 1:
            sign = torch.where(torch.rand(seq.shape, generator=gen) < 0.5,
                               1.0, -1.0).to(dev)
            seq = RotationSequence(seq.cos, seq.sin, sign)
        elif (i // 3) % 3 == 2:
            seq = RotationSequence(seq.cos, seq.sin, None, True)
        out.append((seq, A))
    return out


def serving_phase(bctx, kernels) -> dict:
    """The serving path: RotationService, seq.T staircases through
    apply_batched, a gradient and StreamEngine, with launches counted."""
    import torch
    from repro_torch.kernels.rotseq_batched.ops import rot_sequence_batched
    from repro_torch.serve import RotationService, StreamEngine
    A, seqs, padded = bctx["A"], bctx["seqs"], bctx["padded"]
    dev = A.device
    bucket = [(s, A[i]) for i, s in enumerate(seqs)]
    mixed = mixed_requests(dev)
    stairs = [s.T for s in padded]
    gen = torch.Generator().manual_seed(SEED + 4)
    W = torch.randn((B, MB, NB), generator=gen).to(dev)
    stream_pairs = bucket * (STREAM_REQUESTS // B)
    # what each request gives alone, through another kernel (cuda_wave)
    # and through its own auto plan
    alone = [s.plan(like=X, method="cuda_wave").apply(X)
             for s, X in bucket + mixed]
    alone_auto = [s.plan(like=X).apply(X) for s, X in bucket + mixed]

    for k in kernels.values():
        k.LAUNCHES = 0
    t0 = time.perf_counter()
    svc = RotationService(slots=B, method="auto", store=False)
    outs = svc.apply_many(bucket + mixed)
    plan_t = stairs[0].plan(like=A, batch=B, shared_sequence=False)
    out_t = plan_t.apply_batched(A, sequences=stairs)
    plan_b = svc._plans[svc._bucket_key(*bucket[0])]
    Ag = A.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(
        (plan_b.apply_batched(Ag, sequences=padded) * W).sum(), Ag)
    back = plan_b.apply_batched(grad, sequences=padded)
    eng = StreamEngine(slots=B, method="auto", store=False)
    tickets = [eng.submit(s, X) for s, X in stream_pairs]
    eng.close(drain=True)
    streamed = [t.result(timeout=600) for t in tickets]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {name: k.LAUNCHES for name, k in kernels.items()}

    methods = {"x".join(map(str, key.as_list()[:2])) + f"/k{key.k_pad}"
               + ("/signed" if key.signed else ""): p.method
               for key, p in svc._plans.items()}
    check(plan_b.method == "cuda_batched",
          f"auto planned {plan_b.method} for the {MB}x{NB} bucket")
    check(plan_t.method == "cuda_batched",
          f"auto planned {plan_t.method} for the staircase bucket")
    for i, (o, a, b) in enumerate(zip(outs, alone, alone_auto)):
        check(torch.equal(o, a) and torch.equal(o, b),
              f"request {i}: bucketed != per-request")
    # the staircases: planes applied are the live planes, and the result
    # equals each staircase through cuda_wave alone
    C_t = torch.stack([s.cos for s in stairs])
    S_t = torch.stack([s.sin for s in stairs])
    o_t, planes_t = rot_sequence_batched(A, C_t, S_t, return_planes=True)
    live = torch.tensor([s.k_live for s in stairs], dtype=torch.int32,
                        device=dev)[:, None]
    check(bool((planes_t == live).all()), "staircase planes != live planes")
    check(torch.equal(o_t, out_t), "staircase apply_batched != kernel")
    stair_loop = lambda: [s.plan(like=A[i], method="cuda_wave").apply(A[i])
                          for i, s in enumerate(stairs)]
    per_t = torch.stack(stair_loop())
    err_t = max_abs(out_t, per_t)
    check(err_t == 0.0, f"staircase vs per-request cuda_wave max|d| {err_t}")
    g_err = rel_err(back, W)
    check(bool(torch.isfinite(grad).all()), "batched gradient: non-finite")
    check(g_err <= GRAD_TOL, f"apply_batched(grad) vs W rel err {g_err}")
    sync_ref = outs[:B] * (STREAM_REQUESTS // B)
    check(all(torch.equal(a, b) for a, b in zip(streamed, sync_ref)),
          "streamed != synchronous drain")
    check(eng.stats["completed"] == STREAM_REQUESTS,
          f"stream completed {eng.stats['completed']}")
    check(counts["rotseq_batched"] > 0,
          "rotseq_batched never launched on the serving path")

    stair_ms = time_ms(lambda: plan_t.apply_batched(A, sequences=stairs), 3)
    stair_loop_ms = time_ms(stair_loop, 1)
    # one request alone: what auto plans for a single target of the
    # bucket's shape, against cuda_wave
    one = seqs[0].plan(like=A[0])
    single_ms = {}
    for meth in sorted({one.method, "cuda_batched", "cuda_wave"}):
        pl = seqs[0].plan(like=A[0], method=meth)
        single_ms[meth] = time_ms(lambda: pl.apply(A[0]), 3)

    def run_sync():
        svc.apply_many(stream_pairs)
        torch.cuda.synchronize()

    def run_stream():
        with StreamEngine(service=RotationService(
                slots=B, method="auto", store=False)) as e:
            ts = [e.submit(s, X) for s, X in stream_pairs]
        for t in ts:
            t.result(timeout=600)

    rates = {}
    for name, fn in (("sync", run_sync), ("stream", run_stream)):
        fn()
        t1 = time.perf_counter()
        fn()
        rates[name] = STREAM_REQUESTS / (time.perf_counter() - t1)
    emit(phase="serving", bucket_methods=methods,
         requests=len(bucket) + len(mixed), service_stats=svc.stats,
         bitwise_vs_per_request=True, staircase_waves=stairs[0].k,
         staircase_live_share=float(stairs[0].k_live
                                    / ((NB - 1) * stairs[0].k)),
         staircase_ms=stair_ms, staircase_cuda_wave_loop_ms=stair_loop_ms,
         staircase_max_abs_err_vs_cuda_wave=err_t,
         single_request_auto=one.method, single_request_ms=single_ms,
         single_request_auto_vs_best=single_ms[one.method]
         / min(single_ms.values()),
         grad_rel_err=g_err, tol=GRAD_TOL,
         stream_requests=STREAM_REQUESTS, stream_stats=eng.stats,
         stream_bitwise_vs_sync=True, sync_requests_per_s=rates["sync"],
         stream_requests_per_s=rates["stream"], launches=counts,
         seconds=seconds)
    return counts


@contextlib.contextmanager
def recorded(module, *names):
    """For the span of the block, wrap the functions (or classes)
    ``names`` of ``module`` so that each call appends its seconds, to a
    synchronise, and its result to ``seen[name]``: one run of a solver
    gives its stages' times and recordings."""
    import torch
    seen = {name: [] for name in names}
    orig = {name: getattr(module, name) for name in names}

    def wrap(name, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            seen[name].append((time.perf_counter() - t0, out))
            return out
        return timed

    for name, fn in orig.items():
        setattr(module, name, wrap(name, fn))
    try:
        yield seen
    finally:
        for name, fn in orig.items():
            setattr(module, name, fn)


def same_family(got, want, methods, what: str) -> float:
    """``got`` against ``want``: bit for bit (``torch.equal``, where +0
    and -0 are equal) when every method is of the rotation family,
    within ``MXU_TOL`` relative when one is ``cuda_mxu``/``accumulated``.
    Returns the error (0.0 when equal)."""
    import torch
    if any(m in ("cuda_mxu", "accumulated") for m in methods):
        err = rel_err(got, want)
        check(err <= MXU_TOL, f"{what}: rel err {err} > {MXU_TOL}")
        return err
    check(torch.equal(got, want), f"{what}: not bit for bit")
    return 0.0


def plain_of(method: str) -> str:
    """The plain version of a rotation kernel's backend."""
    return {"cuda_mxu": "accumulated"}.get(method, "blocked")


def plain_replay(buf, recordings, what: str) -> dict:
    """Flush ``recordings`` (host ``(C, S)`` pairs in push order) into a
    fresh identity through the plain version of ``buf``'s pick, at its
    tiles, on the card, and hold ``buf``'s accumulator to the result."""
    import torch
    from repro_torch import RotationSequence
    from repro_torch.eig import DelayedRotationBuffer
    (plan,) = buf._plans.values()
    check(plan.method in KERNEL_OF, f"{what}: auto planned {plan.method}")
    got = buf.value
    plain = plain_of(plan.method)
    eye = torch.eye(got.shape[-1], dtype=got.dtype, device=got.device)
    t0 = time.perf_counter()
    pbuf = DelayedRotationBuffer(eye, k_delay=buf.k_delay, method=plain,
                                 **dict(plan.kwargs))
    for C, S in recordings:
        pbuf.push_sequence(RotationSequence(torch.from_numpy(C),
                                            torch.from_numpy(S)))
    want = pbuf.value
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    err = same_family(got, want, [plan.method],
                      f"{what}: {plan.method} flushes vs {plain}")
    return dict(method=plan.method, tiles=dict(plan.kwargs),
                flushes=buf.flushes, plain=plain, plain_flush_ms=ms,
                err_vs_plain=err)


def eig_qr(dev, kernels) -> dict:
    """``eigh_givens(H, method="qr")`` at ``EIG_N`` float32, run once with
    its kernel launches counted and its stages timed inside that run (the
    recorders, then the delayed flushes to a synchronise); the flushes'
    applications timed back to back on the device; the same recording
    flushed through the pick's plain version on the card;
    ``torch.linalg.eigh``."""
    import numpy as np
    import torch
    import repro_torch.eig.api as eig_api
    from repro_torch import RotationSequence
    from repro_torch.eig import eigh_givens
    n = EIG_N
    rng = np.random.default_rng(SEED + 5)
    X = rng.standard_normal((n, n)).astype(np.float32)
    H = (X + X.T) / 2
    for k in kernels.values():
        k.LAUNCHES = 0
    t0 = time.perf_counter()
    with recorded(eig_api, "tridiagonalize", "tridiag_qr",
                  "DelayedRotationBuffer") as seen:
        w, V = eigh_givens(H, k_delay=EIG_K_DELAY, apply_method="auto",
                           device=dev)
        torch.cuda.synchronize()
    eigh_s = time.perf_counter() - t0
    counts = {name: k.LAUNCHES for name, k in kernels.items()}
    ((tri_s, tri),) = seen["tridiagonalize"]
    ((qr_s, qr),) = seen["tridiag_qr"]
    ((_, buf),) = seen["DelayedRotationBuffer"]
    check(qr.converged, "tridiag_qr did not converge")
    # what follows the recorders: the buffer's pushes, one copy an array
    # a flush, and the applications
    wall_ms = (eigh_s - tri_s - qr_s) * 1e3
    # the composed recording eigh_givens pushed: tridiagonalization
    # waves, then one wave a QR sweep
    C = np.concatenate([tri.cos, qr.cos], 1)
    S = np.concatenate([tri.sin, qr.sin], 1)
    waves = C.shape[1]
    live = int(((C != 1.0) | (S != 0.0)).sum())

    ref = np.linalg.eigvalsh(H.astype(np.float64))
    scale = float(np.abs(ref).max())
    w_err = float(np.abs(w.cpu().double().numpy() - ref).max())
    check(w_err <= EIG_TOL * scale, f"eigenvalues max|d| {w_err}")
    Vd = V.double()
    eye64 = torch.eye(n, dtype=torch.float64, device=dev)
    orth = float((Vd.T @ Vd - eye64).abs().max())
    check(orth <= EIG_TOL, f"max|V^T V - I| {orth}")
    H64 = torch.from_numpy(H).to(dev, torch.float64)
    resid = float((Vd.T @ H64 @ Vd - torch.diag(w.double())).abs().max())
    check(resid <= EIG_TOL * scale * n ** 0.5, f"residual {resid}")

    replay = plain_replay(buf, [(C, S)], "eigh_qr")
    (plan,) = buf._plans.values()
    check(counts[KERNEL_OF[plan.method]] > 0,
          f"{KERNEL_OF[plan.method]} never launched during the eig flushes")
    V_raw = buf.value
    # the flushes' applications alone, back to back on the device
    chunks = [plan.rebind(RotationSequence(
        torch.from_numpy(C[:, i:i + EIG_K_DELAY]).float().to(dev),
        torch.from_numpy(S[:, i:i + EIG_K_DELAY]).float().to(dev)).pad_to(
            EIG_K_DELAY)) for i in range(0, waves, EIG_K_DELAY)]
    eye = torch.eye(n, device=dev)

    def run():
        out = eye
        for pl in chunks:
            out = pl.apply_direct(out)
        return out

    same_family(run(), V_raw, [plan.method], "flushes back to back")
    device_ms = time_ms(run, 3)
    del chunks

    Hd = torch.from_numpy(H).to(dev)
    lib_ms = time_ms(lambda: torch.linalg.eigh(Hd), 3)
    nbytes = 4.0 * buf.flushes * (2 * n * n + 2 * (n - 1) * EIG_K_DELAY)
    b_ms, b_by = bound(6.0 * n * (n - 1) * waves, nbytes)
    live_ms, live_by = bound(6.0 * n * live, nbytes)
    emit(phase="eig", part="eigh_qr", n=n, k_delay=EIG_K_DELAY,
         host_s={"tridiagonalize": tri_s, "tridiag_qr": qr_s},
         waves={"tridiagonalize": tri.cos.shape[1], "tridiag_qr": qr.sweeps},
         live_planes=live, plan=replay, eigh_givens_s=eigh_s,
         launches=counts, flush_wall_ms=wall_ms, flush_device_ms=device_ms,
         device_ms_per_flush=device_ms / buf.flushes, bound_ms=b_ms,
         bound_by=b_by, bound_live_ms=live_ms, bound_live_by=live_by,
         torch_linalg_eigh_ms=lib_ms, eigenvalue_err=w_err, scale=scale,
         orth_err=orth, residual=resid, tol=EIG_TOL)
    return dict(C=C, S=S, V_raw=V_raw, method=plan.method)


def eig_svd(dev, kernels) -> None:
    """``svd_givens`` of a seeded ``SVD_SHAPE`` float32 matrix, run once
    with its stages timed inside that run: singular values against
    ``np.linalg.svd``, orthogonality, reconstruction, and each side's
    flushes replayed through the pick's plain version on the card."""
    import numpy as np
    import torch
    import repro_torch.eig.api as eig_api
    from repro_torch.eig import svd_givens
    m, n = SVD_SHAPE
    A = np.random.default_rng(SEED + 6).standard_normal((m, n)).astype(
        np.float32)
    for k in kernels.values():
        k.LAUNCHES = 0
    t0 = time.perf_counter()
    with recorded(eig_api, "bidiagonalize", "bidiag_qr",
                  "DelayedRotationBuffer") as seen:
        U, s, Vt = svd_givens(A, k_delay=EIG_K_DELAY, device=dev)
        torch.cuda.synchronize()
    svd_s = time.perf_counter() - t0
    counts = {name: k.LAUNCHES for name, k in kernels.items()}
    ((bd_s, bd),) = seen["bidiagonalize"]
    ((bq_s, bq),) = seen["bidiag_qr"]
    (_, ubuf), (_, vbuf) = seen["DelayedRotationBuffer"]
    check(bq.converged, "bidiag_qr did not converge")
    sr = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    smax = float(sr.max())
    s_err = float(np.abs(s.cpu().double().numpy() - sr).max())
    check(s_err <= EIG_TOL * smax, f"singular values max|d| {s_err}")
    Ud, Vd = U.double(), Vt.double()
    eye64 = torch.eye(n, dtype=torch.float64, device=dev)
    orth = max(float((Ud.T @ Ud - eye64).abs().max()),
               float((Vd @ Vd.T - eye64).abs().max()))
    check(orth <= EIG_TOL, f"svd orthogonality {orth}")
    A64 = torch.from_numpy(A).to(dev, torch.float64)
    rec = float((Ud @ torch.diag(s.double()) @ Vd - A64).abs().max())
    check(rec <= EIG_TOL * smax, f"svd reconstruction {rec}")
    # the recordings each buffer was pushed, in svd_givens' order
    left = plain_replay(ubuf, [
        (bd.cos_left, bd.sin_left),
        (eig_api._embed_planes(bq.cos_left, m - 1, 1.0),
         eig_api._embed_planes(bq.sin_left, m - 1, 0.0))], "svd left")
    right = plain_replay(vbuf, [(bd.cos_right, bd.sin_right),
                                (bq.cos_right, bq.sin_right)], "svd right")
    for side in (left, right):
        check(counts[KERNEL_OF[side["method"]]] > 0,
              f"{KERNEL_OF[side['method']]} never launched during the svd "
              f"flushes")
    Ad = A64.float()
    lib_ms = time_ms(lambda: torch.linalg.svd(Ad, full_matrices=False), 3)
    emit(phase="eig", part="svd", shape=[m, n], k_delay=EIG_K_DELAY,
         host_s={"bidiagonalize": bd_s, "bidiag_qr": bq_s},
         waves={"left": bd.cos_left.shape[1] + bq.sweeps,
                "right": bd.cos_right.shape[1] + bq.sweeps},
         flushes=ubuf.flushes + vbuf.flushes, plan={"left": left,
                                                    "right": right},
         svd_givens_s=svd_s, launches=counts, sv_err=s_err, s_max=smax,
         orth_err=orth, reconstruction_err=rec, tol=EIG_TOL,
         torch_linalg_svd_ms=lib_ms)


def eig_jacobi(dev, kernels) -> None:
    """``eigh_givens(method="jacobi")`` at ``JACOBI_N``, run once: a loop
    of torch operations a wave on the card, then one planned application
    of the sign-carrying recording, whose result is held to the pick's
    plain version on the card; eigenvalues, orthogonality and residual at
    the reference's bars (``1e-4 * n``, ``1e-5 * n``, ``2e-4 * n``)."""
    import numpy as np
    import torch
    import repro_torch.core.jacobi as jac
    from repro_torch.eig import eigh_givens
    n = JACOBI_N
    X = np.random.default_rng(SEED + 7).standard_normal((n, n)).astype(
        np.float32)
    H = (X + X.T) / 2
    for k in kernels.values():
        k.LAUNCHES = 0
    t0 = time.perf_counter()
    with recorded(jac, "jacobi_eigh", "jacobi_apply_basis") as seen:
        w, V = eigh_givens(H, method="jacobi", cycles=JACOBI_CYCLES,
                           device=dev)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {name: k.LAUNCHES for name, k in kernels.items()}
    ((loop_s, res),) = seen["jacobi_eigh"]
    ((apply_s, V_raw),) = seen["jacobi_apply_basis"]
    # the plan jacobi_apply_basis resolved (the cost model is
    # deterministic), and its plain version at the same tiles
    plan = res.rotation_sequence().plan(like=V_raw, method="auto",
                                        n_b=None, k_b=None)
    check(plan.method in KERNEL_OF, f"auto planned {plan.method} for the "
          f"Jacobi basis")
    check(counts[KERNEL_OF[plan.method]] > 0,
          f"{KERNEL_OF[plan.method]} never launched applying the Jacobi "
          f"basis")
    plain = plain_of(plan.method)
    t1 = time.perf_counter()
    V_plain = jac.jacobi_apply_basis(res, method=plain, **dict(plan.kwargs))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t1) * 1e3
    err_plain = same_family(V_raw, V_plain, [plan.method],
                            f"Jacobi basis: {plan.method} vs {plain}")
    ref = np.linalg.eigvalsh(H.astype(np.float64))
    w_err = float(np.abs(w.cpu().double().numpy() - ref).max())
    check(w_err <= 1e-4 * n, f"Jacobi eigenvalues max|d| {w_err}")
    Vd = V.double()
    orth = float((Vd.T @ Vd - torch.eye(n, dtype=torch.float64,
                                        device=dev)).abs().max())
    check(orth <= 1e-5 * n, f"Jacobi max|V^T V - I| {orth}")
    H64 = torch.from_numpy(H).to(dev, torch.float64)
    resid = float((Vd.T @ H64 @ Vd - torch.diag(w.double())).abs().max())
    check(resid <= 2e-4 * n, f"Jacobi residual {resid}")
    emit(phase="eig", part="eigh_jacobi", n=n, cycles=JACOBI_CYCLES,
         waves=JACOBI_CYCLES * n, seconds=seconds, loop_s=loop_s,
         apply_s=apply_s, launches=counts,
         plan={"method": plan.method, "tiles": dict(plan.kwargs)},
         plain=plain, plain_ms=plain_ms, err_vs_plain=err_plain,
         eigenvalue_err=w_err, scale=float(np.abs(ref).max()),
         orth_err=orth, residual=resid,
         tol={"eigenvalues": 1e-4 * n, "orth": 1e-5 * n,
              "residual": 2e-4 * n})


def eig_batched(dev, kernels, rec: dict) -> None:
    """A ``(EIG_BATCH, EIG_N, EIG_N)`` buffer of row-permuted identities
    fed the QR recording: each slice equals the 2D flushes' result with
    its rows permuted (bit for bit on the rotation family)."""
    import torch
    from repro_torch import RotationSequence
    from repro_torch.core import registry
    from repro_torch.eig import DelayedRotationBuffer
    n = EIG_N
    gen = torch.Generator().manual_seed(SEED + 8)
    perms = [torch.randperm(n, generator=gen).to(dev)
             for _ in range(EIG_BATCH)]
    eye = torch.eye(n, device=dev)
    M = torch.stack([eye[p] for p in perms])
    seq = RotationSequence(torch.from_numpy(rec["C"]),
                           torch.from_numpy(rec["S"]))
    for k in kernels.values():
        k.LAUNCHES = 0
    t0 = time.perf_counter()
    buf = DelayedRotationBuffer(M, k_delay=EIG_K_DELAY)
    out = buf.push_sequence(seq).value
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = {name: k.LAUNCHES for name, k in kernels.items()}
    (plan,) = buf._plans.values()
    check(plan.method in KERNEL_OF, f"auto planned {plan.method} for the "
          f"batched accumulator")
    check(counts[KERNEL_OF[plan.method]] > 0,
          f"{KERNEL_OF[plan.method]} never launched on the batched flushes")
    err = max(same_family(out[i], rec["V_raw"][p],
                          [plan.method, rec["method"]], f"slice {i}")
              for i, p in enumerate(perms))
    emit(phase="eig", part="batched", shape=[EIG_BATCH, n, n],
         k_delay=EIG_K_DELAY, flushes=buf.flushes,
         plan={"method": plan.method, "tiles": dict(plan.kwargs),
               "route": registry.get_backend(plan.method).capability
               .batch_via},
         launches=counts, wall_ms=wall_ms, err_vs_2d=err,
         bitwise_vs_2d=err == 0.0)


def eig_phase(dev, kernels) -> dict:
    """The eigensolver path: QR eigh, SVD, Jacobi and a batched buffer,
    each with the kernels' launches counted from 0.  Returns the QR
    recording and its basis."""
    rec = eig_qr(dev, kernels)
    eig_svd(dev, kernels)
    eig_jacobi(dev, kernels)
    eig_batched(dev, kernels, rec)
    return rec


def alone_ms(fns: dict, seconds: float = ALONE_SECONDS) -> dict:
    """``{name: median ms of one call of fns[name] alone}``: each call
    between two CUDA events with a synchronize before and after, as
    autotune times a candidate; the functions take turns, one call each
    a round in a seeded random order, for at least 5 rounds and
    ``seconds`` in all (at most ``ALONE_MAX_ROUNDS``), so a slow spell of
    the host falls on all of them, none always follows the same one, and
    a spell shorter than half the window does not move a median."""
    import random
    first = {name: time_ms(fn, 1) for name, fn in fns.items()}
    rounds = max(5, min(ALONE_MAX_ROUNDS,
                        int(seconds * 1e3 / sum(first.values()))))
    ts = {name: [] for name in fns}
    names = list(fns)
    order = random.Random(SEED)
    for _ in range(rounds):
        order.shuffle(names)
        for name in names:
            ts[name].append(time_ms(fns[name], 1, warm=False))
    return {name: statistics.median(t) for name, t in ts.items()}


@contextlib.contextmanager
def measured_candidates():
    """For the span of the block, record every candidate the registry's
    autotune times: ``(problem, plan, seconds)``, seconds ``None`` for a
    candidate its backend refused (a skipped one)."""
    from repro_torch.core import registry
    seen = []
    orig = registry._measure_plans

    def measure(problem, plans):
        secs = orig(problem, plans)
        seen.extend((problem, p, t) for p, t in zip(plans, secs))
        return secs

    registry._measure_plans = measure
    try:
        yield seen
    finally:
        registry._measure_plans = orig


def tiles_of(plan) -> dict:
    return {key: val for key, val in (("n_b", plan.n_b), ("k_b", plan.k_b))
            if val is not None}


def plan_problem(sq, X, seqs) -> dict:
    """``select_plan``'s arguments for ``sq`` over target ``X`` (a 3D
    ``X`` with ``seqs``: one sequence a target)."""
    b, m = (1, X.shape[0]) if X.ndim == 2 else X.shape[:2]
    return dict(m=m, n=sq.n, k=sq.k, dtype="float32",
                platform=X.device.type,
                signs=sq.sign is not None, batch=b,
                shared_sequence=seqs is None, live_planes=sq.k_live)


def applier(pl, X, seqs):
    if X.ndim == 2:
        return lambda: pl.apply(X)
    return lambda: pl.apply_batched(X, sequences=seqs)


def autotune_point(label, sq, X, seqs, model, kernels, seen) -> dict:
    """Autotune one point on the card, every kernel plan a candidate:
    the candidates' ms, the launches and seconds of the measurements;
    the pick's result held to ``cuda_wave``'s; the pick's, the model
    pick's and each kernel's fastest measured plan's applications timed
    alone in turns (``alone_ms``, the quantity autotune ranks by) and
    back to back (``time_ms``)."""
    import torch
    from repro_torch.core import registry
    prob = plan_problem(sq, X, seqs)
    shared = seqs is None
    for k in kernels.values():
        k.LAUNCHES = 0
    seen.clear()
    t0 = time.perf_counter()
    best = registry.select_plan(**prob, autotune=True,
                                autotune_top=AUTOTUNE_TOP)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: k.LAUNCHES for name, k in kernels.items()}
    skipped = [(p.method, tiles_of(p)) for _, p, t in seen if t is None]
    timed = [(p, secs) for _, p, secs in seen if secs is not None]
    check(not skipped, f"autotune {label}: skipped candidates {skipped}")
    check(best.source == "measured", f"autotune {label}: {best.source}")
    for name in ("rotseq_wave", "rotseq_mxu", "rotseq_batched"):
        check(launches[name] > 0, f"autotune {label}: {name} never "
              f"launched during the measurements")
    tuned = sq.plan(like=X, shared_sequence=shared)
    check(tuned.plan == best, f"autotune {label}: seq.plan gave "
          f"{tuned.plan}, not the measured {best}")
    wave = sq.plan(like=X, method="cuda_wave", shared_sequence=shared,
                   **WAVE_TILES)
    err = same_family(applier(tuned, X, seqs)(), applier(wave, X, seqs)(),
                      [tuned.method], f"autotune {label}: the pick vs "
                      f"cuda_wave")
    # each kernel's fastest measured plan, and the pick, timed here
    fastest = {}
    for p, secs in sorted(timed, key=lambda t: t[1]):
        fastest.setdefault(p.method, p)
    check(set(fastest) >= set(KERNEL_OF),
          f"autotune {label}: measured {sorted(fastest)}")
    # the pick is its backend's fastest measured plan: its plan.apply
    # stands for that backend; the model's pick is timed beside them
    fns = {meth: applier(tuned if meth == best.method else sq.plan(
        like=X, method=meth, shared_sequence=shared, n_b=p.n_b,
        k_b=p.k_b), X, seqs) for meth, p in fastest.items()}
    model_key = model.method if model.method in fastest and tiles_of(
        fastest[model.method]) == tiles_of(model) else "model"
    if model_key == "model":
        fns["model"] = applier(sq.plan(
            like=X, method=model.method, shared_sequence=shared,
            n_b=model.n_b, k_b=model.k_b), X, seqs)
    alone = alone_ms(fns)
    b2b = {name: time_ms(fn, 3) for name, fn in fns.items()}
    for times in (alone, b2b):
        times["pick"], times["model"] = times[best.method], times[model_key]
    # every kernel plan timed here (the model's pick is one too)
    floor = min(alone[name] for name in (*KERNEL_OF, "model"))
    row = dict(
        problem={key: prob[key] for key in ("m", "n", "k", "batch",
                                            "shared_sequence",
                                            "live_planes")},
        model={"method": model.method, "tiles": tiles_of(model),
               "est_ms": model.est_seconds * 1e3},
        candidates=[{"method": p.method, "tiles": tiles_of(p),
                     "ms": secs * 1e3} for p, secs in timed],
        pick={"method": best.method, "tiles": tiles_of(best),
              "ms": best.est_seconds * 1e3},
        launches=launches, autotune_s=seconds, err_vs_cuda_wave=err,
        apply_ms_alone=alone, apply_ms_back_to_back=b2b,
        pick_vs_fastest_kernel=alone["pick"] / floor,
        model_vs_pick=alone["model"] / alone["pick"],
        model_vs_pick_back_to_back=b2b["model"] / b2b["pick"])
    check(alone["pick"] <= AUTOTUNE_SLACK * floor,
          f"autotune {label}: the pick's application is more than "
          f"{AUTOTUNE_SLACK} x the fastest kernel's: {json.dumps(row)}")
    return row


def autotune_persistence(points: dict, platform: str, seen) -> dict:
    """The store after the points: one entry a measured key; cleared and
    loaded, every entry ``persisted``; autotune at the paper shape then
    measures nothing; a fresh process plans the paper shape from the
    store; ``NEIGHBOUR`` borrows the paper shape's plan."""
    import os
    from repro_torch.core import registry
    path = registry.plan_cache_path()
    with open(path) as f:
        keys = [tuple(e["key"]) for e in json.load(f)["plans"]]
    measured = {key for key, p in registry._PLAN_CACHE.items()
                if p.source == "measured"}
    check(len(keys) == len(set(keys)) == len(points)
          and set(keys) == measured,
          f"plan store holds {keys}, measured {sorted(measured)}")
    paper = registry.select_plan(M, N, K, platform=platform)
    registry.clear_plan_cache()
    loaded = registry.load_plan_cache()
    sources = {p.source for p in registry._PLAN_CACHE.values()}
    check(loaded == len(points) and sources == {"persisted"},
          f"loaded {loaded} plans, sources {sources}")
    seen.clear()
    again = registry.select_plan(M, N, K, platform=platform,
                                 autotune=True, autotune_top=AUTOTUNE_TOP)
    check(again.source == "persisted" and not seen,
          f"paper shape after loading: {again.source}, {len(seen)} "
          f"measurements")
    same = (again.method, again.n_b, again.k_b) == (paper.method,
                                                    paper.n_b, paper.k_b)
    check(same, f"persisted {again} != measured {paper}")
    code = ("import json\n"
            "from repro_torch.core import api, registry as r\n"
            f"p = r.select_plan({M}, {N}, {K}, platform={platform!r})\n"
            "print(json.dumps([p.source, p.method, p.n_b, p.k_b]))\n")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, check=True,
        env=dict(os.environ, PYTHONPATH=str(SRC))).stdout.splitlines()[-1]
    fresh = json.loads(out)
    check(fresh == ["persisted", paper.method, paper.n_b, paper.k_b],
          f"a fresh process planned the paper shape as {fresh}")
    near = registry.select_plan(*NEIGHBOUR, platform=platform)
    check(near.source == "interpolated"
          and (near.method, near.n_b, near.k_b) == (paper.method, paper.n_b,
                                                    paper.k_b),
          f"{NEIGHBOUR} planned {near}")
    return dict(path_entries=len(keys), loaded=loaded,
                paper_after_load=again.source, measured_after_load=len(seen),
                fresh_process=fresh, neighbour=list(NEIGHBOUR),
                neighbour_plan={"source": near.source, "method": near.method,
                                "tiles": tiles_of(near)})


def autotune_entry_points(bctx, rec, seen) -> dict:
    """``RotationService(autotune=True)`` over the serving bucket and a 2D
    ``DelayedRotationBuffer(autotune=True)`` fed the QR recording, each
    measuring with the cache cleared, against ``autotune=False``."""
    import torch
    from repro_torch import RotationSequence
    from repro_torch.core import registry
    from repro_torch.eig import DelayedRotationBuffer
    from repro_torch.serve import RotationService
    A, seqs = bctx["A"], bctx["seqs"]
    bucket = [(s, A[i]) for i, s in enumerate(seqs)]
    registry.clear_plan_cache()
    base_svc = RotationService(slots=B, store=False)
    base = base_svc.apply_many(bucket)
    (base_plan,) = base_svc._plans.values()
    seen.clear()
    svc = RotationService(slots=B, autotune=True, store=False)
    outs = svc.apply_many(bucket)
    (svc_plan,) = svc._plans.values()
    check(svc_plan.plan.source == "measured" and seen,
          "RotationService(autotune=True) measured nothing")
    svc_err = max(same_family(o, b, [svc_plan.method, base_plan.method],
                              f"RotationService autotune request {i}")
                  for i, (o, b) in enumerate(zip(outs, base)))
    svc_measured = len(seen)
    registry.clear_plan_cache()
    seen.clear()
    buf = DelayedRotationBuffer(torch.eye(EIG_N, device=A.device),
                                k_delay=EIG_K_DELAY, autotune=True)
    V = buf.push_sequence(RotationSequence(
        torch.from_numpy(rec["C"]), torch.from_numpy(rec["S"]))).value
    (buf_plan,) = buf._plans.values()
    check(buf_plan.plan.source == "measured" and seen
          and len({id(prob) for prob, _, _ in seen}) == 1,
          "DelayedRotationBuffer(autotune=True) did not measure once")
    buf_err = same_family(V, rec["V_raw"], [buf_plan.method, rec["method"]],
                          "DelayedRotationBuffer autotune vs the eig phase")
    return dict(
        rotation_service={"model": base_plan.method,
                          "autotuned": svc_plan.method,
                          "tiles": dict(svc_plan.kwargs),
                          "measured": svc_measured, "err": svc_err},
        delayed_buffer={"model": rec["method"], "autotuned": buf_plan.method,
                        "tiles": dict(buf_plan.kwargs),
                        "flushes": buf.flushes, "measured": len(seen),
                        "err": buf_err})


def autotune_phase(ctx, seq, bctx, rec, kernels) -> None:
    """Measured autotune on the card at five points, float32, every kernel
    plan a candidate: the planner's three, the serving bucket (one
    sequence a request, live planes known) and the eig flush
    ``(EIG_N, EIG_N, EIG_K_DELAY)`` (the first 32 waves of the QR
    recording on an identity); then the persisted store round trip and
    the entry points.  It runs after every phase that checks ``auto``'s
    model pick (the LM phases after it plan no rotation): measured plans
    are reused by plain ``auto`` calls and lent to nearby shapes."""
    import torch
    from repro_torch import RotationSequence
    from repro_torch.core import registry
    dev = ctx["A"].device
    t0 = time.perf_counter()
    points = {label: (sq, X, None)
              for label, (sq, X, _) in planner_points(ctx, seq).items()}
    points["serving bucket"] = (bctx["padded"][0], bctx["A"],
                                bctx["padded"])
    points[f"eig flush {EIG_N}^2 k{EIG_K_DELAY}"] = (RotationSequence(
        torch.from_numpy(rec["C"][:, :EIG_K_DELAY]).float().to(dev),
        torch.from_numpy(rec["S"][:, :EIG_K_DELAY]).float().to(dev)),
        torch.eye(EIG_N, device=dev), None)
    # the model's picks, before anything is measured
    registry.clear_plan_cache()
    model = {label: registry.select_plan(**plan_problem(sq, X, seqs))
             for label, (sq, X, seqs) in points.items()}
    check(all(p.source == "model" for p in model.values()),
          "the model's picks were not the model's")
    registry.clear_plan_cache()
    with measured_candidates() as seen:
        rows = {label: autotune_point(label, sq, X, seqs, model[label],
                                      kernels, seen)
                for label, (sq, X, seqs) in points.items()}
        persistence = autotune_persistence(points, dev.type, seen)
        entry = autotune_entry_points(bctx, rec, seen)
    emit(phase="autotune", autotune_top=AUTOTUNE_TOP, slack=AUTOTUNE_SLACK,
         points=rows, persistence=persistence, entry_points=entry,
         seconds=time.perf_counter() - t0)


# the observability phase: obs-on applications a case, and the 1024^2
# point at which obs on (a synchronize before and after each dispatch)
# is timed against obs off, back to back
OBS_REPS = 5
OBS_COST_REPS = 50
OBS_TRACE_SPANS = {"plan", "resolve", "apply_batched", "admit", "drain"}
# the obs launch counter of each kernel
OBS_KERNEL = {"rotseq_wave": "rotseq", "rotseq_mxu": "rotseq_mxu",
              "rotseq_batched": "rotseq_batched"}


@contextlib.contextmanager
def counted_syncs():
    """Count the calls of ``repro_torch.obs.timing.sync`` in the block."""
    from repro_torch.obs import timing
    calls = [0]
    orig = timing.sync

    def sync(device):
        calls[0] += 1
        orig(device)

    timing.sync = sync
    try:
        yield calls
    finally:
        timing.sync = orig


def obs_case(label, run, kernels, exact: bool) -> dict:
    """One case of the obs phase: ``run()`` with obs off (no
    ``timing.sync`` allowed), then once with obs on unrecorded (its first
    call allocates the buffers the off output still holds, which no model
    prices), then ``OBS_REPS`` times with obs on, the
    obs launch counters held to the change of each kernel's ``LAUNCHES``
    and every obs-on output to the obs-off one (bit for bit, or within
    ``MXU_TOL`` where ``exact`` is false).  Returns the case's roofline
    ``by_backend``, counters and launches."""
    import torch
    from repro_torch import obs
    run()                                   # warm: caches, plan, factors
    with obs.override(False), counted_syncs() as calls:
        off = run()
    torch.cuda.synchronize()
    check(calls[0] == 0, f"obs {label}: the disabled path called "
          f"timing.sync {calls[0]} times")
    with obs.override(True):
        run()   # the obs-on path's own first call: allocations, records
    obs.reset()
    before = {name: k.LAUNCHES for name, k in kernels.items()}
    errs = []
    with obs.override(True), counted_syncs() as calls:
        for _ in range(OBS_REPS):
            on = run()
            outs = zip(on, off) if isinstance(on, list) else [(on, off)]
            errs.append(max((max_abs(a, b) if exact else rel_err(a, b))
                            for a, b in outs))
        snap = obs.snapshot()
    launches = {name: k.LAUNCHES - before[name]
                for name, k in kernels.items()}
    counted = {name: snap["counters"].get(
        f"kernels.{OBS_KERNEL[name]}.launches", 0) for name in kernels}
    check(counted == launches, f"obs {label}: launch counters {counted} "
          f"!= LAUNCHES deltas {launches}")
    err = max(errs)
    check(err == 0.0 if exact else err <= MXU_TOL,
          f"obs {label}: obs-on output differs from obs-off by {err}")
    check(calls[0] >= 2 * OBS_REPS, f"obs {label}: {calls[0]} synchronizes "
          f"for {OBS_REPS} dispatches")
    by = snap["roofline"]["by_backend"]
    with obs.override(False):
        off_ms = time_ms(run, OBS_REPS)
    return dict(by_backend={meth: {key: agg[key] for key in (
        "dispatches", "predicted_s", "measured_s", "model_fraction",
        "setup_fraction", "predicted_flops", "predicted_bytes",
        "planes_live", "planes_total")} for meth, agg in by.items()},
        measured_ms=[d["measured_s"] * 1e3
                     for d in snap["roofline"]["dispatches"]],
        off_ms_back_to_back=off_ms, launches=launches, err=err,
        counters={key: val for key, val in snap["counters"].items()
                  if not key.startswith("kernels.")})


def obs_launcher(dev) -> dict:
    """``repro_torch.launch.serve --rotations --check --metrics-json F
    --trace T`` on the card as a child process: the JSON loads, its
    ``serve.*`` counters equal the service's ``stats`` and the trace
    holds the spans of a served run."""
    with tempfile.TemporaryDirectory(prefix="obs_launch_") as tmp:
        metrics, trace = (os.path.join(tmp, "metrics.json"),
                          os.path.join(tmp, "trace.json"))
        env = dict(os.environ, PYTHONPATH=str(SRC), REPRO_PLAN_CACHE="off")
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--rotations",
             "--check", "--device", dev.type, "--metrics-json", metrics,
             "--trace", trace], env=env, cwd=str(ROOT), capture_output=True,
            text=True, timeout=600)
        seconds = time.perf_counter() - t0
        check(out.returncode == 0, f"obs launcher exit {out.returncode}: "
              f"{out.stderr[-2000:]}")
        with open(metrics) as f:
            snap = json.load(f)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    stats = snap["meta"]["stats"]
    c = snap["counters"]
    serve = {key: c.get(f"serve.{key}", 0) for key in (
        "requests", "batches", "slots_executed", "plans_resolved",
        "warm_plans")}
    serve["padded_slots"] = c.get("serve.pad_slots", 0)
    want = {key: stats[key] for key in serve}
    check(serve == want, f"obs launcher: serve counters {serve} != stats "
          f"{want}")
    names = {ev["name"] for ev in events}
    check(OBS_TRACE_SPANS <= names, f"obs launcher: trace spans {names} "
          f"lack {OBS_TRACE_SPANS - names}")
    return dict(serve=serve, spans=sorted(names), events=len(events),
                by_backend={meth: agg["model_fraction"] for meth, agg in
                            snap["roofline"]["by_backend"].items()},
                seconds=seconds)


def obs_phase(ctx, seq, bctx, rec, kernels, kind: str, smi: str) -> None:
    """``repro_torch.obs`` on the card: the roofline ledger of one
    application at the paper shape under each rotation kernel, the
    serving bucket through ``RotationService`` and one eig flush
    ``(EIG_N, EIG_N, EIG_K_DELAY)``: each case's modeled seconds (the
    port's H100 record) against measured seconds (host clock between two
    synchronizes) a backend; obs counters against ``LAUNCHES``, obs-on
    outputs against obs-off ones, no synchronize with obs off; obs on
    against obs off back to back at one ``1024 x 1024`` target; and the
    launcher's ``--metrics-json``/``--trace`` in a child process.  The
    in-memory plan cache is cleared first, so ``auto`` plans by the model
    and the autotune phase's measured picks stay out of the ledger."""
    import torch
    from repro_torch import RotationSequence, obs, random_sequence
    from repro_torch.core import registry
    from repro_torch.eig import DelayedRotationBuffer
    from repro_torch.serve import RotationService
    dev = ctx["A"].device
    A = ctx["A"]
    t0 = time.perf_counter()
    registry.clear_plan_cache()
    cases = {}
    for meth, tiles in (("cuda_wave", WAVE_TILES),
                        ("cuda_mxu", dict(n_b=64, k_b=64)),
                        ("cuda_batched", {})):
        pl = seq.plan(like=A, method=meth, **tiles)
        label = f"paper {meth}" + ("/64" if meth == "cuda_mxu" else "")
        cases[label] = obs_case(label, lambda pl=pl: pl.apply(A), kernels,
                                exact=meth != "cuda_mxu")
    bucket = [(s, bctx["A"][i]) for i, s in enumerate(bctx["seqs"])]

    def serve():
        return RotationService(slots=B, store=False).apply_many(bucket)

    cases[f"serving bucket {B}x{MB}^2"] = obs_case("serving", serve,
                                                   kernels, exact=True)
    waves = RotationSequence(
        torch.from_numpy(rec["C"][:, :EIG_K_DELAY]).float().to(dev),
        torch.from_numpy(rec["S"][:, :EIG_K_DELAY]).float().to(dev))
    eye = torch.eye(EIG_N, device=dev)

    def flush():
        buf = DelayedRotationBuffer(eye.clone(), k_delay=EIG_K_DELAY)
        return buf.push_sequence(waves).value

    flush_plan = waves.plan(like=eye)
    cases[f"eig flush {EIG_N}^2 k{EIG_K_DELAY}"] = obs_case(
        "eig flush", flush, kernels, exact=flush_plan.method != "cuda_mxu")
    cases[f"eig flush {EIG_N}^2 k{EIG_K_DELAY}"]["method"] = \
        flush_plan.method

    # the cost of obs on at one 1024^2 target, back to back, in turns
    gen = torch.Generator().manual_seed(SEED + 8)
    one = torch.randn((1024, 1024), generator=gen).to(dev)
    one_plan = random_sequence(1024, 41, generator=gen,
                               device=dev).plan(like=one)
    cost = {"off": [], "on": []}
    for side in ("off", "on", "on", "off"):
        with obs.override(side == "on"):
            cost[side].append(time_ms(lambda: one_plan.apply(one),
                                      OBS_COST_REPS))
    obs.reset()
    launcher = obs_launcher(dev)
    emit(phase="obs", name=kind, nvidia_smi=smi, cases=cases,
         cost_1024=dict(method=one_plan.method, reps=OBS_COST_REPS,
                        ms_off=cost["off"], ms_on=cost["on"],
                        on_over_off=statistics.median(cost["on"])
                        / statistics.median(cost["off"])),
         launcher=launcher, seconds=time.perf_counter() - t0)


DIST_REPS = 10      # applications a timing, in rounds rep, dist, dist, rep
DIST_COL = (1024, 1024, 32)   # the column pipeline's blocked case
# the two shapes of the reference's auto crossover test, at eight devices
DIST_CROSSOVER = {"small": (64, 32, 8), "large": (2048, 512, 64)}


def turns_ms(fns: dict, reps: int = DIST_REPS) -> dict:
    """``{name: [ms, ms]}`` of two ``fns`` timed in turns a, b, b, a."""
    (a, fa), (b, fb) = fns.items()
    ms = {a: [], b: []}
    for name, fn in ((a, fa), (b, fb), (b, fb), (a, fa)):
        ms[name].append(time_ms(fn, reps))
    return ms


def dist_mesh(dev, store_name: str = "dist_store"):
    """A one-rank process group on ``dev``'s backend (NCCL on the card,
    gloo on the host) through a ``FileStore`` ``store_name`` in the run's
    temporary directory, and the ``(1, 1)`` ``("data", "model")`` mesh
    over it.  One collective checks that the backend came up."""
    import datetime
    import torch
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)   # the device NCCL's communicator binds
    store = tdist.FileStore(os.path.join(os.environ["CHIP_SMOKE_TMP"],
                                         store_name), 1)
    tdist.init_process_group(backend, store=store, rank=0, world_size=1,
                             timeout=datetime.timedelta(seconds=120))
    one = torch.ones(1, device=dev)
    tdist.all_reduce(one)
    check(float(one) == 1.0, f"{backend} all_reduce of one rank gave {one}")
    return backend, init_device_mesh(dev.type, (1, 1),
                                     mesh_dim_names=("data", "model"))


def dist_phase(ctx, seq, bctx, rec, kernels, smi: str) -> None:
    """``repro_torch.dist`` at ``D = 1`` on the card, over a one-rank NCCL
    group and a ``(1, 1)`` mesh: the row path at the paper shape under
    ``cuda_batched`` (one launch, bit for bit to the replicated plan, both
    timed: the DTensor wrapping's cost), ``auto`` (replicated, with
    ``seq.plan``'s pick), the serving bucket through ``apply_batched``
    and ``RotationService(mesh=)``, an eig flush through
    ``DelayedRotationBuffer(mesh=)``, the column pipeline (``blocked`` at
    ``DIST_COL``, bit for bit; ``accumulated`` at the paper shape, within
    ``MXU_TOL``), one sharded application with obs on, and the H100
    record's ``auto`` decisions at the reference test's two shapes for
    eight devices.  The group is destroyed at the end of the phase."""
    import torch
    import torch.distributed as tdist
    from torch.distributed.tensor import DTensor
    from repro_torch import RotationSequence, dist, obs, random_sequence
    from repro_torch.core import registry
    from repro_torch.eig import DelayedRotationBuffer
    from repro_torch.serve import RotationService
    batched_k = kernels["rotseq_batched"]
    A = ctx["A"]
    dev = A.device
    t0 = time.perf_counter()
    registry.clear_plan_cache()
    backend, mesh = dist_mesh(dev)
    try:
        # -- the row path at the paper shape ------------------------------
        rep = seq.plan(like=A, method="cuda_batched")
        sh = dist.plan_sharded(seq, like=A, mesh=mesh, method="cuda_batched")
        want = rep.apply(A)
        batched_k.LAUNCHES = 0
        got = sh.apply(A)
        torch.cuda.synchronize()
        row_launches = batched_k.LAUNCHES
        check(row_launches == 1, f"dist row: {row_launches} rotseq_batched "
              f"launches for one sharded application")
        check(torch.equal(got.full_tensor(), want),
              "dist row: sharded != replicated")
        row_ms = turns_ms({"replicated": lambda: rep.apply(A),
                           "sharded": lambda: sh.apply(A)})
        row = dict(shape=[M, N, K], launches=row_launches,
                   placements=[str(p) for p in got.placements], ms=row_ms,
                   sharded_over_replicated=statistics.median(
                       row_ms["sharded"])
                   / statistics.median(row_ms["replicated"]))
        del got, want

        # -- auto at one device ------------------------------------------
        auto = dist.plan_sharded(seq, like=A, mesh=mesh)
        pick = seq.plan(like=A).method
        check(not auto.execute_sharded and auto.method == pick,
              f"dist auto at D = 1: {auto} (seq.plan picks {pick})")

        # -- the serving bucket -------------------------------------------
        bA, padded = bctx["A"], bctx["padded"]
        brep = padded[0].plan(like=bA, method="cuda_batched",
                              shared_sequence=False)
        bsh = dist.plan_sharded(padded[0], like=bA, mesh=mesh,
                                method="cuda_batched", shared_sequence=False)
        bwant = brep.apply_batched(bA, sequences=padded)
        batched_k.LAUNCHES = 0
        bgot = bsh.apply_batched(bA, sequences=padded)
        torch.cuda.synchronize()
        bucket_launches = batched_k.LAUNCHES
        check(bucket_launches == 1, f"dist bucket: {bucket_launches} "
              f"launches")
        check(torch.equal(bgot.full_tensor(), bwant),
              "dist bucket: sharded != replicated")
        bucket_ms = turns_ms({
            "replicated": lambda: brep.apply_batched(bA, sequences=padded),
            "sharded": lambda: bsh.apply_batched(bA, sequences=padded)})
        del bgot, bwant
        requests = [(s, bA[i]) for i, s in enumerate(bctx["seqs"])]
        base = RotationService(slots=B, store=False).apply_many(requests)
        service = {}
        for method in ("auto", "cuda_batched"):
            outs = RotationService(slots=B, store=False, method=method,
                                   mesh=mesh).apply_many(requests)
            full = [o.full_tensor() if isinstance(o, DTensor) else o
                    for o in outs]
            check(all(torch.equal(a, b) for a, b in zip(full, base)),
                  f"dist RotationService(mesh=, method={method}) != "
                  f"RotationService()")
            service[method] = type(outs[0]).__name__

        # -- an eig flush ------------------------------------------------
        waves = RotationSequence(
            torch.from_numpy(rec["C"][:, :EIG_K_DELAY]).float().to(dev),
            torch.from_numpy(rec["S"][:, :EIG_K_DELAY]).float().to(dev))
        eye = torch.eye(EIG_N, device=dev)
        flush = {}
        for method in ("auto", "cuda_batched"):
            def flushed(**kw):
                buf = DelayedRotationBuffer(eye.clone(), k_delay=EIG_K_DELAY,
                                            method=method, **kw)
                return buf.push_sequence(waves).value
            got_f = flushed(mesh=mesh)
            flush[method] = type(got_f).__name__
            if isinstance(got_f, DTensor):
                got_f = got_f.full_tensor()
            check(torch.equal(got_f, flushed()),
                  f"dist eig flush ({method}) != the unsharded buffer")

        # -- the column pipeline -------------------------------------------
        gen = torch.Generator().manual_seed(SEED + 9)
        mc, nc, kc = DIST_COL
        Ac = torch.randn((mc, nc), generator=gen).to(dev)
        sc = random_sequence(nc, kc, generator=gen, device=dev)
        column = {}
        for label, X, sq, method in (("blocked", Ac, sc, "blocked"),
                                     ("accumulated", A, seq, "accumulated")):
            cplan = dist.plan_sharded(sq, like=X, mesh=mesh,
                                      partition="column", method=method)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            cout = cplan.apply(X)
            torch.cuda.synchronize()
            col_s = time.perf_counter() - t1
            if method == "blocked":
                cwant = sq.plan(like=X, method="blocked",
                                **dict(cplan.kwargs)).apply(X)
                err = max_abs(cout, cwant)
                check(err == 0.0, f"dist column blocked max|d| {err}")
            else:
                err = rel_err(cout, ctx["ref"])
                check(err <= MXU_TOL, f"dist column accumulated rel err "
                      f"{err}")
            column[label] = dict(shape=list(X.shape) + [sq.k],
                                 kwargs=dict(cplan.kwargs), seconds=col_s,
                                 err=err)

        # -- obs on: one sharded application at the paper shape ------------
        with obs.override(True):
            obs.reset()
            sh.apply(A)
            snap = obs.snapshot()
        obs.reset()
        gauges, counters = snap["gauges"], snap["counters"]
        rows = snap["roofline"]["dispatches"]
        check(gauges.get("dist.launches_per_shard") == 1.0
              and gauges.get("dist.devices") == 1.0
              and counters.get("dist.comm_bytes", 0) == 0
              and counters.get("dist.applies") == 1
              and counters.get("kernels.rotseq_batched.launches") == 1
              and len(rows) == 1 and rows[0]["comm_bytes"] == 0,
              f"dist obs: gauges {gauges}, counters {counters}, "
              f"{len(rows)} roofline rows")
        obs_row = {key: rows[0][key] for key in (
            "backend", "predicted_s", "measured_s", "model_fraction",
            "comm_bytes", "launches_per_shard")}
    finally:
        tdist.destroy_process_group()

    # -- the H100 record's sharded-vs-replicated decisions ----------------
    crossover = {}
    for label, (m, n, k) in DIST_CROSSOVER.items():
        sh_s, rep_s = dist.modeled_crossover(m, n, k, devices=8)
        crossover[label] = dict(
            shape=[m, n, k], devices=8, sharded_s=sh_s, replicated_s=rep_s,
            sharded=sh_s < rep_s,
            sharded_method=registry.select_plan(m, n, k, devices=8).method,
            replicated_method=registry.select_plan(m, n, k).method)
    emit(phase="dist", nvidia_smi=smi, backend=backend,
         nccl=".".join(map(str, torch.cuda.nccl.version()))
         if backend == "nccl" else None,
         row=row, auto=dict(method=auto.method, sharded=auto.execute_sharded,
                            seq_plan_method=pick),
         bucket=dict(shape=[B, MB, NB, KB], launches=bucket_launches,
                     ms=bucket_ms),
         service=service, eig_flush=flush, column=column, obs=obs_row,
         h100_crossover=crossover, seconds=time.perf_counter() - t0)


def rope_inputs(dev, label: str, dtype, gen):
    """``(q, k, cos, sin)`` of the ``ROPE_SHAPES`` case ``label`` on
    ``dev``, q starting ``ROPE_OFFSET[label]`` elements into its buffer."""
    import torch
    from repro_torch.kernels.rope.ref import rope_tables
    b, s, hq, hk, d = ROPE_SHAPES[label]
    q = torch.randn((b, s, hq, d), generator=gen).to(dev, dtype)
    k = torch.randn((b, s, hk, d), generator=gen).to(dev, dtype)
    off = ROPE_OFFSET.get(label, 0)
    if off:
        buf = torch.empty(q.numel() + off, device=dev, dtype=dtype)
        buf[off:].copy_(q.reshape(-1))
        q = buf[off:].view(q.shape)
    c, sn = rope_tables(torch.arange(s, device=dev), d, dtype=dtype)
    return q, k, c, sn


def rope_bound(label: str, elt: int):
    """``(ms, "bytes" or "operations")``: q and k read and written once,
    the tables read once, 6 flops a pair."""
    b, s, hq, hk, d = ROPE_SHAPES[label]
    nbytes = (2.0 * b * s * (hq + hk) * d + 2.0 * s * (d // 2)) * elt
    return bound(6.0 * b * s * (hq + hk) * (d // 2), nbytes)


def rope_reps(label: str) -> int:
    return 200 if ROPE_SHAPES[label][1] == 1 else 20


def device_us(cases, reps_of, floor_reps: int = 200):
    """Device microseconds a launch from one ``torch.profiler`` (CUPTI)
    window: each ``(key, fn)`` of ``cases`` (``fn`` launches one kernel
    whose name holds "rope") runs ``reps_of(key)`` times in turn, then a
    one-element ``add_`` ``floor_reps`` times, the launch floor.  The
    RoPE kernels are attributed in launch order.  ``{key: {mean_us,
    min_us}, "floor": ...}``; ``None`` where the trace does not hold
    exactly those launches (no device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    one = torch.zeros(1, device="cuda")
    for _, fn in cases:
        fn()
    one.add_(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for key, fn in cases:
            for _ in range(reps_of(key)):
                fn()
        for _ in range(floor_reps):
            one.add_(1)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    hits = [e for e in events if "rope" in e.name]
    rest = [e for e in events if "rope" not in e.name]
    plan = [(key, reps_of(key)) for key, _ in cases]
    if len(hits) != sum(n for _, n in plan) or len(rest) != floor_reps:
        print(json.dumps({"device_us": "window mismatch", "rope": len(hits),
                          "want": sum(n for _, n in plan),
                          "other": len(rest), "floor_reps": floor_reps,
                          "other_names": sorted({e.name[:60]
                                                 for e in rest})[:8]}),
              file=sys.stderr, flush=True)
        return None
    out, at = {}, 0
    for key, n in plan + [("floor", floor_reps)]:
        group = hits[at:at + n] if key != "floor" else rest
        at += n
        us = [e.time_range.elapsed_us() for e in group]
        out[key] = dict(mean_us=sum(us) / n, min_us=min(us))
    return out


def host_us(fn, calls: int, rounds: int = 5) -> list:
    """Host microseconds a call of ``fn`` in each of ``rounds`` rounds of
    ``calls`` calls with no synchronise among them, after a warm-up call;
    the card is synchronised between rounds."""
    import torch
    fn()
    out = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) * 1e6 / calls)
    torch.cuda.synchronize()
    return out


def rope_phase(dev) -> dict:
    """Hold the fused RoPE kernel against its plain version, bit for bit,
    in float32 and bfloat16 at every shape of ``ROPE_SHAPES``, each on the
    path ``ROPE_PATH`` names (by the wrapper's per-path counts); time each
    launch on the device by CUPTI beside the launch floor, and a wrapper
    call on the host at decode."""
    import torch
    from repro_torch.kernels.rope import kernel as rope_k
    from repro_torch.kernels.rope.ref import apply_rope_ref
    gen = torch.Generator().manual_seed(SEED + 5)
    rows, cases = {}, []
    for label, (b, s, hq, hk, d) in ROPE_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            key = f"{label}/{str(dtype).split('.')[-1]}"
            q, k, c, sn = rope_inputs(dev, label, dtype, gen)
            before = dict(rope_k.PATH_LAUNCHES)
            oq, ok = rope_k.rope(q, k, c, sn)
            pq, pk = apply_rope_ref(q, c, sn), apply_rope_ref(k, c, sn)
            torch.cuda.synchronize()
            took = [p for p, n in rope_k.PATH_LAUNCHES.items()
                    if n != before[p]]
            want = ROPE_PATH.get(label, "vector")
            check(took == [want], f"rope {key}: took {took}, not {want}")
            err = max(max_abs(oq.float(), pq.float()),
                      max_abs(ok.float(), pk.float()))
            check(torch.equal(oq, pq) and torch.equal(ok, pk),
                  f"rope {key}: kernel != plain version (max|d| {err})")
            check(bool(torch.isfinite(oq).all() and torch.isfinite(ok).all()),
                  f"rope {key}: non-finite")
            reps = rope_reps(label)
            plain_ms = time_ms(lambda: (apply_rope_ref(q, c, sn),
                                        apply_rope_ref(k, c, sn)), reps)
            events_ms = time_ms(lambda: rope_k.rope(q, k, c, sn), reps)
            b_ms, b_by = rope_bound(label, q.element_size())
            rows[key] = dict(shape=[b, s, hq, hk, d],
                             q_offset=ROPE_OFFSET.get(label, 0), path=want,
                             max_abs_err=err, events_ms=events_ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
            cases.append((key, lambda q=q, k=k, c=c, sn=sn:
                          rope_k.rope(q, k, c, sn)))
            if key == "decode/bfloat16":
                host = host_us(lambda: rope_k.rope(q, k, c, sn),
                               ROPE_HOST_CALLS)
    launches = rope_k.LAUNCHES
    dev_us = device_us(cases, lambda key: rope_reps(key.split("/")[0]))
    check(rope_k.LAUNCHES - launches == sum(
        rope_reps(key.split("/")[0]) + 1 for key, _ in cases),
        "rope launches in the profiler window")
    for key, row in rows.items():
        us = None if dev_us is None else dev_us[key]
        row["device_us"] = us
        row["bound_share"] = (None if us is None else
                              row["bound_ms"] * 1e3 / us["mean_us"])
    emit(phase="rope", bitwise_vs_plain=True, shapes=rows,
         launch_floor_us=None if dev_us is None else dev_us["floor"],
         host_us_per_call_decode_bf16=min(host), host_us_rounds=host,
         host_calls=ROPE_HOST_CALLS,
         path_launches=dict(rope_k.PATH_LAUNCHES),
         library_ms=None, library="none: no single PyTorch call computes "
         "half-split RoPE")
    main = rows["decode/bfloat16"]
    ms = (main["events_ms"] if main["device_us"] is None
          else main["device_us"]["mean_us"] / 1e3)
    return dict(
        name="rope", route="cuda", source="src/repro_torch/csrc/rope.cu",
        replaces="src/repro/kernels/rope/kernel.py:50",
        max_abs_err=max(r["max_abs_err"] for r in rows.values()),
        ms=ms, plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=None, rows=rows)


def lm_prompts(vocab: int, batch: int):
    """``batch`` seeded prompts of 4-11 tokens."""
    import numpy as np
    rng = np.random.default_rng(SEED + 6)
    lens = rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1, size=batch)
    return [rng.integers(0, vocab, size=int(n)).tolist() for n in lens]


def rope_layers(cfg) -> int:
    """Layers whose attention rotates by RoPE: every layer of the
    transformers, every third of the RG-LRU hybrid, none of Mamba2 or
    Whisper."""
    if cfg.pos_type != "rope":
        return 0
    return cfg.n_layers // 3 if cfg.family == "hybrid" else cfg.n_layers


class Prefilled:
    """An encoder-decoder model served through ``ServeEngine``: its cache
    is made from ``frames`` by the model's ``init_cache(frames, max_len,
    dtype)`` (the prefill: the encoder and each decoder layer's cross
    K/V), timed on its own ``runs`` times (the first warms cuBLAS up); each
    ``init_cache(batch, max_len, dtype)`` of the engine then gets that
    cache with its self-attention caches zeroed, so the engine's runs
    time the decode steps alone."""

    def __init__(self, model, frames, max_len: int, dtype, runs: int = 2):
        import torch
        self.model, self.device = model, model.device
        self.decode_step = model.decode_step
        self.prefill_s = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                self.cache = model.init_cache(frames, max_len, dtype=dtype)
            torch.cuda.synchronize()
            self.prefill_s.append(time.perf_counter() - t0)

    def init_cache(self, batch: int, max_len: int, dtype):
        for c in self.cache["layers"]:
            check(c["k"].shape[:2] == (batch, max_len)
                  and c["k"].dtype == dtype, "prefilled cache mismatch")
            c["k"].zero_()
            c["v"].zero_()
        self.cache["idx"] = 0
        return self.cache


def lm_decode_numbers(dev, kernels, cfg=None, serve=None) -> dict:
    """``cfg`` (SmolLM-135M at full width by default) through
    ``ServeEngine`` on the card (``serve(model)`` if given, e.g. a
    :class:`Prefilled`), its weights drawn from ``SEED``: a
    warm-up ``generate`` from an empty RoPE table cache, then ``LM_RUNS``
    timed ones (every kernel's launches, and RoPE's by path, counted over
    the first), then a profiled one; the peak memory from the model's
    build to the end.  ``rope_tables`` calls are counted by decode step in the
    warm-up and in all over the timed runs.  ms a step is the runs'
    median by the wall clock, which moves from run to run with the
    host's other load; the host's own work a step is read beside it as
    this thread's CPU time (which also counts the spin of each step's
    wait for its tokens)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.rope import kernel as rope_k
    from repro_torch.models import attention, build_model
    from repro_torch.serve import ServeEngine
    cfg = cfg or get_config(LM_ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev,
                        generator=torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = lm_prompts(cfg.vocab, LM_BATCH)
    served = serve(model) if serve else model
    eng = ServeEngine(served, cfg, batch=LM_BATCH, max_len=LM_MAX_LEN)
    finite, built, at = [], [], [0]
    step, fresh = eng._step, attention.rope_tables

    def checked(*args):
        logits, cache = step(*args)
        finite.append(torch.isfinite(logits).all())
        at[0] += 1
        return logits, cache

    def counted(*args, **kw):
        built.append(at[0])
        return fresh(*args, **kw)

    eng._step = checked
    attention.rope_tables = counted
    try:
        if hasattr(attention, "_ROPE"):
            attention._ROPE.clear()
        eng.generate(prompts, max_new=2)      # warm-up: cuBLAS, allocator
        warm = [built.count(i) for i in range(eng.steps)]
        finite.clear()
        built.clear()
        runs, cpu = [], []
        for run in range(LM_RUNS):
            if run == 0:
                for k in kernels.values():
                    k.LAUNCHES = 0
                paths = dict(rope_k.PATH_LAUNCHES)
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), time.thread_time()
            outs = eng.generate(prompts, max_new=LM_MAX_NEW)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
            cpu.append(time.thread_time() - c0)
            if run == 0:
                counts = {name: k.LAUNCHES for name, k in kernels.items()}
                paths = {p: n - paths[p]
                         for p, n in rope_k.PATH_LAUNCHES.items()}
                first = outs
            check(outs == first, "serving runs gave different tokens")
    finally:
        attention.rope_tables = fresh
    steps = eng.steps
    tokens = sum(len(o) for o in outs)
    seconds = statistics.median(runs)
    ms_per_step = seconds * 1e3 / steps
    prof = profile_decode(eng, prompts)
    peak = torch.cuda.max_memory_allocated(dev)
    return dict(
        cfg=cfg, prompts=prompts, outs=outs, finite=finite, counts=counts,
        paths=paths, warm_up=warm, rope_tables_calls=len(built),
        served=served, row=dict(
            arch=cfg.name, family=cfg.family, dtype=cfg.dtype,
            n_layers=cfg.n_layers,
            d_model=cfg.d_model, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, mla=cfg.mla,
            n_experts=cfg.n_experts, top_k=cfg.top_k, vocab=cfg.vocab,
            n_params=sum(p.numel() for p in model.parameters()),
            batch=LM_BATCH,
            max_len=LM_MAX_LEN, max_new=LM_MAX_NEW,
            prompt_lens=[len(p) for p in prompts], decode_steps=steps,
            tokens=tokens, seconds=seconds, tokens_per_s=tokens / seconds,
            ms_per_step=ms_per_step,
            ms_per_step_runs=[s * 1e3 / steps for s in runs],
            host_cpu_ms_per_step=statistics.median(cpu) * 1e3 / steps,
            host_cpu_ms_per_step_runs=[s * 1e3 / steps for s in cpu],
            init_seconds=init_s, launches=counts,
            rope_launches_per_step=counts.get("rope", 0) / steps,
            rope_path_launches=paths, max_memory_allocated_bytes=peak,
            rope_tables_calls_per_step=len(built) / (steps * LM_RUNS),
            warm_up_rope_tables_by_step=warm,
            device_launches_per_step=prof["launches_per_step"],
            device_ms_per_step=prof["device_ms_per_step"],
            device_idle_share=(
                None if prof["device_ms_per_step"] is None else
                1.0 - prof["device_ms_per_step"] / ms_per_step),
            first_outputs=outs[0][:8], profile=prof))


def lm_serving_phase(dev, kernels, cfg=None, phase="lm_serving",
                     serve=None, extra=None) -> dict:
    """``cfg`` (SmolLM-135M at full width by default) through
    ``ServeEngine`` on the card, with every kernel's launches counted over
    the serving run: one RoPE launch a rotating layer (:func:`rope_layers`)
    a step, each on the vector path; no decode step after the warm-up's
    first builds a RoPE table (a model with no RoPE builds none).
    ``extra(served)`` adds keys to the line."""
    import torch
    t0 = time.perf_counter()
    run = lm_decode_numbers(dev, kernels, cfg, serve)
    cfg, prompts, outs, counts = (run["cfg"], run["prompts"], run["outs"],
                                  run["counts"])
    steps = run["row"]["decode_steps"]
    want_steps = max(len(p) for p in prompts) - 1 + LM_MAX_NEW
    check(steps == want_steps, f"{steps} decode steps, expected {want_steps}")
    roped = rope_layers(cfg)
    check(counts["rope"] == roped * steps,
          f"rope launches {counts['rope']} != {roped} x {steps}")
    check(run["paths"]["vector"] == counts["rope"],
          f"rope launches by path {run['paths']}: not all vector")
    by_step = run["warm_up"]
    check(by_step[0] >= min(roped, 1) and not any(by_step[1:])
          and run["rope_tables_calls"] == 0,
          f"rope_tables calls by warm-up step {by_step}, "
          f"{run['rope_tables_calls']} in the serving runs")
    check(all(len(o) == LM_MAX_NEW and all(0 <= t < cfg.vocab for t in o)
              for o in outs), "generated tokens out of range or short")
    check(bool(torch.stack(run["finite"]).all()), "non-finite logits")
    emit(phase=phase, **run["row"],
         **(extra(run["served"]) if extra else {}),
         phase_seconds=time.perf_counter() - t0)
    return dict(counts=counts, ms_per_step=run["row"]["ms_per_step"])


def moe_config(n_layers: int):
    """DeepSeek-V2-Lite at full width, its depth cut to ``n_layers``."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MOE_ARCH), n_layers=n_layers)


def moe_serving_phase(dev, kernels) -> dict:
    """DeepSeek-V2-Lite at full width (``MOE_LAYERS`` layers: the dense
    first one and MoE ones) through ``ServeEngine``: MLA's RoPE through
    the kernel, one launch a layer a step at the shape
    ``ROPE_SHAPES["mla_decode"]`` held it at; routing takes the exact
    route (``N * K <= 4096``)."""
    import torch
    cfg = moe_config(MOE_LAYERS)
    check(ROPE_SHAPES["mla_decode"] == (LM_BATCH, 1, cfg.n_heads, 1,
                                        cfg.qk_rope_dim),
          f"ROPE_SHAPES['mla_decode'] {ROPE_SHAPES['mla_decode']} is not "
          f"the served MLA's q and k")
    check(LM_BATCH * cfg.top_k <= 4096, "decode past the exact route")
    out = lm_serving_phase(dev, kernels, cfg, "moe_serving")
    torch.cuda.empty_cache()
    return out


def profile_decode(eng, prompts) -> dict:
    """Device time of the decode steps of a one-token ``generate``, by
    kernel, from ``torch.profiler`` (CUPTI): per step in all, RoPE's, the
    device launches (kernels and copies) a step, and the kernels that take
    most.  Only the device's own events are summed: a host-side op's
    device time repeats theirs.  ``None`` where the trace holds no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.generate(prompts, max_new=1)
        torch.cuda.synchronize()
    steps = eng.steps
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.device_type != DeviceType.CPU]
    total = sum(us for _, us, _ in rows)
    if total == 0:
        return dict(steps=steps, device_ms_per_step=None,
                    rope_device_ms_per_step=None, launches_per_step=None,
                    top=[])
    rope = sum(us for key, us, _ in rows if "rope_" in key)
    top = sorted(rows, key=lambda r: -r[1])[:8]
    return dict(steps=steps, device_ms_per_step=total / 1e3 / steps,
                rope_device_ms_per_step=rope / 1e3 / steps,
                launches_per_step=sum(n for _, _, n in rows) / steps,
                top=[dict(name=key[:80], ms_per_step=us / 1e3 / steps,
                          calls_per_step=n / steps) for key, us, n in top])


def card_twin(host, cfg, dev):
    """The host model's weights on the card, bit for bit, through
    ``convert.lm_params_from_reference`` (its tree stacked as the
    reference's)."""
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.models.zoo import stack_params
    return lm_params_from_reference(stack_params(cfg, host.params()), cfg,
                                    device=dev)


def lm_parity_phase(dev, cfg=None, phase="lm_parity",
                    seed: int = SEED + 7, serve=None, extra=None) -> None:
    """The float32 twin of the served model (``cfg``, SmolLM-135M by
    default) decodes on the card and on the host from the same seeded
    weights: equal tokens, logits within ``PARITY_RTOL`` of the host's at
    every step.  ``serve(model)`` is what each engine serves, if given;
    ``extra(card, cfg)`` runs more checks on the card's twin and adds
    their keys to the line."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(cfg or get_config(LM_ARCH), dtype="float32")
    t0 = time.perf_counter()
    host = build_model(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(seed))
    card = card_twin(host, cfg, dev)
    init_s = time.perf_counter() - t0
    prompts = lm_prompts(cfg.vocab, LM_BATCH)[:PARITY_BATCH]
    runs = {}
    for name, model in (("card", card), ("host", host)):
        eng = ServeEngine(serve(model) if serve else model, cfg,
                          batch=PARITY_BATCH, max_len=LM_MAX_LEN)
        log = []
        step = eng._step

        def logged(*args, _step=step, _log=log):
            logits, cache = _step(*args)
            _log.append(logits[:, -1].float().cpu())
            return logits, cache

        eng._step = logged
        t0 = time.perf_counter()
        outs = eng.generate(prompts, max_new=PARITY_MAX_NEW)
        runs[name] = (outs, log, time.perf_counter() - t0)
    (c_out, c_log, c_s), (h_out, h_log, h_s) = runs["card"], runs["host"]
    check(len(c_log) == len(h_log), "card and host ran different steps")
    errs = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(c_log, h_log)]
    check(c_out == h_out, f"tokens differ: card {c_out}, host {h_out}")
    check(max(errs) <= PARITY_RTOL,
          f"logits differ by {max(errs)} of their max > {PARITY_RTOL}")
    more = extra(card, cfg) if extra else {}
    emit(phase=phase, arch=cfg.name, dtype=cfg.dtype, n_layers=cfg.n_layers,
         batch=PARITY_BATCH, max_new=PARITY_MAX_NEW, steps=len(c_log),
         tokens_equal=True, tokens=c_out, max_rel_logit_err=max(errs),
         rtol=PARITY_RTOL, card_seconds=c_s, host_seconds=h_s,
         init_seconds=init_s, **more,
         seconds=time.perf_counter() - t_phase)
    del card, host
    torch.cuda.empty_cache()


def rope_backward_phase(dev, forward: dict) -> dict:
    """The RoPE kernel's backward (one launch, ``inverse`` set) held bit
    for bit to ``torch.autograd`` of the plain version on the card, at
    every ``ROPE_SHAPES`` case in float32 and bfloat16, on the path the
    case names (the upstream gradients of the misaligned case are views
    one element into their buffers, as its q is); each backward launch
    timed on the device by CUPTI and by CUDA events beside the forward's
    (``forward``: the rope line's rows)."""
    import torch
    from repro_torch.kernels.rope import kernel as rope_k
    from repro_torch.kernels.rope.ref import apply_rope_ref
    gen = torch.Generator().manual_seed(SEED + 8)
    rows, cases = {}, []
    for label, (b, s, hq, hk, d) in ROPE_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            key = f"{label}/{str(dtype).split('.')[-1]}"
            q, k, c, sn = rope_inputs(dev, label, dtype, gen)
            gq, gk, _, _ = rope_inputs(dev, label, dtype, gen)
            pq, pk = (t.detach().requires_grad_(True) for t in (q, k))
            want = torch.autograd.grad(
                (apply_rope_ref(pq, c, sn), apply_rope_ref(pk, c, sn)),
                (pq, pk), (gq, gk))
            wq, wk = (t.detach().requires_grad_(True) for t in (q, k))
            out = rope_k.rope(wq, wk, c, sn)
            before = dict(rope_k.PATH_LAUNCHES)
            launches = rope_k.LAUNCHES
            got = torch.autograd.grad(out, (wq, wk), (gq, gk))
            torch.cuda.synchronize()
            took = [p for p, n in rope_k.PATH_LAUNCHES.items()
                    if n != before[p]]
            want_path = ROPE_PATH.get(label, "vector")
            check(rope_k.LAUNCHES - launches == 1,
                  f"rope backward {key}: {rope_k.LAUNCHES - launches} "
                  f"launches, not 1")
            check(took == [want_path],
                  f"rope backward {key}: took {took}, not {want_path}")
            err = max(max_abs(a.float(), b.float())
                      for a, b in zip(got, want))
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"rope backward {key}: kernel != autograd of the plain "
                  f"version (max|d| {err})")
            back = (lambda gq=gq, gk=gk, c=c, sn=sn:
                    rope_k._rotate(gq, gk, c, sn, True))
            rows[key] = dict(path=want_path, max_abs_err=err,
                             events_ms=time_ms(back, rope_reps(label)),
                             forward_events_ms=forward[key]["events_ms"])
            cases.append((key, back))
    dev_us = device_us(cases, lambda key: rope_reps(key.split("/")[0]))
    for key, row in rows.items():
        row["device_us"] = None if dev_us is None else dev_us[key]
        row["forward_device_us"] = forward[key]["device_us"]
    emit(phase="rope_backward", bitwise_vs_autograd=True, shapes=rows,
         launch_floor_us=None if dev_us is None else dev_us["floor"])
    return rows


def train_setup(cfg, dev, seed: int):
    """The model (seeded float32 master weights on ``dev``) and its
    training tree (the reference's stacked layout)."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.models.zoo import stack_params
    model = build_model(cfg, device=dev,
                        generator=torch.Generator().manual_seed(seed))
    return model, stack_params(cfg, model.params())


def train_run(model, cfg, params, opt, steps: int, batch: int, seq: int,
              dev, **loop_kw):
    """``TrainLoop.run(steps)`` from ``opt.init(params)`` on the
    synthetic pipeline; returns the loop and its history."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.train import TrainLoop, make_train_step
    loop = TrainLoop(train_step=make_train_step(model, cfg, opt,
                                                remat=False),
                     params=params, opt_state=opt.init(params),
                     data_iter=SyntheticLM(DataConfig(cfg.vocab, seq, batch)),
                     device=dev, **loop_kw)
    return loop, loop.run(steps)


def profile_step(step_fn) -> dict:
    """Device ms of one train step from ``torch.profiler`` (CUPTI), its
    device launches and the kernels that take most; ``None`` where the
    trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.device_type != DeviceType.CPU]
    total = sum(us for _, us, _ in rows)
    top = sorted(rows, key=lambda r: -r[1])[:8]
    return dict(profiled_wall_ms=wall * 1e3,
                device_ms=None if total == 0 else total / 1e3,
                launches=sum(n for _, _, n in rows) if total else None,
                rope_device_ms=sum(us for key, us, _ in rows
                                   if "rope_" in key) / 1e3,
                top=[dict(name=key[:80], ms=us / 1e3, calls=n)
                     for key, us, n in top])


def train_phase(dev, kernels) -> dict:
    """SmolLM-135M at full width: seeded float32 master weights, bf16
    compute, ``AdamW(warmup_cosine(TRAIN_LR))``, ``TRAIN_BATCH x
    TRAIN_SEQ`` tokens a step (attention's flash path), ``TRAIN_STEPS``
    steps through ``TrainLoop``: finite losses that fall from the first
    step to the last, 2 RoPE launches a layer a step (forward and
    backward), every layer's ``wq``/``wk`` gradient nonzero; ms a step
    (median of the last ``TRAIN_TIMED``), tokens/s, peak memory, and one
    profiled step (device ms, idle share).  Then ``TRAIN_Q8_STEPS`` steps
    of ``adamw_q8``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.train import make_train_step
    from repro_torch.train.step import _value_and_grad
    from repro_torch.tree import flatten_with_paths
    from repro_torch.kernels.rope import kernel as rope_k
    cfg = get_config(LM_ARCH)
    check(ROPE_SHAPES["train"] == (TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.head_dim),
          f"ROPE_SHAPES['train'] {ROPE_SHAPES['train']} is not the train "
          f"step's q/k")
    t_phase = time.perf_counter()
    model, params = train_setup(cfg, dev, SEED + 9)
    sched = warmup_cosine(TRAIN_LR, warmup=TRAIN_STEPS // 10 + 1,
                          total=TRAIN_STEPS)
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels.values():
        k.LAUNCHES = 0
    paths = dict(rope_k.PATH_LAUNCHES)
    loop, hist = train_run(model, cfg, params, AdamW(lr=sched), TRAIN_STEPS,
                           TRAIN_BATCH, TRAIN_SEQ, dev)
    torch.cuda.synchronize()
    counts = {name: k.LAUNCHES for name, k in kernels.items()}
    paths = {p: n - paths[p] for p, n in rope_k.PATH_LAUNCHES.items()}
    # the path the rope line and rope_backward held at this shape
    want = ROPE_PATH.get("train", "vector")
    check(paths[want] == counts["rope"],
          f"train rope launches by path {paths}: not all {want}")
    peak = torch.cuda.max_memory_allocated(dev)
    losses = hist["loss"]
    check(all(map(math.isfinite, losses)), f"train losses {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    per_step = 2 * cfg.n_layers
    check(counts["rope"] == per_step * TRAIN_STEPS,
          f"rope launches {counts['rope']} != {per_step} x {TRAIN_STEPS}")
    ms = statistics.median(hist["time"][-TRAIN_TIMED:]) * 1e3
    # the gradients of the first batch: every layer's wq and wk take one
    batch = make_batch(DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH), 0)
    _, grads = _value_and_grad(model, cfg, params, batch, False)
    zero = [path for path, g in flatten_with_paths(grads)
            if path.endswith(("['wq']['w']", "['wk']['w']"))
            and not bool((g.flatten(1).abs().amax(dim=1) > 0).all())]
    check(not zero, f"wq/wk gradients with a zero layer: {zero}")
    step = make_train_step(model, cfg, AdamW(lr=sched), remat=False)
    prof = profile_step(lambda: step(loop.params, loop.opt_state, batch))
    del grads
    # adamw_q8
    q8_loop, q8 = train_run(model, cfg, params,
                            AdamW(lr=sched, quantized=True), TRAIN_Q8_STEPS,
                            TRAIN_BATCH, TRAIN_SEQ, dev)
    check(all(map(math.isfinite, q8["loss"])), f"q8 losses {q8['loss']}")
    del q8_loop
    tokens = TRAIN_BATCH * TRAIN_SEQ
    emit(phase="train", arch=cfg.name, dtype=cfg.dtype,
         param_dtype="float32", n_layers=cfg.n_layers, d_model=cfg.d_model,
         vocab=cfg.vocab, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         steps=TRAIN_STEPS, optimizer="adamw", lr=TRAIN_LR, losses=losses,
         ms_per_step=ms, ms_per_step_all=[t * 1e3 for t in hist["time"]],
         tokens_per_s=tokens / (ms / 1e3),
         max_memory_allocated_bytes=peak, launches=counts,
         rope_launches_per_step=counts["rope"] / TRAIN_STEPS,
         rope_path_launches=paths, profiled_step=prof,
         device_idle_share=(None if prof["device_ms"] is None else
                            1.0 - prof["device_ms"] / ms),
         q8_losses=q8["loss"],
         q8_ms_per_step=statistics.median(q8["time"][1:]) * 1e3,
         seconds=time.perf_counter() - t_phase)
    return dict(loop=loop, model=model, cfg=cfg, counts=counts)


class GradRecorder:
    """An optimizer that keeps the full gradients of its first update,
    then updates as ``opt`` does."""

    def __init__(self, opt):
        self.opt, self.first = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params, **kw):
        if self.first is None:
            from torch.distributed.tensor import DTensor
            from repro_torch.tree import flatten_with_paths
            self.first = [(path, g.full_tensor() if isinstance(g, DTensor)
                           else g.clone())
                          for path, g in flatten_with_paths(grads)]
        return self.opt.update(grads, state, params, **kw)


def mesh_train_phase(dev, kernels) -> dict:
    """The train step under a mesh: SmolLM-135M at full width, seeded
    float32 master weights and bf16 compute, ``TRAIN_BATCH x TRAIN_SEQ``
    tokens a step, AdamW, over a one-rank NCCL group and the ``(1, 1)``
    ``("data", "model")`` mesh, with ``make_rules_for_mesh``'s rules and
    the parameters, optimizer state and batches placed by
    ``sharding_trees`` (``DTensor``s; ``grad_shardings`` the parameters').
    One warm step and ``MESH_STEPS`` steps under the mesh, then the same
    steps without it from the same weights: each step's loss within
    ``TRAIN_PARITY_TOL["loss"]`` and the first step's gradients within
    ``TRAIN_PARITY_TOL["grad"]`` (relative) of the step without a mesh;
    the RoPE launches of the two runs equal (the kernel ran once a shard,
    no plain version in its place); ms a step both ways; the placements
    of the embedding, an attention and an MLP weight."""
    import torch
    import torch.distributed as tdist
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.kernels.rope import kernel as rope_k
    from repro_torch.launch.mesh import make_rules_for_mesh
    from repro_torch.launch.specs import distribute_tree, sharding_trees
    from repro_torch.optim import AdamW
    from repro_torch.parallel.sharding import axis_rules
    from repro_torch.train import make_train_step
    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    model, params = train_setup(cfg, dev, SEED + 23)
    batches = [make_batch(DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH), s)
               for s in range(1 + MESH_STEPS)]
    opt = AdamW(lr=TRAIN_LR)
    backend, mesh = dist_mesh(model.device, "mesh_train_store")
    runs = {}
    try:
        rules = make_rules_for_mesh(mesh)
        trees = sharding_trees(model, cfg, ShapeConfig(
            "mesh_train", TRAIN_SEQ, TRAIN_BATCH, "train"), opt, rules, mesh)
        placed = distribute_tree(params, trees["params"])
        for label in ("mesh", "plain"):
            rec = GradRecorder(opt)
            meshed = label == "mesh"
            step = make_train_step(
                model, cfg, rec, remat=False,
                grad_shardings=trees["params"] if meshed else None)
            p = placed if meshed else params
            state = opt.init(p)
            losses, times = [], []
            with axis_rules(rules, mesh) if meshed \
                    else contextlib.nullcontext():
                for i, b in enumerate(batches):
                    if i == 1:
                        for k in kernels.values():
                            k.LAUNCHES = 0
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    if meshed:
                        b = distribute_tree(b, trees["batch"])
                    p, state, m = step(p, state, b)
                    losses.append(float(m["loss"]))
                    times.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            runs[label] = dict(losses=losses, ms=[t * 1e3 for t in times],
                               grads=rec.first,
                               counts={n: k.LAUNCHES
                                       for n, k in kernels.items()})
            del p, state
        layer = trees["params"]["group0"][0]
        shown = {path: [str(pl) for pl in sh.placements] for path, sh in (
            ("['embed']['e']", trees["params"]["embed"]["e"]),
            ("['group0'][0]['attn']['wq']['w']", layer["attn"]["wq"]["w"]),
            ("['group0'][0]['mlp']['up']['w']", layer["mlp"]["up"]["w"]))}
    finally:
        tdist.destroy_process_group()
    mesh_r, plain_r = runs["mesh"], runs["plain"]
    loss_err = max(abs(a - b) / abs(b) for a, b in
                   zip(mesh_r["losses"], plain_r["losses"]))
    errs = {path: rel_err(a, b) if b.any() or a.any() else 0.0
            for (path, a), (_, b) in zip(mesh_r["grads"], plain_r["grads"])}
    worst = max(errs, key=errs.get)
    check(all(math.isfinite(x) for x in mesh_r["losses"]),
          f"mesh_train losses {mesh_r['losses']}")
    check(loss_err <= TRAIN_PARITY_TOL["loss"],
          f"mesh_train losses {mesh_r['losses']} vs {plain_r['losses']}")
    check(errs[worst] <= TRAIN_PARITY_TOL["grad"],
          f"mesh_train gradient {worst}: rel err {errs[worst]}")
    per_run = 2 * cfg.n_layers * MESH_STEPS
    check(mesh_r["counts"]["rope"] == plain_r["counts"]["rope"] == per_run,
          f"mesh_train rope launches: mesh {mesh_r['counts']['rope']}, "
          f"plain {plain_r['counts']['rope']}, want {per_run}")
    ms = {label: statistics.median(r["ms"][1:]) for label, r in runs.items()}
    out = dict(phase="mesh_train", arch=cfg.name, dtype=cfg.dtype,
               param_dtype="float32", backend=backend,
               mesh={"shape": [1, 1], "names": ["data", "model"]},
               rules=rules.rules, fsdp_axes=list(rules.fsdp_axes),
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=MESH_STEPS,
               placements=shown, losses_mesh=mesh_r["losses"],
               losses_plain=plain_r["losses"], loss_rel_err=loss_err,
               max_grad_rel_err=errs[worst], worst_leaf=worst,
               tol=TRAIN_PARITY_TOL, ms_per_step_mesh=ms["mesh"],
               ms_per_step_plain=ms["plain"],
               mesh_over_plain=ms["mesh"] / ms["plain"],
               ms_all={label: r["ms"] for label, r in runs.items()},
               launches={label: r["counts"] for label, r in runs.items()},
               seconds=time.perf_counter() - t_phase)
    emit(**out)
    return dict(counts=mesh_r["counts"])


DRYRUN_TIMED = 5   # dryrun: steps timed outside the analysis, after a warm one
# dryrun: bytes the allocator may give a step beyond the storages of the
# ops the analysis sees: temporaries an op allocates inside itself and
# frees before it returns (on the train step logsumexp's 805 MB and the
# sums' up to 151 MB, none at its peak; 0.75 MiB live at the peak with
# this line alone, 4.9 MiB after the whole script's earlier phases)
DRYRUN_UNTRACKED = 8 * 2**20


def dryrun_cell(dev, kind: str, kernels, smi: str) -> dict:
    """One cell of the dry run held against the card: SmolLM-135M at full
    width, ``train`` the ``train`` line's step (``TRAIN_BATCH x
    TRAIN_SEQ``, float32 masters, bf16 compute, AdamW, no remat) or
    ``decode`` the ``lm_serving`` line's (``LM_BATCH`` slots of
    ``LM_MAX_LEN``, float32 weights and cache).  The record is built on
    ``meta`` with no mesh; the same step then runs on the card from
    seeded weights once warm and once under the step analysis (peak
    memory reset just before it), then ``DRYRUN_TIMED`` times outside
    it.  Argument bytes and dot flops must be equal, flops equal, the
    record's peak not below ``max_memory_allocated`` less the allocator's
    overheads: what the card held before the step besides its arguments
    (the model module's own weights, which ``functional_call`` swaps
    out, and other blocks: cuBLAS's workspace, earlier phases' caches),
    the rounding of each block to 512 bytes (the record's
    ``allocator_rounding_bytes``), and what the allocator gave the step
    beyond the storages of the ops the analysis saw on the card, an op's
    own temporaries (``untracked_bytes``, at most ``DRYRUN_UNTRACKED``);
    and the step
    must have launched RoPE once a layer (twice, training)."""
    import numpy as np
    import torch
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.launch import dryrun, roofline
    from repro_torch.hw import PLATFORMS
    from repro_torch.optim import AdamW
    from repro_torch.tree import leaves
    cfg = get_config(LM_ARCH)
    f32 = torch.float32
    if kind == "train":
        shape = ShapeConfig("chip_train", TRAIN_SEQ, TRAIN_BATCH, "train")
        opt = AdamW(lr=TRAIN_LR)
    else:
        shape = ShapeConfig("chip_decode", LM_MAX_LEN, LM_BATCH, "decode")
        opt = None
    t0 = time.perf_counter()
    rec = dryrun.step_record(cfg, shape, optimizer=opt, remat=False,
                             param_dtype=f32, cache_dtype=f32)
    record_s = time.perf_counter() - t0
    model, params = train_setup(cfg, dev, SEED + 24)
    if kind == "train":
        toks = make_batch(DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH), 0)
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in toks.items()}
        args = (params, opt.init(params), batch)
    else:
        tokens = torch.randint(0, cfg.vocab, (LM_BATCH, 1),
                               generator=torch.Generator().manual_seed(
                                   SEED + 25), dtype=torch.int32).to(dev)
        args = (params, model.init_cache(LM_BATCH, LM_MAX_LEN, dtype=f32),
                {"tokens": tokens})
    step = dryrun.cell_step(model, cfg, kind, optimizer=opt, remat=False)
    step(*args)                      # warm: cuBLAS, the allocator
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels.values():
        k.LAUNCHES = 0
    card = dryrun.measure(step, args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    launches = {name: k.LAUNCHES for name, k in kernels.items()}
    times = []
    for _ in range(DRYRUN_TIMED):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    ms = statistics.median(times) * 1e3
    held_args = sum(x.nbytes for x in leaves(args)
                    if isinstance(x, torch.Tensor))
    # the module's own weights that are not also leaves of the tree
    shared = {x.untyped_storage().data_ptr() for x in leaves(args)
              if isinstance(x, torch.Tensor)}
    module_bytes = sum(p.nbytes for p in model.parameters()
                       if p.untyped_storage().data_ptr() not in shared)
    m, hc = rec["memory"], rec["hlo_cost"]
    cm, chc = card["memory"], card["hlo_cost"]
    record_peak = rec["fits"]["peak_bytes"]
    other = held - held_args
    # what the allocator gave the step beyond the storages of the ops the
    # analysis saw on the card, in its blocks
    untracked = (peak - held) - (cm["temp_bytes"] + cm["output_bytes"]
                                 - cm["alias_bytes"]
                                 + cm["allocator_rounding_bytes"])
    an = roofline.analyze(
        {"cell": f"{cfg.name}__{shape.name}", "arch": cfg.name,
         "kind": kind, "chips": 1, "memory": m, "hlo_cost": hc},
        dims=(shape.seq_len, shape.global_batch))
    hw = PLATFORMS["cuda"]
    row = dict(
        cell=kind, arch=cfg.name, batch=shape.global_batch,
        seq=shape.seq_len, record_seconds=record_s,
        record_trace_s=rec["trace_s"], card_trace_s=card["trace_s"],
        argument_bytes=m["argument_bytes"],
        card_argument_bytes=held_args,
        dot_flops=hc["dot_flops_per_device"],
        card_dot_flops=chc["dot_flops_per_device"],
        flops=hc["flops_per_device"], card_flops=chc["flops_per_device"],
        flops_diff=chc["flops_per_device"] - hc["flops_per_device"],
        bytes=hc["bytes_per_device"], card_bytes=chc["bytes_per_device"],
        bytes_lo=hc["bytes_lo_per_device"],
        transcendentals=hc["transcendentals"],
        record_memory=m, card_memory=cm, record_peak_bytes=record_peak,
        max_memory_allocated_bytes=peak, held_before_step_bytes=held,
        module_weight_bytes=module_bytes,
        other_held_bytes=other - module_bytes,
        peak_over_max_allocated=record_peak / peak,
        peak_over_max_allocated_less_held=record_peak / (peak - other),
        allocator_rounding_bytes=m["allocator_rounding_bytes"],
        untracked_bytes=untracked,
        rope_launches=launches.get("rope", 0),
        compute_ms=an["compute_s"] * 1e3, memory_ms=an["memory_s"] * 1e3,
        collective_ms=an["collective_s"] * 1e3, dominant=an["dominant"],
        ms_per_step=ms, ms_per_step_runs=[t * 1e3 for t in times],
        model_flops=an["model_flops"],
        roofline_fraction=an["roofline_fraction"],
        mfu=an["model_flops"] / (ms / 1e3 * hw.tc_bf16_flops),
        tc_bf16_flops=hw.tc_bf16_flops, nvidia_smi=smi)
    check(m["argument_bytes"] == held_args == cm["argument_bytes"],
          f"dryrun {kind}: argument bytes {m['argument_bytes']} != card "
          f"{held_args}")
    check(hc["dot_flops_per_device"] == chc["dot_flops_per_device"],
          f"dryrun {kind}: dot flops {hc['dot_flops_per_device']} != card "
          f"{chc['dot_flops_per_device']}")
    check(hc["flops_per_device"] == chc["flops_per_device"],
          f"dryrun {kind}: flops {hc['flops_per_device']} != card "
          f"{chc['flops_per_device']}")
    rounding = m["allocator_rounding_bytes"]
    check(untracked <= DRYRUN_UNTRACKED,
          f"dryrun {kind}: {untracked} bytes allocated outside the ops "
          f"the analysis sees (limit {DRYRUN_UNTRACKED})")
    check(record_peak + rounding + max(untracked, 0) >= peak - other,
          f"dryrun {kind}: record peak {record_peak} (+ {rounding} of "
          f"allocator blocks, {untracked} untracked) below the card's "
          f"{peak} less {other} held before the step")
    rope = 2 * cfg.n_layers if kind == "train" else cfg.n_layers
    check(launches.get("rope", 0) == rope,
          f"dryrun {kind}: {launches.get('rope', 0)} rope launches in the "
          f"analyzed step, expected {rope}")
    del model, params, args
    torch.cuda.empty_cache()
    return row


def dryrun_phase(dev, kernels, smi: str) -> dict:
    """The dry run's predictions against the card on SmolLM-135M's train
    and decode steps at full width (:func:`dryrun_cell`), and the H100
    record's ``hbm_bytes`` against the card's ``total_memory``.  No
    process group: the ``dist`` and ``mesh_train`` phases own NCCL's."""
    import torch
    from repro_torch.hw import PLATFORMS
    t0 = time.perf_counter()
    cells = {kind: dryrun_cell(dev, kind, kernels, smi)
             for kind in ("train", "decode")}
    total = torch.cuda.get_device_properties(dev).total_memory
    emit(phase="dryrun", cells=cells, total_memory=total,
         hbm_bytes=PLATFORMS["cuda"].hbm_bytes,
         seconds=time.perf_counter() - t0)
    check(PLATFORMS["cuda"].hbm_bytes == total,
          f"hw hbm_bytes {PLATFORMS['cuda'].hbm_bytes} != the card's "
          f"total_memory {total}")
    return {"rope": sum(c["rope_launches"] for c in cells.values())}


def train_parity_phase(dev, cfg=None, phase="train_parity",
                       seed: int = SEED + 10) -> None:
    """One float32 step's loss and gradients of ``cfg`` (SmolLM-135M at
    full width by default), ``TRAIN_PARITY`` tokens (an encoder-decoder:
    ``AUDIO_TRAIN`` seeded frames and decoder tokens), on the card and on
    the host from the same weights, TF32 off: the card's RoPE backward is
    the kernel's, the host's autograd of the plain version.  A leaf whose
    gradient is zero on both (a weight the forward never reads, as the
    RG-LRU hybrid's MLP gate) counts as equal."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.models.zoo import stack_params
    from repro_torch.train.step import _value_and_grad
    from repro_torch.tree import flatten_with_paths
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(cfg or get_config(LM_ARCH), dtype="float32")
    b, s = TRAIN_PARITY
    frames = None
    if cfg.is_encdec:
        b, frames, s = AUDIO_TRAIN
        toks = make_batch(DataConfig(cfg.vocab, s, b), 0)
        batch = {"frames": torch.randn(
            (b, frames, cfg.d_model),
            generator=torch.Generator().manual_seed(seed)),
            "dec_tokens": toks["tokens"], "labels": toks["labels"]}
    else:
        batch = make_batch(DataConfig(cfg.vocab, s, b), 0)
    host, params = train_setup(cfg, torch.device("cpu"), seed)
    card = card_twin(host, cfg, dev)
    out = {}
    for name, model in (("card", card), ("host", host)):
        t0 = time.perf_counter()
        p = stack_params(cfg, model.params())
        metrics, grads = _value_and_grad(model, cfg, p, batch, False)
        out[name] = (float(metrics["loss"]), flatten_with_paths(grads),
                     time.perf_counter() - t0)
    (lc, gc, sc), (lh, gh, sh) = out["card"], out["host"]
    loss_err = abs(lc - lh) / abs(lh)
    zero = [path for (path, a), (_, h) in zip(gc, gh)
            if not (a.any() or h.any())]
    errs = {path: 0.0 if path in zero else rel_err(a.cpu(), h)
            for (path, a), (_, h) in zip(gc, gh)}
    worst = max(errs, key=errs.get)
    check(loss_err <= TRAIN_PARITY_TOL["loss"],
          f"train parity loss {lc} vs {lh}")
    check(errs[worst] <= TRAIN_PARITY_TOL["grad"],
          f"train parity gradient {worst}: rel err {errs[worst]}")
    roped = ("['wq']['w']", "['wk']['w']", "['wkv_a']['w']")
    check(all(float(a.abs().max()) > 0 for path, a in gc
              if path.endswith(roped)), "card wq/wk/wkv_a gradient zero")
    emit(phase=phase, arch=cfg.name, dtype=cfg.dtype,
         n_layers=cfg.n_layers, d_model=cfg.d_model, batch=b,
         seq=s, frames=frames, loss_card=lc, loss_host=lh,
         loss_rel_err=loss_err, zero_grad_leaves=zero,
         max_grad_rel_err=errs[worst], worst_leaf=worst,
         grad_rel_err={p: e for p, e in errs.items()
                       if p.endswith(roped) or "embed" in p},
         tol=TRAIN_PARITY_TOL, card_seconds=sc, host_seconds=sh,
         seconds=time.perf_counter() - t_phase)


def soap_phase(dev, kernels) -> None:
    """The reference launcher's ``--reduced --optimizer soap_givens`` on
    the card: ``SOAP_STEPS`` steps with a refresh every ``SOAP_FREQ``
    (Jacobi, ``apply_method="auto"``).  At each refresh the rotation
    kernels launch; every basis is orthogonal within ``SOAP_ORTH_TOL``
    and equals its recording applied through the pick's plain version on
    the card (bit for bit for ``cuda_wave``, ``MXU_TOL`` for
    ``cuda_mxu``).  Then one ``solver="qr"`` refresh of the embedding's
    covariances."""
    import torch
    import repro_torch.optim.soap_givens as soap_mod
    from repro_torch.configs import get_config
    from repro_torch.optim import SoapGivens, warmup_cosine
    from repro_torch.tree import map_tree
    cfg = get_config(LM_ARCH).reduced()
    model, params = train_setup(cfg, dev, SEED + 11)
    refreshes, real = [], soap_mod.SoapGivens.refresh
    recorded_bases = []
    real_basis = soap_mod.jacobi_apply_basis

    def basis(res, **kw):
        V = real_basis(res, **kw)
        recorded_bases.append((res, V))
        return V

    def timed(self, L, R):
        before = {name: k.LAUNCHES for name, k in kernels.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(self, L, R)
        torch.cuda.synchronize()
        refreshes.append(dict(
            sides=[L.shape[0], R.shape[0]], solver=self.solver,
            seconds=time.perf_counter() - t0,
            launches={name: k.LAUNCHES - before[name]
                      for name, k in kernels.items()}))
        return out

    sched = warmup_cosine(TRAIN_LR, warmup=SOAP_STEPS // 10 + 1,
                          total=SOAP_STEPS)
    opt = SoapGivens(lr=sched, update_freq=SOAP_FREQ)
    soap_mod.SoapGivens.refresh = timed
    soap_mod.jacobi_apply_basis = basis
    try:
        t0 = time.perf_counter()
        loop, hist = train_run(model, cfg, params, opt, SOAP_STEPS,
                               SOAP_BATCH, SOAP_SEQ, dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        soap_mod.SoapGivens.refresh = real
        soap_mod.jacobi_apply_basis = real_basis
    check(all(map(math.isfinite, hist["loss"])), f"soap losses {hist}")
    per = []
    map_tree(per.append, loop.opt_state["per"],
             is_leaf=lambda x: isinstance(x, dict) and "m" in x)
    eligible = sum("L" in st for st in per)
    check(eligible >= 1 and len(refreshes) == eligible * (
        SOAP_STEPS // SOAP_FREQ), f"{len(refreshes)} refreshes of "
        f"{eligible} preconditioned leaves")
    for r in refreshes:
        check(sum(r["launches"].values()) > 0,
              f"no rotation kernel launched at the refresh {r}")
    picks = {}
    for res, V in recorded_bases:
        n = V.shape[0]
        plan = res.rotation_sequence().plan(like=V, method="auto")
        check(plan.method in KERNEL_OF, f"auto planned {plan.method} at "
              f"side {n}")
        plain = plain_of(plan.method)
        want = soap_mod.jacobi_apply_basis(res, method=plain,
                                           **dict(plan.kwargs))
        err = same_family(V, want, [plan.method],
                          f"SOAP basis side {n}: {plan.method} vs {plain}")
        orth = float((V.double().T @ V.double() - torch.eye(
            n, dtype=torch.float64, device=dev)).abs().max())
        check(orth <= SOAP_ORTH_TOL, f"SOAP basis side {n}: orth {orth}")
        picks.setdefault(n, dict(method=plan.method,
                                 tiles=dict(plan.kwargs), plain=plain,
                                 err_vs_plain=[], orth_err=[]))
        picks[n]["err_vs_plain"].append(err)
        picks[n]["orth_err"].append(orth)
    st = loop.opt_state["per"]["embed"]["e"]
    qr_opt = SoapGivens(solver="qr")
    soap_mod.SoapGivens.refresh = timed
    try:
        QL, QR = qr_opt.refresh(st["L"], st["R"])
    finally:
        soap_mod.SoapGivens.refresh = real
    qr = refreshes.pop()
    for Q in (QL, QR):
        n = Q.shape[0]
        orth = float((Q.double().T @ Q.double() - torch.eye(
            n, dtype=torch.float64, device=dev)).abs().max())
        check(orth <= SOAP_ORTH_TOL, f"SOAP qr basis side {n}: orth {orth}")
    check(sum(qr["launches"].values()) > 0, "qr refresh launched nothing")
    emit(phase="soap", arch=cfg.name, reduced=True, steps=SOAP_STEPS,
         update_freq=SOAP_FREQ, batch=SOAP_BATCH, seq=SOAP_SEQ,
         losses=hist["loss"], seconds=seconds, refreshes=refreshes,
         refresh_seconds=[r["seconds"] for r in refreshes],
         picks_by_side=picks, qr_refresh=qr, qr_orth_tol=SOAP_ORTH_TOL)


def hybrid_config():
    """RecurrentGemma-9B at full width, its depth cut to
    ``HYBRID_LAYERS``: one (R, R, A) repetition and the 2-block recurrent
    tail the config's 38 layers end in."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(HYBRID_ARCH),
                               n_layers=HYBRID_LAYERS)


def hybrid_serving_phase(dev, kernels) -> dict:
    """The hybrid through ``ServeEngine``: the local attention's RoPE
    through the kernel, one launch a step at the shape
    ``ROPE_SHAPES["griffin_decode"]`` held it at; the ring of
    ``min(window, max_len)`` slots."""
    import torch
    from repro_torch.configs import get_config
    cfg = hybrid_config()
    check(ROPE_SHAPES["griffin_decode"] == (
        LM_BATCH, 1, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim),
        f"ROPE_SHAPES['griffin_decode'] {ROPE_SHAPES['griffin_decode']} "
        f"is not the served local attention's q and k")
    full = get_config(HYBRID_ARCH).n_layers
    check(rope_layers(cfg) == 1 and cfg.n_layers % 3 == full % 3,
          "the cut hybrid is not one (R, R, A) and the config's tail")
    out = lm_serving_phase(dev, kernels, cfg, "hybrid_serving",
                           extra=lambda served: dict(
                               lru_width=cfg.lru_width, window=cfg.window,
                               ring_slots=min(cfg.window, LM_MAX_LEN),
                               layers=["rec", "rec", "attn", "rec", "rec"],
                               depth_cut=f"{cfg.n_layers} of {full} layers"))
    torch.cuda.empty_cache()
    return out


def stub_frames(batch: int, frames: int, d: int, seed: int):
    """Seeded stub frontend output ``(batch, frames, d)`` on the host."""
    import torch
    return torch.randn((batch, frames, d),
                       generator=torch.Generator().manual_seed(seed))


def audio_serving_phase(dev, kernels) -> dict:
    """Whisper-large-v3 with nothing cut: ``init_cache`` runs the encoder
    on ``LM_BATCH x AUDIO_FRAMES`` stub frames (timed apart, on the dense
    attention route) and caches each decoder layer's cross K/V in float32,
    then ``ServeEngine`` decodes the LM path's prompts (no RoPE launch)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import attention
    cfg = get_config(AUDIO_ARCH)
    frames = stub_frames(LM_BATCH, AUDIO_FRAMES, cfg.d_model,
                         SEED + 14).to(dev)

    def extra(served):
        layers = served.cache["layers"]
        return dict(
            frames=list(frames.shape), prefill_ms=served.prefill_s[-1] * 1e3,
            prefill_ms_runs=[t * 1e3 for t in served.prefill_s],
            encoder_route=("flash" if attention._chunked(AUDIO_FRAMES,
                                                         AUDIO_FRAMES)
                           else "dense"),
            cross_kv_bytes=sum(c[k].numel() * c[k].element_size()
                               for c in layers for k in ("xk", "xv")),
            decode_timing="decode steps alone; the prefill timed apart")

    out = lm_serving_phase(
        dev, kernels, cfg, "audio_serving",
        serve=lambda m: Prefilled(m, frames, LM_MAX_LEN, torch.float32),
        extra=extra)
    del frames
    torch.cuda.empty_cache()
    return out


def audio_parity_phase(dev) -> None:
    """The float32 Whisper twin on the card and on the host, each
    prefilled from the same ``PARITY_BATCH x AUDIO_PARITY_FRAMES`` stub
    frames (the host's encoder is cut from the served 1500 frames)."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(AUDIO_ARCH)
    frames = stub_frames(PARITY_BATCH, AUDIO_PARITY_FRAMES, cfg.d_model,
                         SEED + 15)
    lm_parity_phase(
        dev, cfg, "audio_parity", SEED + 16,
        serve=lambda m: Prefilled(m, frames.to(m.device), LM_MAX_LEN,
                                  torch.float32, runs=1),
        extra=lambda card, cfg: dict(
            frames=list(frames.shape),
            cut=f"encoder on {PARITY_BATCH} x {AUDIO_PARITY_FRAMES} frames "
                f"(served: {LM_BATCH} x {AUDIO_FRAMES})"))


def ssm_card_checks(card, cfg) -> dict:
    """On the card's float32 Mamba2 twin: the chunked forward against
    step-by-step decode over ``SSM_CHUNKS`` tokens (two chunks of the
    published 256), within ``SSM_DECODE_RTOL`` of the forward's largest
    logit; and one backward of the train step at that chunk with every
    gradient finite (the reference's decay mask gives NaN there)."""
    import torch
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.models.zoo import stack_params
    from repro_torch.train.step import _value_and_grad
    from repro_torch.tree import flatten_with_paths
    b, s = SSM_CHUNKS
    check(s == 2 * cfg.ssm_chunk, f"{s} tokens are not two chunks")
    batch = make_batch(DataConfig(cfg.vocab, s, b), 0)
    toks = torch.from_numpy(batch["tokens"]).long().to(card.device)
    t0 = time.perf_counter()
    with torch.inference_mode():
        full = card(toks)
        cache = card.init_cache(b, s, dtype=torch.float32)
        err = 0.0
        for t in range(s):
            lg, cache = card.decode_step(cache, toks[:, t:t + 1])
            err = max(err, float((lg[:, 0] - full[:, t]).abs().max()))
        rel = err / float(full.abs().max())
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    check(rel <= SSM_DECODE_RTOL,
          f"mamba2 forward vs decode at {b} x {s}: {rel} > {SSM_DECODE_RTOL}")
    del full, cache
    t0 = time.perf_counter()
    metrics, grads = _value_and_grad(card, cfg, stack_params(
        cfg, card.params()), batch, False)
    flat = flatten_with_paths(grads)
    bad = [p for p, g in flat if not bool(torch.isfinite(g).all())]
    torch.cuda.synchronize()
    check(not bad and math.isfinite(float(metrics["loss"])),
          f"mamba2 backward at chunk {cfg.ssm_chunk}: non-finite {bad}")
    del grads
    torch.cuda.empty_cache()
    return dict(
        forward_vs_decode=dict(batch=b, seq=s, chunk=cfg.ssm_chunk,
                               max_rel_err=rel, rtol=SSM_DECODE_RTOL,
                               seconds=fwd_s),
        backward=dict(batch=b, seq=s, chunk=cfg.ssm_chunk,
                      loss=float(metrics["loss"]), leaves=len(flat),
                      all_finite=True, seconds=time.perf_counter() - t0))


def ssm_soap_phase(dev, kernels) -> None:
    """``SSM_SOAP_STEPS`` steps of ``SoapGivens`` (a refresh every
    ``SSM_SOAP_FREQ``) on reduced Mamba2 on the card: the paper's
    rotations reach the attention-free model through the optimizer.
    Finite losses; the refreshes launch the rotation kernels; every
    preconditioned leaf's bases orthogonal within ``SOAP_ORTH_TOL``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.optim import SoapGivens, warmup_cosine
    from repro_torch.tree import flatten_with_paths
    cfg = get_config(SSM_ARCH).reduced()
    t0 = time.perf_counter()
    model, params = train_setup(cfg, dev, SEED + 17)
    sched = warmup_cosine(TRAIN_LR, warmup=SSM_SOAP_STEPS // 10 + 1,
                          total=SSM_SOAP_STEPS)
    before = {name: k.LAUNCHES for name, k in kernels.items()}
    loop, hist = train_run(model, cfg, params,
                           SoapGivens(lr=sched, update_freq=SSM_SOAP_FREQ),
                           SSM_SOAP_STEPS, SOAP_BATCH, SOAP_SEQ, dev)
    torch.cuda.synchronize()
    launches = {name: k.LAUNCHES - before[name]
                for name, k in kernels.items()}
    check(all(map(math.isfinite, hist["loss"])),
          f"ssm soap losses {hist['loss']}")
    rot = sum(n for name, n in launches.items() if name != "rope")
    check(rot > 0, f"no rotation kernel launched by the refreshes: "
                   f"{launches}")
    orth, leaves = 0.0, []
    for path, Q in flatten_with_paths(loop.opt_state["per"]):
        if path.endswith(("['QL']", "['QR']")):
            n = Q.shape[0]
            orth = max(orth, float((Q.double().T @ Q.double() - torch.eye(
                n, dtype=torch.float64, device=dev)).abs().max()))
            leaves.append(path)
    check(leaves and orth <= SOAP_ORTH_TOL, f"ssm soap bases: orth {orth}")
    emit(phase="ssm_soap", arch=cfg.name, reduced=True,
         steps=SSM_SOAP_STEPS, update_freq=SSM_SOAP_FREQ, batch=SOAP_BATCH,
         seq=SOAP_SEQ, losses=hist["loss"], launches=launches,
         rotation_launches=rot, bases=len(leaves), max_orth_err=orth,
         orth_tol=SOAP_ORTH_TOL, seconds=time.perf_counter() - t0)


def compression_phase(dev, kernels) -> None:
    """``compress_lowrank`` of a seeded ``LOWRANK_SHAPE`` float32 gradient
    at rank ``LOWRANK_RANK`` on the card (``svd_givens``; the rotation
    kernels accumulate its vectors): its error within ``1 + 1e-3`` of
    ``np.linalg.svd``'s optimal one.  Then ``compressed_psum`` over a
    one-rank NCCL group, torn down after: the sum of one shard is its
    int8 round trip, bit for bit."""
    import datetime
    import numpy as np
    import torch
    import torch.distributed as tdist
    from repro_torch.parallel import (compress_lowrank, compressed_psum,
                                      decompress_lowrank,
                                      dequantize_after_allreduce,
                                      quantize_for_allreduce)
    W = np.random.default_rng(SEED + 12).standard_normal(
        LOWRANK_SHAPE).astype(np.float32)
    Wd = torch.from_numpy(W).to(dev)
    for k in kernels.values():
        k.LAUNCHES = 0
    t0 = time.perf_counter()
    P, Q = compress_lowrank(Wd, LOWRANK_RANK)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {name: k.LAUNCHES for name, k in kernels.items()}
    err = float(np.linalg.norm(W.astype(np.float64) - (
        decompress_lowrank(P, Q).double().cpu().numpy())))
    sv = np.linalg.svd(W.astype(np.float64), compute_uv=False)
    best = float(np.linalg.norm(sv[LOWRANK_RANK:]))
    check(err <= best * (1 + 1e-3), f"low-rank error {err} vs best {best}")
    check(sum(counts.values()) > 0, "compress_lowrank launched no kernel")
    store = tdist.FileStore(os.path.join(os.environ["CHIP_SMOKE_TMP"],
                                         "psum_store"), 1)
    tdist.init_process_group("nccl", store=store, rank=0, world_size=1,
                             timeout=datetime.timedelta(seconds=120))
    try:
        x = Wd[:, :7].contiguous()
        got = compressed_psum(x)
        want = dequantize_after_allreduce(*quantize_for_allreduce(x),
                                          x.shape)
        torch.cuda.synchronize()
        check(torch.equal(got, want), "compressed_psum of one rank")
    finally:
        tdist.destroy_process_group()
    emit(phase="compression", shape=list(LOWRANK_SHAPE), rank=LOWRANK_RANK,
         err=err, best=best, ratio=err / best, seconds=seconds,
         launches=counts, wire_fraction=LOWRANK_RANK * sum(LOWRANK_SHAPE)
         / (LOWRANK_SHAPE[0] * LOWRANK_SHAPE[1]),
         compressed_psum="nccl, 1 rank, bit for bit")


def ckpt_phase(dev, train: dict) -> None:
    """The train phase's full-width params and AdamW state saved and
    restored bit for bit; then a loop resumed at step ``CKPT_AT`` of a
    ``CKPT_STEPS`` run gives the uninterrupted run's losses."""
    import torch
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.optim import AdamW
    from repro_torch.train import TrainLoop, make_train_step
    from repro_torch.tree import leaves
    loop, model, cfg = train["loop"], train["model"], train["cfg"]
    tree = {"params": loop.params, "opt": loop.opt_state}
    root = os.path.join(os.environ["CHIP_SMOKE_TMP"], "ckpt")
    mgr = CheckpointManager(os.path.join(root, "full"))
    t0 = time.perf_counter()
    mgr.save(loop.step, tree, blocking=True)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = mgr.restore(loop.step, tree, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(all(torch.equal(a.to(dev), b) for a, b in
              zip(leaves(tree), leaves(back))), "checkpoint not bit for bit")
    nbytes = sum(t.numel() * t.element_size() for t in leaves(tree))
    del back
    params = loop.params
    opt = AdamW(lr=TRAIN_LR)
    step = make_train_step(model, cfg, opt, remat=False)
    dcfg = DataConfig(cfg.vocab, CKPT_SEQ, CKPT_BATCH)

    def run(steps, ckpt_dir=None, every=CKPT_AT, restore=False):
        lp = TrainLoop(train_step=step, params=params,
                       opt_state=opt.init(params),
                       data_iter=SyntheticLM(dcfg), ckpt_dir=ckpt_dir,
                       ckpt_every=every, device=dev)
        start = lp.maybe_restore() if restore else 0
        return start, lp.run(steps)["loss"]

    resume = os.path.join(root, "resume")
    run(CKPT_AT, resume)
    start, tail = run(CKPT_STEPS - CKPT_AT, resume, restore=True)
    _, whole = run(CKPT_STEPS)
    check(start == CKPT_AT, f"resumed at {start}")
    errs = [abs(a - b) / abs(b) for a, b in zip(tail, whole[CKPT_AT:])]
    check(max(errs) <= 1e-5, f"resumed losses {tail} vs {whole[CKPT_AT:]}")
    emit(phase="ckpt", bytes=nbytes, leaves=len(leaves(tree)),
         save_seconds=save_s, restore_seconds=restore_s, bitwise=True,
         resume_at=CKPT_AT, steps=CKPT_STEPS, batch=CKPT_BATCH,
         seq=CKPT_SEQ, resumed_losses=tail, whole_losses=whole,
         resumed_equal=tail == whole[CKPT_AT:], max_rel_err=max(errs))


def train_launcher_phase() -> None:
    """``python -m repro_torch.launch.train`` at full width in a child
    process on the card: exit 0, a final loss printed."""
    args = ["--arch", LM_ARCH, "--steps", "4", "--batch", "4",
            "--seq", "256"]
    env = dict(os.environ, PYTHONPATH=str(SRC) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *args], capture_output=True, text=True, env=env,
                         timeout=600, cwd=str(ROOT))
    seconds = time.perf_counter() - t0
    check(out.returncode == 0 and "final loss" in out.stdout,
          f"launch.train exit {out.returncode}: {out.stderr[-2000:]}")
    emit(phase="train_launcher", args=args, exit=out.returncode,
         seconds=seconds, last_line=out.stdout.strip().splitlines()[-1])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {SRC}", file=sys.stderr)
        return 1
    # a fresh plan cache: plans persisted by an earlier run on this
    # machine would change auto's picks in every phase
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        os.environ["REPRO_PLAN_CACHE"] = os.path.join(tmp, "plans.json")
        os.environ["CHIP_SMOKE_TMP"] = tmp
        return run()


def run() -> int:
    import torch
    sys.path.insert(0, str(SRC))
    from repro_torch import RotationSequence, random_sequence
    from repro_torch.core.accumulate import rot_sequence_accumulated
    from repro_torch.core.blocked import rot_sequence_blocked
    from repro_torch.core.ref import (rot_sequence_numpy,
                                      rot_sequence_wavefront)
    from repro_torch.kernels import _build
    from repro_torch.kernels.rotseq import kernel as wave_k
    from repro_torch.kernels.rotseq.ops import rot_sequence_wave
    from repro_torch.kernels.rotseq_batched import kernel as batched_k
    from repro_torch.kernels.rope import kernel as rope_k
    from repro_torch.kernels.rotseq_mxu import kernel as mxu_k

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    emit(phase="device", name=kind, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    # -- build ----------------------------------------------------------
    t0 = time.perf_counter()
    cached = _build._target().exists()
    log = _build.build()
    report = [ln.strip() for ln in log.splitlines()
              if "entry function" in ln or "registers" in ln
              or "spill" in ln or "error" in ln.lower()]
    emit(phase="build", built=not cached,
         seconds=time.perf_counter() - t0, ptxas=report)

    gen = torch.Generator().manual_seed(SEED)
    A = torch.randn((M, N), generator=gen).to(dev)
    seq = random_sequence(N, K, generator=gen, device=dev)
    C, S = seq.cos, seq.sin
    ref = rot_sequence_wavefront(A, C, S)
    # yardstick: the dense product with Q formed beforehand (not timed)
    Q = rot_sequence_wave(torch.eye(N, device=dev), C, S, **WAVE_TILES)
    lib_ms = time_ms(lambda: torch.matmul(A, Q), 10)
    emit(phase="matmul", ms=lib_ms, rel_err_vs_wavefront=rel_err(
        torch.matmul(A, Q), ref))
    # a ragged signed problem, and a small one held to the numpy oracle
    gen_r = torch.Generator().manual_seed(SEED + 1)
    mr, nr, kr = 3000, 1000, 37
    Ar = torch.randn((mr, nr), generator=gen_r).to(dev)
    sr = random_sequence(nr, kr, generator=gen_r, device=dev)
    sign = torch.where(torch.rand((nr - 1, kr), generator=gen_r) < 0.5,
                       1.0, -1.0)
    seq_r = RotationSequence.from_waves(sr.cos, sr.sin, sign.to(dev))
    small = RotationSequence.from_waves(sr.cos[:63, :7], sr.sin[:63, :7],
                                        sign[:63, :7].to(dev))
    As = Ar[:40, :64].contiguous()
    oracle = torch.from_numpy(rot_sequence_numpy(
        As.cpu().numpy(), small.cos.cpu().numpy(), small.sin.cpu().numpy(),
        G=small.sign.cpu().numpy()))
    ctx = dict(A=A, C=C, S=S, ref=ref, lib_ms=lib_ms,
               io_bytes=4.0 * (2 * M * N + 2 * (N - 1) * K),
               ragged=(Ar, seq_r), small=(As, small))
    ptxas = ptxas_table(log)

    # -- the two tiled kernels at the paper's configuration ---------------
    entries = {"rotseq_wave": wave_phase(ctx, ptxas),
               "rotseq_mxu": mxu_phase(ctx, ptxas)}
    BEST_TILES["cuda_mxu"] = entries["rotseq_mxu"]["best"]

    # -- main path: plan(like=A).apply(A), auto and both kernels ----------
    wave_k.LAUNCHES = 0
    mxu_k.LAUNCHES = 0
    batched_k.LAUNCHES = 0
    t0 = time.perf_counter()
    plan = seq.plan(like=A)
    out = plan.apply(A)
    rplans = {meth: seq_r.plan(like=Ar, method=meth)
              for meth in ("cuda_wave", "cuda_mxu")}
    ragged = {meth: rp.apply(Ar) for meth, rp in rplans.items()}
    smalls = {meth: small.plan(like=As, method=meth, **tiles).apply(As)
              for meth, tiles in (("cuda_wave", WAVE_TILES),
                                  ("cuda_mxu", dict(n_b=8, k_b=4)))}
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    counts = {"rotseq_wave": wave_k.LAUNCHES, "rotseq_mxu": mxu_k.LAUNCHES,
              "rotseq_batched": batched_k.LAUNCHES}

    check(plan.method in KERNEL_OF, f"auto planned {plan.method} on the card")
    kw = dict(plan.kwargs)
    plans = {meth: (plan if meth == plan.method else
                    seq.plan(like=A, method=meth, **BEST_TILES[meth]))
             for meth in KERNEL_OF}
    # cuda_wave held bit for bit to the blocked plain version at its
    # tiles, and a cuda_batched pick held bit for bit to cuda_wave
    wave_plan = plans["cuda_wave"]
    wave_out = out if plan.method == "cuda_wave" else wave_plan.apply(A)
    err_wave = max_abs(wave_out, rot_sequence_blocked(
        A, C, S, **dict(wave_plan.kwargs)))
    check(err_wave == 0.0, f"cuda_wave max|d| {err_wave} vs blocked")
    if plan.method == "cuda_mxu":
        err_auto = rel_err(out, rot_sequence_accumulated(A, C, S, **kw))
        check(err_auto <= MXU_TOL, f"auto cuda_mxu rel err {err_auto}")
    else:
        err_auto = max_abs(out, wave_out)
        check(err_auto == 0.0, f"auto {plan.method} max|d| {err_auto} "
              f"vs cuda_wave")
    rag_w = max_abs(ragged["cuda_wave"], rot_sequence_blocked(
        Ar, seq_r.cos, seq_r.sin, G=seq_r.sign,
        **dict(rplans["cuda_wave"].kwargs)))
    rag_m = rel_err(ragged["cuda_mxu"], rot_sequence_accumulated(
        Ar, seq_r.cos, seq_r.sin, G=seq_r.sign,
        **dict(rplans["cuda_mxu"].kwargs)))
    check(rag_w == 0.0, f"ragged cuda_wave max|d| {rag_w}")
    check(rag_m <= MXU_TOL, f"ragged cuda_mxu rel err {rag_m}")
    small_err = {meth: float((o.cpu().double() - oracle).abs().max())
                 for meth, o in smalls.items()}
    check(max(small_err.values()) <= 5e-5 * 7,
          f"small problem vs numpy oracle {small_err}")
    path = {"rotseq_wave", "rotseq_mxu", KERNEL_OF[plan.method]}
    for name in path:
        check(counts[name] > 0, f"{name} never launched on the main path")
    # the planned application against each kernel's best plan, on the
    # same inputs: what the planner's pick costs end to end
    apply_ms = {meth: time_ms(lambda: pl.apply(A), 3)
                for meth, pl in plans.items()}
    # the fused kernel's one launch at this shape, apart from the packing
    # (transposes, sign grid, live windows) that its application adds
    _, _, fused_args = pack_batched(A[None], [seq])
    fused_out, _ = batched_k.rotseq_batched(*fused_args)
    fused_err = max_abs(fused_out[0].t(), wave_out)
    check(fused_err == 0.0, f"rotseq_batched at {M}x{N}x{K} max|d| "
          f"{fused_err} vs cuda_wave")
    fused_ms = time_ms(lambda: batched_k.rotseq_batched(*fused_args), 3)
    pack_ms = time_ms(lambda: pack_batched(A[None], [seq]), 3)
    fused_live = int(fused_args[5].sum())
    fused_b_ms, fused_b_by = bound(6.0 * M * fused_live,
                                   4.0 * (2 * M * N + 3 * fused_live))
    del fused_args, fused_out
    emit(phase="main_path", auto_method=plan.method, auto_kwargs=kw,
         auto_err=err_auto, apply_ms=apply_ms,
         auto_vs_best=apply_ms[plan.method] / min(apply_ms.values()),
         rotseq_batched_launch_ms=fused_ms, rotseq_batched_pack_ms=pack_ms,
         rotseq_batched_bound_ms=fused_b_ms,
         rotseq_batched_bound_by=fused_b_by,
         rotseq_batched_launch_max_abs_err_vs_cuda_wave=fused_err,
         ragged_shape=[mr, nr, kr], ragged_wave_max_abs_err=rag_w,
         ragged_mxu_rel_err=rag_m, small_vs_numpy_oracle=small_err,
         launches=counts, seconds=main_s)

    planner_phase(ctx, seq)

    # (the fused kernel has no tiles; its kernels-line numbers are the
    # serving bucket's, its launch at this shape is in the main_path line)
    for name in ("rotseq_wave", "rotseq_mxu"):
        entries[name]["launches"] = counts[name]

    # -- gradient ------------------------------------------------------------
    Ag = A.clone().requires_grad_(True)
    W = torch.randn((M, N), generator=gen).to(dev)
    t0 = time.perf_counter()
    (grad,) = torch.autograd.grad((plan.apply(Ag) * W).sum(), Ag)
    back = plan.apply(grad)
    torch.cuda.synchronize()
    g_err = rel_err(back, W)
    check(bool(torch.isfinite(grad).all()), "gradient: non-finite")
    check(g_err <= GRAD_TOL, f"plan.apply(grad) vs W rel err {g_err}")
    emit(phase="gradient", method=plan.method, rel_err=g_err, tol=GRAD_TOL,
         seconds=time.perf_counter() - t0)

    # -- the paper's sweep of m = n at k = 180 ------------------------------
    paper_sweep_phase(dev, {"rotseq_wave": wave_k, "rotseq_mxu": mxu_k,
                            "rotseq_batched": batched_k})

    # -- the serving path at a realistic bucket ----------------------------
    gen_b = torch.Generator().manual_seed(SEED + 2)
    ks = torch.randint(KMIN, KMAX + 1, (B,), generator=gen_b).tolist()
    seqs = [random_sequence(NB, k, generator=gen_b, device=dev) for k in ks]
    bctx = dict(A=torch.randn((B, MB, NB), generator=gen_b).to(dev),
                seqs=seqs, padded=[s.pad_to(KB) for s in seqs])
    entries["rotseq_batched"] = batched_phase(bctx, ptxas)
    served = serving_phase(bctx, {"rotseq_wave": wave_k, "rotseq_mxu": mxu_k,
                                  "rotseq_batched": batched_k})
    entries["rotseq_batched"]["launches"] = served["rotseq_batched"]

    # -- the eigensolver path: recorded rotations flushed in batches ------
    rec = eig_phase(dev, {"rotseq_wave": wave_k, "rotseq_mxu": mxu_k,
                          "rotseq_batched": batched_k})

    # -- measured autotune, after every phase that checks auto's pick ------
    autotune_phase(ctx, seq, bctx, rec, {"rotseq_wave": wave_k,
                                         "rotseq_mxu": mxu_k,
                                         "rotseq_batched": batched_k})

    # -- observability: the roofline ledger, counters, the launcher -------
    obs_phase(ctx, seq, bctx, rec, {"rotseq_wave": wave_k,
                                    "rotseq_mxu": mxu_k,
                                    "rotseq_batched": batched_k}, kind, smi)

    # -- sharded execution at one device over NCCL ------------------------
    dist_phase(ctx, seq, bctx, rec, {"rotseq_batched": batched_k}, smi)

    # -- the LM serving path: SmolLM-135M through ServeEngine -------------
    entries["rope"] = rope_phase(dev)
    lm = lm_serving_phase(dev, {"rotseq_wave": wave_k, "rotseq_mxu": mxu_k,
                                "rotseq_batched": batched_k,
                                "rope": rope_k})
    entries["rope"]["launches"] = lm["counts"]["rope"]
    lm_parity_phase(dev)

    # -- the MoE family: DeepSeek-V2-Lite at full width, MLA's RoPE -------
    t_moe = time.perf_counter()
    moe = moe_serving_phase(dev, {"rotseq_wave": wave_k, "rotseq_mxu": mxu_k,
                                  "rotseq_batched": batched_k,
                                  "rope": rope_k})
    entries["rope"]["launches"] += moe["counts"]["rope"]
    lm_parity_phase(dev, moe_config(MOE_PARITY_LAYERS), "moe_parity",
                    SEED + 12)
    # reduced() deepseek: 4 layers (dense + 3 MoE) at d_model 64
    train_parity_phase(dev, moe_config(MOE_LAYERS).reduced(),
                       "moe_train_parity", SEED + 13)
    emit(phase="moe", seconds=time.perf_counter() - t_moe)

    # -- the recurrent and encoder-decoder families -----------------------
    from repro_torch.configs import get_config
    t_fam = time.perf_counter()
    all_k = {"rotseq_wave": wave_k, "rotseq_mxu": mxu_k,
             "rotseq_batched": batched_k, "rope": rope_k}
    served = {"hybrid_serving": hybrid_serving_phase(dev, all_k)}
    lm_parity_phase(dev, hybrid_config(), "hybrid_parity", SEED + 18)
    served["ssm_serving"] = lm_serving_phase(
        dev, all_k, get_config(SSM_ARCH), "ssm_serving")
    lm_parity_phase(dev, get_config(SSM_ARCH), "ssm_parity", SEED + 19,
                    extra=ssm_card_checks)
    served["audio_serving"] = audio_serving_phase(dev, all_k)
    audio_parity_phase(dev)
    for family, arch, seed in (("hybrid", HYBRID_ARCH, SEED + 20),
                               ("ssm", SSM_ARCH, SEED + 21),
                               ("audio", AUDIO_ARCH, SEED + 22)):
        train_parity_phase(dev, get_config(arch).reduced(),
                           f"{family}_train_parity", seed)
    ssm_soap_phase(dev, all_k)
    for out in served.values():
        entries["rope"]["launches"] += out["counts"]["rope"]
    emit(phase="families", seconds=time.perf_counter() - t_fam)

    # -- training: RoPE's backward, SmolLM-135M steps, SOAP, checkpoints --
    t_train = time.perf_counter()
    rope_backward_phase(dev, entries["rope"]["rows"])
    train = train_phase(dev, all_k)
    # each path's launches apart
    entries["rope"]["launches_by_path"] = {
        "lm_serving": lm["counts"]["rope"],
        "moe_serving": moe["counts"]["rope"],
        **{path: out["counts"]["rope"] for path, out in served.items()},
        "train": train["counts"]["rope"]}
    entries["rope"]["launches"] += train["counts"]["rope"]
    train_parity_phase(dev)
    soap_phase(dev, all_k)
    compression_phase(dev, all_k)
    ckpt_phase(dev, train)
    del train
    train_launcher_phase()
    # -- the train step under a (1, 1) mesh over NCCL ----------------------
    meshed = mesh_train_phase(dev, all_k)
    entries["rope"]["launches_by_path"]["mesh_train"] = \
        meshed["counts"]["rope"]
    entries["rope"]["launches"] += meshed["counts"]["rope"]
    emit(phase="training", seconds=time.perf_counter() - t_train)

    # -- the dry run's records against the card ----------------------------
    dry = dryrun_phase(dev, all_k, smi)
    entries["rope"]["launches_by_path"]["dryrun"] = dry["rope"]
    entries["rope"]["launches"] += dry["rope"]

    # the two tiled kernels' numbers are taken at the paper configuration
    order = ["name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms"]
    extra = ["launches_by_path"]
    print(json.dumps({"kernels": [
        {**{key: e[key] for key in order},
         **{key: e[key] for key in extra if key in e}}
        for e in entries.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
