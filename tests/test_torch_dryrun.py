"""The dry run, its step accounting and the roofline against the reference.

``repro_torch.launch.step_analysis`` counts a step's ops under a
dispatch mode; ``launch.dryrun`` runs each cell's step on ``meta``;
``launch.roofline`` prices the records.  Held here, on the CPU:

* **flop parity** (a): the port's ``dot_flops`` of a reduced config's
  train step (2 x 64 tokens, ``remat=True``) and prefill forward equal
  the reference's ``analyze_hlo(...).dot_flops`` of the same step
  compiled by XLA, exactly, for the dense, MoE, SSM and audio families;
  Mamba2's train step is the one exception (its SSD backward, within
  ``SSD_DOT_RTOL``).  ``flops`` (dots plus one an element of each
  elementwise op and reduction) within ``FLOPS_RTOL``: the port counts
  eager ops, the reference XLA's fused ones;
* **argument bytes** (b): equal to the reference's
  ``memory_analysis().argument_size_in_bytes`` (2 170 628 on SmolLM);
* **the same count on every device**: the step on CPU tensors counts
  what it counts on ``meta``, and a RoPE launch the mode cannot see
  (:func:`step_analysis.opaque`) counts what the plain version counts;
* **collectives** (c), in a subprocess under an 8-rank ``fake`` process
  group (torch's private ``torch.testing._internal.distributed.fake_pg``):
  the mirror of ``tests/test_distributed.py::
  test_hlo_collectives_accounting``, a collective inside a loop of
  ``L = 5`` counts at least ``L`` times and the per-device flops reach
  ``0.9 * L * 2 * M * M * (M / 8)``;
* AdamW's 8-bit state once a shard: equal to the whole tensor's
  quantization where a shard of the last axis is whole blocks, that axis
  gathered where it is not;
* **the mini mesh** (d), the mirror of ``test_mini_dryrun_multipod_mesh``:
  reduced SmolLM on a ``(2, 2, 2)`` ``("pod", "data", "model")`` mesh
  has collectives (counted as ``CommDebugMode`` counts them) and
  ``temp_bytes > 0``; its per-device ``dot_flops`` over the 8 ranks is
  within ``[1, MESH_OVERCOUNT]`` of the unsharded step's (attention and
  the loss run replicated over ``model``; a ``DTensor`` op counted
  twice, once whole and once local, would pass 3);
* **one production cell** (e), ``smollm-135m`` ``train_4k`` on the
  single-pod mesh in a subprocess: ``ok``, its ``fits`` its own peak
  against ``hbm_bytes``, its ``argument_bytes`` the bytes worked out
  from the ``sharding_trees`` specs;
* **the roofline** (f) on a hand-made record, by hand from
  ``hw.PLATFORMS["cuda"]``; its ``PARAMS`` and formulas the
  reference's;
* **RoPE on meta** (g): the plain version's shapes, values on the CPU.
"""
import functools
import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeConfig as JShape
from repro.launch import mesh as j_mesh
from repro.launch import roofline as j_roofline
from repro.launch import specs as j_specs
from repro.launch.hlo_analysis import analyze_hlo
from repro.models import build_model as j_build_model
from repro.optim import AdamW as JAdamW
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.hw import PLATFORMS
from repro_torch.kernels.rope import kernel as rope_k
from repro_torch.kernels.rope.ref import apply_rope_ref
from repro_torch.launch import dryrun, roofline, step_analysis
from repro_torch.launch.mesh import make_rules_for_mesh
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.tree import leaves

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 64
FAMILIES = ["smollm-135m", "deepseek-v2-lite-16b", "mamba2-370m",
            "whisper-large-v3"]
SSD_DOT_RTOL = 5e-3     # Mamba2's train step: 262 144 of 1.5e8 (0.17%)
FLOPS_RTOL = 0.15       # eager ops against XLA's fused ones
MESH_OVERCOUNT = 1.5    # (d): measured 1.125
SUBPROCESS_SECONDS = 240


@functools.lru_cache(maxsize=None)
def _reference(arch, kind):
    """``(analyze_hlo cost, memory_analysis)`` of the reference's step of
    ``arch``'s reduced config, compiled over abstract inputs."""
    cfg = j_get_config(arch).reduced()
    model = j_build_model(cfg)
    params = j_specs.abstract_params(model)
    batch = j_specs.input_specs(cfg, JShape("t", S, B, kind))
    if kind == "train":
        opt = JAdamW(lr=1e-4)
        lowered = jax.jit(j_make_train_step(model, cfg, opt)).lower(
            params, j_specs.abstract_opt_state(opt, params), batch)
    elif cfg.is_encdec:
        lowered = jax.jit(lambda p, b: model.forward(
            p, b["frames"], b["dec_tokens"])).lower(params, batch)
    else:
        lowered = jax.jit(lambda p, b: model.forward(
            p, b["tokens"])).lower(params, batch)
    compiled = lowered.compile()
    return analyze_hlo(compiled.as_text()), compiled.memory_analysis()


@functools.lru_cache(maxsize=None)
def _port(arch, kind):
    return dryrun.step_record(get_config(arch).reduced(),
                              ShapeConfig("t", S, B, kind),
                              optimizer=AdamW(lr=1e-4),
                              param_dtype=torch.float32)


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_dot_flops_equal_the_reference(arch, kind):
    ref, _ = _reference(arch, kind)
    got = _port(arch, kind)["hlo_cost"]
    if (arch, kind) == ("mamba2-370m", "train"):
        assert got["dot_flops_per_device"] == pytest.approx(
            ref.dot_flops, rel=SSD_DOT_RTOL)
    else:
        assert got["dot_flops_per_device"] == ref.dot_flops
    assert got["flops_per_device"] == pytest.approx(ref.flops,
                                                    rel=FLOPS_RTOL)
    assert got["collective_counts"] == {}


def test_smollm_train_step_dot_flops_and_argument_bytes():
    """The reference's figures on reduced SmolLM's train step (2 x 64
    tokens, remat, AdamW): 201 326 592 dot flops, 2 170 628 bytes of
    arguments."""
    ref, mem = _reference("smollm-135m", "train")
    got = _port("smollm-135m", "train")
    assert ref.dot_flops == got["hlo_cost"]["dot_flops_per_device"] \
        == 201_326_592
    assert mem.argument_size_in_bytes == got["memory"]["argument_bytes"] \
        == 2_170_628
    m = got["memory"]
    assert m["alias_bytes"] == 0 and m["temp_bytes"] > 0
    assert got["fits"]["peak_bytes"] == (m["argument_bytes"]
                                         + m["temp_bytes"]
                                         + m["output_bytes"])


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-v2-lite-16b"])
def test_argument_bytes_equal_the_reference(arch):
    for kind in ("train", "prefill"):
        _, mem = _reference(arch, kind)
        assert _port(arch, kind)["memory"]["argument_bytes"] == \
            mem.argument_size_in_bytes


def test_decode_writes_its_cache_in_place():
    """A decode step's cache comes back in the storages it went in:
    counted as aliased, so the peak holds it once."""
    rec = dryrun.step_record(get_config("smollm-135m").reduced(),
                             ShapeConfig("t", S, B, "decode"),
                             cache_dtype=torch.float32)
    m = rec["memory"]
    cfg = get_config("smollm-135m").reduced()
    cache = 2 * cfg.n_layers * B * S * cfg.n_kv_heads * cfg.head_dim * 4
    assert m["alias_bytes"] == cache
    assert m["output_bytes"] == cache + B * cfg.vocab * 4   # f32 logits
    assert rec["hlo_cost"]["dot_flops_per_device"] > 0


def _train_args(cfg, device):
    model = build_model(cfg, device=device,
                        generator=torch.Generator().manual_seed(0))
    opt = AdamW(lr=1e-4)
    meta_args = dryrun.cell_args(model, cfg, ShapeConfig("t", S, B,
                                                         "train"),
                                 optimizer=opt, param_dtype=torch.float32)
    if device == "meta":
        return model, opt, meta_args
    from repro_torch.models.zoo import stack_params
    params = stack_params(cfg, model.params())
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, tuple(v.shape), generator=gen,
                              dtype=v.dtype)
             for k, v in meta_args[2].items()}
    return model, opt, (params, opt.init(params), batch)


@pytest.mark.parametrize("remat", [False, True])
def test_cpu_tensors_count_what_meta_counts(remat):
    """The same step on CPU tensors and on ``meta``: every count equal,
    the arguments' bytes too, and the live-storage peak."""
    cfg = get_config("smollm-135m").reduced()
    out = {}
    for device in ("cpu", "meta"):
        model, opt, args = _train_args(cfg, device)
        step = dryrun.cell_step(model, cfg, "train", optimizer=opt,
                                remat=remat)
        rec = dryrun.measure(step, args)
        del rec["trace_s"]
        out[device] = rec
    assert out["cpu"] == out["meta"]


def test_opaque_counts_the_plain_version():
    """A launch the mode cannot see counts the plain version's ops, on
    meta copies whose storages are not tracked; outside an analysis it
    does nothing."""
    gen = torch.Generator().manual_seed(0)
    q, k = torch.randn(2, 8, 4, 16, generator=gen), torch.randn(2, 8, 2, 16)
    cos, sin = torch.randn(8, 8), torch.randn(8, 8)
    for inverse in (False, True):
        plain = step_analysis.trace_step(rope_k._plain, q, k, cos, sin,
                                         inverse)
        seen = step_analysis.trace_step(
            step_analysis.opaque, rope_k._plain, q, k, cos, sin, inverse)
        assert seen.cost == plain.cost and plain.cost.flops > 0
        assert seen.peak_bytes == 0 and seen.out is None
    assert step_analysis.opaque(rope_k._plain, q, k, cos, sin, False) \
        is None


def test_a_loop_counts_every_iteration():
    """Eager ops: a matmul inside a Python loop of L counts L times (the
    reference parses the while's trip count)."""
    L, M = 5, 32
    x = torch.empty(M, M, device="meta")
    ws = torch.empty(L, M, M, device="meta")

    def f(x, ws):
        for i in range(L):
            x = torch.tanh(x @ ws[i])
        return x

    c = step_analysis.analyze_step(f, x, ws)
    assert c.dot_flops == L * 2 * M ** 3
    assert c.transcendentals == L * M * M
    assert c.flops == c.dot_flops + L * M * M
    assert c.bytes_lo == 2 * L * M * M * 4
    # the product reads two operands, tanh one; each writes its result
    assert c.bytes == L * 5 * M * M * 4


# ------------------------------------------------- under a fake mesh ----

MESH_SCRIPT = r"""
import json
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_rules_for_mesh
from repro_torch.launch.step_analysis import analyze_step
from repro_torch.optim import AdamW

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
out = {}
# (c): the reference's scan of L matmuls over an 8-way sharded axis
L, M = 5, 64
mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("d",))
x = DTensor.from_local(torch.empty(M, M // 8, device="meta"), mesh,
                       [Shard(1)], run_check=False, shape=(M, M),
                       stride=(M, 1))
ws = DTensor.from_local(torch.empty(L, M // 8, M, device="meta"), mesh,
                        [Shard(1)], run_check=False, shape=(L, M, M),
                        stride=(M * M, M, 1))

def f(x, ws):
    for i in range(L):
        x = torch.tanh(x @ ws[i])
    return x

c = analyze_step(f, x, ws)
out["loop"] = dict(counts=c.collective_counts, bytes=c.collective_bytes,
                   flops=c.flops, dot=c.dot_flops)
# (d): reduced SmolLM on the (2, 2, 2) mini mesh
cfg = get_config("smollm-135m").reduced()
shape = ShapeConfig("mini", 64, 8, "train")
pod = init_device_mesh("cpu", (2, 2, 2),
                       mesh_dim_names=("pod", "data", "model"))
rec = dryrun.step_record(cfg, shape, mesh=pod,
                         rules=make_rules_for_mesh(pod),
                         optimizer=AdamW(lr=1e-4))
plain = dryrun.step_record(cfg, shape, optimizer=AdamW(lr=1e-4))
out["mini"] = dict(rec=rec, plain=plain)
# AdamW's 8-bit state once a shard: rank 0's shard of the last axis in
# whole blocks (2048 over 8) quantizes as the whole tensor's first 256
# columns; in parts of blocks (1024 over 8) that axis is gathered first
from repro_torch.optim.adamw import dequantize_q8, quantize_q8
x = torch.randn(3, 2048, generator=torch.Generator().manual_seed(0))
dx = DTensor.from_local(x[:, :256].clone(), mesh, [Shard(1)],
                        run_check=False, shape=x.shape, stride=x.stride())
qv, whole = quantize_q8(dx), quantize_q8(x)
y = DTensor.from_local(torch.zeros(3, 128), mesh, [Shard(1)],
                       run_check=False, shape=(3, 1024), stride=(1024, 1))
out["q8"] = dict(
    q=torch.equal(qv.q.to_local(), whole.q[:, :256]),
    scale=torch.equal(qv.scale.to_local(), whole.scale[:, :1]),
    back=torch.equal(dequantize_q8(qv, dx.shape).to_local(),
                     dequantize_q8(whole, x.shape)[:, :256]),
    placements=[str(qv.q.placements), str(qv.scale.placements)],
    shapes=[list(qv.q.shape), list(qv.scale.shape)],
    parts=str(quantize_q8(y).q.placements))
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_q8_state_once_a_shard(fake_mesh):
    q8 = fake_mesh["q8"]
    assert q8["q"] and q8["scale"] and q8["back"]
    assert q8["placements"] == ["(Shard(dim=1),)"] * 2
    assert q8["shapes"] == [[3, 2048], [3, 8]]
    assert q8["parts"] == "(Replicate(),)"


CELL_SCRIPT = r"""
import json, sys
from repro_torch.launch import dryrun
dryrun.OUT_DIR = sys.argv[1]
print(json.dumps(dryrun.run_cell("smollm-135m", "train_4k", "single")))
"""


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """Both subprocesses at once: the fake 8-rank mesh (c, d) and the
    production cell (e), whose record goes to a tmp directory."""
    out_dir = tmp_path_factory.mktemp("dryrun")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", script, *argv], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, script, argv in (("mesh", MESH_SCRIPT, []),
                                   ("cell", CELL_SCRIPT, [str(out_dir)]))}
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=SUBPROCESS_SECONDS)
            assert proc.returncode == 0, stderr[-3000:]
            out[name] = json.loads(stdout.splitlines()[-1])
    finally:
        for proc in procs.values():
            proc.kill()
    out["out_dir"] = out_dir
    return out


@pytest.fixture(scope="module")
def fake_mesh(children):
    return children["mesh"]


def test_collectives_in_a_loop_count_every_iteration(fake_mesh):
    """The mirror of ``test_hlo_collectives_accounting``: L = 5, M = 64
    over 8 ranks."""
    L, M = 5, 64
    loop = fake_mesh["loop"]
    assert sum(loop["counts"].values()) >= L, loop["counts"]
    assert set(loop["counts"]) <= set(step_analysis.COLLECTIVES.values())
    assert all(b > 0 for b in loop["bytes"].values())
    assert loop["flops"] >= L * 2 * M * M * (M // 8) * 0.9
    # per device: the local products only, never the whole ones too
    assert loop["dot"] == L * 2 * M * M * (M // 8)


def test_mini_mesh_dry_run(fake_mesh):
    rec, plain = fake_mesh["mini"]["rec"], fake_mesh["mini"]["plain"]
    hc = rec["hlo_cost"]
    assert sum(hc["collective_counts"].values()) > 0
    names = {"all-gather": "all_gather_into_tensor",
             "all-reduce": "all_reduce",
             "reduce-scatter": "reduce_scatter_tensor"}
    assert {names[k]: v for k, v in hc["collective_counts"].items()} == \
        rec["comm_debug_counts"]
    assert rec["memory"]["temp_bytes"] > 0
    ratio = 8 * hc["dot_flops_per_device"] / \
        plain["hlo_cost"]["dot_flops_per_device"]
    assert 1.0 <= ratio <= MESH_OVERCOUNT, ratio
    # the arguments are rank 0's shards: less than the whole tree
    assert rec["memory"]["argument_bytes"] < \
        plain["memory"]["argument_bytes"]
    assert not plain["hlo_cost"]["collective_counts"]




def _spec_bytes(shape, spec, mesh_shape, itemsize):
    """Bytes of rank 0's shard of ``shape`` under ``spec``: each dim
    ``ceil(n / ways)``, ``ways`` the product of its axes' sizes."""
    n = itemsize
    for i, d in enumerate(shape):
        axes = spec[i] if i < len(spec) else None
        axes = () if axes is None else (
            (axes,) if isinstance(axes, str) else axes)
        n *= -(-d // math.prod(mesh_shape[a] for a in axes))
    return n


def test_production_cell_single_pod(children):
    """SmolLM-135M ``train_4k`` on the ``(16, 16)`` mesh, at full width:
    ``ok``; argument bytes = parameters and both AdamW moments (float32,
    placed as the parameters), the step count, tokens and labels (int32),
    each by its spec."""
    rec = children["cell"]
    assert (rec["status"], rec["chips"], rec["kind"]) == ("ok", 256, "train")
    assert (children["out_dir"]
            / "smollm-135m__train_4k__single.json").exists()
    m = rec["memory"]
    peak = (m["argument_bytes"] + m["temp_bytes"] + m["output_bytes"]
            - m["alias_bytes"])
    assert rec["fits"] == {"peak_bytes": peak,
                           "hbm_bytes": PLATFORMS["cuda"].hbm_bytes,
                           "fits": peak <= PLATFORMS["cuda"].hbm_bytes}
    # the bytes by spec, from the rules on a stub of the mesh
    cfg = get_config("smollm-135m")
    stub = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(16, 16))
    rules = make_rules_for_mesh(stub, seq_parallel=True)
    model = build_model(cfg, device="meta")
    from repro_torch.launch.specs import (_spec_from_logical_tree,
                                          abstract_params, batch_spec_tree,
                                          input_specs)
    params = abstract_params(model)
    specs = _spec_from_logical_tree(params, model.param_logical(), rules,
                                    params=True)
    shape = dryrun.SHAPES["train_4k"]
    param_bytes = sum(_spec_bytes(tuple(p.shape), tuple(s),
                                  rules.mesh_shape, 4)
                      for p, s in zip(leaves(params), leaves(specs)))
    batch = input_specs(cfg, shape)
    bspec = batch_spec_tree(cfg, shape, rules)
    batch_bytes = sum(_spec_bytes(tuple(batch[k].shape), tuple(bspec[k]),
                                  rules.mesh_shape, 4) for k in batch)
    assert m["argument_bytes"] == 3 * param_bytes + 4 + batch_bytes
    assert rec["hlo_cost"]["collective_counts"]


# ------------------------------------------------------- the roofline ----

def test_roofline_params_and_formulas_are_the_reference():
    assert roofline.PARAMS == j_roofline.PARAMS
    for arch in roofline.PARAMS:
        for kind, seq, batch in (("train", 4096, 256),
                                 ("prefill", 32768, 32),
                                 ("decode", 32768, 128)):
            assert roofline.model_flops(arch, kind, seq, batch) == \
                j_roofline.model_flops(arch, kind, seq, batch)
    coll = {"all-gather": 3e9, "reduce-scatter": 1e9, "all-reduce": 2e8,
            "all-to-all": 5e8, "collective-permute": 7e7}
    # the same ring factors; only the link rate differs
    assert roofline.coll_seconds(coll, 256) * roofline.LINK_BW == \
        pytest.approx(j_roofline.coll_seconds(coll, 256)
                      * j_roofline.LINK_BW, rel=1e-12)


def test_roofline_terms_by_hand():
    hw = PLATFORMS["cuda"]
    rec = {"cell": "smollm-135m__train_4k__single", "arch": "smollm-135m",
           "shape": "train_4k", "kind": "train", "chips": 256,
           "memory": {"argument_bytes": 3 * 2**30, "temp_bytes": 2**30,
                      "output_bytes": 2**30, "alias_bytes": 0},
           "hlo_cost": {"flops_per_device": 5e12,
                        "dot_flops_per_device": 4e12,
                        "bytes_per_device": 9e11,
                        "bytes_lo_per_device": 1e11,
                        "collective_bytes_per_device": {
                            "all-gather": 3.2e10, "all-reduce": 1.6e9}}}
    r = roofline.analyze(rec)
    assert r["compute_s"] == pytest.approx(4e12 / hw.tc_bf16_flops
                                           + 1e12 / hw.vpu_flops)
    assert r["memory_s"] == pytest.approx(3e11 / hw.hbm_bw)
    assert r["collective_s"] == pytest.approx(
        (3.2e10 + 2 * 1.6e9) * 15 / 16 / hw.link_bw)
    mf = 6 * 0.135e9 * 4096 * 256
    terms = {"compute": r["compute_s"], "memory": r["memory_s"],
             "collective": r["collective_s"]}
    assert r["dominant"] == max(terms, key=terms.get)
    assert r["roofline_fraction"] == pytest.approx(
        mf / (256 * hw.tc_bf16_flops) / max(terms.values()))
    assert r["mem_gib"] == 5.0
    assert hw.tc_bf16_flops == 989.4e12 and hw.mxu_flops == 67e12


def test_roofline_cli_reads_the_records(tmp_path, monkeypatch, capsys):
    rec = {"cell": "a__train_4k__single", "status": "ok",
           "arch": "smollm-135m", "shape": "train_4k", "kind": "train",
           "mesh": "single", "chips": 256,
           "memory": {"argument_bytes": 2**30, "temp_bytes": 0,
                      "output_bytes": 0, "alias_bytes": 0},
           "hlo_cost": {"flops_per_device": 2e12,
                        "dot_flops_per_device": 1e12,
                        "bytes_per_device": 1e10, "bytes_lo_per_device": 1e9,
                        "collective_bytes_per_device": {}}}
    (tmp_path / "a.json").write_text(json.dumps(rec))
    (tmp_path / "b.json").write_text(json.dumps(
        {"cell": "b", "status": "skipped", "reason": "x"}))
    monkeypatch.setattr(roofline, "DRYRUN_DIR", str(tmp_path))
    monkeypatch.setattr(sys, "argv", ["roofline", "--markdown", "--out",
                                      str(tmp_path / "t.md")])
    roofline.main()
    text = capsys.readouterr().out
    assert "| a__train_4k__single |" in text and "| b |" not in text
    rows = json.loads((tmp_path / "t.json").read_text())
    assert rows[0]["dominant"] == "compute" and rows[0]["mem_gib"] == 1.0


# ------------------------------------------------------- RoPE on meta ----

def test_rope_meta_branch_gives_shapes_and_cpu_values():
    gen = torch.Generator().manual_seed(2)
    q = torch.randn(2, 8, 4, 16, generator=gen)
    k = torch.randn(2, 8, 2, 16, generator=gen)
    cos, sin = torch.randn(8, 8, generator=gen), torch.randn(8, 8,
                                                             generator=gen)
    mq, mk = rope_k.rope(*(t.to("meta") for t in (q, k, cos, sin)))
    assert (mq.device.type, mq.shape, mq.dtype) == ("meta", q.shape,
                                                    q.dtype)
    assert (mk.device.type, mk.shape) == ("meta", k.shape)
    launches = rope_k.LAUNCHES
    cq, ck = rope_k.rope(q, k, cos, sin)
    assert cq.device.type == "cpu"
    assert torch.equal(cq, apply_rope_ref(q, cos, sin))
    assert torch.equal(ck, apply_rope_ref(k, cos, sin))
    assert rope_k.LAUNCHES == launches
    # through autograd on meta: the backward's shapes too
    mq = q.to("meta").requires_grad_(True)
    oq, ok = rope_k.rope(mq, k.to("meta"), cos.to("meta"), sin.to("meta"))
    (g,) = torch.autograd.grad(oq.sum(), mq)
    assert (g.device.type, g.shape) == ("meta", q.shape)


def test_production_mesh_rules_match_the_reference_stub():
    """The dry run's rules (sequence parallel on) are the reference's."""
    for names, shape in ((("data", "model"), (16, 16)),
                         (("pod", "data", "model"), (2, 16, 16))):
        ref = j_mesh.make_rules_for_mesh(
            types.SimpleNamespace(axis_names=names,
                                  devices=np.empty(shape, dtype=np.int8)),
            seq_parallel=True)
        port = make_rules_for_mesh(
            types.SimpleNamespace(mesh_dim_names=names, shape=shape),
            seq_parallel=True)
        assert port.rules == dict(ref.rules)
        assert port.fsdp_axes == ref.fsdp_axes
