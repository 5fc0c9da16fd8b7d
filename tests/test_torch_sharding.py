"""The logical-axis sharding rules of the port against the reference.

``repro_torch.parallel.sharding``, ``launch.mesh`` and the sharding half
of ``launch.specs`` are pure functions of shapes and rules, so they are
held to the reference's on the same inputs:

* ``_dedup``, ``logical_to_spec`` and ``param_spec`` case by case;
* every parameter spec of the ten full configs (the models' own
  ``param_logical()`` over their meta parameter trees: 317 leaves),
  equal to the reference's leaf for leaf under the single-pod and the
  multi-pod rules of ``make_rules_for_mesh`` and under ``DEFAULT_RULES``.
  The reference's rules read only ``mesh.axis_names`` and
  ``mesh.devices.shape``, so a stub stands in for its 256- and
  512-device meshes;
* the batch specs of every (config, shape) cell of ``SHAPES`` that runs,
  and the cache specs of its decode cells: the port's cache holds one
  entry a layer where the reference stacks them, so a layer's spec is
  the reference's of its stack without the stack's leading axis;
* ``to_placements`` (``Shard``/``Replicate`` a mesh dimension, nested
  ``Shard``s in mesh order, ``ValueError`` out of order), ``shard``
  without rules or a mesh (its input itself) and on a plain tensor
  under both (``TypeError``);
* both production meshes built in one process under torch's ``fake``
  process group (``torch.testing._internal.distributed.fake_pg``, a
  private module of torch's tests) in a subprocess, since the group is
  global: their rules equal the reference's on the stub.
"""
import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as j_get_config
from repro.launch import mesh as j_mesh
from repro.launch import specs as j_specs
from repro.models import build_model as j_build_model
from repro.parallel import sharding as j_sharding
from repro_torch.configs import ARCHS, SHAPES, get_config, shape_skips
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_rules_for_mesh
from repro_torch.models import build_model
from repro_torch.models.transformer import _groups
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import (DEFAULT_RULES,
                                           PartitionSpec, axis_rules, shard,
                                           to_placements)
from repro_torch.tree import flatten_with_paths

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single_pod": (("data", "model"), (16, 16)),
          "multi_pod": (("pod", "data", "model"), (2, 16, 16))}
N_PARAM_LEAVES = 317


def _stub(names, shape):
    """The reference's mesh as its rules read it, and the port's."""
    ref = types.SimpleNamespace(axis_names=names,
                                devices=np.empty(shape, dtype=np.int8))
    port = types.SimpleNamespace(mesh_dim_names=names, shape=shape)
    return ref, port


def _rules():
    """``{label: (reference rules, port rules)}``."""
    out = {"default": (j_sharding.DEFAULT_RULES, DEFAULT_RULES)}
    for label, (names, shape) in MESHES.items():
        ref, port = _stub(names, shape)
        out[label] = (j_mesh.make_rules_for_mesh(ref),
                      make_rules_for_mesh(port))
    return out


RULES = _rules()


def _jflat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return [(jax.tree_util.keystr(p), tuple(s)) for p, s in flat]


def _flat(tree):
    return [(p, tuple(s)) for p, s in flatten_with_paths(tree)]


# ------------------------------------------------------------- the rules --

def test_rules_for_mesh_equal_the_reference():
    for label, (ref, port) in RULES.items():
        assert port.rules == ref.rules, label
        assert port.fsdp_axes == ref.fsdp_axes, label
        assert port.mesh_shape == ref.mesh_shape, label
    ref, port = _stub(*MESHES["single_pod"])
    assert make_rules_for_mesh(port, seq_parallel=True).rules == \
        j_mesh.make_rules_for_mesh(ref, seq_parallel=True).rules


DEDUP = [([("pod", "data"), "model", ("data", "model")], None),
         (["model", None, "model"], (8, 4, 16)),
         ([("pod", "data"), None, "model"], (6, 3, 16)),
         ([("pod", "data"), "model"], (32, 9)),
         ([None, ("data",)], (5, 48))]


@pytest.mark.parametrize("label", sorted(RULES))
@pytest.mark.parametrize("axes,shape", DEDUP)
def test_dedup_equals_the_reference(label, axes, shape):
    ref, port = RULES[label]
    assert sharding._dedup(list(axes), shape, port) == \
        j_sharding._dedup(list(axes), shape, ref)


LOGICAL = [(("batch", None, "heads"), (8, 4, 9)),
           (("batch", "seq", "embed"), (256, 4096, 576)),
           (("batch", None, "vocab"), (32, 7, 49152)),
           (("batch", "experts", None, None), (1, 64, 12, 2048)),
           ((), ()), (("heads", "kv_heads"), (16, 16))]
PARAMS = [((576, 1536), ("embed", "ff")),
          ((49152, 576), ("vocab", "embed")), ((30, 576), (None, None)),
          ((4, 64, 100), ("experts", None, "embed")),
          ((17, 3), ("embed", "ff")), ((512,), ("ff",))]


@pytest.mark.parametrize("label", sorted(RULES))
def test_logical_and_param_specs_equal_the_reference(label):
    ref, port = RULES[label]
    for logical, shape in LOGICAL:
        got = sharding.logical_to_spec(logical, port, shape=shape)
        assert isinstance(got, PartitionSpec)
        assert tuple(got) == tuple(j_sharding.logical_to_spec(
            logical, ref, shape=shape)), (logical, shape)
    for shape, logical in PARAMS:
        assert tuple(sharding.param_spec(shape, logical, port)) == tuple(
            j_sharding.param_spec(shape, logical, ref)), (shape, logical)
    # the active rules stand in for a missing argument; none: P()
    with axis_rules(port):
        assert sharding.current_rules() is port
        assert tuple(sharding.param_spec(*PARAMS[0])) == tuple(
            j_sharding.param_spec(*PARAMS[0], ref))
    assert sharding.current_rules() is None
    assert sharding.param_spec(*PARAMS[0]) == PartitionSpec()
    assert repr(PartitionSpec("model", ("pod", "data"))) == \
        repr(JP("model", ("pod", "data")))


# ------------------------------------------------- every config's trees --

@pytest.fixture(scope="module")
def models():
    """``{arch: (reference model, port model on the meta device)}``."""
    return {arch: (j_build_model(j_get_config(arch)),
                   build_model(get_config(arch), device="meta"))
            for arch in ARCHS}


@pytest.fixture(scope="module")
def param_abs(models):
    return {arch: (j_specs.abstract_params(ref), specs.abstract_params(port))
            for arch, (ref, port) in models.items()}


@pytest.mark.parametrize("label", sorted(RULES))
def test_param_specs_of_every_config_equal_the_reference(models, param_abs,
                                                         label):
    ref_rules, port_rules = RULES[label]
    total = 0
    for arch, (ref, port) in models.items():
        ref_abs, port_abs = param_abs[arch]
        assert all(t.device.type == "meta"
                   for _, t in flatten_with_paths(port_abs))
        want = _jflat(j_specs._spec_from_logical_tree(
            ref_abs, ref.param_logical(), ref_rules, params=True))
        got = _flat(specs._spec_from_logical_tree(
            port_abs, port.param_logical(), port_rules, params=True))
        assert got == want, arch
        total += len(got)
    assert total == N_PARAM_LEAVES


def _cells(kind):
    return [(arch, name) for arch in ARCHS for name, shape in SHAPES.items()
            if shape.kind == kind and shape_skips(get_config(arch), shape)
            is None]


@pytest.mark.parametrize("label", sorted(RULES))
def test_batch_specs_equal_the_reference(label):
    ref_rules, port_rules = RULES[label]
    for arch in ARCHS:
        for name, shape in SHAPES.items():
            cfg = get_config(arch)
            if shape_skips(cfg, shape):
                continue
            abs_batch = specs.input_specs(cfg, shape)
            ref_batch = j_specs.input_specs(j_get_config(arch), shape)
            assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                    for k, v in abs_batch.items()} == \
                {k: (tuple(v.shape), str(v.dtype))
                 for k, v in ref_batch.items()}, (arch, name)
            got = _flat(specs.batch_spec_tree(cfg, shape, port_rules))
            want = _jflat(j_specs.batch_spec_tree(j_get_config(arch), shape,
                                                  ref_rules))
            assert got == want, (arch, name)


def _reference_layer_prefix(cfg, i: int):
    """``(path prefix in the reference's cache, stacked)`` of the port's
    layer ``i``."""
    if cfg.family == "ssm":
        return "", True
    if cfg.family == "audio":
        return "", True
    if cfg.family == "hybrid":
        reps = cfg.n_layers // 3
        if i < 3 * reps:
            return f"['{('rec0', 'rec1', 'attn')[i % 3]}']", True
        return f"['tail{i - 3 * reps}']", False
    for gi, (start, count, slots) in enumerate(_groups(cfg)):
        if start <= i < start + count:
            return f"['group{gi}'][{(i - start) % len(slots)}]", True
    raise AssertionError(i)


@pytest.fixture(scope="module")
def caches(models):
    """``{(arch, shape): (reference abstract cache, port's)}`` of every
    decode cell."""
    out = {}
    for arch, name in _cells("decode"):
        ref, port = models[arch]
        shape = SHAPES[name]
        out[arch, name] = (
            j_specs.abstract_cache(ref, j_get_config(arch), shape),
            specs.abstract_cache(port, get_config(arch), shape))
    return out


@pytest.mark.parametrize("label", sorted(RULES))
def test_cache_specs_equal_the_reference(models, caches, label):
    ref_rules, port_rules = RULES[label]
    checked = 0
    for (arch, name), (ref_abs, port_abs) in caches.items():
        ref, port = models[arch]
        cfg = get_config(arch)
        want = dict(_jflat(j_specs._spec_from_logical_tree(
            ref_abs, ref.cache_logical(), ref_rules, params=False)))
        got = _flat(specs._spec_from_logical_tree(
            port_abs, port.cache_logical(), port_rules, params=False))
        assert got[0] == ("['idx']", ()) and want["['idx']"] == ()
        for path, spec in got[1:]:
            i, leaf = re.fullmatch(r"\['layers'\]\[(\d+)\](.*)",
                                   path).groups()
            prefix, stacked = _reference_layer_prefix(cfg, int(i))
            ref_spec = want[prefix + leaf]
            assert spec == (ref_spec[1:] if stacked else ref_spec), \
                (arch, name, path)
            checked += 1
    assert checked > 0


def test_sharding_trees_follow_the_reference_state_rules(models):
    """``sharding_trees`` of a train cell: AdamW's moments follow their
    parameter (a q8 scale through ``_dedup``), SoapGivens' state is
    replicated; the trees hold NamedShardings of the given mesh."""
    from repro.optim import AdamW as JAdamW
    from repro_torch.optim import AdamW, SoapGivens
    ref_rules, port_rules = RULES["single_pod"]
    cfg, shape = get_config("smollm-135m"), SHAPES["train_4k"]
    ref, port = models["smollm-135m"]
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    for quantized in (False, True):
        got = specs.sharding_trees(port, cfg, shape,
                                   AdamW(quantized=quantized), port_rules,
                                   mesh)
        p_abs = j_specs.abstract_params(ref)
        p_spec = j_specs._spec_from_logical_tree(
            p_abs, ref.param_logical(), ref_rules, params=True)
        o_abs = j_specs.abstract_opt_state(JAdamW(quantized=quantized),
                                           p_abs)
        assert all(s.mesh is mesh for _, s in flatten_with_paths(
            got["opt"]))
        specs_of = lambda t: [(p, tuple(s.spec)) for p, s in  # noqa: E731
                              flatten_with_paths(t)]
        want_params = _jflat(p_spec)
        assert specs_of(got["params"]) == want_params
        if quantized:
            o_abs = {jax.tree_util.keystr(k): v for k, v in
                     jax.tree_util.tree_flatten_with_path(o_abs)[0]}
            got_opt = specs_of(got["opt"])
            assert [p for p, _ in got_opt] == list(o_abs)
            for path, spec in got_opt:
                if path == "['step']":
                    assert spec == ()
                    continue
                leaf, field = path[len("['m']"):].rsplit(".", 1)
                p = dict(want_params)[leaf]
                assert spec == (p if field == "q" else tuple(
                    j_sharding._dedup(list(p), tuple(o_abs[path].shape),
                                      ref_rules))), path
        else:
            assert specs_of(got["opt"]) == [("['m']" + p, s) for p, s in
                                            want_params] + [
                ("['step']", ())] + [("['v']" + p, s)
                                     for p, s in want_params]
    soap = specs.sharding_trees(port, cfg, shape, SoapGivens(), port_rules,
                                mesh)
    assert {tuple(s.spec) for _, s in flatten_with_paths(soap["opt"])} \
        == {()}


# ------------------------------------------------ placements and shard --

def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    P = PartitionSpec
    assert to_placements(P(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert to_placements(P("model", ("pod", "data")), mesh) == (
        Shard(1), Shard(1), Shard(0))
    assert to_placements(P(None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    assert to_placements(P(), mesh) == (Replicate(),) * 3
    for bad in (P(("data", "pod")), P(("model", "data"), None),
                P("data", "data"), P("expert")):
        with pytest.raises(ValueError):
            to_placements(bad, mesh)


def test_shard_without_rules_or_mesh_returns_its_input():
    x = torch.randn(4, 6, 8)
    assert shard(x, "batch", "seq", "embed") is x
    with axis_rules(DEFAULT_RULES):
        assert shard(x, "batch", "seq", "embed") is x
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    with axis_rules(None, mesh):
        assert shard(x, "batch", "seq", "embed") is x
    with axis_rules(RULES["single_pod"][1], mesh):
        with pytest.raises(TypeError):
            shard(x, "batch", "seq", "embed")
    assert sharding.current_mesh() is None


MESH_SCRIPT = """
import json
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.mesh import make_production_mesh, make_rules_for_mesh
from repro_torch.launch.specs import sharding_trees
from repro_torch.models import build_model
from repro_torch.optim import AdamW
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    rules = make_rules_for_mesh(mesh)
    cfg = get_config("smollm-135m")
    trees = sharding_trees(build_model(cfg, device="meta"), cfg,
                           SHAPES["train_4k"], AdamW(), rules, mesh)
    out[str(multi)] = dict(
        shape=list(mesh.shape), names=list(mesh.mesh_dim_names),
        rules=rules.rules, fsdp=list(rules.fsdp_axes),
        mesh_shape=rules.mesh_shape,
        embed=[str(p) for p in trees["params"]["embed"]["e"].placements],
        tokens=[str(p) for p in trees["batch"]["tokens"].placements])
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_production_meshes_under_the_fake_process_group():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", MESH_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.splitlines()[-1])
    for multi, label in (("False", "single_pod"), ("True", "multi_pod")):
        names, shape = MESHES[label]
        got = out[multi]
        assert (tuple(got["names"]), tuple(got["shape"])) == (names, shape)
        ref = RULES[label][0]
        assert got["rules"] == {k: (list(v) if isinstance(v, tuple) else v)
                                for k, v in ref.rules.items()}
        assert tuple(got["fsdp"]) == ref.fsdp_axes
        assert got["mesh_shape"] == ref.mesh_shape
    # the embedding: vocab over model, FSDP of d_model over the data axes
    assert out["False"]["embed"] == ["S(1)", "S(0)"]
    assert out["True"]["embed"] == ["S(1)", "S(1)", "S(0)"]
    assert out["False"]["tokens"] == ["S(0)", "R"]
    assert out["True"]["tokens"] == ["S(0)", "S(0)", "R"]
