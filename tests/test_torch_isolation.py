"""The port stands alone: no JAX, nothing of ``repro``, the card by default.

``repro_torch`` and ``chip_smoke.py`` import ``torch`` and ``numpy``,
never ``jax`` and nothing of the reference package (not even its
JAX-free modules).  Constructors that build tensors default to the card
and refuse to fall back to the host silently.
"""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch import RotationSequence, random_sequence
from repro_torch.core import identity_sequence

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _banned(name):
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "repro")


def test_no_jax_or_reference_imports_in_the_port():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for part in ("serve/rotations.py", "serve/stream.py",
                 "kernels/rotseq_batched/kernel.py", "serve/lm.py",
                 "launch/serve.py", "convert.py", "configs/__init__.py",
                 "configs/base.py", "configs/smollm_135m.py",
                 "models/layers.py", "models/attention.py",
                 "models/transformer.py", "models/zoo.py",
                 "models/rglru.py", "models/mamba2.py", "models/whisper.py",
                 "kernels/rope/ref.py", "kernels/rope/kernel.py",
                 "kernels/rope/ops.py", "core/jacobi.py", "eig/__init__.py",
                 "eig/api.py", "eig/delayed.py", "eig/qr_shift.py",
                 "eig/svd.py", "eig/tridiag.py", "dist/__init__.py",
                 "dist/plan.py", "dist/colsharded.py",
                 "core/distributed.py", "tree.py", "data/__init__.py",
                 "data/pipeline.py", "optim/__init__.py", "optim/adamw.py",
                 "optim/schedule.py", "optim/soap_givens.py",
                 "train/__init__.py", "train/step.py", "train/loop.py",
                 "train/losses.py", "ckpt/__init__.py", "ckpt/manager.py",
                 "parallel/__init__.py", "parallel/compression.py",
                 "launch/train.py", "parallel/sharding.py",
                 "launch/mesh.py", "launch/specs.py",
                 "configs/rotseq_paper.py", "launch/dryrun.py",
                 "launch/roofline.py", "launch/step_analysis.py"):
        assert PORT / part in files
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imports(f) if _banned(name)]
    assert bad == []
    assert (PORT / "csrc" / "rotseq_batched.cu").exists()
    assert (PORT / "csrc" / "rope.cu").exists()


def test_dist_imports_no_kernel_module():
    """``repro_torch.dist`` runs only through the planned hooks of
    ``repro_torch.core.sequence``: no module of it imports
    ``repro_torch.kernels``."""
    files = sorted((PORT / "dist").glob("*.py"))
    assert len(files) == 3
    names = [name for f in files for name in _imports(f)]
    assert "repro_torch.core.sequence" in names
    assert [n for n in names if n.startswith("repro_torch.kernels")] == []


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.convert, "
            "repro_torch.serve, repro_torch.kernels.rotseq.ops, "
            "repro_torch.kernels.rotseq_mxu.ops, "
            "repro_torch.kernels.rotseq_batched.ops, "
            "repro_torch.kernels.rope.ops, repro_torch.models, "
            "repro_torch.models.transformer, repro_torch.serve.lm, "
            "repro_torch.launch.serve, repro_torch.configs, "
            "repro_torch.eig, repro_torch.core.jacobi, repro_torch.dist, "
            "repro_torch.core.distributed, repro_torch.data, "
            "repro_torch.optim, repro_torch.train, repro_torch.ckpt, "
            "repro_torch.parallel, repro_torch.launch.train, "
            "repro_torch.tree, repro_torch.parallel.sharding, "
            "repro_torch.launch.mesh, repro_torch.launch.specs, "
            "repro_torch.configs.rotseq_paper, "
            "repro_torch.launch.dryrun, repro_torch.launch.roofline, "
            "repro_torch.launch.step_analysis; "
            "[__import__('repro_torch.configs.' + a.replace('-', '_')) "
            "for a in repro_torch.configs.ARCHS]; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] "
            "in ('jax', 'jaxlib', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert repro_torch.__name__ == "repro_torch"


def test_constructors_default_to_the_card():
    if torch.cuda.is_available():
        assert random_sequence(5, 2).device.type == "cuda"
        return
    for build in (lambda: random_sequence(5, 2),
                  lambda: identity_sequence(5, 2),
                  lambda: RotationSequence.identity(5, 2),
                  lambda: RotationSequence.from_waves([[1.0]], [[0.0]])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    seq = random_sequence(5, 2, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    assert seq.device.type == "cpu" and seq.shape == (4, 2)
    # tensors stay where they are
    moved = RotationSequence.from_waves(seq.cos, seq.sin)
    assert moved.device.type == "cpu"
    assert torch.equal(moved.cos, seq.cos)


def test_training_defaults_to_the_card(tmp_path):
    """``launch.train``, ``TrainLoop`` and ``CheckpointManager.restore``
    put their tensors on the card unless told otherwise, and refuse
    without one; ``launch.mesh.make_production_mesh`` builds a card
    mesh unless told otherwise."""
    import inspect

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.train import TrainLoop
    assert inspect.signature(TrainLoop).parameters["device"].default == \
        "cuda"
    assert inspect.signature(make_production_mesh).parameters[
        "device_type"].default == "cuda"
    assert inspect.signature(
        CheckpointManager.restore).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.zeros(3)}, blocking=True)
    for build in (lambda: TrainLoop(train_step=None, params={},
                                    opt_state={}, data_iter=iter([])),
                  lambda: mgr.restore(1),
                  lambda: launch_train.main(["--arch", "smollm-135m",
                                             "--reduced", "--steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    assert torch.equal(mgr.restore(1, device="cpu")["x"], torch.zeros(3))


def test_chip_smoke_refuses_without_a_card_or_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the refusal is what a host without a card sees")
    runs = [(ROOT / "chip_smoke.py", ROOT)]
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    runs.append((alone, tmp_path))
    for script, cwd in runs:
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
