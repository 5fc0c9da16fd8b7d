"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every source under ``repro_torch/csrc/`` goes into one shared library
with a plain C interface, compiled for ``sm_90a`` by one ``nvcc`` call at
first use into ``build/kernels/`` at the repository root.  The library
is named by a hash of the sources, the headers beside them and the flags,
so an edited source or header is rebuilt and an unchanged tree reuses
what it built.  ``nvcc``'s output
(the ptxas register and spill report) is kept beside the library.
Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Optional

__all__ = ["build", "load"]

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"

# --fmad=false: no contraction anywhere the sources do not ask for one
# (the plane form is spelled with __fmul_rn/__fadd_rn; the GEMM uses fmaf)
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    """What ``nvcc`` compiles: every ``*.cu`` under ``csrc/``."""
    return sorted(CSRC.glob("*.cu"))


def _target() -> pathlib.Path:
    """The library, named by a hash of the flags, the sources and the
    headers they include (``*.cuh``)."""
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted([*_sources(), *CSRC.glob("*.cuh")]):
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"librotseq_{digest.hexdigest()[:16]}.so"


def build() -> str:
    """Build the library if it is missing; return ``nvcc``'s output.

    The output holds the ``-Xptxas -v`` register and spill report of
    every kernel.  It is saved beside the library, so a library built
    earlier returns the report of its own build; a library without its
    report is built again.  The build writes temporary files and renames
    them into place, the report first, because test workers on one card
    (``pytest -n``) may build at the same time and none may load a
    partial library.  Raises with ``nvcc``'s output if the build fails.
    """
    target = _target()
    report = target.with_suffix(".log")
    if target.exists() and report.exists():
        return report.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=".librotseq.",
                               suffix=".so")
    os.close(fd)
    proc = subprocess.run(
        [_nvcc(), *FLAGS, "-o", tmp, *map(str, _sources())],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"kernel build failed: nvcc exited "
                           f"{proc.returncode}\n{proc.stdout}")
    fd, tmp_log = tempfile.mkstemp(dir=BUILD_DIR, prefix=".librotseq.",
                                   suffix=".log")
    with os.fdopen(fd, "w") as f:
        f.write(proc.stdout)
    os.replace(tmp_log, report)
    os.replace(tmp, target)
    return proc.stdout


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _LIB
    if _LIB is None:
        build()
        _LIB = ctypes.CDLL(str(_target()))
    return _LIB
