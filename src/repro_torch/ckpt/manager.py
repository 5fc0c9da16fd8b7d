"""Fault-tolerant checkpointing: async, atomic, elastic.

Mirror of :mod:`repro.ckpt.manager`, writing the reference's layout: a
directory ``step_N/`` with one ``.npy`` a leaf and ``manifest.json``
(the leaves in the reference's order under its paths,
:mod:`repro_torch.tree`), so either package reads the other's.

* **Atomic**: each step writes to ``step_N.tmp/`` then ``os.replace``s to
  ``step_N/``; a crashed writer never corrupts the latest checkpoint.
* **Async**: ``save`` copies every leaf to host memory before it returns
  (a copy, never a view: ``Tensor.cpu()`` of a host tensor is the tensor
  itself, which an in-place update would change under the writer), then
  a background thread writes them.  ``wait()`` joins outstanding writes.
* **Elastic**: ``restore`` puts every leaf on the device it is given,
  or, with ``shardings``, places it on a mesh as the reference's elastic
  re-shard does.
* **Meshes**: ``save`` of a tree of ``DTensor``s writes each leaf's full
  tensor; gathering it is a collective, so every rank of the mesh calls
  ``save`` (each writes the directory it was given).
* **Retention**: keeps the newest ``keep`` complete checkpoints.

``Quantized`` optimizer states round-trip (their ``q`` and ``scale`` are
leaves).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.sequence import resolve_device
from repro_torch.tree import flatten_with_paths, from_paths, map_tree

__all__ = ["CheckpointManager"]


def _host_copy(x) -> np.ndarray:
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------ save ----

    def save(self, step: int, tree: Any, *, blocking: bool = False):
        """Snapshot ``tree`` and write checkpoint ``step`` asynchronously."""
        self.wait()
        items = [(path, _host_copy(leaf))
                 for path, leaf in flatten_with_paths(tree)]

        def write():
            try:
                tmp = os.path.join(self.dir, f"step_{step}.tmp")
                final = os.path.join(self.dir, f"step_{step}")
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                manifest = []
                for i, (path, leaf) in enumerate(items):
                    np.save(os.path.join(tmp, f"{i}.npy"), leaf,
                            allow_pickle=False)
                    manifest.append({"i": i, "path": path,
                                     "dtype": str(leaf.dtype),
                                     "shape": list(leaf.shape)})
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump({"step": step, "leaves": manifest}, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------- restore ----

    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any = None, *, shardings: Any = None,
                device="cuda"):
        """Rebuild checkpoint ``step`` with every leaf on ``device`` (the
        card by default; refused without one).

        With ``like`` the result takes its structure (leaves matched in
        order, as the reference does); without it, the structure of the
        manifest's paths, ``Quantized`` where a node has the fields ``q``
        and ``scale``.  ``shardings`` (with ``like``): a matching tree of
        :class:`~repro_torch.parallel.sharding.NamedSharding`, each leaf
        placed by its own as a ``DTensor`` on its mesh's device (the
        reference's elastic re-shard; every rank reads the full leaf and
        takes its shard, so every rank of the mesh calls ``restore``); a
        ``None`` in it leaves that leaf a tensor on ``device``.
        """
        from repro_torch.optim.adamw import Quantized

        device = resolve_device(device)
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        arrs = [torch.from_numpy(np.load(os.path.join(path,
                                                      f"{e['i']}.npy")))
                .to(device) for e in manifest["leaves"]]
        if like is None:
            return from_paths(
                [(e["path"], a) for e, a in zip(manifest["leaves"], arrs)],
                {frozenset(Quantized._fields): Quantized})
        n_like = len(flatten_with_paths(like))
        if len(arrs) != n_like:
            raise ValueError(f"checkpoint {step} holds {len(arrs)} leaves, "
                             f"the tree to restore {n_like}")
        it = iter(arrs)
        if shardings is None:
            return map_tree(lambda _: next(it), like)
        return map_tree(lambda _, sh: _place(next(it), sh), like, shardings)


def _place(x, sharding):
    """``x`` as a ``DTensor`` placed by ``sharding``; ``x`` itself for a
    ``None`` sharding."""
    if sharding is None:
        return x
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x.to(sharding.mesh.device_type), sharding.mesh,
                             sharding.placements)
