"""Production mesh construction: mirror of the reference's
``launch/mesh.py`` over ``torch.distributed``.

``make_production_mesh`` is a function (not a module-level constant), so
importing this module starts no process group: the caller initialises
one of the mesh's size first (``torch.distributed.init_process_group``).
"""
from __future__ import annotations

__all__ = ["make_production_mesh", "make_rules_for_mesh"]


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The ``(16, 16)`` ``("data", "model")`` mesh, or ``(2, 16, 16)``
    ``("pod", "data", "model")`` with ``multi_pod``, over the ranks of the
    current process group (``init_device_mesh``)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_rules_for_mesh(mesh, *, seq_parallel: bool = False):
    """AxisRules bound to a mesh (drops the "pod" axis on single-pod);
    reads ``mesh.mesh_dim_names`` and ``mesh.shape``."""
    from repro_torch.parallel.sharding import AxisRules

    names = tuple(mesh.mesh_dim_names)
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    rules = {
        "batch": data_axes,
        "heads": "model",
        "kv_heads": "model",
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        "seq": "model" if seq_parallel else None,
        "embed": None,
    }
    return AxisRules(
        rules=rules,
        fsdp_axes=data_axes,
        mesh_shape={a: int(s) for a, s in zip(names, tuple(mesh.shape))},
    )
