"""One gloo rank of ``compressed_psum``, for ``tests/test_torch_compression.py``.

    python tests/_torch_psum_ranks.py RANK WORLD INIT_FILE OUT_DIR

Joins a ``WORLD``-rank gloo group through the ``file://`` rendezvous
``INIT_FILE`` (60 s group timeout, as ``tests/_torch_dist_ranks.py``),
sums each rank's seeded ``x`` with ``compressed_psum`` over the default
group and over a one-dimensional ``DeviceMesh``, and saves both sums and
its own ``x`` to ``OUT_DIR/psum{RANK}.pt``.
"""
import datetime
import sys

import numpy as np
import torch
import torch.distributed as tdist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.parallel import compressed_psum

TIMEOUT = datetime.timedelta(seconds=60)
SHAPES = [(777,), (33, 40)]


def inputs(rank):
    rng = np.random.default_rng(100 + rank)
    return [torch.from_numpy((rng.standard_normal(s) * 3).astype(np.float32))
            for s in SHAPES]


def main():
    rank, world, init, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4])
    tdist.init_process_group("gloo", init_method=f"file://{init}",
                             rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
        xs = inputs(rank)
        out = {"x": xs,
               "group": [compressed_psum(x) for x in xs],
               "mesh": [compressed_psum(x, mesh) for x in xs]}
        tdist.barrier()
    finally:
        tdist.destroy_process_group()
    torch.save(out, f"{out_dir}/psum{rank}.pt")


if __name__ == "__main__":
    main()
