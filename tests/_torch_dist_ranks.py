"""One gloo rank of the port's sharded cases, for ``tests/test_torch_dist.py``.

    python tests/_torch_dist_ranks.py RANK WORLD INIT_FILE INPUTS OUT_DIR

Joins a ``WORLD``-rank gloo group through the ``file://`` rendezvous
``INIT_FILE`` (every group, the meshes' too, times out after 60 s), runs
every case on the ``(2, 2)`` ``("data", "model")`` and ``(4,)``
``("data",)`` meshes with the seeded inputs of the ``INPUTS`` npz, and
saves what the tests check to ``OUT_DIR/rank{RANK}.pt``.  Gathered
results are whole on every rank.
"""
import datetime
import json
import sys
import warnings

import numpy as np
import torch
import torch.distributed as tdist
from torch.distributed import distributed_c10d
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from repro_torch import RotationSequence, dist, obs
from repro_torch.core import distributed as compat
from repro_torch.eig import DelayedRotationBuffer
from repro_torch.serve import RotationService, StreamEngine, synthetic_stream

# (m, n, k, n_b, k_b, method) of the reference's row/column test
ROWCOL = [(8, 32, 5, 4, 2, "blocked"), (16, 64, 7, 8, 4, "blocked"),
          (8, 32, 9, 8, 3, "accumulated"), (4, 64, 2, 16, 8, "accumulated")]
TIMEOUT = datetime.timedelta(seconds=60)


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def raises(exc, fn) -> bool:
    try:
        fn()
    except exc:
        return True
    return False


def rowcol(inp, mesh, out):
    for i, (m, n, k, n_b, k_b, method) in enumerate(ROWCOL):
        A = t(inp[f"rc{i}_A"])
        seq = RotationSequence(t(inp[f"rc{i}_C"]), t(inp[f"rc{i}_S"]))
        out[f"rc{i}_row"] = full(dist.rot_sequence_row_sharded(
            A, seq, mesh, n_b=n_b, k_b=k_b))
        out[f"rc{i}_row_rep"] = seq.plan(like=A, method="blocked", n_b=n_b,
                                         k_b=k_b).apply_direct(A)
        out[f"rc{i}_col"] = dist.rot_sequence_column_sharded_padded(
            A, seq, mesh, col_axis="model", n_b=n_b, k_b=k_b,
            row_axes=("data",), method=method)
        out[f"rc{i}_col_rep"] = seq.plan(like=A, method=method, n_b=n_b,
                                         k_b=k_b).apply(A)
    A, seq = t(inp["rc0_A"]), RotationSequence(t(inp["rc0_C"]),
                                               t(inp["rc0_S"]))
    out["raw_arrays_raise"] = raises(TypeError, lambda: (
        dist.rot_sequence_row_sharded(A, seq.cos, seq.sin, mesh)))
    out["no_mesh_raises"] = raises(TypeError, lambda: (
        dist.rot_sequence_row_sharded(A, seq)))
    out["mesh_keyword"] = full(dist.rot_sequence_row_sharded(
        A, seq, mesh=mesh, n_b=4, k_b=2))


def compat_wrapper(inp, mesh, out):
    A, seq = t(inp["cw_A"]), RotationSequence(t(inp["cw_C"]), t(inp["cw_S"]))
    want = full(dist.rot_sequence_row_sharded(A, seq, mesh, n_b=8, k_b=2))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = full(compat.rot_sequence_row_sharded(A, seq, mesh, n_b=8,
                                                   k_b=2))
    out["cw_warned"] = any(issubclass(x.category, DeprecationWarning)
                           and "repro_torch.dist" in str(x.message)
                           for x in w)
    out["cw_equal"] = torch.equal(got, want)


def variants(inp, key):
    C, S, G = t(inp[f"{key}_C"]), t(inp[f"{key}_S"]), t(inp[f"{key}_G"])
    return {"plain": RotationSequence(C, S),
            "signed": RotationSequence(C, S, G),
            "reflector": RotationSequence(C, S, None, True)}


def fused_parity(inp, mesh, out):
    A = t(inp["fp_A"])
    for name, seq in variants(inp, "fp").items():
        for method in ("blocked", "cuda_batched"):
            plan = dist.plan_sharded(seq, like=A, mesh=mesh, method=method)
            out[f"fp_{name}_{method}"] = full(plan.apply_batched(A))
            out[f"fp_{name}_{method}_rep"] = seq.plan(
                like=A, method=method, shared_sequence=True).apply_batched(A)
    # per-request waves, mixed structure under a signed plan
    seqs = [RotationSequence(t(inp["fp_C"]) if i % 2 else t(inp["fp_C2"]),
                             t(inp["fp_S"]) if i % 2 else t(inp["fp_S2"]),
                             t(inp["fp_G"]) if i % 3 == 0 else None,
                             i % 3 == 1) for i in range(A.shape[0])]
    rep_seq = seqs[0].with_signs()
    for method in ("blocked", "cuda_batched"):
        plan = dist.plan_sharded(rep_seq, like=A, mesh=mesh, method=method,
                                 shared_sequence=False)
        out[f"fp_perreq_{method}"] = full(plan.apply_batched(
            A, sequences=seqs))
        out[f"fp_perreq_{method}_rep"] = rep_seq.plan(
            like=A, method=method, shared_sequence=False).apply_batched(
                A, sequences=seqs)
    plain = variants(inp, "fp")["plain"]
    with obs.override(True):
        obs.reset()
        dist.plan_sharded(plain, like=A, mesh=mesh,
                          method="cuda_batched").apply_batched(A)
        snap = obs.snapshot()
    out["fp_obs"] = {
        "gauges": snap["gauges"], "counters": snap["counters"],
        "rows": [r for r in snap["roofline"]["dispatches"]
                 if r["backend"] == "cuda_batched"],
        "wave_bytes": plain.cos.nbytes + plain.sin.nbytes}


def grad_roundtrip(inp, mesh, mesh22, out):
    A = t(inp["gr_A"])
    seq = RotationSequence(t(inp["gr_C"]), t(inp["gr_S"]))
    plan = dist.plan_sharded(seq, like=A, mesh=mesh, method="blocked")
    X = distribute_tensor(A, mesh, [Shard(0)],
                          src_data_rank=None).requires_grad_()
    (g,) = torch.autograd.grad((plan.apply(X) ** 2).sum(), X)
    out["gr_grad"] = g.full_tensor()
    rp = seq.plan(like=A, method="blocked")
    Ag = A.clone().requires_grad_()
    (out["gr_grad_rep"],) = torch.autograd.grad((rp.apply(Ag) ** 2).sum(),
                                                Ag)
    d = json.loads(json.dumps(plan.to_dict()))
    plan2 = dist.ShardedSequencePlan.from_dict(d, seq, mesh)
    out["gr_roundtrip"] = (plan2.devices == plan.devices
                           and plan2.execute_sharded == plan.execute_sharded
                           and torch.equal(full(plan2.apply(A)),
                                           full(plan.apply(A))))
    ref = dist.ShardedSequencePlan.from_dict(
        json.loads(str(inp["gr_ref_dict"])), seq, mesh)
    out["gr_ref_dict"] = (ref.method, ref.devices, ref.execute_sharded,
                          dict(ref.kwargs))
    out["gr_ref_dict_apply"] = torch.equal(full(ref.apply(A)),
                                           full(plan.apply(A)))
    out["gr_other_mesh_raises"] = raises(ValueError, lambda: (
        dist.ShardedSequencePlan.from_dict(d, seq, mesh22)))


def auto(inp, mesh, out):
    for label in ("small", "large"):
        A = t(inp[f"au_{label}_A"])
        seq = RotationSequence(t(inp[f"au_{label}_C"]),
                               t(inp[f"au_{label}_S"]))
        plan = dist.plan_sharded(seq, like=A, mesh=mesh, method="auto")
        out[f"au_{label}"] = (plan.execute_sharded, plan.method)


def services(inp, mesh, out):
    stream = synthetic_stream(24, device="cpu")
    for method in ("blocked", "auto"):
        base = RotationService(slots=4, store=False,
                               method=method).apply_many(stream)
        got = RotationService(slots=4, store=False, method=method,
                              mesh=mesh).apply_many(stream)
        out[f"sv_{method}"] = all(torch.equal(full(a), b)
                                  for a, b in zip(got, base))
        out[f"sv_{method}_dtensor"] = isinstance(got[0], DTensor)
    one = synthetic_stream(16, shapes=((16, 32, 8),), seed=3, device="cpu")
    base = RotationService(slots=4, store=False,
                           method="blocked").apply_many(one)
    # one bucket and size closes only: every rank closes the same batches
    eng = StreamEngine(slots=4, store=False, method="blocked", mesh=mesh,
                       min_age_s=60.0, max_age_s=60.0)
    tickets = [eng.submit(seq, A) for seq, A in one]
    got = [tk.result(timeout=60) for tk in tickets]
    eng.close()
    out["se_equal"] = all(torch.equal(full(a), b) for a, b in zip(got, base))
    C, S = inp["db_C"], inp["db_S"]
    for M in (torch.eye(16), t(inp["db_M3"])):
        sharded = DelayedRotationBuffer(M.clone(), k_delay=8,
                                        method="blocked", mesh=mesh)
        plain = DelayedRotationBuffer(M.clone(), k_delay=8, method="blocked")
        for buf in (sharded, plain):
            for p in range(C.shape[1]):
                buf.push(C[:, p], S[:, p])
        out[f"db_{M.ndim}d"] = torch.equal(full(sharded.value), plain.value)
        out[f"db_{M.ndim}d_dtensor"] = isinstance(sharded.value, DTensor)


def argument_checks(inp, mesh, out):
    A = t(inp["rc1_A"])
    seq = RotationSequence(t(inp["rc1_C"]), t(inp["rc1_S"]))
    out["ck_not_a_mesh"] = all(raises(TypeError, fn) for fn in (
        lambda: dist.plan_sharded(seq, like=A, mesh=object()),
        lambda: RotationService(mesh=object()),
        lambda: DelayedRotationBuffer(torch.eye(4), mesh=object())))
    out["ck_unknown_axis"] = all(raises(ValueError, fn) for fn in (
        lambda: dist.plan_sharded(seq, like=A, mesh=mesh,
                                  row_axes=("rows",)),
        lambda: RotationService(mesh=mesh, row_axes=("rows",)),
        lambda: DelayedRotationBuffer(torch.eye(4), mesh=mesh,
                                      row_axes=("rows",)),
        lambda: dist.plan_sharded(seq, like=A, mesh=mesh,
                                  row_axes=("model", "data"))))
    out["ck_not_shard_capable"] = all(raises(ValueError, lambda: (
        dist.plan_sharded(seq, like=A, mesh=mesh, method=meth)))
        for meth in ("cuda_wave", "cuda_mxu"))
    out["ck_rows"] = raises(ValueError, lambda: dist.plan_sharded(
        seq, like=A, mesh=mesh, method="blocked").apply(A[:15]))


def run(rank, inp) -> dict:
    mesh22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    mesh4 = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    out = {}
    rowcol(inp, mesh22, out)
    compat_wrapper(inp, mesh4, out)
    fused_parity(inp, mesh4, out)
    grad_roundtrip(inp, mesh4, mesh22, out)
    auto(inp, mesh4, out)
    services(inp, mesh22, out)
    argument_checks(inp, mesh22, out)
    return out


def main(argv) -> None:
    rank, world, init_file, inputs, out_dir = argv[1:]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    # the meshes' subgroups take the default timeout, not the world's
    distributed_c10d.default_pg_timeout = TIMEOUT
    tdist.init_process_group("gloo", init_method=f"file://{init_file}",
                             rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        out = run(rank, np.load(inputs))
    finally:
        tdist.destroy_process_group()
    torch.save(out, f"{out_dir}/rank{rank}.pt")


if __name__ == "__main__":
    main(sys.argv)
