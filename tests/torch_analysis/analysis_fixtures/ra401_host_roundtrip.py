# repro-torch-lint: fixture-as=src/repro_torch/kernels/rotseq/kernel.py
"""RA401 fixture: host round-trips in a wrapper's CUDA branch.

Each of these waits for the card, and every launch queued before, on
the path that should only enqueue.  The CPU branch may do as it likes.
"""
import torch

from .ref import rotseq_wave_ref


def bad_wrapper(AT, Cw):
    dev = AT.device
    if dev.type == "cpu":
        return rotseq_wave_ref(AT, Cw)
    first = AT[0, 0].item()  # expect: RA401
    rows = AT.sum(1).tolist()  # expect: RA401
    torch.cuda.synchronize()  # expect: RA401
    host = AT.to("cpu")  # expect: RA401
    return first, rows, host


def bad_cuda_branch(x):
    if x.is_cuda:
        return x.cpu().numpy()  # expect: RA401
    return x


def fine_cpu_branch(x):
    if x.device.type == "cpu":
        return x.tolist()
    return x
