# repro-torch-lint: fixture-as=src/repro_torch/serve/bad_probe.py
"""RA102 fixture: the card probed outside the port's device rule."""
import torch
from torch.cuda import is_available as _avail  # expect: RA102


def on_card():
    return torch.cuda.is_available()  # expect: RA102


def how_many():
    return torch.cuda.device_count()  # expect: RA102


def aliased():
    return _avail()  # expect: RA102


def resolve_device(device):
    # the name alone carves out nothing: only core.sequence's function
    return torch.cuda.get_device_properties(0).total_memory  # expect: RA102


def fine_current():
    return torch.cuda.current_device
