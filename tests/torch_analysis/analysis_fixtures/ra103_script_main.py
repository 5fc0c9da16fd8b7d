# repro-torch-lint: fixture-as=tools/bad_sweep.py
"""RA103 fixture: a script's main() sets each switch once, and only there."""
import torch


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False  # expect: RA103
    return 0


def helper():
    torch.set_default_device("cuda")  # expect: RA103
