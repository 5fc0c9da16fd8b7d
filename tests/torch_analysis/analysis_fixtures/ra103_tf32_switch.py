# repro-torch-lint: fixture-as=tests/test_bad_tf32.py
"""RA103 fixture: global float32 switches flipped without the compat
context manager (a test that leaks TF32 into every later test)."""
import torch
from torch.backends.cuda import matmul as _mm


def test_leaks_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False  # expect: RA103


def test_leaks_cudnn():
    torch.backends.cudnn.allow_tf32 = False  # expect: RA103


def test_aliased():
    _mm.allow_tf32 = True  # expect: RA103


def test_precision():
    torch.set_float32_matmul_precision("highest")  # expect: RA103


def test_default_dtype():
    torch.set_default_dtype(torch.float64)  # expect: RA103


def test_reading_is_fine():
    return torch.backends.cuda.matmul.allow_tf32
