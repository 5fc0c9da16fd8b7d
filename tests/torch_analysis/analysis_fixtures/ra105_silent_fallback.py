# repro-torch-lint: fixture-as=src/repro_torch/kernels/rotseq/bad_wrapper.py
"""RA105 fixture: a kernel wrapper that falls back to its plain version.

On a CUDA tensor a wrapper launches its kernel or raises; the plain
version runs only off the card.
"""
from repro_torch.kernels.rotseq.ref import rotseq_wave_ref

from .ref import rotseq_wave_ref as _plain


def _launch(AT, Cw):
    raise RuntimeError("launch failed")


def bad_fallback_on_error(AT, Cw):
    try:
        return _launch(AT, Cw)
    except RuntimeError:
        return rotseq_wave_ref(AT, Cw)  # expect: RA105


def bad_unguarded(AT, Cw):
    if AT.device.type == "cuda":
        _launch(AT, Cw)
    return _plain(AT, Cw)  # expect: RA105


def bad_host_copy(AT, Cw):
    try:
        return _launch(AT, Cw)
    except RuntimeError:
        return _launch(AT.cpu(), Cw.to("cpu"))  # expect: RA105


def fine_guarded(AT, Cw):
    dev = AT.device
    if dev.type == "cpu":
        return rotseq_wave_ref(AT, Cw)
    return _launch(AT, Cw)


def fine_after_the_card_returned(AT, Cw):
    if AT.is_cuda:
        return _launch(AT, Cw)
    return _plain(AT, Cw)


def fine_not_cuda(AT, Cw):
    if not AT.is_cuda:
        if AT.device.type not in ("cpu", "meta"):
            raise ValueError(AT.device)
        return _plain(AT, Cw)
    return _launch(AT, Cw)
