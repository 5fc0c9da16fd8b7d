"""The paper's workload config: the port's data-only copy of
``repro.configs.rotseq_paper`` keeps every field but the TPU's
``m_blk`` and holds each to the reference's ``CONFIG``."""
import dataclasses

from repro.configs import rotseq_paper as ref
from repro_torch.configs import ARCHS
from repro_torch.configs import rotseq_paper as port
from repro_torch.kernels.limits import BATCHED_M_BLK

KEPT = ("k", "sizes", "n_b", "k_b", "mxu_n_b", "mxu_k_b")


def test_rotseq_paper_fields_equal_the_reference():
    fields = {f.name for f in dataclasses.fields(port.RotSeqConfig)}
    assert fields == set(KEPT)
    assert {f.name for f in dataclasses.fields(ref.RotSeqConfig)} \
        - fields == {"m_blk"}
    for name in KEPT:
        assert getattr(port.CONFIG, name) == getattr(ref.CONFIG, name), name
    assert port.CONFIG.sizes == (240, 480, 960, 1920, 3840)
    assert port.CONFIG.k == 180


def test_rotseq_paper_is_not_an_architecture():
    assert "rotseq-paper" not in ARCHS and "rotseq_paper" not in ARCHS
    # the batched kernel's rows a block are a compiled constant instead
    assert isinstance(BATCHED_M_BLK, int) and BATCHED_M_BLK > 0
