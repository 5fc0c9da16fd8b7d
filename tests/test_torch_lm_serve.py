"""Port parity of LM serving: ``ServeEngine`` and the serving launcher.

The reference's ``ServeEngine`` and the port's greedy-decode the same
prompts with the same weights (the reference's, carried across with
``repro_torch.convert.lm_params_from_reference``) on the ``TINY`` config
of ``tests/test_substrates.py`` and on reduced SmolLM-135M,
DeepSeek-V2-Lite (MLA and MoE) and Kimi-K2 (GQA and MoE): the tokens
are equal and every decode step's logits agree to ``atol 5e-5,
rtol 1e-4`` (float32; the matmuls sum in another order).  Greedy output
equals the argmax of the port's teacher-forced forward, and the
launcher's LM, rotation and stream modes run on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import build_model as j_build_model
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import ModelConfig, get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.core import registry
from repro_torch.launch import serve as launcher
from repro_torch.serve import ServeEngine

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab=256, head_dim=16, dtype="float32")
TOL = dict(atol=5e-5, rtol=1e-4)
PROMPTS = [[1, 2, 3], [7, 8], [9], [4, 5, 6, 7, 8]]
MAX_NEW = 5


def _record(engine, log):
    """Wrap the engine's decode step so that it logs each step's logits."""
    step = engine._step

    def recorded(*args):
        logits, cache = step(*args)
        log.append(np.asarray(logits, np.float32) if not isinstance(
            logits, torch.Tensor) else logits.numpy())
        return logits, cache

    engine._step = recorded


def _cases():
    out = {"tiny": (JModelConfig(**TINY), ModelConfig(**TINY), 4)}
    for name, arch, seed in (("smollm", "smollm-135m", 11),
                             ("deepseek", "deepseek-v2-lite-16b", 12),
                             ("kimi", "kimi-k2-1t-a32b", 13)):
        out[name] = (j_get_config(arch).reduced(),
                     get_config(arch).reduced(), seed)
    return out


@pytest.fixture(scope="module")
def references():
    """The reference engine's tokens and per-step logits, and its
    weights, for each case, built once for the module."""
    out = {}
    for name, (jcfg, _, seed) in _cases().items():
        model = j_build_model(jcfg)
        params = model.init(jax.random.key(seed))
        eng = JServeEngine(model, jcfg, params, batch=4, max_len=32)
        log = []
        _record(eng, log)
        toks = eng.generate(PROMPTS, max_new=MAX_NEW)
        out[name] = (jax.tree.map(np.asarray, params), toks, log)
    return out


@pytest.mark.parametrize("case", ["tiny", "smollm", "deepseek", "kimi"])
def test_generate_vs_reference(case, references):
    params, ref_toks, ref_log = references[case]
    cfg = _cases()[case][1]
    model = lm_params_from_reference(params, cfg, device="cpu")
    eng = ServeEngine(model, cfg, batch=4, max_len=32)
    log = []
    _record(eng, log)
    toks = eng.generate(PROMPTS, max_new=MAX_NEW)
    assert toks == ref_toks
    assert all(len(t) == MAX_NEW for t in toks)
    assert eng.steps == len(log) == len(ref_log) == 4 + MAX_NEW
    for port, ref in zip(log, ref_log):
        np.testing.assert_allclose(port, ref, **TOL)


def test_greedy_equals_teacher_forced_forward(references):
    params = references["tiny"][0]
    cfg = ModelConfig(**TINY)
    model = lm_params_from_reference(params, cfg, device="cpu")
    outs = ServeEngine(model, cfg, batch=4, max_len=32).generate(
        PROMPTS[:3], max_new=MAX_NEW)
    assert len(outs) == 3
    for p, out in zip(PROMPTS[:3], outs):
        seq = list(p)
        with torch.no_grad():
            for _ in range(MAX_NEW):
                lg = model(torch.tensor([seq]))
                seq.append(int(lg[0, -1].argmax()))
        assert out == seq[len(p):]


def test_eos_ends_a_slot_and_too_many_prompts_raise(references):
    params, ref_toks, _ = references["tiny"]
    cfg = ModelConfig(**TINY)
    model = lm_params_from_reference(params, cfg, device="cpu")
    eng = ServeEngine(model, cfg, batch=4, max_len=32, eos=ref_toks[0][1])
    outs = eng.generate(PROMPTS, max_new=MAX_NEW)
    assert outs[0] == ref_toks[0][:2]
    with pytest.raises(ValueError, match="slots"):
        eng.generate(PROMPTS + [[1]], max_new=2)


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-v2-lite-16b",
                                  "kimi-k2-1t-a32b"])
def test_launcher_lm_mode(capsys, arch):
    launcher.main(["--arch", arch, "--reduced", "--device", "cpu",
                   "--batch", "2", "--max-new", "3"])
    out = capsys.readouterr().out
    assert out.count("prompt ") == 2
    assert "6 tokens in" in out and "decode steps on cpu" in out


@pytest.mark.parametrize("mode", [[], ["--stream"]])
def test_launcher_rotation_modes(mode, capsys):
    registry.clear_plan_cache()
    launcher.main(["--rotations", *mode, "--check", "--device", "cpu",
                   "--requests", "9", "--slots", "4"])
    out = capsys.readouterr().out
    assert "check: " in out and "9 requests in" in out
    registry.clear_plan_cache()


def test_launcher_needs_an_arch_in_lm_mode():
    with pytest.raises(SystemExit):
        launcher.main(["--device", "cpu"])
