"""Port registry: the same SS6 arithmetic as the reference, on the card's rates.

On ``"cpu"`` the port's hardware row is the reference's, so the four
backends both packages share cost exactly the same.  On ``"cuda"`` (an
H100) ``method="auto"`` must land on a CUDA kernel, never on an eager
plain backend, and at the paper's shape on ``cuda_wave``, whose
application is the faster one there (the eager tile factors of
``cuda_mxu`` are priced by their measured step count).
"""
import dataclasses

import pytest

import repro_torch.core.api  # noqa: F401  (registers the backends)
from repro.core import registry as jreg
from repro.hw import PLATFORMS as J_PLATFORMS
from repro.kernels import limits as jlimits
from repro_torch.core import registry as treg
from repro_torch.hw import PLATFORMS
from repro_torch.kernels import limits

SHARED = ["unoptimized", "wavefront", "blocked", "accumulated"]
PROBLEMS = [dict(m=3840, n=3840, k=180), dict(m=7, n=9, k=4),
            dict(m=256, n=1000, k=37, signs=True),
            dict(m=64, n=128, k=16, batch=8),
            dict(m=64, n=128, k=16, batch=8, shared_sequence=False),
            dict(m=100, n=50, k=3, dtype="float64")]
TILES = [dict(), dict(n_b=64, k_b=16), dict(n_b=128, k_b=128),
         dict(n_b=8, k_b=4)]


def test_cpu_hardware_row_is_the_reference_row():
    ref = J_PLATFORMS["cpu"]
    assert dataclasses.astuple(PLATFORMS["cpu"]) == dataclasses.astuple(ref)
    h100 = PLATFORMS["cuda"]
    assert h100.vpu_flops == h100.mxu_flops == 67e12
    assert (h100.hbm_bw, h100.link_bw) == (3.35e12, 450e9)


@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("prob", PROBLEMS)
@pytest.mark.parametrize("method", SHARED)
def test_cost_components_equal_reference_on_cpu(method, prob, tiles):
    tp = treg.Problem(platform="cpu", **prob)
    jp = jreg.Problem(platform="cpu", **prob)
    got = treg.cost_components(method, tp, treg.Plan(method, **tiles))
    want = jreg.cost_components(method, jp, jreg.Plan(method, **tiles))
    for key in ("flops", "bytes", "seconds"):
        assert got[key] == want[key], key
    for part in ("setup", "stream"):
        assert got[part] == want[part], part


@pytest.mark.parametrize("prob", PROBLEMS)
def test_cuda_kernels_priced_like_pallas_kernels(prob):
    """The kernels cost what the reference's Pallas kernels cost, with
    ``cuda`` taking the place of ``tpu`` (same rates on both sides)."""
    for cuda, pallas in (("cuda_wave", "pallas_wave"),
                         ("cuda_mxu", "pallas_mxu")):
        for platform in ("cpu", "cuda"):
            tp = treg.Problem(platform=platform, **prob)
            jp = jreg.Problem(platform={"cuda": "tpu"}.get(platform,
                                                           platform), **prob)
            plan = dict(n_b=32, k_b=8)
            t = treg.cost_components(cuda, tp, treg.Plan(cuda, **plan))
            if platform == "cpu":
                j = jreg.cost_components(pallas, jp,
                                         jreg.Plan(pallas, **plan))
                assert t["seconds"] == j["seconds"]
                assert t["stream"] == j["stream"]
            base = treg.cost_components(
                "blocked" if cuda == "cuda_wave" else "accumulated", tp,
                treg.Plan("", **plan))
            assert (t["flops"], t["bytes"]) == (base["flops"],
                                                base["bytes"])


def test_auto_on_the_card_picks_a_kernel_at_paper_shape():
    treg.clear_plan_cache()
    plan = treg.select_plan(3840, 3840, 180, platform="cuda")
    assert plan.method == "cuda_wave"
    plan = treg.select_plan(3000, 1000, 37, platform="cuda", signs=True)
    assert plan.method in ("cuda_wave", "cuda_mxu", "cuda_batched")
    # a bucket of small per-request problems (the reference's demo
    # shapes): the plain backends sit at the latency floor but are eager
    # step loops on the card, so a kernel wins
    demo = treg.select_plan(16, 32, 8, platform="cuda", batch=16,
                            shared_sequence=False)
    assert demo.method.startswith("cuda_")
    prob = treg.Problem(m=16, n=32, k=8, platform="cuda")
    for method in ("unoptimized", "wavefront", "blocked", "accumulated"):
        spec = treg.get_backend(method)
        cand = spec.candidates(prob)[0]
        assert spec.cost(prob, cand) >= 1e3 * 2e-6   # floor, penalised
    # the accumulated kernel's eager factors: 127 vectorised steps a band
    # at 64/64, priced at their measured time on the card
    paper = treg.Problem(m=3840, n=3840, k=180, platform="cuda")
    mxu = treg.cost_cuda_mxu(paper, treg.Plan("cuda_mxu", n_b=64, k_b=64))
    wave = treg.cost_cuda_wave(paper, treg.Plan("cuda_wave", n_b=64, k_b=16))
    assert mxu > 36e-3 > 10 * wave
    # where no kernel is eligible (float64) a plain backend still plans
    f64 = treg.select_plan(64, 96, 8, platform="cuda", dtype="float64")
    assert not f64.method.startswith("cuda_")
    cpu = treg.select_plan(3840, 3840, 180, platform="cpu")
    assert cpu.method == jreg.select_plan(3840, 3840, 180,
                                          platform="cpu").method
    assert not cpu.method.startswith("cuda")


def test_eligibility():
    names = lambda **kw: {s.name for s in treg.eligible_backends(
        treg.Problem(m=8, n=8, k=2, **kw))}
    assert names(platform="cuda") == set(treg.registered_methods())
    assert "cuda_wave" in names(platform="cpu")   # plain version, penalised
    assert not {"unoptimized", "wavefront"} & names(signs=True)
    assert not {"cuda_wave", "cuda_mxu", "cuda_batched"} & names(
        dtype="float64")
    tiles = treg.cuda_mxu_tiles(treg.Problem(m=3840, n=3840, k=180))
    assert all(p.n_b + p.k_b <= limits.MXU_MAX_W for p in tiles)
    # a kernel plan names its tiles only; rows per block are the kernel's
    assert all(set(p.kwargs()) == {"n_b", "k_b"} for p in tiles)


def test_plan_cache_counts_hits_and_misses():
    treg.clear_plan_cache()
    assert treg.plan_cache_stats() == {"hits": 0, "misses": 0, "size": 0}
    first = treg.select_plan(64, 33, 7, platform="cpu")
    again = treg.select_plan(64, 33, 7, platform="cpu")
    treg.select_plan(64, 33, 7, platform="cuda")
    assert again is first
    assert treg.plan_cache_stats() == {"hits": 1, "misses": 2, "size": 2}
    assert treg.select_plan(1, 1, 5, platform="cpu").est_seconds == 0.0
    treg.clear_plan_cache()
    assert treg.plan_cache_stats()["size"] == 0


def test_limits():
    assert limits.round_up(33, 32) == 64 == jlimits.round_up(33, 32)
    assert limits.clamp_m_blk(5, 128) == 32
    assert limits.clamp_m_blk(3840, 128) == 128
    assert limits.wave_smem_bytes(64, 16, 128) <= limits.SMEM_PER_BLOCK
    # past the static 48 KB: the launcher opts in to dynamic shared memory
    assert limits.wave_smem_bytes(64, 16, 128) > limits.SMEM_STATIC
    # the wrapper refuses a tile whose window a block cannot hold
    assert limits.wave_smem_bytes(128, 128, 128) > limits.SMEM_PER_BLOCK
    # the fused batched kernel: one thread a row, the row's n columns in
    # shared memory; one warp's float32 slab fits up to n = 1816
    assert limits.batched_threads(1024, 1024) == 32
    assert limits.batched_smem_bytes(1024, 32) == 128 * 1024
    assert limits.batched_threads(32, 5000) == limits.BATCHED_M_BLK
    assert limits.batched_threads(32, 5) == limits.WARP
    assert limits.batched_threads(1816, 64) == limits.WARP
    assert limits.batched_threads(1817, 64) == 0
    assert limits.batched_smem_bytes(1816, 32) <= limits.SMEM_PER_BLOCK
