"""Port registry: the same SS6 arithmetic as the reference, on the card's rates.

On ``"cpu"`` the port's hardware row is the reference's, so the four
backends both packages share cost exactly the same.  On ``"cuda"`` (an
H100) ``method="auto"`` must land on a CUDA kernel, never on an eager
plain backend, and where the kernels' applications were measured on the
card it must order them as the measurements did: ``cuda_mxu`` before
``cuda_wave`` before ``cuda_batched`` at the paper's shape, ``cuda_wave``
for one ``1024 x 1024`` target, ``cuda_batched`` for the serving bucket,
``cuda_mxu`` for a shared-sequence batch of 8 paper-shape targets.
"""
import dataclasses
import pathlib

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
    # every field of the reference's record equal; the port's record adds
    # two the registry does not read (tc_bf16_flops, hbm_bytes)
    ref = J_PLATFORMS["cpu"]
    assert {f.name: getattr(PLATFORMS["cpu"], f.name)
            for f in dataclasses.fields(ref)} == dataclasses.asdict(ref)
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
    # measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): plan.apply
    # through cuda_mxu 1.75 ms at 64/64 and 1.79 at 128/128 (its
    # rotseq_mxu line), cuda_wave 1.94-1.98 ms, cuda_batched 6.62-6.67 ms
    # (the main_path and planner lines of the same run)
    assert plan.method == "cuda_mxu"
    assert plan.kwargs() in ({"n_b": 64, "k_b": 64},
                             {"n_b": 128, "k_b": 128})
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
    # the accumulated kernel at its measured slab time, its factors one
    # fused launch a band at that kernel's plane rate, plus the host's
    # calls of the first band; the two row-parallel kernels at their
    # measured plane rates
    paper = treg.Problem(m=3840, n=3840, k=180, platform="cuda")
    mxu = treg.cost_cuda_mxu(paper, treg.Plan("cuda_mxu", n_b=64, k_b=64))
    mxu128 = treg.cost_cuda_mxu(paper,
                                treg.Plan("cuda_mxu", n_b=128, k_b=128))
    wave = treg.cost_cuda_wave(paper, treg.Plan("cuda_wave", k_b=16))
    fused = treg.cost_cuda_batched(paper, treg.Plan("cuda_batched"))
    assert max(mxu, mxu128) < wave < fused
    assert mxu == pytest.approx(1.75e-3, rel=0.1)
    assert mxu128 == pytest.approx(1.79e-3, rel=0.1)
    assert wave == pytest.approx(1.95e-3, rel=0.02)
    assert fused == pytest.approx(6.62e-3, rel=0.02)
    # where no kernel is eligible (float64) a plain backend still plans
    f64 = treg.select_plan(64, 96, 8, platform="cuda", dtype="float64")
    assert not f64.method.startswith("cuda_")
    cpu = treg.select_plan(3840, 3840, 180, platform="cpu")
    assert cpu.method == jreg.select_plan(3840, 3840, 180,
                                          platform="cpu").method
    assert not cpu.method.startswith("cuda")


def test_shared_batch_pays_the_factors_once():
    """A shared-sequence batch of 8 paper-shape targets: the tile factors
    are built once for ``8 * 3840`` rows.  On the card (chip_smoke.py's
    planner line, NVIDIA H100 80GB HBM3, 700 W) ``cuda_mxu`` took 8.52
    ms at 64/64 and 10.25 at 128/128, ``cuda_batched`` 12.73 and
    ``cuda_wave`` 15.09: ``auto`` plans ``cuda_mxu``, and prices the
    other two above it."""
    treg.clear_plan_cache()
    plan = treg.select_plan(3840, 3840, 180, platform="cuda", batch=8)
    assert plan.method == "cuda_mxu"
    batch = treg.Problem(m=3840, n=3840, k=180, platform="cuda", batch=8)
    wave = treg.cost_cuda_wave(batch, treg.Plan("cuda_wave", k_b=16))
    mxu = treg.cost_cuda_mxu(batch, treg.Plan("cuda_mxu", n_b=128,
                                               k_b=128))
    fused = treg.cost_cuda_batched(batch, treg.Plan("cuda_batched"))
    assert min(wave, fused) > mxu
    assert mxu == pytest.approx(8.52e-3, rel=0.2)
    # the factors are paid once: 8 targets cost less than 8 single ones
    one = treg.cost_cuda_mxu(treg.Problem(m=3840, n=3840, k=180,
                                          platform="cuda"),
                             treg.Plan("cuda_mxu", n_b=128, k_b=128))
    assert mxu < 8 * one


def test_refit_orders_the_single_request_as_measured():
    """One ``1024 x 1024`` target of the serving bucket's first request
    (41 waves): ``cuda_wave`` took 0.33 ms and ``cuda_batched`` 0.87 ms
    on the card (chip_smoke.py's serving phase, NVIDIA H100 80GB HBM3,
    700 W), so ``auto`` plans the wavefront kernel, and prices the fused
    kernel above it by a factor near the measured one."""
    treg.clear_plan_cache()
    plan = treg.select_plan(1024, 1024, 41, platform="cuda",
                            live_planes=1023 * 41)
    assert plan.method == "cuda_wave"
    one = treg.Problem(m=1024, n=1024, k=41, platform="cuda",
                       live_planes=1023 * 41)
    fused = treg.cost_cuda_batched(one, treg.Plan("cuda_batched"))
    wave = min(treg.cost_cuda_wave(one, p)
               for p in treg.cuda_wave_tiles(one))
    assert 1.5 < fused / wave < 6.0          # measured: 0.87 / 0.33 = 2.6
    # a whole serving bucket still plans the fused kernel, far below a
    # per-request loop of wavefront launches (measured, chip_smoke.py's
    # rotseq_batched line: 4.42 ms for the loop against 0.64 ms)
    bucket = treg.Problem(m=1024, n=1024, k=64, platform="cuda", batch=16,
                          shared_sequence=False, live_planes=1023 * 48)
    assert (treg.cost_cuda_batched(bucket, treg.Plan("cuda_batched"))
            < min(treg.cost_cuda_wave(bucket, p)
                  for p in treg.cuda_wave_tiles(bucket)) / 3)
    treg.clear_plan_cache()


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
    # the wavefront kernel's block: a group of 32 rows, one a lane, on
    # WAVE_WARPS warps; its plane staging and rings fit a block
    assert limits.WAVE_ROWS == limits.WARP
    assert limits.wave_smem_bytes() <= limits.SMEM_PER_BLOCK
    # past the static 48 KB: the launcher opts in to dynamic shared memory
    assert limits.wave_smem_bytes() > limits.SMEM_STATIC
    # the budget bounds the warps a block: twice the compiled count does
    # not fit
    assert limits.wave_smem_bytes(warps=2 * limits.WAVE_WARPS) > \
        limits.SMEM_PER_BLOCK
    # the fused batched kernel: one thread a row in blocks of two warps,
    # the one block size its source is compiled for; the width sets no
    # limit (the row's window is in registers, not a shared-memory slab)
    from repro_torch.kernels.rotseq_batched.ref import row_blocks
    assert limits.BATCHED_M_BLK == 2 * limits.WARP
    cu = pathlib.Path(limits.__file__).parents[1] / "csrc" / "rotseq_batched.cu"
    assert (f"constexpr int kThreads = {limits.BATCHED_M_BLK};"
            in cu.read_text())
    assert [row_blocks(m) for m in (1, 64, 65, 1024, 5000)] == [
        1, 1, 2, 16, 79]


def test_float16_eligible_for_auto():
    """As the reference's ``tests/test_api_dispatch.py``: the default
    capability takes the four dtypes the reference's does; the CUDA
    kernels take float32, bfloat16 and float16, as the reference's Pallas
    kernels take their operand's dtype, and not float64."""
    p = treg.Problem(m=8, n=16, k=4, dtype="float16", platform="cpu")
    assert treg.eligible_backends(p), "float16 must have eligible backends"
    kernels = {"cuda_wave", "cuda_mxu", "cuda_batched"}
    for dtype in ("bfloat16", "float16"):
        names = {s.name for s in treg.eligible_backends(treg.Problem(
            m=8, n=16, k=4, dtype=dtype, platform="cuda"))}
        assert kernels <= names
    names = {s.name for s in treg.eligible_backends(treg.Problem(
        m=8, n=16, k=4, dtype="float64", platform="cuda"))}
    assert names and not any(x.startswith("cuda_") for x in names)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_half_mxu_sweep_priced_at_its_dtype_chunk_time(dtype, monkeypatch):
    """A half target's ``cuda_mxu`` sweep reads its own dtype's measured
    chunk time (the tensor-core tier's fit), not the other half dtype's,
    and a float32 target's price does not move with it: float32 keeps
    the slab fit of its FMA tier.  At the paper shape the sweep is the
    fit's time of a chunk of ``Q_t`` at the tiling's padded width, bands
    x tiles x chunks of a block, the 60 blocks of 64 rows on 132 SMs at
    once."""
    times = treg._MXU_HALF_CHUNK_SECONDS
    other = "float16" if dtype == "bfloat16" else "bfloat16"
    assert set(times) == {"bfloat16", "float16"}
    assert all(a > 0 and b > 0 for a, b in times.values())
    half = treg.Problem(m=3840, n=3840, k=180, dtype=dtype, platform="cuda")
    f32 = dataclasses.replace(half, dtype="float32")
    oth = dataclasses.replace(half, dtype=other)
    plan = treg.Plan("cuda_mxu", n_b=128, k_b=128)
    costs = {}
    for a in (1e-6, 4e-6):
        monkeypatch.setitem(times, dtype, (a, 0.0))
        costs[a] = (treg.cost_cuda_mxu(half, plan),
                    treg.cost_cuda_mxu(f32, plan),
                    treg.cost_cuda_mxu(oth, plan))
        # 2 bands of 31 tiles of 2 + 2 chunks
        assert treg._mxu_half_sweep_seconds(half, 128, 128) == \
            pytest.approx(2 * 31 * 4 * a)
    assert costs[4e-6][0] > costs[1e-6][0]
    assert costs[4e-6][1] == costs[1e-6][1]
    assert costs[4e-6][2] == costs[1e-6][2]
    monkeypatch.setitem(times, dtype, (0.0, 1e-8))
    # 3 bands of 61 tiles of 1 + 1 chunks at the padded width 128
    assert treg._mxu_half_sweep_seconds(half, 64, 64) == \
        pytest.approx(3 * 61 * 2 * 128 * 1e-8)
    assert limits.MXU_HALF_CHUNK == 64 and limits.MXU_HALF_ROWS == 64


def test_half_mxu_picks_follow_the_card():
    """With the half sweep at its measured chunk time, ``auto`` plans at
    the paper shape the tiling the card runs faster in both half dtypes,
    64/64 (chip_smoke.py's half_main_path line, the applications timed
    back to back on the card: 128/128 pays two bands of factors over
    twice the planes); float32 keeps 64/64."""
    treg.clear_plan_cache()
    picks = {dt: treg.select_plan(3840, 3840, 180, dtype=dt,
                                  platform="cuda")
             for dt in ("bfloat16", "float16", "float32")}
    assert {dt: (p.method, p.n_b, p.k_b) for dt, p in picks.items()} == {
        dt: ("cuda_mxu", 64, 64) for dt in picks}


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_half_wave_priced_at_its_dtype_rate(dtype, monkeypatch):
    """A half target's ``cuda_wave`` price reads its own dtype's plane
    rate, not float32's, and a float32 target's does not: the measured
    half rates (the paper shape's launch of the paired half body) are
    slower than float32's, and float32's is still the main path's
    1.66 ms."""
    rates = treg._WAVE_PLANE_SECONDS
    assert rates[dtype] > rates["float32"] == 1.66e-3 / treg._WAVE_CHAIN
    half = treg.Problem(m=3840, n=3840, k=180, dtype=dtype, platform="cuda")
    f32 = dataclasses.replace(half, dtype="float32")
    plan = treg.Plan("cuda_wave", k_b=16)
    costs = {}
    for rate in (1e-6, 2e-6):
        monkeypatch.setitem(rates, dtype, rate)
        costs[rate] = (treg.cost_cuda_wave(half, plan),
                       treg.cost_cuda_wave(f32, plan))
    assert costs[2e-6][0] > costs[1e-6][0]
    assert costs[2e-6][1] == costs[1e-6][1]
    # the row chain the model prices at the paper shape: 12 bands on 12
    # warps a row group, the rate times one warp's share of a row's planes
    chain = treg._row_chain_seconds(3839 * 192 / 12, 3840 * 12, 1.0)
    assert chain == pytest.approx(treg._WAVE_CHAIN)
