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
    # the wavefront kernel: one plan a compiled band, no column tiles
    for prob in (treg.Problem(m=3840, n=3840, k=180),
                 treg.Problem(m=1024, n=1024, k=32)):
        waves = treg.cuda_wave_tiles(prob)
        assert [p.k_b for p in waves] == list(limits.WAVE_BANDS)
        assert all(p.n_b is None for p in waves)
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
    """A half target's ``cuda_wave`` price reads its own dtype's fitted
    constants at its plan's band (the default band's walk, or the small
    band's kernel's), and a float32 target's does not: the measured half
    launches (the paired half body) are slower than float32's at the
    default band's paper shape and the small band's eig flush (at the
    paper shape the small band's bfloat16 launch, which stages half the
    bytes, ran faster), and each dtype's fits hold the launches they
    were fitted to within 8%."""
    half = treg.Problem(m=3840, n=3840, k=180, dtype=dtype, platform="cuda")
    f32 = dataclasses.replace(half, dtype="float32")
    for kb, consts, shape in (
            (limits.WAVE_KB, treg._WAVE_STEP_SECONDS, (3840, 3840, 180)),
            (limits.WAVE_SMALL_KB, treg._WAVE_SMALL_STEP_SECONDS,
             (1024, 1024, 32))):
        assert set(consts) == set(treg._WAVE_LAUNCHES) == {
            "float32", "bfloat16", "float16"}
        fitted = consts[dtype]
        plan = treg.Plan("cuda_wave", k_b=kb)
        assert treg._wave_launch_seconds(*shape, kb, dtype) > \
            treg._wave_launch_seconds(*shape, kb, "float32")
        costs = {}
        for scale in (1.0, 2.0):
            monkeypatch.setitem(consts, dtype, tuple(scale * x
                                                     for x in fitted))
            costs[scale] = (treg.cost_cuda_wave(half, plan),
                            treg.cost_cuda_wave(f32, plan))
        assert costs[2.0][0] > costs[1.0][0]
        assert costs[2.0][1] == costs[1.0][1]
        monkeypatch.setitem(consts, dtype, fitted)
    for (m, n, k, kb), ms in treg._WAVE_LAUNCHES[dtype].items():
        got = treg._wave_launch_seconds(m, n, k, kb, dtype) * 1e3
        assert got == pytest.approx(ms, rel=0.08)
    # the walk the model prices at the paper shape: 12 bands on 12 warps
    # a row group, three a scheduler, 484 chunks of 8 steps and a lag of
    # 5 chunks a warp; 120 row groups, no queue
    assert treg._wave_walk(3840, 3840, 180, limits.WAVE_KB) == (
        484 + 5 * 11, 16 * 8 * 3)


# the planner's points and the serving bucket (chip_smoke.py's autotune
# points besides the eig flush), with the model's pick at each: the
# small band changes none of them
PICKS = [(dict(m=3840, n=3840, k=180), "cuda_mxu"),
         (dict(m=1024, n=1024, k=41), "cuda_wave"),
         (dict(m=3840, n=3840, k=180, batch=8), "cuda_mxu"),
         (dict(m=1024, n=1024, k=64, batch=16, shared_sequence=False,
               live_planes=1023 * 48), "cuda_batched")]


def test_small_band_wins_the_eig_flush():
    """At an eigensolver's flush ``(1024, 1024, 32)`` the model picks the
    wavefront kernel at the small band, the default band next by about
    the ratio measured on the card (NVIDIA H100 80GB HBM3 at 700.00 W,
    chip_smoke.py's rotseq_wave_flush line), and every other kernel plan
    at 1.5 times it or more.  The default band is slow there for its
    walk: 2 warps of a row group's 12 through 137 chunk iterations of 128
    planes, each closed by a block barrier; the small band's kernel runs
    a warp of 4 rows by 8 bands through 1087 steps, one warp a scheduler
    on 128 SMs.  At the paper shape (45 bands of 4, six passes, two warps
    a scheduler) the small band never wins, and ``auto`` stays
    ``cuda_mxu``."""
    treg.clear_plan_cache()
    small = treg.Plan("cuda_wave", k_b=limits.WAVE_SMALL_KB)
    default = treg.Plan("cuda_wave", k_b=limits.WAVE_KB)
    pick = treg.select_plan(1024, 1024, 32, dtype="float32",
                            platform="cuda")
    assert (pick.method, pick.n_b, pick.k_b) == ("cuda_wave", None,
                                                 limits.WAVE_SMALL_KB)
    eig = treg.Problem(m=1024, n=1024, k=32, platform="cuda")
    plans = treg._modeled_plans(eig)
    assert [(p.method, p.k_b) for p in plans[:2]] == [("cuda_wave", 4),
                                                      ("cuda_wave", 16)]
    launches = treg._WAVE_LAUNCHES["float32"]
    measured = launches[1024, 1024, 32, 16] / launches[1024, 1024, 32, 4]
    assert plans[1].est_seconds / plans[0].est_seconds == pytest.approx(
        measured, rel=0.15)
    assert all(p.est_seconds >= 1.5 * plans[0].est_seconds
               for p in plans if p.method != "cuda_wave")
    # the two walks: 132 chunks of 8 steps and a lag of 5 chunks a warp,
    # one warp a scheduler; 1024 + 7 + 7 * 8 steps of a warp alone on its
    # scheduler (256 warps in 128 blocks of 2, one block an SM)
    assert treg._wave_walk(1024, 1024, 32, 16) == (132 + 5 * 1, 128)
    assert treg._wave_walk(1024, 1024, 32, 4) == (1024 + 7 + 7 * 8, 4.0)
    assert treg.cost_cuda_wave(eig, small) == pytest.approx(
        0.7 * treg._blocked_seconds(eig, default)
        + treg._wave_launch_seconds(1024, 1024, 32, 4, "float32"))
    # the float32 fits hold every launch they were fitted to within 7%
    for (m, n, k, kb), ms in launches.items():
        assert treg._wave_launch_seconds(m, n, k, kb, "float32") * 1e3 == \
            pytest.approx(ms, rel=0.07)
    paper = treg.Problem(m=3840, n=3840, k=180, platform="cuda")
    assert treg.cost_cuda_wave(paper, small) > treg.cost_cuda_wave(
        paper, default)
    # six passes of 8 bands (the last of 5), each walking the row again;
    # 960 warps in 480 blocks, four blocks an SM: two warps a scheduler
    assert treg._wave_walk(3840, 3840, 180, 4) == (
        5 * (3840 + 7 + 7 * 8) + (3840 + 7 + 4 * 8), 8.0)
    treg.clear_plan_cache()


@pytest.mark.parametrize("m,n,k,steps,load", [
    (1024, 1024, 32, 1024 + 7 + 7 * 8, 4.0),
    (3000, 1000, 37, (1000 + 7 + 7 * 8) + (1000 + 7 + 1 * 8), 6.0),
    (64, 200, 13, 200 + 7 + 3 * 8, 4.0),
    (40000, 100, 8, 100 + 7 + 1 * 8, 76.0)])
def test_small_band_walk(m, n, k, steps, load):
    """The small band's price walks its kernel's schedule: a warp's steps
    over every pass (``n + 7 + 8 (bands - 1)``, 8 bands a pass) and
    ``k_b = 4`` planes a warp-step times the warps an SM shares among
    its 4 schedulers, at least one: at the flush 128 blocks of two warps,
    one an SM; 750 warps in 375 blocks, three an SM; 10000 warps in 5000
    blocks, 38 an SM."""
    assert treg._wave_walk(m, n, k, limits.WAVE_SMALL_KB) == (steps, load)
    assert steps == limits.wave_small_steps(n, k)
    c, s = treg._WAVE_SMALL_STEP_SECONDS["float32"]
    assert treg._wave_launch_seconds(m, n, k, limits.WAVE_SMALL_KB,
                                     "float32") == pytest.approx(
        steps * (c + s * load))


@pytest.mark.parametrize("prob,method", PICKS)
def test_small_band_leaves_the_other_picks(prob, method):
    """The planner's three points and the serving bucket plan what they
    planned before the small band (``auto`` at the paper shape stays
    ``cuda_mxu``); the small band takes only what is ``cuda_wave``'s
    already, where fewer bands than warps leave a row group idle."""
    treg.clear_plan_cache()
    pick = treg.select_plan(**prob, platform="cuda")
    assert pick.method == method
    if method == "cuda_wave":
        assert pick.k_b == limits.WAVE_SMALL_KB   # 11 bands, not 3
    treg.clear_plan_cache()


@pytest.mark.parametrize("k_b", [4, 16])
def test_a_persisted_band_loads_and_runs(k_b, tmp_path, monkeypatch):
    """A measured ``cuda_wave`` plan at either band goes through the
    store and back (a store written before the small band holds ``k_b =
    16``), is taken as is, and its application runs at that band: on
    the CPU the plain version, equal to the blocked sweep."""
    import torch
    from repro_torch import random_sequence
    from repro_torch.core.blocked import rot_sequence_blocked
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "plans.json"))
    treg.clear_plan_cache()
    prob = treg.Problem(m=24, n=40, k=32, platform="cpu")
    key = treg._plan_key(prob)
    treg._PLAN_CACHE[key] = treg.Plan("cuda_wave", k_b=k_b, est_seconds=1e-4,
                                      source="measured")
    assert treg.save_plan_cache() == str(tmp_path / "plans.json")
    treg.clear_plan_cache()
    assert treg.load_plan_cache() == 1
    plan = treg.select_plan(24, 40, 32, platform="cpu", autotune=True)
    assert (plan.source, plan.method, plan.k_b) == ("persisted", "cuda_wave",
                                                    k_b)
    gen = torch.Generator().manual_seed(k_b)
    seq = random_sequence(40, 32, generator=gen, device="cpu")
    A = torch.randn((24, 40), generator=gen)
    sp = seq.plan(like=A)
    assert sp.plan == plan and dict(sp.kwargs) == {"k_b": k_b}
    assert torch.equal(sp.apply(A), rot_sequence_blocked(
        A, seq.cos, seq.sin, k_b=k_b))
    treg.clear_plan_cache()
