"""The accumulated kernel's route: tile factors, band inputs, schedule.

``kernels/rotseq_mxu/ops.py`` builds a band's tile factors on the card
with one launch of the fused batched kernel (:func:`batched_band_factors`)
and feeds ``csrc/rotseq_mxu.cu`` its band inputs in natural layout.  On
the CPU the factor route runs the batched kernel's plain version and is
held to the eager plain version ``accumulate_tile_factors`` under ``==``.

No CUDA code runs here, so :func:`_emulate_kernel` walks the kernel's
schedule in numpy float32 (the slab ring filled ahead by TMA, each
slot's full and empty barriers, the double-buffered ``[carry | fresh]``
operand, the epilogue) with every slot tagged by what it holds, and
checks at every write that no thread of the block (for the ring: of the
cluster) may still read what it overwrites.  Tests marked ``gpu`` hold
the kernel to its plain version on the card; they decide inside the
test whether a card is present.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.core.accumulate import (accumulate_tile_factors,
                                         rot_sequence_accumulated)
from repro_torch.core.blocked import band_inputs, num_tiles, pack_sheared
from repro_torch.kernels import limits
from repro_torch.kernels.rotseq_batched import kernel as batched_k
from repro_torch.kernels.rotseq_mxu import kernel as mxu_k
from repro_torch.kernels.rotseq_mxu.ops import (band_factors,
                                                band_inputs_natural,
                                                band_panels, band_windows,
                                                batched_band_factors,
                                                rot_sequence_mxu)
from repro_torch.kernels.rotseq_mxu.ref import rotseq_mxu_ref

CU = (pathlib.Path(limits.__file__).parents[1] / "csrc"
      / "rotseq_mxu.cu").read_text()
MXU_TOL = 1e-5


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", CU).group(1))


# the kernel's block: rows of A, slab rows, ring slots, cluster
ROWS, SLAB, STAGES, CLUSTER = (_constant(c) for c in
                               ("kRows", "kSlab", "kStages", "kCluster"))

# (n, k, n_b, k_b, signs): the shapes the factor route was first checked
# at, every band of each
FACTOR_SHAPES = [(40, 7, 8, 4, False), (100, 37, 16, 16, True),
                 (64, 20, 8, 8, False), (300, 64, 64, 64, True)]


def _waves(n, k, seed, signs=False):
    rng = np.random.default_rng(seed)
    th = rng.uniform(0.0, 2.0 * np.pi, (n - 1, k))
    C = torch.from_numpy(np.cos(th).astype(np.float32))
    S = torch.from_numpy(np.sin(th).astype(np.float32))
    G = None
    if signs:
        G = torch.from_numpy(np.where(rng.random((n - 1, k)) < 0.5, 1.0,
                                      -1.0).astype(np.float32))
    return C, S, G


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("reflect", [False, True])
@pytest.mark.parametrize("n,k,n_b,k_b,signs", FACTOR_SHAPES)
def test_factor_route_equals_eager_factors(n, k, n_b, k_b, signs, reflect):
    """Every band's factors through the fused batched kernel's route (its
    plain version here) equal ``accumulate_tile_factors`` of the sheared
    tiles under ``==``, and ``band_factors`` on a CPU tensor is the eager
    version itself.

    Only the sign of zeros may differ: the batched kernel skips the
    no-op planes outside each wave's live window, which ``apply_tile``
    multiplies through, and a multiplied-through identity turns ``+0``
    into ``-0``.  So the bits differ only where both entries are zero.
    """
    if reflect and signs:
        pytest.skip("per-entry signs take the place of reflect")
    C, S, G = _waves(n, k, n * k + n_b, signs)
    T = num_tiles(n, n_b, k_b)
    before = batched_k.LAUNCHES
    for p0 in range(0, k, k_b):
        kw = dict(reflect=reflect, G=G)
        want = accumulate_tile_factors(*pack_sheared(C, S, p0, k_b, n_b, T,
                                                     **kw))
        got = batched_band_factors(C, S, p0, k_b, n_b, T, **kw)
        assert got.shape == (T, n_b + k_b, n_b + k_b)
        assert torch.equal(got, want)
        differ = got.view(torch.int32) != want.view(torch.int32)
        assert bool((got[differ] == 0).all())
        assert torch.equal(band_factors(C, S, p0, k_b, n_b, T, **kw), want)
    assert batched_k.LAUNCHES == before   # the CPU path launches nothing


@pytest.mark.parametrize("n,k,n_b,k_b,signs", FACTOR_SHAPES)
def test_band_panels_hold_the_sheared_tiles_in_their_windows(n, k, n_b, k_b,
                                                             signs):
    """Tile plane ``(jj, p)`` of ``pack_sheared`` sits at local pair
    ``k_b - 1 - p + jj`` of wave ``p`` of the tile's panel, which is
    wave ``p``'s live window of :func:`band_windows`."""
    C, S, G = _waves(n, k, n + k_b, signs)
    T = num_tiles(n, n_b, k_b)
    p0 = (k - 1) // k_b * k_b                 # the last band: maybe short
    tiles = pack_sheared(C, S, p0, k_b, n_b, T, G=G)
    panels = band_panels(C, S, p0, k_b, n_b, T, G=G)
    starts, counts = band_windows(T, n_b, k_b, "cpu")
    assert bool((counts == n_b).all())
    for tile, panel in zip(tiles, panels):
        assert panel.shape == (T, k_b, n_b + k_b - 1)
        for p in range(k_b):
            s0 = int(starts[0, p])
            assert s0 == k_b - 1 - p
            assert torch.equal(panel[:, p, s0:s0 + n_b], tile[:, :, p])


@pytest.mark.parametrize("m,n,n_b,k_b", [(5, 40, 8, 4), (7, 300, 128, 128)])
def test_natural_band_inputs_equal_packed_ones_transposed(m, n, n_b, k_b):
    A = torch.from_numpy(np.random.default_rng(m).standard_normal(
        (m, n)).astype(np.float32))
    T = num_tiles(n, n_b, k_b)
    fresh, init = band_inputs_natural(A[:, :n], k_b, n_b, T)
    init_p, fresh_p = band_inputs(A.t(), k_b, n_b, T)
    assert fresh.is_contiguous() and init.is_contiguous()
    assert torch.equal(fresh, fresh_p.t()) and torch.equal(init, init_p.t())


class SlotError(AssertionError):
    """A slot did not hold what its reader expects, or was overwritten
    while a reader may still need it."""


def _emulate_kernel(fresh, Q, init, *, slab=SLAB, stages=STAGES,
                    ahead=None, xbufs=2, carry_into="next"):
    """``rotseq_mxu_kernel`` over all rows at once, numpy float32.

    The schedule as the source runs it: the producer warp fills
    ``ahead`` (the kernel: ``stages``) slabs of the ring, and refills
    slab ``j``'s slot with slab ``j + ahead`` as soon as its empty
    barrier completes, when every FMA warp of the cluster is done with
    slab ``j`` (here: right after the block's FMAs on it); at the start
    of tile ``t`` the block copies ``fresh_{t+1}`` into ``X[(t+1) %
    xbufs]``; after tile ``t``'s last slab each thread writes its carry
    into ``X[(t+1) % xbufs]`` (``carry_into="same"``: into the buffer
    tile ``t`` reads) and the tile ends with a block barrier.  A read of
    X is closed once a block barrier has followed it; a slab's slot once
    its empty barrier has completed.  Every write checks that the slot's
    last reads are closed, every read that the slot holds the slab, tile
    and column it wants and that its write was published (by the tile's
    barrier, or for a slab by its full barrier).  Also checks that while
    slab ``j`` runs, slab ``j + 1``'s copy is in flight.
    """
    ahead = stages if ahead is None else ahead
    m, U = fresh.shape
    T, w, _ = Q.shape
    k_b = init.shape[1]
    n_b = w - k_b
    NS = -(-w // slab)
    J = T * NS
    w4 = -(-w // 4) * 4
    XW = w4 + 4
    X = [np.zeros((m, XW), np.float32) for _ in range(xbufs)]
    tag = [[None] * XW for _ in range(xbufs)]      # (kind, tile) a column
    pending = [set() for _ in range(xbufs)]         # written, unpublished
    last_read = [np.full(XW, -1) for _ in range(xbufs)]
    ring = [None] * stages                           # (slab, data)
    out = np.full((m, U), np.nan, np.float32)
    closed_block = closed_cluster = -1
    issued = -1

    def write_x(b, cols, kind, t, values):
        for c in cols:
            if last_read[b][c] > closed_block:
                raise SlotError(f"{kind} of tile {t} written over column "
                                f"{c} of X[{b}], still being read at slab "
                                f"{last_read[b][c]}")
            tag[b][c] = (kind, t)
            pending[b].add(c)
        X[b][:, list(cols)] = values

    def publish():
        for p in pending:
            p.clear()

    def issue(i):
        nonlocal issued
        s = i % stages
        if ring[s] is not None and ring[s][0] > closed_cluster:
            raise SlotError(f"slab {i} issued into slot {s}, which holds "
                            f"slab {ring[s][0]} a block may still read")
        t, k0 = divmod(i, NS)
        k0 *= slab
        data = np.zeros((slab, w4), np.float32)
        rows = Q[t, k0:k0 + slab]
        data[:rows.shape[0], :w] = rows
        ring[s] = (i, data)
        issued = max(issued, i)

    for b in range(xbufs):
        X[b][:, w:] = 0.0
        for c in range(w, XW):
            tag[b][c] = ("zero", None)
    write_x(0, range(k_b), "carry", 0, init)
    write_x(0, range(k_b, w), "fresh", 0, fresh[:, :n_b])
    for i in range(min(ahead, J)):
        issue(i)
    publish()
    acc = np.zeros((m, w4), np.float32)
    for j in range(J):
        t, ks = divmod(j, NS)
        k0 = ks * slab
        b = t % xbufs
        if ks == 0 and t + 1 < T:
            write_x((t + 1) % xbufs, range(k_b, w), "fresh", t + 1,
                    fresh[:, (t + 1) * n_b:(t + 2) * n_b])
        slot = ring[j % stages]
        if slot is None or slot[0] != j:
            raise SlotError(f"slab {j} wanted from slot {j % stages}, which "
                            f"holds {None if slot is None else slot[0]}")
        if j + 1 < J and issued < j + 1:
            raise SlotError(f"no copy in flight while slab {j} runs")
        kend = min(slab, w4 - k0)
        for kk in range(kend):
            c = k0 + kk
            want = (("carry", t) if c < k_b else ("fresh", t)) if c < w \
                else ("zero", None)
            if tag[b][c] != want or c in pending[b]:
                raise SlotError(f"slab {j} reads column {c} of X[{b}] as "
                                f"{want}, which holds {tag[b][c]}"
                                + (" unpublished" if c in pending[b] else ""))
            last_read[b][c] = j
            acc += X[b][:, c:c + 1] * slot[1][kk][None, :]
        # every warp of the cluster released slab j (the slot's empty
        # barrier): the producer refills its slot
        closed_cluster = j
        if j + ahead < J:
            issue(j + ahead)
        if ks == NS - 1:
            out[:, t * n_b:(t + 1) * n_b] = acc[:, :n_b]
            if t + 1 < T:
                cb = (t + 1) % xbufs if carry_into == "next" else b
                write_x(cb, range(k_b), "carry", t + 1, acc[:, n_b:w])
            acc = np.zeros_like(acc)
            publish()
            closed_block = j
    return out


def _band(m, n, k, n_b, k_b, seed, signs=False):
    C, S, G = _waves(n, k, seed, signs)
    A = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (m, n)).astype(np.float32))
    T = num_tiles(n, n_b, k_b)
    Q = accumulate_tile_factors(*pack_sheared(C, S, 0, k_b, n_b, T, G=G))
    fresh, init = band_inputs_natural(A, k_b, n_b, T)
    return fresh, Q, init


def _rel(a, b):
    return float(np.linalg.norm(a.astype(np.float64) - b)
                 / np.linalg.norm(b.astype(np.float64)))


@pytest.mark.parametrize("m,n,k,n_b,k_b,signs", [
    (5, 40, 7, 8, 4, False), (6, 300, 20, 128, 128, True),
    (3, 200, 9, 64, 9, True), (4, 30, 5, 3, 2, False)])
def test_schedule_emulation_equals_plain_version(m, n, k, n_b, k_b, signs):
    """Every width class: one slab a tile (``w = 12``, ``w = 5``, the
    latter not a multiple of 4), several slabs with a ragged last one
    (``w = 73``) and the paper's ``w = 256``."""
    fresh, Q, init = _band(m, n, k, n_b, k_b, m + n, signs)
    got = _emulate_kernel(fresh.numpy(), Q.numpy(), init.numpy())
    want = rotseq_mxu_ref(fresh, Q, init).numpy()
    assert _rel(got, want) <= MXU_TOL


def test_schedule_emulation_fails_with_a_ring_one_slot_short():
    """The kernel keeps ``kStages`` slabs ahead in ``kStages`` slots; a
    ring one slot shorter would fill the slot of a slab that a block of
    the cluster has not read yet."""
    fresh, Q, init = _band(4, 300, 20, 128, 128, 5)
    args = (fresh.numpy(), Q.numpy(), init.numpy())
    _emulate_kernel(*args)
    with pytest.raises(SlotError, match="may still read"):
        _emulate_kernel(*args, stages=STAGES - 1, ahead=STAGES)


def test_schedule_emulation_fails_without_a_copy_in_flight():
    """A ring of one slot is refilled only once its slab is done, so no
    copy is in flight while a slab runs: the next slab's load would be
    exposed.  Two slots are the least; the kernel keeps three."""
    fresh, Q, init = _band(4, 300, 20, 128, 128, 6)
    args = (fresh.numpy(), Q.numpy(), init.numpy())
    _emulate_kernel(*args, stages=2)
    with pytest.raises(SlotError, match="no copy in flight"):
        _emulate_kernel(*args, stages=1)


@pytest.mark.parametrize("n,n_b,k_b", [(40, 8, 4), (300, 128, 128)])
def test_schedule_emulation_fails_with_a_carry_write_before_the_last_read(
        n, n_b, k_b):
    """A carry written over the X the tile reads, right after this
    thread's FMAs, meets other threads' reads of the tile (no barrier
    has closed them); the kernel writes the other buffer, closed since
    the previous tile's barrier."""
    fresh, Q, init = _band(5, n, 7, n_b, k_b, 7)
    args = (fresh.numpy(), Q.numpy(), init.numpy())
    with pytest.raises(SlotError, match="still being read"):
        _emulate_kernel(*args, carry_into="same")


def test_schedule_emulation_fails_with_one_x_buffer():
    """With one X buffer the copy of the next tile's fresh columns
    overwrites the columns the current tile still reads."""
    fresh, Q, init = _band(5, 300, 20, 128, 128, 8)
    with pytest.raises(SlotError, match="fresh"):
        _emulate_kernel(fresh.numpy(), Q.numpy(), init.numpy(), xbufs=1)


def test_source_constants_match():
    """The emulation runs the source's slab, ring and rows; the ring and
    the cluster fit a slab, and the widest micro-tile is ``MXU_MAX_W``."""
    assert SLAB % (4 * CLUSTER) == 0 and STAGES >= 3
    assert (ROWS, SLAB) == (limits.MXU_ROWS, limits.MXU_SLAB)
    assert [limits.mxu_width(w) for w in (5, 64, 65, 128, 129, 256)] == [
        64, 64, 128, 128, 256, 256]
    assert "if (w <= 128)" in CU and limits.MXU_MAX_W == 256
    assert "__cluster_dims__(kCluster, 1, 1)" in CU
    assert "fmaf(" in CU and "wgmma" not in CU.split("#include")[1]


def test_cpu_route_launches_nothing():
    fresh, Q, init = _band(6, 40, 7, 8, 4, 9)
    before = (mxu_k.LAUNCHES, batched_k.LAUNCHES)
    assert torch.equal(mxu_k.rotseq_mxu(fresh, Q, init),
                       rotseq_mxu_ref(fresh, Q, init))
    assert (mxu_k.LAUNCHES, batched_k.LAUNCHES) == before


# -- on the card ---------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k,n_b,k_b,signs,reflect", [
    (300, 40, 7, 8, 4, True, False),        # w = 12
    (131, 70, 16, 16, 16, False, True),     # w = 32, reflectors
    (3 * ROWS * CLUSTER + 5, 300, 64, 64, 64, True, False),   # w = 128
    (ROWS * CLUSTER + 1, 300, 20, 128, 128, False, False),    # w = 256
    (77, 100, 5, 128, 1, True, False),      # T = 1 (k_b = 1, n_b = n)
    (1, 50, 9, 8, 3, False, False)])        # w = 11, one row
def test_kernel_matches_plain_version_on_card(m, n, k, n_b, k_b, signs,
                                              reflect):
    """Ragged rows (not a multiple of the rows a cluster takes), each
    width path, ``T = 1``: the kernel against its plain version on one
    band, and the route (factors through ``rotseq_batched``, one launch
    of each kernel a band) against the eager plain path."""
    dev = _cuda()
    C, S, G = _waves(n, k, m + n, signs)
    A = torch.from_numpy(np.random.default_rng(m).standard_normal(
        (m, n)).astype(np.float32)).to(dev)
    C, S = C.to(dev), S.to(dev)
    G = None if G is None else G.to(dev)
    n_b_eff = min(n_b, max(8, n))
    T = num_tiles(n, n_b_eff, k_b)
    if k_b == 1:
        assert T == 1
    tiles = pack_sheared(C, S, 0, k_b, n_b_eff, T, reflect=reflect, G=G)
    Q = band_factors(C, S, 0, k_b, n_b_eff, T, reflect=reflect, G=G)
    assert torch.equal(Q, accumulate_tile_factors(*tiles))
    fresh, init = band_inputs_natural(A, k_b, n_b_eff, T)
    got = mxu_k.rotseq_mxu(fresh, Q, init)
    want = rotseq_mxu_ref(fresh, Q, init)
    torch.cuda.synchronize()
    assert float((got - want).norm() / want.norm()) <= MXU_TOL
    before = (mxu_k.LAUNCHES, batched_k.LAUNCHES)
    out = rot_sequence_mxu(A, C, S, n_b=n_b, k_b=k_b, reflect=reflect, G=G)
    torch.cuda.synchronize()
    bands = -(-k // k_b)
    assert (mxu_k.LAUNCHES - before[0], batched_k.LAUNCHES - before[1]) == (
        bands, bands)
    plain = rot_sequence_accumulated(A, C, S, n_b=n_b, k_b=k_b,
                                     reflect=reflect, G=G)
    assert bool(torch.isfinite(out).all())
    assert float((out - plain).norm() / plain.norm()) <= MXU_TOL
