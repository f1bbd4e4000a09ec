"""The knn forward kernels' launch plan (``knn_kernels.knn_fwd_plan``) and the
fused GAPT generator's item plan (``gapt_kernels.gapt_plan``), on the CPU.

K5 and K8 (``csrc/knn_stages.cuh``) take their pass shape, items, grid, K5's
search span and weight slab size from their plan, K9 (``csrc/gapt_fused.cu``)
its jets an item, rows, grid and slab size from its own, and the kernels only
check them on the card, so what the schedules must hold is tested here: every
receiver in one item of one jet, every (receiver, rank) edge in one pass row
with K1's knn id, every receiver searched once, every GAPT jet in one item with
only the last item short, and the shared memory within the card's 227 KB.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

from mpgan_tpu_torch.ops import knn_kernels as kk
from mpgan_tpu_torch.ops import mp_kernels as mk

FE = [96, 160, 192]

# (batch, n, c, k, fe): the main paths' shapes, the card tests' shapes (item ranges
# across jets, rs = 8, odd widths, no hidden layer, ranks over several passes, search
# segments shorter than a jet, a wide chain) and the --fe 128 256 chain
SHAPES = [
    (512, 150, 32, 20, FE), (160, 150, 32, 20, FE), (128, 150, 32, 20, FE),
    (601, 150, 32, 20, FE), (37, 13, 8, 5, [24, 16, 12]), (3, 13, 8, 5, [24, 16, 12]),
    (2, 70, 3, 33, [30, 50, 7]), (2, 9, 4, 3, [96]), (4, 150, 32, 149, FE),
    (2, 30, 4, 20, [250, 255, 256, 249, 200]), (16, 150, 32, 20, [128, 256]),
    (512, 150, 32, 20, [128, 256]), (1, 150, 32, 20, FE), (7, 160, 5, 140, [30, 50, 7]),
]


@pytest.mark.parametrize("search", [True, False])
@pytest.mark.parametrize("batch,n,c,k,dims", [
    (512, 150, 32, 20, FE),   # knn-20 generation
    (160, 150, 32, 20, FE),   # the train CLI's batch
    (128, 150, 32, 20, FE),   # the step bench's batch
])
def test_knn_plans_at_the_published_widths(batch, n, c, k, dims, search):
    plan = kk.knn_fwd_plan(batch, n, c, k, dims, 132, search)
    # 6 receivers x 20 ranks: 120 of 128 rows, 25 items a jet
    assert (plan.ti, plan.kc, plan.rows, plan.rs, plan.blocks) == (6, 20, 128, 20, 25)
    assert plan.items == batch * 25 and plan.grid == 132
    # K5 searches whole jets beside slabs of 12288 floats; K8 keeps no neighbours
    assert (plan.sspan, plan.slab_floats) == ((150, 12288) if search else (0, 16384))
    assert plan.smem_bytes <= mk.MAX_SMEM_BYTES


@pytest.mark.parametrize("search", [True, False])
@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("batch,n,c,k,dims", SHAPES)
def test_knn_plan_covers_every_receiver_once(batch, n, c, k, dims, sms, search):
    plan = kk.knn_fwd_plan(batch, n, c, k, dims, sms, search)
    assert plan.rows in (32, 64, 128) and 1 <= plan.kc <= k and plan.rs == max(plan.kc, 8)
    assert plan.ti * plan.rs <= plan.rows and 1 <= plan.ti <= n
    assert plan.blocks == -(-n // plan.ti) and plan.items == batch * plan.blocks
    assert 1 <= plan.grid <= min(sms, plan.items)
    assert plan.smem_bytes == kk.knn_fwd_smem_bytes(dims, plan.rows, plan.ti, n, c, k,
                                                    plan.sspan, search)
    assert plan.smem_bytes <= mk.MAX_SMEM_BYTES
    assert plan.slab_floats % 4 == 0 and plan.slab_floats >= mk.BWD_SLAB_FLOATS
    if search:
        assert plan.ti <= plan.sspan <= n and (plan.sspan == n or plan.sspan % plan.ti == 0)
    else:
        assert plan.sspan == 0
    ranges = [plan.item_range(cta) for cta in range(plan.grid)]
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.items
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(lo < hi for lo, hi in ranges)
    seen = np.zeros((batch, n), np.int64)
    for item in range(plan.items):
        b, recv = plan.item_receivers(item, n)
        # an item is a block of one jet
        assert 0 <= b < batch and 0 <= recv.start < recv.stop <= n
        assert recv.start % plan.ti == 0 and len(recv) <= plan.ti
        seen[b, recv.start:recv.stop] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("batch,n,k,dims", [
    (3, 13, 5, [24, 16, 12]), (2, 70, 33, [30, 50, 7]), (2, 9, 3, [96]),
    (2, 150, 20, FE), (1, 160, 140, [30, 50, 7]), (2, 30, 20, [250, 255, 256, 249, 200]),
])
def test_knn_plan_rows_are_the_pair_ids(batch, n, k, dims):
    """The row -> (receiver, rank) mapping of every pass, as the kernel fills its
    rows, gives K1's knn ids (``knn_pair_ids``) and takes every edge once."""
    plan = kk.knn_fwd_plan(batch, n, 4, k, dims, 132)
    ids = kk.knn_pair_ids(batch, n, k, "cpu")[..., 0].numpy().astype(np.int64) & 0xFFFFFFFF
    seen = np.zeros((batch, n, k), np.int64)
    for item in range(plan.items):
        for s0 in range(0, k, plan.kc):
            rows = plan.pass_rows(item, s0, n, k)
            assert len({r for r, *_ in rows}) == len(rows)
            for r, b, i, s, pid in rows:
                assert r < plan.rows and r // plan.rs < plan.ti
                assert pid == ids[b, i, s]
                seen[b, i, s] += 1
    assert (seen == 1).all()


def _searches(plan, cta, n):
    """The searches CTA ``cta`` makes, as ``knn_fwd_kernel`` makes them: for an
    item outside the searched segment, the receivers of its jet that the CTA's
    range holds from the item on, at most ``sspan``; each ``(jet, lo, hi)``."""
    t_begin, t_end = plan.item_range(cta)
    out, seg = [], (-1, 0, 0)
    for t in range(t_begin, t_end):
        b, recv = plan.item_receivers(t, n)
        if b != seg[0] or recv.start >= seg[2]:
            t_jet = min(t_end, (b + 1) * plan.blocks)
            seg = (b, recv.start,
                   min(n, recv.start + plan.sspan, (t_jet - b * plan.blocks) * plan.ti))
            out.append(seg)
        # every row of the item reads sel inside the segment
        assert seg[1] <= recv.start and recv.stop <= seg[2]
    return out


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("batch,n,c,k,dims", SHAPES)
def test_knn_plan_searches_every_receiver_once(batch, n, c, k, dims, sms):
    plan = kk.knn_fwd_plan(batch, n, c, k, dims, sms)
    seen = np.zeros((batch, n), np.int64)
    for cta in range(plan.grid):
        for b, lo, hi in _searches(plan, cta, n):
            assert 0 < hi - lo <= plan.sspan
            seen[b, lo:hi] += 1
    assert (seen == 1).all()


def test_knn_plan_segments_a_jet_whose_neighbours_do_not_fit():
    # 150 x 149 neighbours and distances (179 KB) do not fit beside a pass: on two SMs
    # a CTA walks two jets and searches each in two pieces of at most sspan receivers
    plan = kk.knn_fwd_plan(4, 150, 32, 149, FE, 2)
    assert plan.sspan < 150 and plan.sspan % plan.ti == 0
    searches = [s for cta in range(plan.grid) for s in _searches(plan, cta, 150)]
    assert len(searches) == 8 and max(hi - lo for _, lo, hi in searches) == plan.sspan


def test_knn_plan_is_memoised_and_refuses_what_does_not_fit():
    assert kk.knn_fwd_plan(160, 150, 32, 20, FE, 132) is kk.knn_fwd_plan(160, 150, 32, 20,
                                                                          list(FE), 132)
    # the search's scratch of 4000 senders x 289 rows cannot fit in shared memory
    with pytest.raises(ValueError, match="shared memory"):
        kk.knn_fwd_plan(1, 4000, 256, 20, [256, 256], 132)
    # without the search the same chain runs
    assert kk.knn_fwd_plan(1, 4000, 256, 20, [256, 256], 132, search=False).sspan == 0


def test_knn_shared_memory_by_hand():
    tab = 96  # the layer table
    # K5 at the published widths: a_1 (160 wide) over a_0, the 6 x 192 aggregate, 5 row
    # arrays, the table, sel and seld [150 x 20] and two slabs of 12288 floats
    assert kk.knn_fwd_smem_bytes(FE, 128, 6, 150, 32, 20, 150, True) == 4 * (
        160 * 132 + 6 * 192 + 5 * 132 + tab + 2 * 150 * 20 + 2 * 12288)
    # K8: no neighbours, slabs of 16384
    assert kk.knn_fwd_smem_bytes(FE, 128, 6, 150, 32, 20, 0, False) == 4 * (
        160 * 132 + 6 * 192 + 5 * 132 + tab + 2 * 16384)
    # the search's scratch: xf^T with norms, 33 rows of 156 (150 rounded up to 4, then to
    # an odd number of 4-float groups), and the 21-key lists that up to 3 x 128 threads
    # hand to the receivers' first threads (the lists live in registers)
    merge = 3 * 128 * 21
    assert kk.knn_search_floats(150, 32) == 33 * 156 + merge
    assert kk.knn_search_floats(30, 32) == 33 * 36 + merge
    assert kk.knn_search_floats(13, 8) == 9 * 20 + merge
    # narrower rows are padded to 4, 8 or 16 columns, wider ones than 32 kept as they are
    assert kk.knn_search_floats(70, 3) == 5 * 76 + merge
    assert kk.knn_search_floats(37, 40) == 41 * 44 + merge
    # a search scratch wider than the pass buffer widens the region before the slabs
    wide = kk.knn_search_floats(300, 64)
    assert wide > 96 * 36 + 32
    assert kk.knn_fwd_smem_bytes([96], 32, 4, 300, 64, 3, 300, True) == 4 * (
        wide + 5 * 36 + tab + 2 * 300 * 3 + 2 * kk.knn_fwd_slab_floats([96], 32, 4, 300, 64, 3,
                                                                       300, True))


# ---------------------------------------------------------------------------
# K9's item plan (gapt_kernels.gapt_plan; csrc/gapt_fused.cu checks it on the card)
# ---------------------------------------------------------------------------


def test_gapt_plan_at_the_published_sizes():
    from mpgan_tpu_torch.ops import gapt_kernels as gk

    # 30 particles: 4 jets of 32 rows an item, 256 items at the sampler's batch
    p = gk.gapt_plan(1024, 30, 64, 4, 132)
    assert (p.jets, p.ns, p.rows, p.items, p.grid) == (4, 32, 128, 256, 132)
    assert gk.gapt_plan(4096, 30, 64, 4, 132).items == 1024
    # 150 particles: one jet of 152 rows in 160
    p150 = gk.gapt_plan(512, 150, 64, 4, 132)
    assert (p150.jets, p150.ns, p150.rows, p150.items, p150.grid) == (1, 152, 160, 512, 132)
    for plan in (p, p150):
        assert plan.smem_bytes <= mk.MAX_SMEM_BYTES and plan.slab_floats % 4 == 0
        # the qkv weights [64 x 192] arrive in two slabs of 32 rows, out and ff in one
        assert plan.slab_floats // 192 in range(32, 64) and plan.slab_floats >= 64 * 64


def test_gapt_item_shared_memory_by_hand():
    from mpgan_tpu_torch.ops import gapt_kernels as gk

    # x^T and qkv^T [4 x 64 rows of 132], the mask bias row and two slabs
    p = gk.gapt_plan(1024, 30, 64, 4, 132)
    assert p.smem_bytes == 4 * (4 * 64 * 132 + 132 + 2 * p.slab_floats)
    # the slabs take what is left (227 KB in all), at most one layer's qkv weights
    assert p.slab_floats == (mk.MAX_SMEM_BYTES // 4 - (4 * 64 * 132 + 132)) // 2 // 4 * 4
    assert gk.gapt_plan(8, 25, 32, 2, 132).slab_floats == 3 * 32 * 32


@pytest.mark.parametrize("n,e,heads", [
    (9, 10, 5),     # a width that is no multiple of 4
    (64, 64, 1),    # a head wider than the attention's registers
    (161, 64, 4),   # 164 rows in 192: 12 columns a thread in the qkv product
    (300, 64, 4),
    (512, 64, 4),   # the gate's cap
])
def test_gapt_plan_leaves_what_the_item_path_does_not_take_to_the_per_jet_path(n, e, heads):
    from mpgan_tpu_torch.ops import gapt_kernels as gk

    assert gk.gapt_plan(5, n, e, heads, 132).jets == 0


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("batch,n,e,heads", [
    (1, 30, 64, 4), (3, 30, 64, 4), (37, 30, 64, 4), (1023, 30, 64, 4), (4097, 30, 64, 4),
    (1024, 30, 64, 4), (512, 150, 64, 4), (10, 25, 32, 2), (3, 100, 32, 4), (4, 40, 48, 2),
    (5, 1, 64, 4), (2, 256, 32, 4),
])
def test_gapt_plan_covers_every_jet_once(batch, n, e, heads, sms):
    from mpgan_tpu_torch.ops import gapt_kernels as gk

    plan = gk.gapt_plan(batch, n, e, heads, sms)
    assert plan.jets >= 1 and plan.ns == -(-n // 4) * 4 and plan.ns % 4 == 0
    # whole jets in an item, at most 128 rows of them unless one jet is wider
    assert plan.jets * plan.ns <= max(128, plan.ns) and plan.jets == max(1, 128 // plan.ns)
    assert plan.rows % 32 == 0 and 0 <= plan.rows - plan.jets * plan.ns < 32
    assert plan.items == -(-batch // plan.jets) and 1 <= plan.grid <= min(sms, plan.items)
    assert plan.smem_bytes <= mk.MAX_SMEM_BYTES and plan.slab_floats >= 12 * e
    ranges = [plan.item_range(cta) for cta in range(plan.grid)]
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.items
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(ranges, ranges[1:]))
    seen = np.zeros(batch, np.int64)
    for item in range(plan.items):
        jets = plan.item_jets(item, batch)
        assert 1 <= len(jets) <= plan.jets
        # only the last item may be short
        assert len(jets) == plan.jets or item == plan.items - 1
        seen[jets.start:jets.stop] += 1
    assert (seen == 1).all()
