"""The bf16 forward pass's plans (``csrc/edge_fwd_bf16_tiles.cuh``) on the CPU.

K2's, K4's, K5's and K8's bf16 launches run a pass in which a warp takes 16 pair
rows through the whole chain, the weights resident in shared memory; K4 then runs
fn on tiles of 16 receivers after a grid-wide barrier. Its plan
(``mp_kernels.bf16_tile_plan``, ``knn_kernels.bf16_tile_plan``) is made in
Python; these tests walk it as the kernel does (CTAs' contiguous item ranges,
the warps in turn, K5's search chunks, 16-row tiles, K4's fn tiles in rounds of
its slots) and hold it to what the kernel needs: every pair row once, each
receiver's rows in the 8-row groups of the FP32 plan's row order (so the sums are
the FP32 pass's), a receiver's group sums added in the FP32 pass's order, every
receiver in one fn tile, and the shared memory at the published widths as worked
out by hand.
"""

import numpy as np
import pytest

from mpgan_tpu_torch.ops import knn_kernels as kk
from mpgan_tpu_torch.ops import mp_kernels as mk

FE = [96, 160, 192]
SMS = 132
# (batch, n, fe): the flagship step, 150p dense (its step and generation), the
# --fe 128 256 chain, MNIST (N=75, 100), and ragged small ones
DENSE = [(256, 30, FE), (32, 150, FE), (64, 150, [128, 256]), (32, 75, FE), (32, 100, FE),
         (3, 13, [24, 16, 12]), (33, 13, [20, 13, 12]), (2, 40, [13, 9, 11, 5]),
         (3, 30, [250, 255, 256, 249, 200]), (5, 7, [30, 50, 7])]
# (batch, n, c, k, fe): knn-20 (the step's and the D step's batch) and ragged small ones
KNN = [(160, 150, 32, 20, FE), (8, 150, 32, 20, FE), (3, 13, 8, 5, [24, 16, 12]),
       (2, 70, 3, 33, [30, 50, 7]), (2, 9, 4, 3, [96])]


def _walk(plan, batch, n, knn_k=0):
    """The pair rows a launch computes, as the kernel walks its plan: arrays of
    (receiver b n + i, sender or rank, row within its item's chunk, item), one
    entry a real row, and K5's neighbour slots of each item."""
    senders = knn_k or n
    recv, send, rows, items, slots = [], [], [], [], {}
    span_of = (lambda lo, hi: plan.sspan_items) if plan.sspan_items else (lambda lo, hi: hi - lo)
    for cta in range(plan.grid):
        lo, hi = plan.item_range(cta)
        for c0 in range(lo, hi, max(span_of(lo, hi), 1)):
            c1 = min(hi, c0 + span_of(lo, hi))
            for warp in range(plan.warps):
                for t in range(c0 + warp, c1, plan.warps):
                    if knn_k:
                        b, blk = divmod(t, plan.blocks)
                        q0, ti_eff = b * n + blk * plan.ti, min(plan.ti, n - blk * plan.ti)
                    else:
                        q0, ti_eff = t * plan.ti, min(plan.ti, batch * n - t * plan.ti)
                    if plan.sspan_items:
                        slots[t] = (t - c0) * plan.ti * knn_k
                    for j0 in range(0, senders, plan.jc):
                        jc_eff = min(plan.jc, senders - j0)
                        r = np.arange(16 * plan.tiles(ti_eff, jc_eff))
                        ii, jj = r // plan.rs, r % plan.rs
                        real = (ii < ti_eff) & (jj < jc_eff)
                        recv.append(q0 + ii[real])
                        send.append(j0 + jj[real])
                        rows.append(r[real])
                        items.append(np.full(real.sum(), t))
    cat = np.concatenate
    return cat(recv), cat(send), cat(rows), cat(items), slots


def _check_rows(plan, batch, n, fp32_ti, knn_k=0):
    recv, send, rows, _, _ = _walk(plan, batch, n, knn_k)
    senders = knn_k or n
    # every (receiver, sender) pair row exactly once
    pairs = recv.astype(np.int64) * senders + send
    assert pairs.size == batch * n * senders
    assert np.unique(pairs).size == pairs.size
    # each row sits where the FP32 plan's row order puts it within its 8-row group: the
    # receiver's place in its item times rs, plus the sender's place in its chunk
    index = recv % n if knn_k else recv
    place = send % plan.jc
    fp32 = (index % fp32_ti) * plan.rs + place
    assert np.array_equal(rows, (index % plan.ti) * plan.rs + place)
    assert np.array_equal(rows % 8, fp32 % 8)


@pytest.mark.parametrize("batch,n,fe", DENSE)
def test_dense_tile_rows_cover_every_pair_once_in_the_fp32_order(batch, n, fe):
    plan = mk.bf16_tile_plan(batch, n, fe, SMS)
    fp32 = mk.fwd_plan(batch, n, fe, SMS)
    assert plan.jc == fp32.jc and plan.rs == fp32.rs
    assert plan.ti * plan.rs % 8 == 0 or plan.ti == fp32.ti
    assert plan.items == -(-batch * n // plan.ti) and plan.grid == min(SMS, plan.items)
    assert plan.sspan_items == 0 and 1 <= plan.warps <= mk.tile_warps(plan.width)
    _check_rows(plan, batch, n, fp32.ti)


@pytest.mark.parametrize("search", [True, False])
@pytest.mark.parametrize("batch,n,c,k,fe", KNN)
def test_knn_tile_rows_cover_every_edge_once_in_the_fp32_order(batch, n, c, k, fe, search):
    plan = kk.bf16_tile_plan(batch, n, c, k, fe, SMS, search)
    fp32 = kk.knn_fwd_plan(batch, n, 0, k, fe, SMS, search=False)
    assert plan.jc == fp32.kc
    assert plan.blocks == -(-n // plan.ti) and plan.items == batch * plan.blocks
    assert plan.warps == mk.tile_warps(plan.width) or not search
    _check_rows(plan, batch, n, fp32.ti, knn_k=k)
    # K5's neighbour slots of a chunk stay inside the plan's arrays
    _, _, _, _, slots = _walk(plan, batch, n, k)
    assert bool(slots) == search
    assert all(s + plan.ti * k <= plan.sspan_items * plan.ti * k for s in slots.values())


@pytest.mark.parametrize("batch,n,c,k,fe", KNN)
def test_k5_and_k8_plans_chunk_the_ranks_alike(batch, n, c, k, fe):
    """K8 on K5's idx sums each receiver's ranks as K5 does."""
    k5 = kk.bf16_tile_plan(batch, n, c, k, fe, SMS, True)
    k8 = kk.bf16_tile_plan(batch, n, 0, k, fe, SMS, False)
    assert k5.jc == k8.jc and k5.rs == k8.rs
    assert k5.ti * k5.rs % 8 == 0 or k5.ti == k8.ti


def _tile_sums(ti_eff, jc_eff, rs, tiles):
    """Each receiver's sum as the kernel's group_add adds it over the tiles' 8-row
    groups: the partials (head or tail, group) in the order they are added."""
    out, run = {}, None
    for rt in range(tiles):
        for g in (2 * rt, 2 * rt + 1):
            head = 8 * g // rs
            g1 = (head * rs + jc_eff - 1) // 8
            if head < ti_eff and g <= g1:
                run = [("head", g)] if head * rs == 8 * g else run + [("head", g)]
                if g == g1:
                    out[head] = run
            tail = head + 1
            if tail < ti_eff and tail * rs < 8 * g + 8:
                run = [("tail", g)]
                if g == (tail * rs + jc_eff - 1) // 8:
                    out[tail] = run
    return out


def _fp32_tail_sums(ti_eff, jc_eff, rs):
    """The FP32 pass's tail (edge_fwd_common.cuh: fwd_pass): receiver ii adds the
    groups holding its rows in order, a group's head partial where it starts at or
    after the receiver's first row, else its tail."""
    out = {}
    for ii in range(ti_eff):
        first = ii * rs
        out[ii] = [("head" if 8 * g >= first else "tail", g)
                   for g in range(first // 8, (first + jc_eff - 1) // 8 + 1)]
    return out


@pytest.mark.parametrize("jc", [1, 3, 5, 8, 9, 13, 20, 25, 30, 33, 64, 100, 128])
def test_tile_group_sums_follow_the_fp32_tail(jc):
    rs = max(jc, 8)
    for ti in range(1, mk.TILE_MAX_ROWS // rs + 1):
        for ti_eff in range(1, ti + 1):
            for jc_eff in sorted({1, jc // 2 or 1, jc - 1 or 1, jc}):
                tiles = -(-((ti_eff - 1) * rs + jc_eff) // 16)
                assert _tile_sums(ti_eff, jc_eff, rs, tiles) == _fp32_tail_sums(ti_eff, jc_eff, rs)


def _smem_by_hand(weights, biases, sel=0, work=0):
    """Floats of the layout: the resident copy (bf16 weights two a float, biases
    padded to 4), the layer table (4 ints a layer, 8 layers), the mbarrier (4),
    K5's neighbours and distances, the work region; in bytes."""
    return 4 * (weights + biases + 32 + 4 + 2 * sel + work)


def _warp_regions(warps, widest_input, agg=0):
    """Each warp's tile region: 16 rows x the widest layer input in bf16 (the A
    fragments), 256 running sums, and the receivers' aggregates where a receiver
    takes several chunks."""
    return warps * (16 * widest_input // 2 + 256 + agg)


@pytest.mark.parametrize("case", ["flagship", "fe128_256", "dense150", "knn20_k5", "knn20_k8"])
def test_resident_shared_memory_by_hand(case):
    """At the published widths the bf16 weights stay resident: fe [96, 160, 192] is
    96 x 160 + 160 x 192 bf16 = 23,040 floats and biases 160 + 192, its widest input
    160 (the 128 class: a hidden input of 96); --fe 128 256 is 128 x 256 bf16 =
    16,384 floats and a bias of 256 (the 64 class: no hidden layer)."""
    flagship = (96 * 160 + 160 * 192) // 2, 160 + 192
    if case == "flagship":
        plan = mk.bf16_tile_plan(256, 30, FE, SMS)
        want = _smem_by_hand(*flagship, work=_warp_regions(16, 160))
    elif case == "fe128_256":
        # 150p dense at B=512: 6 sender chunks of 25, aggregates of 5 receivers x 256
        plan = mk.bf16_tile_plan(512, 150, [128, 256], SMS)
        want = _smem_by_hand(128 * 256 // 2, 256, work=_warp_regions(16, 128, 5 * 256))
    elif case == "dense150":
        # 6 sender chunks of 25: aggregates of 5 receivers x 192, 13 warps' regions fit
        plan = mk.bf16_tile_plan(32, 150, FE, SMS)
        assert plan.warps == 13
        want = _smem_by_hand(*flagship, work=_warp_regions(13, 160, 5 * 192))
    elif case == "knn20_k5":
        # a CTA's 16 items of 12 receivers x 20 ranks searched at once; the search's
        # scratch (xf^T and the norms, 33 x 156, and the merge lists, 3 x 128 x 21)
        # fits in the warps' regions
        plan = kk.bf16_tile_plan(160, 150, 32, 20, FE, SMS)
        assert (plan.ti, plan.sspan_items, plan.warps) == (12, 16, 16)
        assert 33 * 156 + 3 * 128 * 21 < _warp_regions(16, 160)
        want = _smem_by_hand(*flagship, sel=16 * 12 * 20, work=_warp_regions(16, 160))
    else:
        plan = kk.bf16_tile_plan(160, 150, 0, 20, FE, SMS, False)
        want = _smem_by_hand(*flagship, work=_warp_regions(16, 160))
    assert plan.resident and plan.smem_bytes == want <= mk.MAX_SMEM_BYTES


@pytest.mark.parametrize("dims,resident", [([256, 256], True), ([64, 256, 256], True),
                                           ([256] * 3, False), ([250, 255, 256, 249, 200], False),
                                           ([256] * 9, False)])
def test_chains_at_kmaxwidth_take_column_chunks_or_the_packed_copy(dims, resident):
    """A chain at kMaxWidth takes its outputs 64 columns (8 n tiles) at a time and
    its last layer's A a k step at a time; where its bf16 weights fit in shared
    memory beside fewer warps' regions, it runs fewer warps; where they do not fit
    at all it reads them from the packed copy in device memory, on the 256 class."""
    plan = mk.bf16_tile_plan(4, 30, dims, SMS)
    assert plan.resident == resident
    assert plan.width == (mk.tile_class(dims) if resident else 256)
    assert 1 <= plan.warps <= mk.tile_warps(plan.width)
    assert plan.smem_bytes <= mk.MAX_SMEM_BYTES
    assert (mk.fwd_packed_floats_bf16(dims) * 4 <= plan.smem_bytes) == resident


def test_width_classes_and_warps():
    """The class holds the hidden layers' inputs (all but the last layer's)."""
    assert [mk.tile_class(d) for d in ([24, 16, 12], [64], [65], FE, [128, 256], [256],
                                       [129, 20, 30], [250, 255, 256, 249, 200])] == \
        [64, 64, 64, 128, 64, 64, 256, 256]
    assert [mk.tile_warps(w) for w in mk.TILE_CLASSES] == [16, 16, 12]
    with pytest.raises(ValueError):
        mk.tile_class([257])


# (batch, n, fe, fn): K4's bf16 launches: the flagship G's two layers in the bf16 D+G
# step (fn [224, 256, 256, 32] and [224, 256, 256, 3]) at B=256, the card tests' shapes
# (a 601-jet batch, odd widths, a wide chain of 64-row passes, no hidden layer) and a
# batch whose receivers end inside an fn tile
K4 = [(256, 30, FE, [224, 256, 256, 32]), (256, 30, FE, [224, 256, 256, 3]),
      (601, 30, FE, [224, 256, 256, 32]), (33, 13, [30, 50, 7], [13, 13, 3]),
      (2, 45, [64, 256, 224], [256, 256, 8]), (3, 5, [96], [112, 20]),
      (7, 30, FE, [224, 256, 256, 3])]


@pytest.mark.parametrize("batch,n,fe,fn", K4)
def test_k4_tile_rows_cover_every_pair_once_in_the_fp32_order(batch, n, fe, fn):
    """K4's first phase is K2's pass on K4's FP32 row order (its own plan's sender
    chunk and receivers a pass), so its float32 aggregates are that pass's."""
    plan = mk.bf16_tile_plan(batch, n, fe, SMS, fn)
    fp32 = mk.fwd_plan(batch, n, fe, SMS, fn)
    assert plan.jc == fp32.jc and plan.rs == fp32.rs
    assert plan.ti * plan.rs % 8 == 0 or plan.ti == fp32.ti
    assert plan.items == -(-batch * n // plan.ti) and plan.grid == min(SMS, plan.items)
    assert plan.warps % mk.FN_SLOT_WARPS == 0 and 1 <= plan.fn_slots <= plan.warps // 4
    _check_rows(plan, batch, n, fp32.ti)


@pytest.mark.parametrize("batch,n,fe,fn", K4)
def test_k4_fn_tiles_take_every_receiver_once(batch, n, fe, fn):
    """fn's tiles, walked as fn_phase walks them (CTA c's tiles c, c + grid, ... in
    rounds of fn_slots slots), hold every receiver once; a CTA takes at most one
    round more than another."""
    plan = mk.bf16_tile_plan(batch, n, fe, SMS, fn)
    total = batch * n
    tiles = -(-total // mk.FN_TILE_ROWS)
    seen, rounds = [], []
    for cta in range(plan.grid):
        count = (tiles - 1 - cta) // plan.grid + 1 if cta < tiles else 0
        rounds.append(-(-count // plan.fn_slots))
        for r in range(rounds[-1]):
            for slot in range(plan.fn_slots):
                i = r * plan.fn_slots + slot
                if i < count:
                    tile = cta + i * plan.grid
                    seen.extend(range(16 * tile, min(16 * tile + 16, total)))
    assert sorted(seen) == list(range(total))
    assert max(rounds) - min(rounds) <= 1


def test_k4_shared_memory_by_hand():
    """K4's flagship launch (fe [96, 160, 192], fn [224, 256, 256, 3], B=256): the
    first phase is K2's layout with a table of 16 layers (64 floats); the second
    holds the largest staged layer (256 x 256 bf16 fragments: 32,768 floats; the
    first layer's 224 rows of 256 bf16 are 28,672), a bias of 256, four slots of a
    tile's rows (224 x 16 floats) and one layer's A fragments (256 columns of 16 rows
    in bf16: 2,048 floats), and the mbarrier; the larger of the two, 217 KB, is the
    launch's."""
    plan = mk.bf16_tile_plan(256, 30, FE, SMS, [224, 256, 256, 3])
    flagship = (96 * 160 + 160 * 192) // 2, 160 + 192
    first = _smem_by_hand(*flagship, work=_warp_regions(16, 160)) + 4 * 32
    second = 4 * (256 * 256 // 2 + 256 + 4 * (224 * 16 + 16 * 256 // 2) + 4)
    assert (plan.resident, plan.warps, plan.fn_slots) == (True, 16, 4)
    assert first < second == plan.smem_bytes == 222_224 <= mk.MAX_SMEM_BYTES
    assert mk.fn_smem_bytes([224, 256, 256, 3], 4) == second
    # fn's packed copy after fe's: the first layer's rows at M padded to 64, the
    # later ones in fragments, then the biases
    fn_floats = 224 * 256 // 2 + 256 * 256 // 2 + 256 * 8 // 2 + 256 + 256 + 4
    assert mk.fwd_packed_floats_bf16(FE, [224, 256, 256, 3]) == sum(flagship) + fn_floats


@pytest.mark.parametrize("batch,n,fe,fn", K4)
def test_k4_takes_the_most_slots_that_fit(batch, n, fe, fn):
    """The plan runs the most warps (a multiple of 4) whose first phase fits, then
    the most fn slots whose second phase fits: one more slot does not."""
    plan = mk.bf16_tile_plan(batch, n, fe, SMS, fn)
    assert plan.smem_bytes <= mk.MAX_SMEM_BYTES
    if plan.fn_slots < plan.warps // 4:
        assert mk.fn_smem_bytes(fn, plan.fn_slots + 1) > mk.MAX_SMEM_BYTES


def test_k4_refuses_fn_widths_past_the_cap():
    """fn's layers share the kernels' width cap (kMaxWidth): a wider one is refused
    where the plan is made, as fill_chain refuses it in the launcher."""
    with pytest.raises(ValueError, match="exceed the kernel cap"):
        mk.bf16_tile_plan(4, 30, FE, SMS, [224, 300, 3])
