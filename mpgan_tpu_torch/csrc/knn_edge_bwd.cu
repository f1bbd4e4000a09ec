// Backward of the fused knn message-passing edge stage for Hopper (sm_90a), FP32
// on CUDA cores.
//
// Replaces K6 of mpgan_tpu/ops/knn_pallas.py: _bwd_impl_v3 (_bwd_kernel_v3), with
// the in-kernel dropout of K1 (mp_pallas._dropmul) replayed. Given the forward's
// operands (u1, u2m = [u2 | mask], the hidden layers, w_d, the dropout seed), its
// residuals idx [B, N, k] (and dists) and g = dL/dagg, it returns
//   du1[b, i]        = sum_s dz1[b, i, s],
//   du2[b, j]        = sum over the edges (i, s) with idx[b, i, s] = j of dz1[b, i, s],
//   dmask[b, j]      = the same sum of sum_h g[b, i, h] * a_last[b, i, s, h],
//   ddists[b, i, s]  = sum_h dz1[b, i, s, h] * w_d[h],   dw_d = sum of dist * dz1,
//   dW_l = sum over edges of a_{l-1}^T dz_l,   db_l = sum over edges of dz_l,
// where g is divided by k for the mean, da_last = g[i] * mask[idx[i, s]], and per
// layer (last to first) dz = da * mult * dleaky(z), da_prev = dz W^T.
//
// What bounds it: per edge row it does three times the forward chain's FMAs (the
// recompute, dW and da), so it is bound by FP32 FMA issue and shared-memory
// operand loads. The recompute-and-backprop pass, its shared-memory plan, the
// products and the contractions are edge_bwd_common.cuh's (shared with K3, the
// dense backward); layer 1's dist * w_d term is rounded there as the plain
// version rounds it. This file adds what is knn:
//   - an item of the persistent grid's schedule is a block of ti receivers of one
//     jet; a pass is ti receivers x kc neighbour ranks (6 x 20 = 120 edge rows of
//     128 at k = 20), its rows' senders gathered from idx;
//   - du1 and ddists rows belong to one item and are written in place;
//   - the scatter into the senders is deterministic. Each CTA that touches a jet
//     owns one slab [n, h1 + 1] (column h1: dmask) of that jet's `slots` and
//     zeroes it itself on its first item of the jet, so the caller fills nothing.
//     A pass's rows that share a sender are first summed in shared memory: a warp
//     per row finds the first row with its sender by ballots, thread
//     h + (h1 + 1) * (first mod Q), Q = 512 / (h1 + 1), owns column h of that
//     row's staging line and adds the later rows to it in row order, so the
//     whole CTA works and each staged sum has one fixed order. Then one bulk
//     reduction (cp.reduce.async.bulk) a sender adds its line to the slab:
//     within a pass no two adds meet at one address in device memory, and a
//     pass's reductions are complete before the next pass issues its own, so a
//     slab is the same sum, bit for bit, on every run. This is the path at the
//     published widths. Only where the plan finds no room for the staging buffer
//     (off_stage < 0: wide chains) the owner thread of (h, j mod Q) walks the
//     pass's rows in order and adds those of its senders to the slab with
//     fire-and-forget atomicAdds, which from one thread to one address land in
//     program order. A second kernel sums a jet's slabs in slot order;
//   - the weight gradients (and dw_d) go to one partial slab a CTA, reduced over
//     the CTAs in order. With need_wgrads = 0 (the G step differentiating through
//     D) the contractions are skipped and the caller's zero gradients stay zero.

#include "knn_edge_bwd.cuh"

extern "C" {

#ifdef MPGAN_PHASE_CLOCKS
// Clocks summed per phase (edge_bwd_common.cuh: Phase) since the last reset.
int mpgan_knn_edge_aggregate_bwd_phase_clocks(unsigned long long* out, int reset) {
  return read_phase_clocks(out, reset);
}
#endif

// K6. idx int32 [batch, n, k]; dists [batch, n, k] and w_d [h1], or both null
// (then ddists is not touched). hidden_w / hidden_b: per hidden layer W [in, out]
// and b; packed: scratch for the packed weights (mpgan_edge_bwd_packed_floats
// floats). wgrads: the weight gradients, flat [sum_l (in_l *
// out_l + out_l) (+ h1 with dists: dw_d, last)] in layer order (dW_l then db_l),
// left untouched without need_wgrads. The pass shape (ti receivers x kc ranks in
// buffers of `rows`), the grid and the slots per jet are the caller's plan.
// Partials: sender_part [batch, slots, n, h1 + 1] (not initialised by the
// caller); w_part [grid, mpgan_edge_bwd_wslab_floats] (unused without need_wgrads).
int mpgan_knn_edge_aggregate_bwd(const float* u1, const float* u2m, const int* idx,
                                 const float* dists, const float* w_d, const float* g,
                                 float* du1, float* du2, float* dmask, float* ddists,
                                 float* wgrads, float* sender_part, float* w_part, int batch,
                                 int n, int h1, int k, int n_hidden,
                                 const void* const* hidden_w, float* packed,
                                 const void* const* hidden_b, const int* hidden_dims,
                                 float alpha, int sum_agg, int dropout, const int* seed,
                                 unsigned thr,
                                 float mult, int need_wgrads, int ti, int kc, int rows, int grid,
                                 int slots, void* stream) {
  return launch_knn_bwd<float>(u1, u2m, idx, dists, w_d, g, du1, du2, dmask, ddists, wgrads,
                               sender_part, w_part, batch, n, h1, k, n_hidden, hidden_w, packed,
                               0, hidden_b, hidden_dims, alpha, sum_agg, dropout, seed, thr, mult,
                               need_wgrads, ti, kc, rows, grid, slots, stream);
}

}  // extern "C"
