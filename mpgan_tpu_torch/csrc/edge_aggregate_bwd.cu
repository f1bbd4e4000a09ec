// Backward of the dense message-passing edge aggregate for Hopper (sm_90a), FP32
// on CUDA cores.
//
// Replaces K3 of mpgan_tpu/ops/mp_pallas.py: _edge_aggregate_bwd_impl
// (_bwd_kernel_jets / _bwd_kernel), with the in-kernel dropout of K1 (_dropmul)
// replayed. Given the forward's inputs (u1, u2, mask, the hidden layers, the
// dropout seed) and g = dL/dagg, it returns
//   du1[b, i] = sum_j dz1[b, i, j],   du2[b, j] = sum_i dz1[b, i, j],
//   dmask[b, j] = sum_i sum_h g[b, i, h] * a_last[b, i, j, h],
//   dW_l = sum over pairs of a_{l-1}^T dz_l,   db_l = sum over pairs of dz_l,
// where g is divided by n for the mean, da_last = g[i] * mask[j], and per layer
// (last to first) dz = da * mult * dleaky(z), da_prev = dz W^T.
//
// What bounds it: per pair row it does three times the forward's FMAs (the
// recompute, dW and da), so it is bound by FP32 FMA issue and shared-memory
// operand loads. The recompute-and-backprop pass, its shared-memory plan, the
// products and the contractions are edge_bwd_common.cuh's (shared with K6, the
// knn backward); this file adds what is dense:
//   - an item of the persistent grid's schedule is a block of ti receivers of one
//     jet; the CTA walks the jet's senders in chunks of jc (a pass is ti x jc
//     pair rows: 4 x 30 = 120 of 128 at N = 30, 5 x 25 = 125 at N = 150);
//   - du1 rows belong to one item and are accumulated in place over its chunks;
//   - du2 and dmask sum over the receivers, so over the items of a jet: each CTA
//     that touches a jet owns one slab [n, h1 + 1] (column h1: dmask) of that
//     jet's `slots`; its first item of the jet writes the slab (every item covers
//     every sender), later items add, each address always by the same thread. A
//     second kernel sums a jet's slabs in slot order;
//   - the weight gradients go to one partial slab a CTA, reduced over the CTAs
//     in order. With need_wgrads = 0 (the G step differentiating through D) the
//     contractions are skipped and the caller's zero gradients stay zero.
// Every sum has a fixed order, so repeated launches agree bit for bit.

#include "edge_aggregate_bwd.cuh"

extern "C" {

// Floats of the packed-weight scratch that the backward kernels (K3 and K6) need
// for a chain of these widths at passes of `rows` pair rows; -1 on bad arguments.
long long mpgan_edge_bwd_packed_floats(int n_hidden, const int* hidden_dims, int rows) {
  Chain fe;
  const void* none[kMaxLayers] = {};
  if (!fill_chain(fe, n_hidden, none, none, hidden_dims)) return -1;
  if (rows != 32 && rows != 64 && rows != 128) return -1;
  PackJobs jobs;
  return plan_pack(jobs, fe, 8 * (kWarps / (rows / 32)));
}

// Floats of one CTA's weight-gradient slab (dW tile-major, db, `n_extra` more).
int mpgan_edge_bwd_wslab_floats(int n_hidden, const int* hidden_dims, int n_extra) {
  Chain fe;
  const void* none[kMaxLayers] = {};
  if (!fill_chain(fe, n_hidden, none, none, hidden_dims) || n_extra < 0) return -1;
  return make_wslab(fe, n_extra).slab_floats;
}

#ifdef MPGAN_PHASE_CLOCKS
// Clocks summed per phase (edge_bwd_common.cuh: Phase) since the last reset.
int mpgan_edge_aggregate_bwd_phase_clocks(unsigned long long* out, int reset) {
  return read_phase_clocks(out, reset);
}
#endif

// K3. hidden_w / hidden_b: per hidden layer W [in, out] and b. packed: scratch for
// the packed weights (mpgan_edge_bwd_packed_floats floats).
// wgrads: the weight gradients, flat [sum_l (in_l * out_l + out_l)] in layer order
// (dW_l then db_l), left untouched without need_wgrads. The pass shape (ti x jc
// pair rows in buffers of `rows`), the grid and the slots per jet are the
// caller's plan. Partials: sender_part [batch, slots, n, h1 + 1]; w_part [grid,
// mpgan_edge_bwd_wslab_floats] (unused without need_wgrads).
int mpgan_edge_aggregate_bwd(const float* u1, const float* u2, const float* mask, const float* g,
                             float* du1, float* du2, float* dmask, float* wgrads,
                             float* sender_part, float* w_part, int batch, int n, int h1,
                             int n_hidden, const void* const* hidden_w,
                             float* packed, const void* const* hidden_b,
                             const int* hidden_dims, float alpha, int sum_agg, int dropout,
                             const int* seed, unsigned thr, float mult, int need_wgrads,
                             int ti, int jc,
                             int rows, int grid, int slots, void* stream) {
  return launch_bwd<float>(u1, u2, mask, g, du1, du2, dmask, wgrads, sender_part, w_part, batch,
                           n, h1, n_hidden, hidden_w, packed, 0, hidden_b, hidden_dims, alpha,
                           sum_agg, dropout, seed, thr, mult, need_wgrads, ti, jc, rows, grid,
                           slots, stream);
}

}  // extern "C"
