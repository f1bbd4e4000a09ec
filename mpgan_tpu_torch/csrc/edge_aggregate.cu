// Dense message-passing edge aggregate for Hopper (sm_90a), FP32 on CUDA cores.
//
// Replaces the Pallas TPU kernels of mpgan_tpu/ops/mp_pallas.py:
//   - K2 forward: edge_aggregate (_fwd_kernel_jets / _fwd_kernel), with K1, the
//     in-kernel dropout hash (_dropmul), in train mode,
//   - K4: edge_aggregate_fn (_fwd_kernel_jets_fn / _fwd_kernel_fn / _fn_tail).
// The backward, K3, is edge_aggregate_bwd.cu.
//
// For every jet b and receiver i
//   agg[b, i] = sum_j mask[b, j] * chain(leaky(u1[b, i] + u2[b, j]))    (/ n for mean)
// where `chain` is the fe MLP's hidden layers (LeakyReLU after each). The fe first
// layer arrives decomposed: u1 = x @ W1_recv and u2 = x @ W1_send + b1 are computed
// by the caller. K4 then runs the node MLP fn on [agg | x], its first layer read as
// two row segments (W1_top for agg, W1_bot for x) so the concat never leaves
// shared memory.
//
// What bounds it: the N^2 edge chain is ~166 MFLOP per 30-particle jet and
// ~4.1 GFLOP per 150-particle jet at the flagship widths, against ~1 KB of input
// per particle, so the kernel is bound by FP32 FMA issue. The design:
//   - the pass is edge_fwd_common.cuh's fwd_pass, which the knn forward (K5, K8)
//     runs too, on edge_products.cuh's products, the backward's own: this file
//     adds the dense rows (receiver x sender) and K4's node MLP. A pass is ti
//     receivers x jc senders in a buffer of 32, 64 or 128 pair rows
//     (5 x 25 = 125 at N = 150, 4 x 30 = 120 at N = 30), all 512 threads hold full
//     8 x TN register tiles of every product, and the weights come in k-slabs
//     through shared memory, 128-bit cp.async copies of a packed copy, the next
//     product's first slab in flight during the current product's last;
//   - the packed copy is made by the kernel itself: its CTAs pack the fe (and
//     K4's fn) weights into the caller's scratch, a share each, then meet at a
//     grid-wide barrier (a cooperative launch: at most one CTA an SM, all
//     resident), so no launch of its own and no cache keyed on the weights;
//   - a product writes its output over its input (the barrier before its
//     epilogue allows it), so a pass keeps one buffer as wide as the widest of
//     a_0 .. a_{L-1}; the last layer's activation is never stored: its epilogue
//     multiplies by mask[j] and sums each receiver's rows (a thread's 8 rows meet
//     at most two receivers: a receiver takes rs = max(jc, 8) rows) into partials
//     in the pass buffer it has just read, and one ordered add a (receiver,
//     column) makes the pass's share of the aggregate. No a_L buffer, no sweep
//     over it;
//   - the grid is persistent, a CTA an SM, each walking a contiguous range of
//     items. An item is `span` consecutive receivers of the batch's flat
//     receiver list (b * n + i), taken ti at a time, each over the senders of its
//     own jet in chunks of jc; a block may hold two jets' receivers, so none is
//     cut short at a jet's end. K2: span = ti. K4: span is a multiple of ti of at
//     most `rows` receivers (104 at N = 30 on 132 SMs, for the balance of the
//     grid's last round), whose aggregates are kept transposed in shared memory;
//     fn then runs on the item's [agg | x]
//     rows at once (TN = 8 for its 256-wide layers on 128 rows), each layer in
//     place (fn is row-wise, so an item needs no whole jets);
//   - train mode multiplies each activation by K1's multiplier after layer 1's
//     LeakyReLU (salt 0) and after hidden layer k (salt k), keyed on the global
//     pair id (b * n + i) * ns + j, ns = ceil(n / 8) * 8, so K3 replays the same
//     masks; a dropped element is stored as -0.0f;
//   - every sum has a fixed order (no atomics), so two launches on equal inputs
//     are bit-identical;
//   - no tensor cores and no TF32, so results hold FP32 parity with the plain
//     version.
// The pass shape, the weight slabs' size, the items and the grid are planned by
// the caller (mp_kernels.fwd_plan, CPU-tested); the launcher checks them and lays
// out the shared memory.

#include "edge_aggregate.cuh"

extern "C" {

// Sizes of a forward launch (K2 with n_fn = 0, else K4) at passes of `rows` pair
// rows and `ti` receivers with weight slabs of `slab_floats`: sizes[0] the shared
// memory (bytes), sizes[1] the packed weights' scratch (floats). Returns -1 where
// the kernel does not run the shape. Only the card tests call it, to hold
// mp_kernels.fwd_smem_bytes and fwd_packed_floats to the launcher's layout.
int mpgan_edge_fwd_sizes(int n_hidden, const int* hidden_dims, int n_fn, const int* fn_dims,
                         int rows, int ti, int slab_floats, long long* sizes) {
  Chain fe, fn;
  const void* none[kMaxLayers] = {};
  if (!fill_chain(fe, n_hidden, none, none, hidden_dims)) return -1;
  if (n_fn > 0 && !fill_chain(fn, n_fn, none, none, fn_dims)) return -1;
  FwdPlan p{};
  p.rows = rows;
  p.ti = ti;
  p.jc = 1;
  p.row_arrays = 4;
  p.slab_floats = slab_floats;
  if (!fwd_layout(p, fe, n_fn > 0 ? &fn : nullptr)) return -1;
  sizes[0] = (long long)p.smem;
  sizes[1] = p.pk_off[fe.n + (n_fn > 0 ? fn.n : 0)];
  return 0;
}

#ifdef MPGAN_PHASE_CLOCKS
// Clocks summed per phase (edge_products.cuh: Phase) since the last reset.
int mpgan_edge_aggregate_phase_clocks(unsigned long long* out, int reset) {
  return read_phase_clocks(out, reset);
}
#endif

// K2 forward. hidden_dims has n_hidden + 1 entries, hidden_dims[0] == h1. The pass
// (ti receivers x jc senders in buffers of `rows`), the grid and the weight slabs'
// size are the caller's plan; `packed` is scratch for the packed weights
// (mp_kernels.fwd_packed_floats). Returns a
// cudaError_t code (0 on success); the launch is asynchronous on `stream`.
int mpgan_edge_aggregate(const float* u1, const float* u2, const float* mask, float* out,
                         float* packed, int batch, int n, int h1, int n_hidden,
                         const void* const* hidden_w,
                         const void* const* hidden_b, const int* hidden_dims, float alpha,
                         int sum_agg, int ti, int jc, int rows, int grid, int slab_floats,
                         void* stream) {
  Chain fe, fn{};
  if (!fill_chain(fe, n_hidden, hidden_w, hidden_b, hidden_dims))
    return (int)cudaErrorInvalidValue;
  return launch<false, float>(u1, u2, mask, nullptr, out, packed, batch, n, h1, 0, fe, fn, alpha,
                              0.f, sum_agg, 0, Drop{}, nullptr, ti, jc, rows, ti, grid,
                              slab_floats, stream);
}

// K2 forward in train mode, with K1 dropout: `seed` points to one int in device
// memory, in [0, 2^31); keep threshold `thr` and multiplier `mult` as computed on
// the host (see Drop).
int mpgan_edge_aggregate_train(const float* u1, const float* u2, const float* mask, float* out,
                               float* packed, int batch, int n, int h1, int n_hidden,
                               const void* const* hidden_w, const void* const* hidden_b,
                               const int* hidden_dims, float alpha, int sum_agg,
                               const int* seed, unsigned thr, float mult, int ti, int jc,
                               int rows, int grid, int slab_floats, void* stream) {
  Chain fe, fn{};
  if (!fill_chain(fe, n_hidden, hidden_w, hidden_b, hidden_dims) || seed == nullptr)
    return (int)cudaErrorInvalidValue;
  Drop drop{};
  drop.thr = thr;
  drop.mult = mult;
  return launch<false, float>(u1, u2, mask, nullptr, out, packed, batch, n, h1, 0, fe, fn, alpha,
                              0.f, sum_agg, 1, drop, seed, ti, jc, rows, ti, grid, slab_floats,
                              stream);
}

// K4. fn_w[0] is fn's first-layer weight rows for agg ([h_out, dims[1]]), fn_w0_lo its rows
// for x ([feat, dims[1]]); fn_dims has n_fn + 1 entries, fn_dims[0] == h_out + feat. An
// item is `span` consecutive receivers (a multiple of ti, at most rows).
int mpgan_edge_aggregate_fn(const float* u1, const float* u2, const float* mask, const float* x,
                            float* out, float* packed, int batch, int n, int h1, int feat,
                            int n_hidden,
                            const void* const* hidden_w, const void* const* hidden_b,
                            const int* hidden_dims, int n_fn, const void* const* fn_w,
                            const void* fn_w0_lo, const void* const* fn_b, const int* fn_dims,
                            float alpha, int sum_agg, float fn_alpha, int fn_act_last, int ti,
                            int jc, int rows, int span, int grid, int slab_floats,
                            void* stream) {
  Chain fe, fn;
  if (!fill_chain(fe, n_hidden, hidden_w, hidden_b, hidden_dims))
    return (int)cudaErrorInvalidValue;
  if (n_fn < 1 || !fill_chain(fn, n_fn, fn_w, fn_b, fn_dims)) return (int)cudaErrorInvalidValue;
  const int h_out = fe.dim[fe.n];
  if (feat < 1 || fn.dim[0] != h_out + feat) return (int)cudaErrorInvalidValue;
  fn.w0_lo = static_cast<const float*>(fn_w0_lo);
  fn.k0_split = h_out;
  fn.act_last = fn_act_last;
  return launch<true, float>(u1, u2, mask, x, out, packed, batch, n, h1, feat, fe, fn, alpha,
                             fn_alpha, sum_agg, 0, Drop{}, nullptr, ti, jc, rows, span, grid,
                             slab_floats, stream);
}

const char* mpgan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
