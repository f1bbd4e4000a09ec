// Dense message-passing edge aggregate for Hopper (sm_90a) in the bf16 mode: K2
// (eval and train) and K4 with bf16 inputs, weights and outputs.
//
// Replaces the Pallas TPU kernels of mpgan_tpu/ops/mp_pallas.py called with bf16
// refs, as StepConfig.bf16 calls them on every dense MPGAN step:
//   - K2: _fwd_kernel_jets / _fwd_kernel (edge_aggregate, mp_pallas.py:319), with K1
//     in train mode;
//   - K4: _fwd_kernel_jets_fn / _fwd_kernel_fn (edge_aggregate_fn).
// What they compute, and where they round (the plain versions in
// mp_kernels.py hold the same): a_0 = leaky(f32(u1) + f32(u2)) times K1's
// multiplier, in float32; each hidden layer z = bf16(a) @ W_bf16 with float32
// accumulation, + f32(b), LeakyReLU, K1; the last layer's activations unrounded,
// times f32(mask), summed over the senders in float32 (/ n for the mean); the
// output rounded to bf16 once. K4: fn's first layer on float32 operands (the
// unrounded aggregate and f32(x)) with the bf16 weights' float32 values, later
// layers on bf16-rounded inputs, the output rounded to bf16.
//
// K2 runs the bf16 forward pass written for this card (edge_fwd_bf16_tiles.cuh: the
// chain's bf16 weights resident in shared memory, a warp taking 16 pair rows through
// the whole chain with the activations chained in registers between the mma.sync
// products, no CTA barrier between them), planned by mp_kernels.bf16_tile_plan. K4
// still runs the FP32 kernel (edge_aggregate.cuh: the planner's pass, the persistent
// grid, the in-kernel packing before a grid-wide barrier, a_0's build, K1 and the
// fixed-order aggregate) instantiated for bf16 elements: the fe products (and fn's
// after its first) on the bf16 stage (edge_products_bf16.cuh: mma.sync m16n8k16, A
// rounded from the float32 activations in registers, B from a bf16 copy packed in
// fragment order), fn's first layer on the FP32 stage; fwd_pack_bf16 lays out the
// packed copy, the launcher checks that the scratch holds it.
//
// What bounds them on this card: at the flagship's widths the products are 85 MFLOP
// a 30-particle jet, 0.09 us of the dense bf16 tensor cores' 989 TFLOP/s. K2's pass
// leaves around them a_0's element loads, K1's hash and the last layer's shuffles
// (PERF.md: its phase clocks); K4's pass keeps the float32 a_0, the epilogues in
// shared memory and the slab barriers. Every sum has a fixed order: two launches on
// equal inputs are bit-identical.

#include "edge_aggregate.cuh"
#include "edge_fwd_bf16.cuh"
#include "edge_fwd_bf16_tiles.cuh"

extern "C" {

#ifdef MPGAN_PHASE_CLOCKS
// Clocks summed per phase (edge_products.cuh: Phase) since the last reset: K2's and K4's
// bf16 launches, which share this source's array.
int mpgan_edge_aggregate_bf16_phase_clocks(unsigned long long* out, int reset) {
  return read_phase_clocks(out, reset);
}
#endif

// Floats of the bf16 mode's packed scratch for a forward launch (K2 with n_fn =
// 0, else K4) at passes of `rows` pair rows; -1 on bad arguments. Only the card
// tests call it, to hold mp_kernels.fwd_packed_floats_bf16 to the launcher.
long long mpgan_edge_fwd_packed_floats_bf16(int n_hidden, const int* hidden_dims, int n_fn,
                                            const int* fn_dims, int rows) {
  Chain fe, fn{};
  const void* none[kMaxLayers] = {};
  if (!fill_chain(fe, n_hidden, none, none, hidden_dims)) return -1;
  if (n_fn > 0 && !fill_chain(fn, n_fn, none, none, fn_dims)) return -1;
  if (rows != 32 && rows != 64 && rows != 128) return -1;
  return fwd_pack_bf16(fe, fn, fe.n + fn.n, n_fn > 0 ? fe.n : -1, col_threads_of(rows)).total;
}

// Shared memory (bytes) of the bf16 forward pass's plan (edge_fwd_bf16_tiles.cuh:
// tile_layout) for the chain `dims` (n_hidden + 1 widths) over `senders` senders
// (dense n, knn k); `search` (K5) with jets of n particles of c features;
// `warps` a CTA; `resident`: the weights in shared memory; -1 where
// the launcher refuses the plan. Only the card tests call it, to hold
// mp_kernels.bf16_tile_smem_bytes to the launcher.
long long mpgan_bf16_tile_smem(int n_hidden, const int* dims, int senders, int n, int c, int k,
                               int search, int width, int warps, int resident, int ti,
                               int jc, int sspan_items) {
  Chain fe;
  const void* none[kMaxLayers] = {};
  if (!fill_chain(fe, n_hidden, none, none, dims)) return -1;
  TilePlan p{};
  p.width = width;
  p.warps = warps;
  p.resident = resident;
  p.ti = ti;
  p.jc = jc;
  p.sspan_items = sspan_items;
  return tile_layout(p, fe, senders, n, c, k, search != 0) ? p.smem : -1;
}

// K2 in the bf16 mode, eval (drop_on = 0) or train (K1 dropout: `seed` points to
// one int in device memory, keep threshold `thr`, multiplier `mult`). u1, u2, mask,
// the hidden weights and biases and out are bf16; `packed` holds `packed_floats`
// floats (mp_kernels.fwd_packed_floats_bf16). The plan (mp_kernels.bf16_tile_plan):
// the width class, the warps a CTA, whether the weights are resident, ti receivers an
// item, jc senders a chunk, grid CTAs. Returns a cudaError_t code.
int mpgan_edge_aggregate_bf16(const bf16* u1, const bf16* u2, const bf16* mask, bf16* out,
                              float* packed, long long packed_floats, int batch, int n, int h1,
                              int n_hidden, const void* const* hidden_w,
                              const void* const* hidden_b, const int* hidden_dims, float alpha,
                              int sum_agg, int drop_on, const int* seed, unsigned thr,
                              float mult, int width, int warps, int resident, int ti, int jc,
                              int grid, void* stream) {
  Chain fe;
  if (batch < 1 || n < 1 || h1 < 1 || !fill_chain(fe, n_hidden, hidden_w, hidden_b, hidden_dims) ||
      fe.dim[0] != h1 || (drop_on && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  // offsets into u1, u2 and out are ints
  if ((long long)batch * n * (h1 > fe.dim[fe.n] ? h1 : fe.dim[fe.n]) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (fwd_pack_bf16(fe, fe, fe.n, -1, 8).total > packed_floats) return (int)cudaErrorInvalidValue;
  TileArgs a{};
  a.u1 = u1;
  a.u2 = u2;
  a.mask = mask;
  a.out = out;
  a.packed = packed;
  a.seed = seed;
  a.batch = batch;
  a.n = n;
  a.h1 = h1;
  a.ns = round_up(n, 8);
  a.alpha = alpha;
  a.denom = sum_agg ? 1.f : (float)n;  // the mean divides by the true n
  a.drop_on = drop_on != 0;
  a.drop.thr = thr;
  a.drop.mult = mult;
  TilePlan p{};
  p.width = width;
  p.warps = warps;
  p.resident = resident;
  p.ti = ti;
  p.jc = jc;
  return launch_tiles<false>(a, fe, p, grid, stream);
}

// K4 in the bf16 mode; arguments as mpgan_edge_aggregate_fn's, bf16 tensors.
int mpgan_edge_aggregate_fn_bf16(const bf16* u1, const bf16* u2, const bf16* mask,
                                 const bf16* x, bf16* out, float* packed,
                                 long long packed_floats, int batch, int n, int h1, int feat,
                                 int n_hidden, const void* const* hidden_w,
                                 const void* const* hidden_b, const int* hidden_dims, int n_fn,
                                 const void* const* fn_w, const void* fn_w0_lo,
                                 const void* const* fn_b, const int* fn_dims, float alpha,
                                 int sum_agg, float fn_alpha, int fn_act_last, int ti, int jc,
                                 int rows, int span, int grid, int slab_floats, void* stream) {
  Chain fe, fn;
  if (!fill_chain(fe, n_hidden, hidden_w, hidden_b, hidden_dims) ||
      (rows != 32 && rows != 64 && rows != 128))
    return (int)cudaErrorInvalidValue;
  if (n_fn < 1 || !fill_chain(fn, n_fn, fn_w, fn_b, fn_dims)) return (int)cudaErrorInvalidValue;
  const int h_out = fe.dim[fe.n];
  if (feat < 1 || fn.dim[0] != h_out + feat) return (int)cudaErrorInvalidValue;
  fn.w0_lo = static_cast<const float*>(fn_w0_lo);
  fn.k0_split = h_out;
  fn.act_last = fn_act_last;
  if (fwd_pack_bf16(fe, fn, fe.n + fn.n, fe.n, col_threads_of(rows)).total > packed_floats)
    return (int)cudaErrorInvalidValue;
  return launch<true, bf16>(u1, u2, mask, x, out, packed, batch, n, h1, feat, fe, fn, alpha,
                            fn_alpha, sum_agg, 0, Drop{}, nullptr, ti, jc, rows, span, grid,
                            slab_floats, stream);
}

}  // extern "C"
