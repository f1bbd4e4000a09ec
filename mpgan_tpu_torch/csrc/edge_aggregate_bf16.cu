// Dense message-passing edge aggregate for Hopper (sm_90a) in the bf16 mode: K2
// (eval and train) and K4 with bf16 inputs, weights and outputs.
//
// Replaces the Pallas TPU kernels of mpgan_tpu/ops/mp_pallas.py called with bf16
// refs, as StepConfig.bf16 calls them on every dense MPGAN step:
//   - K2: _fwd_kernel_jets / _fwd_kernel (edge_aggregate), with K1 in train mode;
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
// The kernel is the FP32 one (edge_aggregate.cuh: the planner's pass, the
// persistent grid, the in-kernel packing before a grid-wide barrier, a_0's
// build, K1 and the fixed-order aggregate) instantiated for bf16 elements: the
// fe products (and fn's after its first) run on the bf16 stage
// (edge_products_bf16.cuh: mma.sync m16n8k16 on tensor cores, A rounded from the
// float32 activations in registers, B from a bf16 copy packed in fragment
// order), fn's first layer on the FP32 stage. The CTAs pack that copy and every
// bias (as float32) into the caller's scratch: fwd_pack_bf16 lays it out, the
// launcher checks that the scratch holds it.
//
// What bounds it on this card: at the flagship's widths the products are 85 MFLOP
// a 30-particle jet, 0.09 us of the dense bf16 tensor cores' 989 TFLOP/s; the
// pass around them (float32 a_0, K1's hash, the epilogues in shared memory, slab
// barriers) is what remains, and is what a later design would cut (wgmma, bf16
// activations). Every sum has a fixed order: two launches on equal inputs are
// bit-identical.

#include "edge_aggregate.cuh"
#include "edge_fwd_bf16.cuh"

extern "C" {

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

// K2 in the bf16 mode, eval (drop_on = 0) or train (K1 dropout: `seed` points to
// one int in device memory, keep threshold `thr`, multiplier `mult`). Arguments
// as mpgan_edge_aggregate's; u1, u2, mask, the hidden weights and biases and out
// are bf16; `packed` holds `packed_floats` floats. Returns a cudaError_t code.
int mpgan_edge_aggregate_bf16(const bf16* u1, const bf16* u2, const bf16* mask, bf16* out,
                              float* packed, long long packed_floats, int batch, int n, int h1,
                              int n_hidden, const void* const* hidden_w,
                              const void* const* hidden_b, const int* hidden_dims, float alpha,
                              int sum_agg, int drop_on, const int* seed, unsigned thr,
                              float mult, int ti, int jc, int rows, int grid, int slab_floats,
                              void* stream) {
  Chain fe, fn{};
  if (!fill_chain(fe, n_hidden, hidden_w, hidden_b, hidden_dims) ||
      (drop_on && seed == nullptr) || (rows != 32 && rows != 64 && rows != 128))
    return (int)cudaErrorInvalidValue;
  if (fwd_pack_bf16(fe, fn, fe.n, -1, col_threads_of(rows)).total > packed_floats)
    return (int)cudaErrorInvalidValue;
  Drop drop{};
  drop.thr = thr;
  drop.mult = mult;
  return launch<false, bf16>(u1, u2, mask, nullptr, out, packed, batch, n, h1, 0, fe, fn, alpha,
                             0.f, sum_agg, drop_on, drop, seed, ti, jc, rows, ti, grid,
                             slab_floats, stream);
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
