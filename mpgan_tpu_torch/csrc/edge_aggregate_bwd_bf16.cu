// Backward of the dense message-passing edge aggregate for Hopper (sm_90a) in the
// bf16 mode: K3 with bf16 inputs and weights, with and without weight gradients.
//
// Replaces K3 of mpgan_tpu/ops/mp_pallas.py (_bwd_kernel_jets / _bwd_kernel)
// called with bf16 refs, as StepConfig.bf16 calls it through edge_aggregate's
// custom VJP. What it computes, and where it rounds (the plain version in
// mp_kernels.py holds the same): the recompute is K2's in the bf16 mode (hidden
// products on bf16-rounded activations, float32 accumulation), g is taken as
// float32 (/ n for the mean), and the backward runs in float32: dW = a_{l-1}^T
// dz with the unrounded activation, da = dz @ f32(W). du1, du2 and dmask are
// summed in float32 and rounded to bf16 once; the weight gradients are summed in
// float32 and returned as float32, which the caller rounds to the weights'
// dtype (mp_pallas._edge_aggregate_bwd does the same). The TPU kernel's
// receiver mode adds each receiver block's du2 into its bf16 output; summing in
// float32 and rounding once differs from that by at most one rounding.
//
// The kernel is the FP32 one (edge_aggregate_bwd.cuh on edge_bwd_common.cuh:
// the planner's pass, the persistent grid, a_0's rebuild, K1 stored as -0.0f,
// the tile layout of dW and the fixed-order reductions) instantiated for bf16
// elements. Its recompute runs on the bf16 stage (edge_products_bf16.cuh,
// tensor cores), its da products and dW contractions on the split-TF32 stage
// (edge_bwd_tf32x3.cuh, tensor cores: a float32 operand split in registers into
// two TF32 parts, about 2^-21 of each product, float32 sums). A launch of its
// own first packs the weights: the recompute's in the bf16 fragment order, W^T
// for da in the TF32 fragment order (the float32 values of the bf16 weights,
// exact in TF32), the biases as float32.
//
// What bounds it on this card: the backward's two products per layer (dW and
// da, 2 x 85 MFLOP a 30-particle jet at the flagship's widths) at a third of the
// dense TF32 tensor-core rate (495 TFLOP/s, three products a split product),
// plus the recompute's 85 MFLOP at the bf16 rate: 0.28 ms at B=256 N=30. Around
// the products the pass keeps the FP32 kernel's float32 a_0 build, K1's hash on
// every activation, the epilogues in shared memory and the slab barriers, and
// adds the splits (PERF.md: the phase shares). Every sum has a fixed order: two
// launches on equal inputs are bit-identical.

#include "edge_aggregate_bwd.cuh"
#include "edge_bwd_bf16.cuh"

extern "C" {

#ifdef MPGAN_PHASE_CLOCKS
// Clocks summed per phase (edge_bwd_common.cuh: Phase) since the last reset.
int mpgan_edge_aggregate_bwd_bf16_phase_clocks(unsigned long long* out, int reset) {
  return read_phase_clocks(out, reset);
}
#endif

// Floats of the bf16 mode's packed scratch for a backward launch at passes of
// `rows` pair rows (which do not change it); -1 on bad arguments. Only the card tests call it, to hold
// mp_kernels.bwd_packed_floats_bf16 to the launcher.
long long mpgan_edge_bwd_packed_floats_bf16(int n_hidden, const int* hidden_dims, int rows) {
  Chain fe;
  const void* none[kMaxLayers] = {};
  if (!fill_chain(fe, n_hidden, none, none, hidden_dims)) return -1;
  if (rows != 32 && rows != 64 && rows != 128) return -1;
  return bwd_pack_bf16(fe).total;
}

// K3 in the bf16 mode. Arguments as mpgan_edge_aggregate_bwd's, with bf16 u1,
// u2, mask, g, hidden weights and biases, du2 and dmask; du1 is float32 scratch
// [batch, n, h1] (the caller rounds it), wgrads float32; `packed` holds
// `packed_floats` floats.
int mpgan_edge_aggregate_bwd_bf16(const bf16* u1, const bf16* u2, const bf16* mask,
                                  const bf16* g, float* du1, bf16* du2, bf16* dmask,
                                  float* wgrads, float* sender_part, float* w_part, int batch,
                                  int n, int h1, int n_hidden, const void* const* hidden_w,
                                  float* packed, long long packed_floats,
                                  const void* const* hidden_b, const int* hidden_dims,
                                  float alpha, int sum_agg, int dropout, const int* seed,
                                  unsigned thr, float mult, int need_wgrads, int ti, int jc,
                                  int rows, int grid, int slots, void* stream) {
  return launch_bwd<bf16>(u1, u2, mask, g, du1, du2, dmask, wgrads, sender_part, w_part, batch,
                          n, h1, n_hidden, hidden_w, packed, packed_floats, hidden_b,
                          hidden_dims, alpha, sum_agg, dropout, seed, thr, mult, need_wgrads, ti,
                          jc, rows, grid, slots, stream);
}

}  // extern "C"
