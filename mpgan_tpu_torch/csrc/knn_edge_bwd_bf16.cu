// Backward of the knn message-passing edge stage for Hopper (sm_90a) in the bf16
// mode: K6 with bf16 inputs and weights, with and without weight gradients.
//
// Replaces K6 of mpgan_tpu/ops/knn_pallas.py (_bwd_impl_v3, _bwd_kernel_v3, and
// the older generations' backwards) called with bf16 refs, as StepConfig.bf16
// calls it through knn_fused_layer's and knn_edge_aggregate_v3's custom VJPs.
// What it computes, and where it rounds (the plain version in knn_kernels.py
// holds the same):
//   - the recompute is K5's in the bf16 mode (knn_pallas.py:1310-1320): float32
//     z1 from u1, the gathered u2m rows and dist * f32(w_d), hidden products on
//     bf16-rounded activations with float32 accumulation;
//   - g is taken as float32 (/ k for the mean), and the backward runs in float32:
//     dW = a_{l-1}^T dz with the unrounded activation, da = dz @ f32(W) (:1347,
//     :1358-1362);
//   - du1, du2 and dmask are summed in float32 and rounded to bf16 once; ddists
//     stays float32 (the distances' dtype); the weight gradients and dw_d are
//     summed in float32 and returned as float32, which the caller rounds to the
//     weights' dtype (:1591-1600, :2057-2085).
//
// The kernel is the FP32 one (knn_edge_bwd.cuh on edge_bwd_common.cuh: the
// planner's pass, the persistent grid, a_0's rebuild with layer 1's rounding,
// K1 stored as -0.0f, the tile layout of dW, the deterministic sender scatter
// through staged bulk reductions and the fixed-order reductions) instantiated
// for bf16 elements. Its recompute runs on the bf16 stage (edge_products_bf16.cuh,
// tensor cores), its da products and dW contractions on the split-TF32 stage
// (edge_bwd_tf32x3.cuh, tensor cores: a float32 operand split in registers into
// two TF32 parts, about 2^-21 of each product, float32 sums). A launch of its
// own first packs the weights (edge_bwd_bf16.cuh, K3's packer): the
// recompute's in the bf16 fragment order, W^T for da in the TF32 fragment order
// (the float32 values of the bf16 weights, exact in TF32), the biases as
// float32.
//
// What bounds it on this card: the backward's two products per layer (dW and
// da, 2 x 277 MFLOP a 150-particle jet at the knn-20 widths) at a third of the
// dense TF32 tensor-core rate (495 TFLOP/s, three products a split product),
// plus the recompute's 277 MFLOP at the bf16 rate: 0.58 ms at B=160. Around the
// products the pass keeps the FP32 kernel's float32 a_0 build, K1's hash, the
// epilogues in shared memory, the slab barriers and the sender scatter, and
// adds the splits (PERF.md: the phase shares). Every sum has a fixed order: two
// launches on equal inputs are bit-identical.

#include "edge_bwd_bf16.cuh"
#include "knn_edge_bwd.cuh"

extern "C" {

#ifdef MPGAN_PHASE_CLOCKS
// Clocks summed per phase (edge_bwd_common.cuh: Phase) since the last reset.
int mpgan_knn_edge_aggregate_bwd_bf16_phase_clocks(unsigned long long* out, int reset) {
  return read_phase_clocks(out, reset);
}
#endif

// K6 in the bf16 mode. Arguments as mpgan_knn_edge_aggregate_bwd's, with bf16 u1,
// u2m, w_d, g, hidden weights and biases, du2 and dmask; idx int32, dists and
// ddists float32; du1 is float32 scratch [batch, n, h1] (the caller rounds it),
// wgrads float32; `packed` holds `packed_floats` floats
// (mp_kernels.bwd_packed_floats_bf16).
int mpgan_knn_edge_aggregate_bwd_bf16(const bf16* u1, const bf16* u2m, const int* idx,
                                      const float* dists, const bf16* w_d, const bf16* g,
                                      float* du1, bf16* du2, bf16* dmask, float* ddists,
                                      float* wgrads, float* sender_part, float* w_part,
                                      int batch, int n, int h1, int k, int n_hidden,
                                      const void* const* hidden_w, float* packed,
                                      long long packed_floats, const void* const* hidden_b,
                                      const int* hidden_dims, float alpha, int sum_agg,
                                      int dropout, const int* seed, unsigned thr, float mult,
                                      int need_wgrads, int ti, int kc, int rows, int grid,
                                      int slots, void* stream) {
  return launch_knn_bwd<bf16>(u1, u2m, idx, dists, w_d, g, du1, du2, dmask, ddists, wgrads,
                              sender_part, w_part, batch, n, h1, k, n_hidden, hidden_w, packed,
                              packed_floats, hidden_b, hidden_dims, alpha, sum_agg, dropout,
                              seed, thr, mult, need_wgrads, ti, kc, rows, grid, slots, stream);
}

}  // extern "C"
