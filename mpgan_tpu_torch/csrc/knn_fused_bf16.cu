// The knn message-passing edge forward for Hopper (sm_90a) in the bf16 mode: K5
// (search + gather + fe chain + masked sum) and K8 (the same from a given idx)
// with bf16 inputs, weights and outputs.
//
// Replaces the Pallas TPU kernels of mpgan_tpu/ops/knn_pallas.py called with bf16
// refs, as StepConfig.bf16 calls them on every knn MPGAN step:
//   - K5: _fused_impl_v4 (_fused_kernel_v4), with K1 in train mode;
//   - K8: _fwd_impl_v3 (_fwd_kernel_v3) and the older generations' forwards.
// What they compute, and where they round (the plain versions in knn_kernels.py
// hold the same):
//   - the search on the float32 values of xs and xf (knn_pallas.py:1763-1764),
//     the keys and idx as in the FP32 mode, the distances float32;
//   - z1 = f32(u1) + f32(u2m[idx, :h1]) (+ dist * f32(w_d)), a_0 = leaky(z1) times
//     K1's multiplier, in float32 (:1886-1891);
//   - each hidden layer z = bf16(a) @ W_bf16 with float32 accumulation, + f32(b),
//     LeakyReLU, K1 (_chain_ids -> mp_pallas._split_mlp_chain);
//   - the last layer's activations unrounded, times f32(mask), summed over the k
//     neighbours in float32 (/ k for the mean), rounded to bf16 once (:2004).
// idx is int32 and dists float32, as in the FP32 mode.
//
// The kernel is the FP32 one (knn_stages.cuh: the planner's pass, the persistent
// grid, the search once a (CTA, jet), a_0's build with layer 1's rounding, K1 and
// the fixed-order aggregate) instantiated for bf16 elements: the search widens
// xs and xf as it stages them, the fe products run on the bf16 stage
// (edge_products_bf16.cuh: mma.sync m16n8k16 on tensor cores, A rounded from the
// float32 activations in registers, B from a bf16 copy packed in fragment order),
// and the CTAs pack that copy and every bias as float32 before the grid-wide
// barrier (edge_fwd_bf16.cuh, the dense bf16 forward's packer).
//
// What bounds it on this card: at the published knn-20 widths the hidden
// products are 2 x 20 x (96 x 160 + 160 x 192) = 1.8 MFLOP a receiver, 277
// MFLOP a 150-particle jet, 0.28 us of the dense bf16 tensor cores' 989 TFLOP/s;
// the rest of the pass (float32 a_0 from gathered rows, K1's hash on every
// activation, the epilogues in shared memory, slab barriers) and the search's
// integer work (about 42 min/max a key) stay what they are in the FP32 mode, and
// are what a faster version would cut. Every sum has a fixed order: two launches
// on equal inputs are bit-identical, and K8 on K5's idx gives K5's output bit for
// bit.

#include "edge_fwd_bf16.cuh"
#include "knn_stages.cuh"

extern "C" {

// K5 in the bf16 mode. Arguments as mpgan_knn_fused_layer's, with bf16 xs, xf, u1,
// u2m, w_d, the hidden weights and biases and out; idx_out int32 and dists_out
// float32; `packed` holds `packed_floats` floats (mp_kernels.fwd_packed_floats_bf16).
int mpgan_knn_fused_layer_bf16(const bf16* xs, const bf16* xf, const bf16* u1, const bf16* u2m,
                               const bf16* w_d, bf16* out, int* idx_out, float* dists_out,
                               float* packed, long long packed_floats, int batch, int n, int c,
                               int h1, int k, int self_loops, int want_dists, int n_hidden,
                               const void* const* hidden_w, const void* const* hidden_b,
                               const int* hidden_dims, float alpha, int sum_agg, int dropout,
                               const int* seed, unsigned thr, float mult, int ti, int kc,
                               int rows, int sspan, int grid, int slab_floats, void* stream) {
  Chain fe, fn{};
  if (batch < 1 || n < 1 || n > (1 << 22) || c < 1 || c > kMaxWidth || h1 < 1 || h1 > kMaxWidth)
    return (int)cudaErrorInvalidValue;
  if (k < 1 || k + (self_loops ? 0 : 1) > n || (want_dists && w_d == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!fill_chain(fe, n_hidden, hidden_w, hidden_b, hidden_dims) || fe.dim[0] != h1 ||
      (rows != 32 && rows != 64 && rows != 128))
    return (int)cudaErrorInvalidValue;
  if (fwd_pack_bf16(fe, fn, fe.n, -1, col_threads_of(rows)).total > packed_floats)
    return (int)cudaErrorInvalidValue;
  KnnArgs a{};
  a.xs = reinterpret_cast<const float*>(xs);
  a.xf = reinterpret_cast<const float*>(xf);
  a.u1 = reinterpret_cast<const float*>(u1);
  a.u2m = reinterpret_cast<const float*>(u2m);
  a.w_d = reinterpret_cast<const float*>(w_d);
  a.out = reinterpret_cast<float*>(out);
  a.idx_out = idx_out;
  a.dists_out = dists_out;
  a.packed = packed;
  a.batch = batch;
  a.n = n;
  a.c = c;
  a.h1 = h1;
  a.k = k;
  a.self_loops = self_loops;
  a.want_dists = want_dists;
  a.sum_agg = sum_agg;
  a.sspan = sspan;
  return launch_knn_fwd<true, bf16>(a, fe, alpha, dropout, seed, thr, mult, ti, kc, rows, grid,
                                    slab_floats, stream);
}

// K8 in the bf16 mode. Arguments as mpgan_knn_edge_aggregate's, with bf16 u1, u2m,
// w_d, the hidden weights and biases and out; idx int32 and dists float32;
// `packed` holds `packed_floats` floats.
int mpgan_knn_edge_aggregate_bf16(const bf16* u1, const bf16* u2m, const int* idx,
                                  const float* dists, const bf16* w_d, bf16* out, float* packed,
                                  long long packed_floats, int batch, int n, int h1, int k,
                                  int n_hidden, const void* const* hidden_w,
                                  const void* const* hidden_b, const int* hidden_dims,
                                  float alpha, int sum_agg, int dropout, const int* seed,
                                  unsigned thr, float mult, int ti, int kc, int rows, int grid,
                                  int slab_floats, void* stream) {
  Chain fe, fn{};
  if (batch < 1 || n < 1 || n > (1 << 22) || h1 < 1 || h1 > kMaxWidth || k < 1 ||
      idx == nullptr || (dists == nullptr) != (w_d == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!fill_chain(fe, n_hidden, hidden_w, hidden_b, hidden_dims) || fe.dim[0] != h1 ||
      (rows != 32 && rows != 64 && rows != 128))
    return (int)cudaErrorInvalidValue;
  if (fwd_pack_bf16(fe, fn, fe.n, -1, col_threads_of(rows)).total > packed_floats)
    return (int)cudaErrorInvalidValue;
  KnnArgs a{};
  a.idx = idx;
  a.dists = dists;
  a.u1 = reinterpret_cast<const float*>(u1);
  a.u2m = reinterpret_cast<const float*>(u2m);
  a.w_d = reinterpret_cast<const float*>(w_d);
  a.out = reinterpret_cast<float*>(out);
  a.packed = packed;
  a.batch = batch;
  a.n = n;
  a.h1 = h1;
  a.k = k;
  a.want_dists = dists != nullptr;
  a.sum_agg = sum_agg;
  return launch_knn_fwd<false, bf16>(a, fe, alpha, dropout, seed, thr, mult, ti, kc, rows, grid,
                                     slab_floats, stream);
}

}  // extern "C"
