// The knn edge MLP and masked aggregate from a given neighbour list, for Hopper
// (sm_90a), FP32 on CUDA cores.
//
// Replaces K8 of mpgan_tpu/ops/knn_pallas.py: the forwards of its three gather
// kernel generations, _fwd_impl (_fwd_kernel, raw pair rows), _fwd_impl_v2
// (_fwd_kernel_v2, decomposed first layer) and _fwd_impl_v3 (_fwd_kernel_v3, the
// same on neighbour-major rows), with K1, the in-kernel dropout hash, in train
// mode. The three are one function with one dropout mask (all key the hash on the
// edge id b*n*k + i*k + s) in three TPU row layouts, so one kernel stands for
// them; the first generation's in-kernel first layer is, on the caller's side, the
// decomposition into u1 and u2m in torch. Their backwards are K6 (knn_edge_bwd.cu).
//
//   z1[i, s]  = u1[i] + u2m[idx[i, s], :h1] (+ dists[i, s] * w_d)
//   agg[i]    = sum_s u2m[idx[i, s], h1] * chain(leaky(z1[i, s]))         (/ k for mean)
//
// It is knn_stages.cuh's forward kernel without the search, each row's sender
// read from idx (clamped to [0, n), so a wrong idx cannot read outside the jet)
// and its distance from dists: the pass that K2, K4 and K5 run
// (edge_fwd_common.cuh), so on K5's own idx the result equals K5's bit for bit.
// What bounds it: K5's chain, 2 * k * (sum of in * out) FLOP a receiver against
// ~1 KB of operands a particle and 8 bytes an edge of idx and dists, so the FP32
// FMA issue of the pass's products. The TPU kernels' one-hot gather matmul is not
// carried over: the sender rows are read from device memory by index.

#include "knn_stages.cuh"

extern "C" {

// K8. u1 [batch, n, h1]; u2m [batch, n, h1 + 1]; idx int32 [batch, n, k]; dists
// [batch, n, k] and w_d [h1], both null or both given; out [batch, n, h_out];
// packed: scratch for the packed weights (mp_kernels.fwd_packed_floats).
// hidden_dims has n_hidden + 1 entries, hidden_dims[0] == h1. The pass, the grid
// and the weight slabs' size are the caller's plan (knn_kernels.knn_fwd_plan with
// search off). With `dropout`, K1 runs with the seed `seed` points to in device
// memory, keep threshold `thr` and multiplier `mult` as computed on the host (see
// Drop). Returns a
// cudaError_t code (0 on success); the launch is asynchronous on `stream`.
int mpgan_knn_edge_aggregate(const float* u1, const float* u2m, const int* idx,
                             const float* dists, const float* w_d, float* out, float* packed,
                             int batch, int n, int h1, int k, int n_hidden,
                             const void* const* hidden_w, const void* const* hidden_b,
                             const int* hidden_dims, float alpha, int sum_agg, int dropout,
                             const int* seed, unsigned thr, float mult, int ti, int kc,
                             int rows, int grid, int slab_floats, void* stream) {
  Chain fe;
  if (batch < 1 || n < 1 || n > (1 << 22) || h1 < 1 || h1 > kMaxWidth || k < 1 ||
      idx == nullptr || (dists == nullptr) != (w_d == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!fill_chain(fe, n_hidden, hidden_w, hidden_b, hidden_dims) || fe.dim[0] != h1)
    return (int)cudaErrorInvalidValue;
  KnnArgs a{};
  a.idx = idx;
  a.dists = dists;
  a.u1 = u1;
  a.u2m = u2m;
  a.w_d = w_d;
  a.out = out;
  a.packed = packed;
  a.batch = batch;
  a.n = n;
  a.h1 = h1;
  a.k = k;
  a.want_dists = dists != nullptr;
  a.sum_agg = sum_agg;
  return launch_knn_fwd<false, float>(a, fe, alpha, dropout, seed, thr, mult, ti, kc, rows,
                                      grid, slab_floats, stream);
}

#ifdef MPGAN_PHASE_CLOCKS
// Clocks summed per phase (edge_products.cuh: Phase) since the last reset.
int mpgan_knn_edge_aggregate_phase_clocks(unsigned long long* out, int reset) {
  return read_phase_clocks(out, reset);
}
#endif

}  // extern "C"
