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
// It is the chain stage of the fused layer (knn_fused.cu, K5) fed from idx and
// dists in device memory instead of the search stage: knn_stages.cuh holds the
// one source, so on the search's own idx the result equals K5's bit for bit.
//
// What bounds it: K5's arithmetic, 2 * k * (sum of in * out) FLOP per receiver
// against ~1 KB of operands per particle and 8 bytes per edge of idx and dists:
// the FP32 FMA rate. The design is K5's: a CTA per group of up to 32 receivers of a
// jet, passes of at most 128 pair rows through transposed ping-pong buffers and the
// register-tiled dense layer, the sender rows read from device memory by index (the
// TPU kernels' one-hot gather matmul is not carried over). An index outside
// [0, n) is clamped, so a wrong idx cannot read outside the jet.

#include "knn_stages.cuh"

namespace {

template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
    knn_edge_aggregate_kernel(const float* __restrict__ u1, const float* __restrict__ u2m,
                              const int* __restrict__ idx, const float* __restrict__ dists,
                              const float* __restrict__ w_d, float* __restrict__ out, int n,
                              int h1, int k, KnnPlan p, Chain fe, float alpha, int sum_agg,
                              Drop drop) {
  extern __shared__ float4 smem4[];
  const KnnSmem sm = knn_smem(reinterpret_cast<float*>(smem4), p, fe.dim[fe.n], k, true);
  const int b = blockIdx.x;
  const int g0 = blockIdx.y * p.group;
  const int g_eff = min(p.group, n - g0);
  const size_t e0 = ((size_t)b * n + g0) * k;
  for (int t = threadIdx.x; t < g_eff * k; t += kThreads) {
    sm.sel[t] = min(max(idx[e0 + t], 0), n - 1);
    if (dists != nullptr) sm.seld[t] = dists[e0 + t];
  }
  knn_chain_stage<kDrop>(u1, u2m, w_d, out, b, g0, g_eff, n, h1, k, dists != nullptr, p, fe,
                         alpha, sum_agg, drop, sm);
}

template <bool kDrop>
int launch(const float* u1, const float* u2m, const int* idx, const float* dists,
           const float* w_d, float* out, int batch, int n, int h1, int k, const Chain& fe,
           float alpha, int sum_agg, int dropout, int seed, unsigned thr, float mult,
           void* stream) {
  KnnPlan p;
  const size_t smem = make_knn_plan(n, 0, k, fe, false, true, p);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(knn_edge_aggregate_kernel<kDrop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch, (n + p.group - 1) / p.group);
  knn_edge_aggregate_kernel<kDrop><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      u1, u2m, idx, dists, w_d, out, n, h1, k, p, fe, alpha, sum_agg,
      knn_drop(dropout, seed, thr, mult, p, k));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K8. u1 [batch, n, h1]; u2m [batch, n, h1 + 1]; idx int32 [batch, n, k]; dists
// [batch, n, k] and w_d [h1], both null or both given; out [batch, n, h_out].
// hidden_dims has n_hidden + 1 entries, hidden_dims[0] == h1. With `dropout`, K1
// runs with seed in [0, 2^31), keep threshold `thr` and multiplier `mult` as
// computed on the host (see Drop). Returns a cudaError_t code (0 on success); the
// launch is asynchronous on `stream`.
int mpgan_knn_edge_aggregate(const float* u1, const float* u2m, const int* idx,
                             const float* dists, const float* w_d, float* out, int batch, int n,
                             int h1, int k, int n_hidden, const void* const* hidden_w,
                             const void* const* hidden_b, const int* hidden_dims, float alpha,
                             int sum_agg, int dropout, int seed, unsigned thr, float mult,
                             void* stream) {
  Chain fe;
  if (batch < 1 || n < 1 || n > (1 << 22) || h1 < 1 || h1 > kMaxWidth || k < 1 || seed < 0 ||
      idx == nullptr || (dists == nullptr) != (w_d == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!fill_chain(fe, n_hidden, hidden_w, hidden_b, hidden_dims) || fe.dim[0] != h1)
    return (int)cudaErrorInvalidValue;
  auto* fn = dropout ? launch<true> : launch<false>;
  return fn(u1, u2m, idx, dists, w_d, out, batch, n, h1, k, fe, alpha, sum_agg, dropout, seed,
            thr, mult, stream);
}

}  // extern "C"
