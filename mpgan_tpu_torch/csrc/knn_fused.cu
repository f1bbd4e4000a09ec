// Fused knn message-passing edge stage for Hopper (sm_90a), FP32 on CUDA cores.
//
// Replaces K5 of mpgan_tpu/ops/knn_pallas.py: _fused_impl_v4 (_fused_kernel_v4),
// with K1, the in-kernel dropout hash (mp_pallas._dropmul), in train mode. The
// backward, K6, is in knn_edge_bwd.cu; the two stages (search, chain) are in
// knn_stages.cuh, shared with the search alone (knn_search.cu, K7) and the aggregate
// from a given idx (knn_edge_aggregate.cu, K8); the rest is in edge_common.cuh.
//
// For every jet b and receiver i
//   d[i, j]   = (-2 xs[i] | 1) . (xf[j] | |xf[j]|^2) + |xs[i]|^2          (full FP32)
//               summed term by term in column order, every product and sum rounded
//               on its own (__fmul_rn, __fadd_rn: no contraction into FMAs), so the
//               keys equal the plain PyTorch version's bit for bit
//   key[i, j] = bits(max(d, 0)) & ~(2^bits - 1) | j,   bits = max(8, bitlen(n - 1))
//   idx[i, s] = sender of the s-th smallest key (k + 1 extractions, the first
//               dropped, without self loops)
//   z1[i, s]  = u1[i] + u2m[idx[i, s], :h1] (+ |xf[idx[i, s]] - xs[i] + 1e-12| * w_d)
//   agg[i]    = sum_s u2m[idx[i, s], h1] * chain(leaky(z1[i, s]))         (/ k for mean)
// where `chain` is the fe MLP's hidden layers (LeakyReLU after each) and u2m's
// last column is the sender mask. The fe first layer arrives decomposed, as in the
// dense kernels. In train mode every activation is multiplied by K1's multiplier,
// keyed on the pair id b*n*k + i*k + s: the extraction rank s is part of the id,
// so the neighbours are kept in ascending key order. A launch that feeds a
// backward also writes idx [B, N, k] (and the distances).
//
// What bounds it: the chain is 2 * k * (sum of in * out) FLOP per receiver (92
// KFLOP per edge at the published widths, k = 20: 277 MFLOP per 150-particle jet)
// against ~1 KB of input per particle, so like K2 the kernel is bound by FP32 FMA
// issue; the search is under 1% of that arithmetic. The design:
//   - the TPU kernel's layout devices are not carried over: its one-hot gather
//     matmul is an indexed read of u2m rows from device memory (a jet's operands
//     sit in L2), its receiver padding and neighbour-major residual columns are a
//     plain [B, N, k] idx, its tree sum a fixed-order loop;
//   - a CTA owns a group of up to 32 receivers of one jet, as in K2. First the
//     search: the jet's senders are staged transposed in shared memory with their
//     squared norms, then a warp per receiver computes the n keys into its own row
//     of shared memory and extracts the minimum k times (lane-strided minimum,
//     __reduce_min_sync, the winner's key set to INT_MAX). Keys are unique, so a
//     pass removes exactly one sender, and ties inside a truncation bucket break by
//     index, as in the TPU kernel. The search arrays share their shared memory
//     with the pass buffers, which are not live yet;
//   - then the chain in passes of ti receivers x kc ranks (ti * kc <= 128 pair
//     rows) through the same transposed ping-pong buffers and register-tiled
//     dense layer as K2, and a masked sum over each receiver's ranks into the
//     group's aggregate in shared memory. Nothing crosses CTAs;
//   - no tensor cores and no TF32: the keys need full FP32 (a reduced-precision
//     product flips neighbours), and the chain holds FP32 parity with the plain
//     version.

#include "knn_stages.cuh"

namespace {

// grid = (batch, number of receiver groups). Dynamic shared memory: see KnnSmem.
template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
    knn_fused_kernel(const float* __restrict__ xs, const float* __restrict__ xf,
                     const float* __restrict__ u1, const float* __restrict__ u2m,
                     const float* __restrict__ w_d, float* __restrict__ out,
                     int* __restrict__ idx_out, float* __restrict__ dists_out, int n, int c,
                     int h1, int k, int self_loops, int want_dists, int key_bits, KnnPlan p,
                     Chain fe, float alpha, int sum_agg, Drop drop) {
  extern __shared__ float4 smem4[];
  const KnnSmem sm = knn_smem(reinterpret_cast<float*>(smem4), p, fe.dim[fe.n], k, true);
  const int b = blockIdx.x;
  const int g0 = blockIdx.y * p.group;
  const int g_eff = min(p.group, n - g0);
  knn_search_stage(xs, xf, idx_out, dists_out, b, g0, g_eff, n, c, k, self_loops, want_dists,
                   key_bits, p, sm.work, sm.sel, sm.seld);
  knn_chain_stage<kDrop>(u1, u2m, w_d, out, b, g0, g_eff, n, h1, k, want_dists, p, fe, alpha,
                         sum_agg, drop, sm);
}

template <bool kDrop>
int launch(const float* xs, const float* xf, const float* u1, const float* u2m, const float* w_d,
           float* out, int* idx_out, float* dists_out, int batch, int n, int c, int h1, int k,
           int self_loops, int want_dists, const Chain& fe, float alpha, int sum_agg,
           int dropout, int seed, unsigned thr, float mult, void* stream) {
  KnnPlan p;
  const size_t smem = make_knn_plan(n, c, k, fe, true, true, p);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(knn_fused_kernel<kDrop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch, (n + p.group - 1) / p.group);
  knn_fused_kernel<kDrop><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xs, xf, u1, u2m, w_d, out, idx_out, dists_out, n, c, h1, k, self_loops, want_dists,
      knn_key_bits(n), p, fe, alpha, sum_agg, knn_drop(dropout, seed, thr, mult, p, k));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K5. xs, xf [batch, n, c]; u1 [batch, n, h1]; u2m [batch, n, h1 + 1]; w_d [h1]
// (read with want_dists); out [batch, n, h_out]; idx_out int32 [batch, n, k] and
// dists_out [batch, n, k] may be null (dists_out is written with want_dists only).
// hidden_dims has n_hidden + 1 entries, hidden_dims[0] == h1. With `dropout`, K1
// runs with seed in [0, 2^31), keep threshold `thr` and multiplier `mult` as
// computed on the host (see Drop). Returns a cudaError_t code (0 on success); the
// launch is asynchronous on `stream`.
int mpgan_knn_fused_layer(const float* xs, const float* xf, const float* u1, const float* u2m,
                          const float* w_d, float* out, int* idx_out, float* dists_out,
                          int batch, int n, int c, int h1, int k, int self_loops, int want_dists,
                          int n_hidden, const void* const* hidden_w,
                          const void* const* hidden_b, const int* hidden_dims, float alpha,
                          int sum_agg, int dropout, int seed, unsigned thr, float mult,
                          void* stream) {
  Chain fe;
  if (batch < 1 || n < 1 || n > (1 << 22) || c < 1 || c > kMaxWidth || h1 < 1 || h1 > kMaxWidth ||
      seed < 0)
    return (int)cudaErrorInvalidValue;
  if (k < 1 || k + (self_loops ? 0 : 1) > n || (want_dists && w_d == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!fill_chain(fe, n_hidden, hidden_w, hidden_b, hidden_dims) || fe.dim[0] != h1)
    return (int)cudaErrorInvalidValue;
  auto* fn = dropout ? launch<true> : launch<false>;
  return fn(xs, xf, u1, u2m, w_d, out, idx_out, dists_out, batch, n, c, h1, k, self_loops,
            want_dists, fe, alpha, sum_agg, dropout, seed, thr, mult, stream);
}

}  // extern "C"
